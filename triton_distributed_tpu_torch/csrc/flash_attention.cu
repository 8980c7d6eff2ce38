// K1: flash-attention prefill for Hopper (sm_90a), and K8, its chunk fold.
//
// K1 replaces triton_distributed_tpu/ops/attention.py::_attn_kernel (the
// Pallas causal/non-causal flash prefill with GQA and tanh soft_cap).  K8
// replaces ::_attn_chunk_kernel (flash_attention_chunk: one KV chunk folded
// into a carried (m, l, acc) f32 state, the step of ring attention): the
// same kernel with CHUNK set, which starts each row from the state it is
// given instead of (-1e30, 0, 0), applies causality by absolute position
// (query q_offset + i against key kv_offset + j, the offsets read on the
// device from int32 tensors or passed as ints), and writes the state back
// unnormalized.  A query tile whose rows all precede the chunk reads no K/V
// and copies its state through, so a chunk wholly in the future does no
// work; a row with no visible key keeps its state exactly (its masked
// scores give p = 0 and a rescale of exp(0) = 1), never NaN.  It computes
// what that kernel computes, not block for block: q is scaled in f32 and cast
// to the storage type before the q.k dot, scores and the online-softmax state
// (m, l, acc) are f32, p is cast to the V type before the p.v dot, a masked
// score is -1e30 with p = 0 (never NaN), and the causal kv loop stops at the
// diagonal tile.
//
// Bound on the H100 at the Qwen3-8B prefill shape (B = 4, H = 32, Hkv = 8,
// S = 1024, D = 128): about 34 GFLOP of causal q.k and p.v products against
// about 84 MB of q, k, v and o, so the tensor cores bound it.  The bf16 design
// keeps both products on the tensor cores: one block owns 64 query rows of one
// (batch, head), four warps own 16 rows each, and 64-row K/V tiles of the
// head's kv head stream through shared memory with cp.async, double-buffered
// so tile j + 1 arrives while tile j is computed; the q tile is staged in the
// second K buffer, so three blocks fit on an SM (rows padded by 8 elements
// so the ldmatrix reads hit distinct banks).  QK^T and PV are mma.sync
// m16n8k16 bf16 -> f32 with the K and V^T fragments read by ldmatrix; the
// score fragment is reused in registers as the A operand of the PV product,
// so no score tile ever goes through memory, and exp is exp2 of a scaled
// argument.  Query tiles are launched heaviest-first across all heads so the
// causal tail finishes early.
// The f32 storage path is plain scalar FMA: it serves parity checks, not the
// serving path.
#include "ptx.cuh"

namespace tdt {
namespace {

constexpr int kBQ = 64;       // query rows per block (bf16 path)
constexpr int kBK = 64;       // kv rows per tile (bf16 path)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr float kLog2e = 1.4426950408889634f;

// The chunk fold's carried state and offsets (K8); unused by K1.  m, l:
// (B * H, Sq), acc: (B * H, Sq, D), f32; the offsets come from the int32
// pointers when they are not null, else from the ints.
struct ChunkState {
  const float *m_in, *l_in, *acc_in;
  float *m_out, *l_out, *acc_out;
  const int *q_off_ptr, *kv_off_ptr;
  int q_off, kv_off;
};

// q_offset - kv_offset: a key at chunk position j is visible to the query at
// position i when j <= i + delta.
__device__ __forceinline__ int chunk_delta(const ChunkState& cs) {
  const int qo = cs.q_off_ptr ? *cs.q_off_ptr : cs.q_off;
  const int ko = cs.kv_off_ptr ? *cs.kv_off_ptr : cs.kv_off;
  return qo - ko;
}

// kv tiles of `bk` rows a causal query tile whose last row is `last` (chunk
// positions, offset by delta) must read: none when last < 0.
__device__ __forceinline__ int causal_tiles(int last, int bk, int n_kt) {
  return last < 0 ? 0 : min(n_kt, last / bk + 1);
}

// Copy the state of rows [r0, r1) of (batch * head) bh through unchanged.
template <int D>
__device__ void copy_state(const ChunkState& cs, int bh, int Sq, int r0,
                           int r1) {
  r1 = min(r1, Sq);
  const size_t base = static_cast<size_t>(bh) * Sq;
  for (int i = threadIdx.x; i < (r1 - r0) * D; i += blockDim.x) {
    const size_t row = base + r0 + i / D;
    cs.acc_out[row * D + i % D] = cs.acc_in[row * D + i % D];
    if (i % D == 0) {
      cs.m_out[row] = cs.m_in[row];
      cs.l_out[row] = cs.l_in[row];
    }
  }
}

template <int D, bool CHUNK>
__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int H,
               int Hkv, int Sq, int Skv, int causal, float sm_scale,
               float soft_cap, ChunkState cs) {
  constexpr int LD = D + 8;      // padded shared-memory row, in elements
  constexpr int CH = D / 8;      // 16-byte chunks per row
  constexpr int KSTEPS = D / 16; // k steps of the q.k product
  constexpr int NT = kBK / 8;    // 8-column score tiles per kv tile
  constexpr int DT = D / 8;      // 8-column output tiles
  constexpr int T = kBK * LD;     // one K or V tile, in elements
  // [K0][V0][K1][V1]; the q tile is staged in K1, which it leaves for
  // registers before K1 is first filled (kBQ == kBK)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* sQ = smem + 2 * T;

  // blocks start in x-fastest order: every (batch, head) takes its longest
  // causal q tile first, so the last wave holds only short tiles
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const bf16* qp = q + static_cast<size_t>(bh) * Sq * D;
  const bf16* kp = k + static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const bf16* vp = v + static_cast<size_t>(b * Hkv + hk) * Skv * D;
  bf16* op = o + static_cast<size_t>(bh) * Sq * D;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBQ;
  const int delta = CHUNK ? chunk_delta(cs) : 0;
  if (CHUNK && causal && q0 + kBQ - 1 + delta < 0) {
    copy_state<D>(cs, bh, Sq, q0, q0 + kBQ);  // every key is in these rows' future
    return;
  }

  // K/V tile j -> buffer `buf`, asynchronously; rows past Skv are zeros
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * kBK;
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = k0 + r < Skv;
      const size_t off = static_cast<size_t>(in ? k0 + r : 0) * D + c;
      cp_async16(smem + 2 * buf * T + r * LD + c, kp + off, in);
      cp_async16(smem + (2 * buf + 1) * T + r * LD + c, vp + off, in);
    }
    cp_async_commit();
  };
  load_kv(0, 0);  // in flight while q is staged

  // stage q, scaled in f32 and rounded back to bf16 (the JAX _scaled_q)
  for (int i = tid; i < kBQ * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) {
      u = *reinterpret_cast<const uint4*>(qp + static_cast<size_t>(q0 + r) * D + c);
      __nv_bfloat162* hh = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(hh[j]);
        hh[j] = __floats2bfloat162_rn(f.x * sm_scale, f.y * sm_scale);
      }
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = u;
  }
  __syncthreads();

  const int r_lo = warp * 16 + g;  // this thread's rows in the tile: r_lo, r_lo + 8
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const bf16* base = sQ + r_lo * LD + kk * 16 + 2 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }
  __syncthreads();  // every warp holds its q fragments before K1 is filled

  float acc[DT][4];
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const int row0 = q0 + r_lo, row1 = row0 + 8;  // query positions in q

  int n_kt = (Skv + kBK - 1) / kBK;
  if (causal) n_kt = causal_tiles(q0 + kBQ - 1 + delta, kBK, n_kt);  // stop at the diagonal
  if (CHUNK) {  // start from the carried state
    const size_t base = static_cast<size_t>(bh) * Sq;
    if (row0 < Sq) {
      m0 = cs.m_in[base + row0];
      l0 = cs.l_in[base + row0];
    }
    if (row1 < Sq) {
      m1 = cs.m_in[base + row1];
      l1 = cs.l_in[base + row1];
    }
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int col = dn * 8 + 2 * t;
      if (row0 < Sq) {
        const float2 a = *reinterpret_cast<const float2*>(cs.acc_in + (base + row0) * D + col);
        acc[dn][0] = a.x;
        acc[dn][1] = a.y;
      }
      if (row1 < Sq) {
        const float2 a = *reinterpret_cast<const float2*>(cs.acc_in + (base + row1) * D + col);
        acc[dn][2] = a.x;
        acc[dn][3] = a.y;
      }
    }
  }

  // ldmatrix row addresses of this lane (see ldmatrix_x4): K matrices are
  // (8 kv rows) x (8 head-dim columns) at column offsets 0, 8, 16, 24; V
  // matrices are (8 kv rows) x (8 columns) at kv offsets 0, 8 and column
  // offsets 0, 8
  const int mrow = lane & 7, mat = lane >> 3;
  const int k_off = mrow * LD + mat * 8;
  const int v_off = ((mat & 1) * 8 + mrow) * LD + (mat >> 1) * 8;

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kBK;
    const int buf = j & 1;
    if (j + 1 < n_kt) {
      load_kv(j + 1, buf ^ 1);  // in flight while tile j is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = smem + 2 * buf * T;
    const bf16* tV = smem + (2 * buf + 1) * T;

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; kk += 2) {
        uint32_t kb[4];  // B fragments of k steps kk and kk + 1
        ldmatrix_x4(kb, tK + nt * 8 * LD + kk * 16 + k_off);
        mma_bf16(s[nt], qa[kk], kb);
        mma_bf16(s[nt], qa[kk + 1], kb + 2);
      }
    }

    // soft cap, then the mask (ragged kv edge, causal diagonal)
    const bool need_mask = (k0 + kBK > Skv) || (causal && k0 + kBK - 1 > q0 + delta);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e];
        if (soft_cap > 0.f) x = tanhf(x / soft_cap) * soft_cap;
        if (need_mask) {
          const int col = k0 + nt * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= Skv || (causal && col > row + delta)) x = kNegInf;
        }
        s[nt][e] = x;
      }
    }

    // online softmax; the four threads of a quad share a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
    const bool live0 = mx0 > 0.5f * kNegInf, live1 = mx1 > 0.5f * kNegInf;
    // exp(x) as exp2(x * log2 e): one multiply and the hardware exp2
    const float ms0 = mx0 * kLog2e, ms1 = mx1 * kLog2e;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = live0 ? exp2f(fmaf(s[nt][0], kLog2e, -ms0)) : 0.f;
      s[nt][1] = live0 ? exp2f(fmaf(s[nt][1], kLog2e, -ms0)) : 0.f;
      s[nt][2] = live1 ? exp2f(fmaf(s[nt][2], kLog2e, -ms1)) : 0.f;
      s[nt][3] = live1 ? exp2f(fmaf(s[nt][3], kLog2e, -ms1)) : 0.f;
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    rs0 += __shfl_xor_sync(kFullMask, rs0, 1);
    rs0 += __shfl_xor_sync(kFullMask, rs0, 2);
    rs1 += __shfl_xor_sync(kFullMask, rs1, 1);
    rs1 += __shfl_xor_sync(kFullMask, rs1, 2);
    const float a0 = exp2f((m0 - mx0) * kLog2e), a1 = exp2f((m1 - mx1) * kLog2e);
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      acc[dn][0] *= a0; acc[dn][1] *= a0;
      acc[dn][2] *= a1; acc[dn][3] *= a1;
    }

    // p.v: the score fragments of two adjacent 8-column tiles form the
    // 16x16 A fragment of one k step
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
      for (int dn = 0; dn < DT; dn += 2) {
        uint32_t vb[4];  // B fragments of output tiles dn and dn + 1
        ldmatrix_x4_trans(vb, tV + ks * 16 * LD + dn * 8 + v_off);
        mma_bf16(acc[dn], pa, vb);
        mma_bf16(acc[dn + 1], pa, vb + 2);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  if (CHUNK) {  // the unnormalized state; one thread of the quad writes m, l
    const size_t base = static_cast<size_t>(bh) * Sq;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int col = dn * 8 + 2 * t;
      if (row0 < Sq)
        *reinterpret_cast<float2*>(cs.acc_out + (base + row0) * D + col) =
            make_float2(acc[dn][0], acc[dn][1]);
      if (row1 < Sq)
        *reinterpret_cast<float2*>(cs.acc_out + (base + row1) * D + col) =
            make_float2(acc[dn][2], acc[dn][3]);
    }
    if (t == 0 && row0 < Sq) {
      cs.m_out[base + row0] = m0;
      cs.l_out[base + row0] = l0;
    }
    if (t == 0 && row1 < Sq) {
      cs.m_out[base + row1] = m1;
      cs.l_out[base + row1] = l1;
    }
    return;
  }
#pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row0 < Sq) {
      *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(row0) * D + col) =
          l0 > 0.f ? pack_bf16(acc[dn][0] / l0, acc[dn][1] / l0) : 0u;
    }
    if (row1 < Sq) {
      *reinterpret_cast<uint32_t*>(op + static_cast<size_t>(row1) * D + col) =
          l1 > 0.f ? pack_bf16(acc[dn][2] / l1, acc[dn][3] / l1) : 0u;
    }
  }
}

// f32 storage: one warp per query row at a time, lanes over kv rows for the
// scores and over head-dim columns for the p.v accumulation.
constexpr int kF32BQ = 32;
constexpr int kF32BK = 32;
constexpr int kF32Warps = 8;

template <int D, bool CHUNK>
__global__ void __launch_bounds__(kF32Warps * 32)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int Hkv, int Sq, int Skv, int causal, float sm_scale,
              float soft_cap, ChunkState cs) {
  constexpr int RPW = kF32BQ / kF32Warps;  // query rows per warp
  constexpr int DPL = D / 32;              // output columns per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [kF32BQ][D]
  float* sK = sQ + kF32BQ * D;                     // [kF32BK][D + 1]
  float* sV = sK + kF32BK * (D + 1);               // [kF32BK][D]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const float* qp = q + static_cast<size_t>(bh) * Sq * D;
  const float* kp = k + static_cast<size_t>(b * Hkv + hk) * Skv * D;
  const float* vp = v + static_cast<size_t>(b * Hkv + hk) * Skv * D;
  float* op = o + static_cast<size_t>(bh) * Sq * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kF32BQ;
  const int delta = CHUNK ? chunk_delta(cs) : 0;
  int n_kt = (Skv + kF32BK - 1) / kF32BK;
  if (causal) n_kt = causal_tiles(q0 + kF32BQ - 1 + delta, kF32BK, n_kt);
  if (CHUNK && n_kt == 0) {
    copy_state<D>(cs, bh, Sq, q0, q0 + kF32BQ);
    return;
  }

  for (int i = tid; i < kF32BQ * D; i += kF32Warps * 32) {
    const int r = i / D, c = i % D;
    sQ[i] = q0 + r < Sq ? qp[static_cast<size_t>(q0 + r) * D + c] * sm_scale : 0.f;
  }
  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp * RPW + i;
    const size_t at = static_cast<size_t>(bh) * Sq + row;
    const bool carried = CHUNK && row < Sq;
    m[i] = carried ? cs.m_in[at] : kNegInf;
    l[i] = carried ? cs.l_in[at] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = carried ? cs.acc_in[at * D + lane + 32 * c] : 0.f;
  }

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kF32BK;
    __syncthreads();
    for (int i = tid; i < kF32BK * D; i += kF32Warps * 32) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Skv;
      const size_t off = static_cast<size_t>(k0 + r) * D + c;
      sK[r * (D + 1) + c] = in ? kp[off] : 0.f;
      sV[r * D + c] = in ? vp[off] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      const int row = q0 + r;
      const int col = k0 + lane;  // this lane's kv row
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(sQ[r * D + d], sK[lane * (D + 1) + d], s);
      if (soft_cap > 0.f) s = tanhf(s / soft_cap) * soft_cap;
      if (col >= Skv || (causal && col > row + delta)) s = kNegInf;
      float mx = fmaxf(m[i], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float p = mx > 0.5f * kNegInf ? expf(s - mx) : 0.f;
      float rs = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) rs += __shfl_xor_sync(kFullMask, rs, off);
      const float alpha = expf(m[i] - mx);
      l[i] = l[i] * alpha + rs;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= alpha;
      for (int kr = 0; kr < kF32BK; ++kr) {
        const float pk = __shfl_sync(kFullMask, p, kr);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(pk, sV[kr * D + lane + 32 * c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int row = q0 + warp * RPW + i;
    if (row >= Sq) continue;
    if (CHUNK) {
      const size_t at = static_cast<size_t>(bh) * Sq + row;
#pragma unroll
      for (int c = 0; c < DPL; ++c) cs.acc_out[at * D + lane + 32 * c] = acc[i][c];
      if (lane == 0) {
        cs.m_out[at] = m[i];
        cs.l_out[at] = l[i];
      }
      continue;
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      op[static_cast<size_t>(row) * D + lane + 32 * c] = l[i] > 0.f ? acc[i][c] / l[i] : 0.f;
    }
  }
}

template <int D, bool CHUNK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int Hkv, int Sq, int Skv, int causal,
                        float sm_scale, float soft_cap, const ChunkState& cs,
                        cudaStream_t stream) {
  // two K tiles + two V tiles (the q tile is staged in the second K tile)
  const int smem = 4 * kBK * (D + 8) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<D, CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_bf16<D, CHUNK><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, Hkv, Sq, Skv,
      causal, sm_scale, soft_cap, cs);
  return cudaGetLastError();
}

template <int D, bool CHUNK>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hkv, int Sq, int Skv, int causal,
                       float sm_scale, float soft_cap, const ChunkState& cs,
                       cudaStream_t stream) {
  const int smem = (kF32BQ * D + kF32BK * (D + 1) + kF32BK * D) *
                   static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D, CHUNK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kF32BQ - 1) / kF32BQ);
  flash_fwd_f32<D, CHUNK><<<grid, kF32Warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, Sq, Skv,
      causal, sm_scale, soft_cap, cs);
  return cudaGetLastError();
}

template <bool CHUNK>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int Sq, int Skv, int D, int causal,
             float sm_scale, float soft_cap, int dtype, const ChunkState& cs,
             cudaStream_t st) {
  if (dtype == 1 && D == 128)
    return launch_bf16<128, CHUNK>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, sm_scale, soft_cap, cs, st);
  if (dtype == 1 && D == 64)
    return launch_bf16<64, CHUNK>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, sm_scale, soft_cap, cs, st);
  if (dtype == 0 && D == 128)
    return launch_f32<128, CHUNK>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, sm_scale, soft_cap, cs, st);
  if (dtype == 0 && D == 64)
    return launch_f32<64, CHUNK>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, sm_scale, soft_cap, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace tdt

// q (B, H, Sq, D), k/v (B, Hkv, Skv, D), o (B, H, Sq, D), all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch;
// the caller checks D and dtype against what is instantiated here.
extern "C" int tdt_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Hkv, int Sq,
                                   int Skv, int D, int causal, float sm_scale,
                                   float soft_cap, int dtype, void* stream) {
  using namespace tdt;
  return dispatch<false>(q, k, v, o, B, H, Hkv, Sq, Skv, D, causal, sm_scale,
                         soft_cap, dtype, ChunkState{},
                         static_cast<cudaStream_t>(stream));
}

// K8: q (B, H, Sq, D) at positions q_offset + [0, Sq), k/v (B, Hkv, Sc, D)
// at kv_offset + [0, Sc), all contiguous; the state in and out: m, l
// (B, H, Sq) and acc (B, H, Sq, D), f32, distinct buffers.  The offsets are
// read from q_off_ptr / kv_off_ptr (int32 on the device) when those are not
// null, else taken from q_off / kv_off.  dtype: 0 = float32, 1 = bfloat16.
extern "C" int tdt_flash_attention_chunk(
    const void* q, const void* k, const void* v, const float* m_in,
    const float* l_in, const float* acc_in, float* m_out, float* l_out,
    float* acc_out, const int* q_off_ptr, const int* kv_off_ptr, int B, int H,
    int Hkv, int Sq, int Sc, int D, int causal, int q_off, int kv_off,
    float sm_scale, float soft_cap, int dtype, void* stream) {
  using namespace tdt;
  const ChunkState cs{m_in, l_in, acc_in, m_out, l_out, acc_out,
                      q_off_ptr, kv_off_ptr, q_off, kv_off};
  return dispatch<true>(q, k, v, nullptr, B, H, Hkv, Sq, Sc, D, causal,
                        sm_scale, soft_cap, dtype, cs,
                        static_cast<cudaStream_t>(stream));
}
