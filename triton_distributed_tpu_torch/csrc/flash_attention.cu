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
// unnormalized, in f32, into new tensors.  A unit of query rows that all
// precede the chunk reads no K/V and copies its state through, so a chunk
// wholly in the future does no work; a row with no visible key keeps its
// state bitwise (its masked scores give p = 0 and a rescale of exp(0) = 1),
// never NaN.  It computes what that kernel computes, not block for block: q
// is scaled in f32 and cast to the storage type before the q.k dot, scores
// and the online-softmax state (m, l, acc) are f32, p is cast to the V type
// before the p.v dot, a masked score is -1e30 with p = 0 (never NaN), and the
// causal kv loop stops at the diagonal tile.
//
// Bound on the H100 at the Qwen3-8B prefill shape (B = 4, H = 32, Hkv = 8,
// S = 1024, D = 128): about 34 GFLOP of causal q.k and p.v products against
// about 84 MB of q, k, v and o, so the tensor cores bound it (0.035 ms).
// K8's fold at the last rank of a 4-way ring (q 1024 rows at 3072, four
// 1024-key chunks) is 60 GFLOP against 17 MB of f32 state in and out a
// chunk: operations again (0.061 ms).
//
// bf16 at D = 128 (K1's served form and K8's fold) runs a wgmma body
// (namespace fa) on wgmma_tile.cuh's mbarriers, TMA and descriptors.  A
// unit of work is 64 query rows of two q heads of one kv head (GQA is 4 or
// 8 on the served models): one 64-row K and V tile in shared memory serves
// both heads, so each K/V byte crosses L2 into shared memory half as often
// as with one head a block, and the two consumer warpgroups see the same
// causal mask and the same number of kv tiles (with 128 rows of one head
// they would not).  An odd group's last pair has one head; its second
// warpgroup computes that head again and stores nothing, so every
// warpgroup runs the same code.  Units are numbered heaviest q tile first
// (for K8 too: a row's visible keys never decrease with the row, whatever
// q_offset - kv_offset is, so the order needs no offset on the host); one
// persistent block an SM takes them in rounds, every other round walked
// backwards, which evens out the blocks' causal work.  Warpgroup 2's first
// warp is the producer: one thread keeps TMA loads in flight, running ahead
// across units, of each unit's two q tiles (two slots, one a unit in turn)
// and of its K and V tiles, each in a three-stage ring with its own
// full/empty mbarriers, so K_{j+1} lands while P V_{j-1} still holds
// V_{j-1}; its three spare warps scale each q tile in f32 and round it to
// bf16 in shared memory as it lands, off the consumers' path.  K8's units
// with no visible key are skipped by all three roles alike (each reads the
// offsets and derives the unit's kv tiles itself), and their consumers copy
// the state through.  Boxes are 64 columns (the 128-byte swizzle).  S = Q
// K^T is wgmma m64n64k16 with both operands K-major in shared memory (q and
// k rows run along D); the soft cap, the mask (only on tiles that reach the
// diagonal or the ragged kv edge) and the online softmax run in f32
// registers, exp as ex2 of a scaled argument, a row with no visible key
// subtracting +inf so that its p is 0 with no select; p is rounded to bf16
// in registers, where a 16-column slice of the m64n64 accumulator already
// has the layout of one k-step's A fragment, and O += P V is wgmma
// m64n128k16 with A from registers and V from shared memory, MN-major (the
// transpose bit).  Tile j's S is issued before tile j - 1's P V, so that
// product runs behind tile j's softmax.  K8 loads each unit's carried O (the
// accumulator's own layout: float pairs, a quad's four threads on 32
// contiguous bytes of a row) and its rows' (m, l) into registers before the
// unit's waits, so their latency hides behind the q tile's landing and the
// first S; after tile 0's softmax it rescales that O to the new running max;
// its epilogue writes O, m and l back unscaled.  S (32 registers), O (64) and
// P (16) fit the 168 registers a thread of a 384-thread block is compiled
// to, with no spill.  ptxas serializes register-operand wgmmas that follow a
// trap on a divergent path, so the consumers' stage waits are plain spins
// and the producer thread is the watchdog: after its last load it waits,
// bounded, for every stage to be released, and traps if one is not.  The
// tensor maps travel as __grid_constant__ parameters, so a captured CUDA
// graph replays them.

// The other forms (D = 64, f32 storage, K1 and K8 alike) keep the first
// design: one block owns 64 query rows of one (batch, head), four warps own
// 16 rows each, and 64-row K/V tiles of the head's kv head stream through
// shared memory with cp.async, double-buffered; QK^T and PV are mma.sync
// m16n8k16 bf16 -> f32 with the K and V^T fragments read by ldmatrix, the
// score fragment reused in registers as the A operand of the PV product.
// The f32 storage path is plain scalar FMA: it serves parity checks, not
// the serving path.
#include "wgmma_tile.cuh"

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

// Copy the state of rows [r0, r1) of (batch * head) bh through unchanged,
// thread t of `threads` (the whole block by default).
template <int D>
__device__ __forceinline__ void copy_state(const ChunkState& cs, int bh, int Sq, int r0, int r1,
                                           int t = threadIdx.x, int threads = blockDim.x) {
  r1 = min(r1, Sq);
  const size_t base = static_cast<size_t>(bh) * Sq;
  for (int i = t; i < (r1 - r0) * D; i += threads) {
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

// ---------------------------------------------------------------------------
// K1's served form (bf16, D = 128, not the chunk fold): the wgmma body

namespace fa {

constexpr int D = 128, BQ = 64, BKV = 64, STAGES = 3;
constexpr int kAcc = 64;                // f32 registers of O, an m64n128 accumulator
constexpr int kS = 32;                  // f32 registers of S, an m64n64 accumulator
constexpr int Q_BYTES = BQ * D * 2;     // 16 KB a head: two 64-row x 64-column boxes
constexpr int KV_BYTES = BKV * D * 2;   // 16 KB a tile: two 64-row x 64-column boxes
constexpr int SMEM_BYTES = 4 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;  // + alignment slack
constexpr int THREADS = 384, kProducerWarp = 8;  // warpgroup 2's first warp
constexpr int kArrivals = 8;            // a stage's release: one arrival a consumer warp
constexpr int kSpare = 96;              // the producer warpgroup's other three warps

struct Bars {
  // the two q slots (a block's units alternate): landed, scaled, free again
  uint64_t qfull[2], qready[2], qempty[2];
  uint64_t kfull[STAGES], kempty[STAGES], vfull[STAGES], vempty[STAGES];
};

// The launch: q (D, Sq, B H), k and v (D, Skv, B Hkv) as TMA maps,
// innermost first, 128-byte swizzle; o (B, H, Sq, D).
struct Args {
  CUtensorMap mq, mk, mv;
  bf16* o;  // K1's output; null in K8's fold, which writes cs's state
  int B, H, Hkv, Sq, Skv, causal;
  float sm_scale, soft_cap;
  ChunkState cs;  // K8's carried state and offsets; unused by K1
};

// d (64 x 64 f32) = (scale_d ? d : 0) + A (64 x 16) @ B (16 x 64), A and B
// from shared memory, both K-major (S = Q K^T: q rows and kv rows along D).
__device__ __forceinline__ void wgmma_ss_64(float (&d)[kS], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) += A (64 x 16 bf16, four registers a thread in the
// m16n8k16 A layout of each warp's 16 rows) @ B (16 x 128, MN-major in
// shared memory: the transpose bit).  O += P V with P from registers.
__device__ __forceinline__ void wgmma_rs_128(float (&d)[kAcc], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
__device__ __forceinline__ void fence_acc(float& x) { asm volatile("" : "+f"(x)::"memory"); }

// A consumer's wait for a full stage: a plain spin.  A bound with a trap on
// this path would put the wgmmas after it on a divergent path, where ptxas
// serializes them (it waits for each before the next issues); the
// producer's watchdog bounds these waits instead.
__device__ __forceinline__ void wait_full(uint64_t* bar, int parity) {
  const uint32_t at = smem_u32(bar);
  while (!wg::mbar_try(at, parity)) {
  }
}

// 2^x on the special-function unit, subnormal results flushed to zero (p
// below 2^-126 counts for nothing against a row sum of at least 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Unit u's work: q tile qt (heaviest first: the last tiles of a causal row
// read the most kv tiles, whatever delta is: a row's visible keys never
// decrease with the row), batch b, kv head hk, and the pair of q heads
// 2 pair, 2 pair + 1 of that kv head's group (one when the group is odd
// and this is its last pair); and the kv tiles it reads, none when all its
// rows precede the chunk (K8: delta = q_offset - kv_offset; K1: 0).
struct Item {
  int qt, b, hk, pair, n_kt;
};

__device__ __forceinline__ Item item(const Args& a, int u, int delta) {
  const int pairs = (a.H / a.Hkv + 1) / 2, per = a.B * a.Hkv * pairs;
  const int nqt = (a.Sq + BQ - 1) / BQ, r = u % per, qt = nqt - 1 - u / per;
  int n_kt = (a.Skv + BKV - 1) / BKV;
  if (a.causal)  // stop at the diagonal of the tile's last row inside Sq
    n_kt = causal_tiles(min(qt * BQ + BQ - 1, a.Sq - 1) + delta, BKV, n_kt);
  return Item{qt, r / (a.Hkv * pairs), (r / pairs) % a.Hkv, r % pairs, n_kt};
}

__device__ __forceinline__ int units(const Args& a) {
  return a.B * a.Hkv * ((a.H / a.Hkv + 1) / 2) * ((a.Sq + BQ - 1) / BQ);
}

// The n-th unit of block b of G: rounds of G units in heaviest-first order,
// every other round walked backwards (a snake), so that the blocks' shares
// of the causal work come out about even.
__device__ __forceinline__ int unit_of(int n) {
  return n * gridDim.x + ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// K1 (CHUNK false) and K8's fold (CHUNK true): the same body, K8's units
// starting from the carried state and writing it back unnormalized.
template <bool CHUNK>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_wgmma(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Bars bars;
  const int U = units(a), g = a.H / a.Hkv;
  const int delta = CHUNK ? chunk_delta(a.cs) : 0;
  unsigned char* sq = wg::stages(dyn);          // two slots of the two warpgroups' q tiles
  unsigned char* sk = sq + 4 * Q_BYTES;         // STAGES K tiles
  unsigned char* sv = sk + STAGES * KV_BYTES;   // STAGES V tiles
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      wg::mbar_init(&bars.qfull[s], 1);
      wg::mbar_init(&bars.qready[s], kSpare);
      wg::mbar_init(&bars.qempty[s], kArrivals);
    }
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&bars.kfull[s], 1);
      wg::mbar_init(&bars.vfull[s], 1);
      wg::mbar_init(&bars.kempty[s], kArrivals);
      wg::mbar_init(&bars.vempty[s], kArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, through a shuffle so that the compiler sees it is
  // the same across each warp (a branch on it does not diverge a warp)
  const int w = __shfl_sync(kFullMask, static_cast<int>(threadIdx.x / 128), 0);
  if (w == 2) {
    wg::set_max_regs_dec<40>();
    if (threadIdx.x == kProducerWarp * 32) {
      // the block's units in turn, running ahead across them: the next
      // unit's q and first tiles load while this one's last tiles compute
      int nu = 0, kv = 0;  // units and kv tiles loaded so far
      for (int n = 0; n * static_cast<int>(gridDim.x) < U; ++n) {
        const int u = unit_of(n);
        if (u >= U) continue;
        const Item it = item(a, u, delta);
        if (CHUNK && it.n_kt == 0) continue;  // copied through by the consumers: no loads
        const int h0 = it.hk * g + 2 * it.pair, heads = min(2, g - 2 * it.pair);
        const int kv_slab = it.b * a.Hkv + it.hk, slot = nu & 1;
        // warpgroup hw's q tile is head h0 + hw's; where the pair has one
        // head both take it (the second computes it again and stores nothing)
        wg::mbar_wait(&bars.qempty[slot], ((nu >> 1) & 1) ^ 1);
        wg::mbar_expect_tx(&bars.qfull[slot], 2 * Q_BYTES);
        for (int hw = 0; hw < 2; ++hw)
          for (int c = 0; c < 2; ++c)
            wg::tma3(sq + (2 * slot + hw) * Q_BYTES + c * (Q_BYTES / 2), &a.mq,
                     &bars.qfull[slot], c * 64, it.qt * BQ, it.b * a.H + h0 + min(hw, heads - 1));
        for (int j = 0; j < it.n_kt; ++j, ++kv) {
          const int s = kv % STAGES, ph = (kv / STAGES) & 1;
          wg::mbar_wait(&bars.kempty[s], ph ^ 1);
          wg::mbar_expect_tx(&bars.kfull[s], KV_BYTES);
          for (int c = 0; c < 2; ++c)
            wg::tma3(sk + s * KV_BYTES + c * (KV_BYTES / 2), &a.mk, &bars.kfull[s], c * 64,
                     j * BKV, kv_slab);
          wg::mbar_wait(&bars.vempty[s], ph ^ 1);
          wg::mbar_expect_tx(&bars.vfull[s], KV_BYTES);
          for (int c = 0; c < 2; ++c)
            wg::tma3(sv + s * KV_BYTES + c * (KV_BYTES / 2), &a.mv, &bars.vfull[s], c * 64,
                     j * BKV, kv_slab);
        }
        ++nu;
      }
      // the watchdog: every stage still in use is released within the
      // bound, or the launch traps (the consumers' own waits are unbounded)
      for (int i = max(0, kv - STAGES); i < kv; ++i) {
        wg::mbar_wait(&bars.kempty[i % STAGES], (i / STAGES) & 1);
        wg::mbar_wait(&bars.vempty[i % STAGES], (i / STAGES) & 1);
      }
    } else if (threadIdx.x >= (kProducerWarp + 1) * 32) {
      // the spare warps: each unit's q scaled in f32 and rounded back to
      // bf16 in place (the JAX _scaled_q) as soon as it lands, then handed
      // to the async proxy that wgmma reads through; off the consumers' path
      const int t = threadIdx.x - (kProducerWarp + 1) * 32;
      int nu = 0;
      for (int n = 0; n * static_cast<int>(gridDim.x) < U; ++n) {
        if (unit_of(n) >= U || (CHUNK && item(a, unit_of(n), delta).n_kt == 0)) continue;
        const int slot = nu & 1;
        wg::mbar_wait(&bars.qfull[slot], (nu >> 1) & 1);
        uint4* qs = reinterpret_cast<uint4*>(sq + 2 * slot * Q_BYTES);
        for (int i = t; i < 2 * Q_BYTES / 16; i += kSpare) {
          uint4 v = qs[i];
          __nv_bfloat162* hh = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(hh[e]);
            hh[e] = __floats2bfloat162_rn(f.x * a.sm_scale, f.y * a.sm_scale);
          }
          qs[i] = v;
        }
        wg::fence_proxy_async();
        wg::mbar_arrive(&bars.qready[slot]);
        ++nu;
      }
    }
    return;
  }

  wg::set_max_regs_inc<232>();
  const int t = threadIdx.x % 128;
  const bool signal = (threadIdx.x & 31) == 0;
  const int r0 = (t / 32) * 16 + (t & 31) / 4, c0 = 2 * (t & 3);
  float o[kAcc], s[kS];
  uint32_t p[kS / 2];
  float m0, m1, l0, l1, r0_, r1_;
  int nu = 0, kv = 0;  // units and kv tiles consumed so far
  for (int n = 0; n * static_cast<int>(gridDim.x) < U; ++n) {
    const int u = unit_of(n);
    if (u >= U) continue;
    const Item it = item(a, u, delta);
    const int h0 = it.hk * g + 2 * it.pair, heads = min(2, g - 2 * it.pair);
    const int q0 = it.qt * BQ, n_kt = it.n_kt, slot = nu & 1;
    const int row0 = q0 + r0, row1 = row0 + 8;  // this thread's query positions
    // K8: the first state row of this warpgroup's head (the pair's first
    // head again where the pair has one: computed, not stored)
    const size_t srow = static_cast<size_t>(it.b * a.H + h0 + min(w, heads - 1)) * a.Sq;
    if constexpr (CHUNK) {
      if (n_kt == 0) {  // every row precedes the chunk: the state goes through
        if (w < heads) copy_state<D>(a.cs, it.b * a.H + h0 + w, a.Sq, q0, q0 + BQ, t, 128);
        continue;
      }
      // the carried state, loaded before the waits so that its latency
      // hides behind them and behind the first S (rows past Sq: a fresh one)
      const bool in0 = row0 < a.Sq, in1 = row1 < a.Sq;
      m0 = in0 ? a.cs.m_in[srow + row0] : kNegInf;
      l0 = in0 ? a.cs.l_in[srow + row0] : 0.f;
      m1 = in1 ? a.cs.m_in[srow + row1] : kNegInf;
      l1 = in1 ? a.cs.l_in[srow + row1] : 0.f;
      const float* acc0 = a.cs.acc_in + (srow + row0) * D + c0;
      const float* acc1 = a.cs.acc_in + (srow + row1) * D + c0;
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j) {
        const float2 v0 = in0 ? *reinterpret_cast<const float2*>(acc0 + 8 * j) : float2{0.f, 0.f};
        const float2 v1 = in1 ? *reinterpret_cast<const float2*>(acc1 + 8 * j) : float2{0.f, 0.f};
        o[4 * j] = v0.x;
        o[4 * j + 1] = v0.y;
        o[4 * j + 2] = v1.x;
        o[4 * j + 3] = v1.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
      m0 = m1 = kNegInf;
      l0 = l1 = 0.f;
    }
    wait_full(&bars.qready[slot], (nu >> 1) & 1);  // landed and scaled

    const uint32_t qa = smem_u32(sq + (2 * slot + w) * Q_BYTES);

    // S = Q K^T of the tile in ring stage st: 8 k-steps over D, both
    // operands K-major in shared memory
    auto issue_s = [&](int st) {
      const uint32_t kb = smem_u32(sk + st * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_64(s, wg::desc_a(qa + (kk / 4) * (Q_BYTES / 2) + (kk % 4) * 32),
                    wg::desc_a(kb + (kk / 4) * (KV_BYTES / 2) + (kk % 4) * 32), kk != 0);
      wg::wgmma_commit();
    };
    // O += P V of the tile in ring stage st, P from registers, V MN-major
    // (the transpose bit)
    auto issue_pv = [&](int st) {
      const uint32_t vb = smem_u32(sv + st * KV_BYTES);
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks)
        wgmma_rs_128(o, p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3],
                     wg::desc_mn(vb + ks * 16 * 128, BKV), 1);
      wg::wgmma_commit();
    };
    // S of the unit's tile j: soft cap and mask, folded into the running max
    // and sum; s becomes p (f32), (r0_, r1_) the rescale of O for the new max
    auto softmax = [&](int j) {
      if (a.soft_cap > 0.f) {  // uniform branches around the whole tile
#pragma unroll
        for (int i = 0; i < kS; ++i) s[i] = tanhf(s[i] / a.soft_cap) * a.soft_cap;
      }
      const int k0 = j * BKV;
      if (k0 + BKV > a.Skv || (a.causal && k0 + BKV - 1 > q0 + delta)) {
#pragma unroll
        for (int i = 0; i < kS; ++i) {
          const int col = k0 + 8 * (i / 4) + c0 + (i & 1);
          const int row = (i & 2) ? row1 : row0;
          if (col >= a.Skv || (a.causal && col > row + delta)) s[i] = kNegInf;
        }
      }
      // the four threads of a quad share a row
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < kS; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
      // a row with no visible key yet (max -1e30) subtracts +inf: p = 0
      const float inf = __int_as_float(0x7f800000);
      const float ms0 = mx0 > 0.5f * kNegInf ? mx0 * kLog2e : inf;
      const float ms1 = mx1 > 0.5f * kNegInf ? mx1 * kLog2e : inf;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < kS; i += 4) {
        s[i] = ex2(fmaf(s[i], kLog2e, -ms0));
        s[i + 1] = ex2(fmaf(s[i + 1], kLog2e, -ms0));
        s[i + 2] = ex2(fmaf(s[i + 2], kLog2e, -ms1));
        s[i + 3] = ex2(fmaf(s[i + 3], kLog2e, -ms1));
        rs0 += s[i] + s[i + 1];
        rs1 += s[i + 2] + s[i + 3];
      }
      rs0 += __shfl_xor_sync(kFullMask, rs0, 1);
      rs0 += __shfl_xor_sync(kFullMask, rs0, 2);
      rs1 += __shfl_xor_sync(kFullMask, rs1, 1);
      rs1 += __shfl_xor_sync(kFullMask, rs1, 2);
      r0_ = ex2((m0 - mx0) * kLog2e);
      r1_ = ex2((m1 - mx1) * kLog2e);
      l0 = l0 * r0_ + rs0;
      l1 = l1 * r1_ + rs1;
      m0 = mx0;
      m1 = mx1;
    };
    // p rounded to bf16: a 16-column slice of the accumulator is the A
    // fragment of one k-step of P V (column blocks 2 ks and 2 ks + 1)
    auto pack = [&]() {
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks) {
        p[4 * ks] = wg::pack_bf16(s[8 * ks], s[8 * ks + 1]);
        p[4 * ks + 1] = wg::pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
        p[4 * ks + 2] = wg::pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
        p[4 * ks + 3] = wg::pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
      }
    };

    // tile 0 alone (K1: O is still zero: no rescale, no P V behind it; K8:
    // the carried O is rescaled to tile 0's running max)
    wait_full(&bars.kfull[kv % STAGES], (kv / STAGES) & 1);
    fence_acc(s);
    wg::wgmma_fence();
    issue_s(kv % STAGES);
    wg::wgmma_wait<0>();
    fence_acc(s);
    if (signal) wg::mbar_arrive(&bars.kempty[kv % STAGES]);
    softmax(0);
    if constexpr (CHUNK) {
#pragma unroll
      for (int i = 0; i < kAcc; i += 4) {
        o[i] *= r0_;
        o[i + 1] *= r0_;
        o[i + 2] *= r1_;
        o[i + 3] *= r1_;
      }
    }
    pack();
    // tile j: S_j is issued, then P_{j-1} V_{j-1}, which runs behind S_j's
    // softmax; both tiles have landed before the first wgmma is issued
    for (int j = 1; j < n_kt; ++j) {
      const int i = kv + j, st = i % STAGES, pst = (i - 1) % STAGES;
      wait_full(&bars.kfull[st], (i / STAGES) & 1);
      wait_full(&bars.vfull[pst], ((i - 1) / STAGES) & 1);
      fence_acc(s);
      fence_acc(o);
      fence_acc(p);
      wg::wgmma_fence();
      issue_s(st);
      issue_pv(pst);
      wg::wgmma_wait<1>();
      fence_acc(s);
      if (signal) wg::mbar_arrive(&bars.kempty[st]);
      softmax(j);
      // the softmax's results are computed here, before the wait below (the
      // compiler would otherwise move it past the wait, off the P V's shadow)
      fence_acc(s);
      fence_acc(r0_);
      fence_acc(r1_);
      fence_acc(l0);
      fence_acc(l1);
      wg::wgmma_wait<0>();
      fence_acc(o);
      if (signal) wg::mbar_arrive(&bars.vempty[pst]);
#pragma unroll
      for (int i = 0; i < kAcc; i += 4) {
        o[i] *= r0_;
        o[i + 1] *= r0_;
        o[i + 2] *= r1_;
        o[i + 3] *= r1_;
      }
      pack();
    }
    const int last = kv + n_kt - 1;
    wait_full(&bars.vfull[last % STAGES], (last / STAGES) & 1);
    fence_acc(o);
    fence_acc(p);
    wg::wgmma_fence();
    issue_pv(last % STAGES);
    wg::wgmma_wait<0>();
    fence_acc(o);
    if (signal) {
      wg::mbar_arrive(&bars.vempty[last % STAGES]);
      wg::mbar_arrive(&bars.qempty[slot]);  // this unit's q tiles are read
    }

    if constexpr (CHUNK) {  // the unnormalized state; one thread of a quad writes m, l
      if (w < heads) {
        float* out0 = a.cs.acc_out + (srow + row0) * D + c0;
        float* out1 = a.cs.acc_out + (srow + row1) * D + c0;
#pragma unroll
        for (int j = 0; j < kAcc / 4; ++j) {
          if (row0 < a.Sq)
            *reinterpret_cast<float2*>(out0 + 8 * j) = make_float2(o[4 * j], o[4 * j + 1]);
          if (row1 < a.Sq)
            *reinterpret_cast<float2*>(out1 + 8 * j) = make_float2(o[4 * j + 2], o[4 * j + 3]);
        }
        if ((t & 3) == 0 && row0 < a.Sq) {
          a.cs.m_out[srow + row0] = m0;
          a.cs.l_out[srow + row0] = l0;
        }
        if ((t & 3) == 0 && row1 < a.Sq) {
          a.cs.m_out[srow + row1] = m1;
          a.cs.l_out[srow + row1] = l1;
        }
      }
      kv += n_kt;
      ++nu;
      continue;
    }
    // o / l (one reciprocal a row), rounded once, out in 16-byte row
    // pieces; a row with no visible key (l = 0) is zeros
    const float inv0 = l0 > 0.f ? __frcp_rn(l0) : 0.f, inv1 = l1 > 0.f ? __frcp_rn(l1) : 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] *= (i & 2) ? inv1 : inv0;
    bf16* out = a.o + static_cast<size_t>(it.b * a.H + h0 + w) * a.Sq * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row1 : row0;
#pragma unroll
      for (int k = 0; k < kAcc / 16; ++k) {
        const uint4 v = wg::row_piece(o, h, k);
        if (w < heads && row < a.Sq)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * D + wg::piece_col(k)) = v;
      }
    }
    kv += n_kt;
    ++nu;
  }
}

template <bool CHUNK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                   int Sq, int Skv, int causal, float sm_scale, float soft_cap,
                   const ChunkState& cs, cudaStream_t stream) {
  const uintptr_t outs = CHUNK ? (reinterpret_cast<uintptr_t>(cs.acc_in) |
                                  reinterpret_cast<uintptr_t>(cs.acc_out))
                               : reinterpret_cast<uintptr_t>(o);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | outs) % 16)
    return cudaErrorInvalidValue;
  const size_t rows = static_cast<size_t>(B) * H * Sq;
  if (Skv < 1) {  // no key: K1's rows are zeros, K8's state goes through
    if (!CHUNK) return cudaMemsetAsync(o, 0, rows * D * 2, stream);
    cudaError_t e = cudaMemcpyAsync(cs.m_out, cs.m_in, rows * 4, cudaMemcpyDeviceToDevice, stream);
    if (e == cudaSuccess)
      e = cudaMemcpyAsync(cs.l_out, cs.l_in, rows * 4, cudaMemcpyDeviceToDevice, stream);
    if (e == cudaSuccess)
      e = cudaMemcpyAsync(cs.acc_out, cs.acc_in, rows * D * 4, cudaMemcpyDeviceToDevice, stream);
    return e;
  }
  Args a{};
  const uint64_t row = 2ull * D;
  cudaError_t e = wg::make_map(&a.mq, q, D, Sq, static_cast<uint64_t>(B) * H, row, row * Sq, BQ);
  if (e == cudaSuccess)
    e = wg::make_map(&a.mk, k, D, Skv, static_cast<uint64_t>(B) * Hkv, row, row * Skv, BKV);
  if (e == cudaSuccess)
    e = wg::make_map(&a.mv, v, D, Skv, static_cast<uint64_t>(B) * Hkv, row, row * Skv, BKV);
  if (e != cudaSuccess) return e;
  a.o = static_cast<bf16*>(o);
  a.B = B, a.H = H, a.Hkv = Hkv, a.Sq = Sq, a.Skv = Skv, a.causal = causal;
  a.sm_scale = sm_scale, a.soft_cap = soft_cap;
  a.cs = cs;
  const long long U = static_cast<long long>(B) * Hkv * ((H / Hkv + 1) / 2) *
                      ((Sq + BQ - 1) / BQ);
  if (U < 1) return cudaSuccess;
  if (U >= (1LL << 31)) return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma<CHUNK>;
  long long fit = 0;  // one block an SM
  if ((e = dl::resident_lanes(kernel, 1, THREADS, SMEM_BYTES, &fit)) != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(max(1LL, min(fit, U)));
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fa

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
  if (dtype == 1 && D == 128)  // K1's served form and K8's fold: the wgmma body
    return fa::launch<CHUNK>(q, k, v, o, B, H, Hkv, Sq, Skv, causal, sm_scale, soft_cap, cs, st);
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
