// K2 and K3's served form on Hopper (sm_90a): single-token decode attention
// of bf16 queries at D = 128 over a contiguous cache, over bf16 pages or over
// int8 pages, in one clustered launch a call.
//
// Replaces triton_distributed_tpu/ops/attention.py::_decode_fused_kernel
// (K2, pallas_call at :1010) and ::_paged_decode_kernel (K3, :1187) in those
// forms; f32 and D = 64 keep decode_attention.cu's split + combine pass.
//
// Bound on the H100: the K and V bytes.  A cached element costs 4 G flops,
// far below the 295 flops a byte where the tensor cores would bind; at the
// Qwen3-8B decode shape (B 4, 8 kv heads, 1056 positions) the rows are 17.3
// MB, 5.2 us.  The split + combine pass took ~25 us there, lost to latency:
// three launches, splits planned from the capacity, one trip to memory at a
// time, dot products and their shuffles on the CUDA cores.  So:
//   * a (batch, kv head) is one cluster of kCluster blocks.  Each block
//     reads lens[b] and takes an even share of [0, len) in pieces of 16 rows
//     (the mma's k-depth; ops/attention.py::decode_pieces mirrors the rule),
//     so the splits follow the length on the device and the grid depends on
//     B and Hkv alone: a captured graph replays at any length.  A page holds
//     a multiple of 16 rows, so a piece never straddles one;
//   * the producer warp reads the share's block-table entries in one trip (a
//     lane a piece); one thread then copies each piece's K and V rows with
//     TMA (4 KB each in bf16, 2 KB in int8) into a ring of kStages stages,
//     with the 128-byte swizzle, so that the fragment loads below meet no
//     bank conflict.  On int8 pages each consumer warp looks up its own
//     pieces' scales (a lane a piece) while the first copies are in flight.
//     Three blocks fit an SM (at most 128 registers a thread, ~74 KB of
//     shared memory at G = 4), so the 8B shape's 256 blocks run in one wave
//     (at two an SM a second wave cost ~7 us);
//   * four consumer warps take the pieces in turn, each for all G query
//     heads of the group on the tensor cores, the products transposed so
//     that M is never padding: mma.sync m16n8k16 with a piece's 16
//     positions as M and the heads as N (8, padded from G), S^T = K q^T
//     from ldmatrix fragments of K, the online softmax in registers, P
//     (rounded to bf16, as the JAX kernel rounds p to the V type) moved from
//     S's accumulators into the B operand of O^T = V^T P^T by an
//     in-register transpose (movmatrix), V^T through ldmatrix.trans: 16 mma
//     a piece.  int8 codes are exact in fp16 and are widened in registers
//     with a byte permute and a subtraction (no conversion instruction), so
//     the int8 form multiplies in fp16: q and P, rounded to bf16 first, are
//     exact there too.  The page's K scale multiplies S after the product
//     and its V scale the piece's P V (the JAX kernel scales p before the
//     product: the rounding differs, within bf16's);
//   * each warp, as soon as its pieces are done, stores its (m, l, acc)
//     state through distributed shared memory into the blocks of its
//     cluster, each block receiving the slice of the G x D outputs that it
//     finalizes; one cluster barrier (release, acquire) later every block
//     merges the kCluster x kWarps states of its slice in (rank, warp)
//     order, a fixed order, so a replayed graph gives the eager bits, and
//     stores it.  The other cluster barrier, arrived at after the barriers'
//     initialization and waited for just before the first store, makes sure
//     every block of the cluster has started; no block waits for another to
//     finish reading it.
// No second kernel, no state in device memory, no length copy.  A length-0
// row gives exact zeros.  Rows at or past the length are never used: S is
// masked and V's fragments zeroed past it in the last, partial piece.
// Consumers wait with plain spins; the producer thread's waits are bounded
// (wgmma_tile.cuh's mbar_wait traps), and it waits last for every stage to
// be released, the watchdog of the consumers' waits.
#include <atomic>
#include <cstdint>

#include "wgmma_tile.cuh"

namespace tdt {
namespace dc {

constexpr int D = 128, PIECE = 16;
constexpr int kWarps = 4;                    // consumer warps
constexpr int kThreads = (kWarps + 1) * 32;  // and the producer warp
constexpr int kStages = 8;  // a multiple of kWarps: piece k's stage is warp k % kWarps's
constexpr int kCluster = 8;
constexpr int kSources = kCluster * kWarps;  // the states a block merges
static_assert(kSources == 32, "the merge's weights take a warp, a lane a source");
constexpr int kBox = 2048;                   // bytes of one TMA box: 16 rows of 128 bytes

template <bool INT8>
struct Form {
  static constexpr int kTileBytes = PIECE * D * (INT8 ? 1 : 2);  // a piece of K (or V)
  static constexpr int kStageBytes = 2 * kTileBytes;
};

// The launch.  mk, mv: (D, rows, slabs) maps, innermost first, boxes of 16
// rows of 128 bytes with the 128-byte swizzle; a slab is a (batch, kv head)
// of the contiguous cache or a (page, kv head) of a pool.  lens[b *
// lens_stride] is sequence b's length (stride 0: one for every sequence),
// len_const when lens is null.  table (B, max_pages) is null for the
// contiguous cache; k_scale, v_scale (P * Hkv) are null unless S is int8.
struct Args {
  CUtensorMap mk, mv;
  const bf16* q;
  bf16* out;
  const int *lens, *table;
  const float *k_scale, *v_scale;
  int lens_stride, len_const, Hkv, capacity, page_size, max_pages;
  float sm_scale, soft_cap;
};

// Shared memory after the ring: the slice of every source warp's state that
// this block finalizes (pushed there by the sources; a slice lies in one
// head, as kPer divides D), the sources' weights in the merge and the
// stages' barriers.
template <int G>
struct Smem {
  static constexpr int kPer = G * D / kCluster;  // the outputs a block finalizes
  float acc[kSources][kPer];
  float m[kSources], l[kSources], c[kSources];
  float den;
  uint64_t full[kStages], empty[kStages];
};

template <int G, bool INT8>
constexpr int smem_bytes() {
  return kStages * Form<INT8>::kStageBytes + static_cast<int>(sizeof(Smem<G>)) + 1024;
}

// Byte offset of 16-byte chunk c of row r in a box of 128-byte rows that TMA
// wrote with the 128-byte swizzle: each 8-row atom XORs the chunk with the row.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The operand pair (lo, hi) rounded to bf16, in the form's mma type: bf16,
// or fp16 for the int8 form (exact: a bf16 value inside fp16's range).
template <bool INT8>
__device__ __forceinline__ uint32_t operand2(float lo, float hi) {
  const uint32_t b = pack2(lo, hi);
  if (!INT8) return b;
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  uint32_t h;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(h) : "f"(f.y), "f"(f.x));
  return h;
}

// Bytes I and J of the int8 codes x as an fp16 pair (exact), byte I low:
// y = x ^ 0x80808080 biases each code by 128, a byte permute puts it under
// 0x64 (1024 + u in fp16), and 1152 is taken off.
template <int I, int J>
__device__ __forceinline__ uint32_t codes(uint32_t y) {
  const uint32_t h = __byte_perm(y, 0x64646464u, (4u << 12) | (J << 8) | (4u << 4) | I);
  uint32_t r;
  asm("sub.f16x2 %0, %1, %2;" : "=r"(r) : "r"(h), "r"(0x64806480u));
  return r;
}

// d (16x8 f32) += a (16x16) * b (16x8), fp16 operands (the int8 form)
__device__ __forceinline__ void mma_f16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void wait_full(uint64_t* bar, int parity) {
  const uint32_t at = smem_u32(bar);
  while (!wg::mbar_try(at, parity)) {
  }
}

// The address of `p` in the shared memory of block `rank` of the cluster.
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t at;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(at) : "r"(smem_u32(p)), "r"(rank));
  return at;
}

__device__ __forceinline__ void st_remote(uint32_t at, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(at), "f"(v) : "memory");
}

__device__ __forceinline__ void st_remote2(uint32_t at, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(at), "f"(x), "f"(y) : "memory");
}

// Sequence b's length, clamped to [0, capacity].
__device__ __forceinline__ int seq_len(const Args& a, int b) {
  const int n = a.lens ? a.lens[static_cast<size_t>(b) * a.lens_stride] : a.len_const;
  return min(max(n, 0), a.capacity);
}

// The slab (a (batch or page, kv head) row block) and first row of piece
// `piece` of sequence b.
template <bool PAGED>
__device__ __forceinline__ void locate(const Args& a, int b, int hk, int piece, int& slab,
                                       int& row) {
  row = piece * PIECE;
  slab = b * a.Hkv + hk;
  if (PAGED) {
    const int lp = row / a.page_size;  // the piece's logical page
    slab = a.table[static_cast<size_t>(b) * a.max_pages + lp] * a.Hkv + hk;
    row -= lp * a.page_size;
  }
}

// The producer warp: the share's pieces into the ring, a lane's table
// lookup a piece (32 at a time), lane 0's copies in piece order.
template <int G, bool PAGED, bool INT8>
__device__ __forceinline__ void produce(const Args& a, Smem<G>& sm, unsigned char* ring, int b,
                                        int hk, int p0, int n) {
  using F = Form<INT8>;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += 32) {
    int slab = 0, row = 0;
    if (base + lane < n) locate<PAGED>(a, b, hk, p0 + base + lane, slab, row);
    for (int i = 0; i < min(32, n - base); ++i) {
      const int s_slab = __shfl_sync(kFullMask, slab, i), s_row = __shfl_sync(kFullMask, row, i);
      if (lane == 0) {
        const int k = base + i, st = k % kStages;
        wg::mbar_wait(&sm.empty[st], ((k / kStages) & 1) ^ 1);
        wg::mbar_expect_tx(&sm.full[st], F::kStageBytes);
        unsigned char* dst = ring + st * F::kStageBytes;
#pragma unroll
        for (int c = 0; c < F::kTileBytes / kBox; ++c) {
          wg::tma3(dst + c * kBox, &a.mk, &sm.full[st], c * 64, s_row, s_slab);
          wg::tma3(dst + F::kTileBytes + c * kBox, &a.mv, &sm.full[st], c * 64, s_row, s_slab);
        }
      }
      __syncwarp();
    }
  }
  // the watchdog: every stage in use is released within the bound
  if (lane == 0)
    for (int k = max(0, n - kStages); k < n; ++k)
      wg::mbar_wait(&sm.empty[k % kStages], (k / kStages) & 1);
  __syncwarp();
}

// A consumer warp: pieces warp, warp + kWarps, ... of the share, folded into
// the (m, l, acc) state of the group's G heads, then pushed to the blocks
// that finalize it.  The products run transposed, so that the 16 rows of
// the mma's M are a piece's 16 positions (S^T = K q^T) and then 16 of the D
// columns (O^T = V^T P^T), and the heads are N, 8 columns (padding from G):
// lane l holds position or column l / 4 (and + 8) of a tile, and heads 2t,
// 2t + 1 (t = l % 4).
template <int G, bool PAGED, bool INT8>
__device__ __forceinline__ void consume(const Args& a, Smem<G>& sm, unsigned char* ring, int b,
                                        int hk, int p0, int n, int len, int rank, int warp) {
  using F = Form<INT8>;
  const int lane = threadIdx.x & 31, t = lane & 3, r = lane >> 2;

  // q's B fragments (q^T: k = d, n = head r), scaled in f32 and rounded to
  // bf16 (the JAX _scaled_q); heads from G are zero.  The int8 form reads
  // K's codes four to a lane (k-slots 2t, 2t + 1, 2t + 8, 2t + 9 of a step
  // are d = 16 step + 4t + 0..3), so q's columns follow the same order.
  uint32_t qb[8][2];
  const bf16* qh = a.q + (static_cast<size_t>(b * a.Hkv + hk) * G + (r < G ? r : 0)) * D;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const int d0 = INT8 ? 16 * ks + 4 * t : 16 * ks + 2 * t, d1 = INT8 ? d0 + 2 : d0 + 8;
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qh + d0));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qh + d1));
    qb[ks][0] = r < G ? operand2<INT8>(x.x * a.sm_scale, x.y * a.sm_scale) : 0u;
    qb[ks][1] = r < G ? operand2<INT8>(y.x * a.sm_scale, y.y * a.sm_scale) : 0u;
  }

  // O^T: tile i's rows are 16 of the D columns (bf16: d = 16i + r and + 8;
  // int8: d = 16i + 2r and + 1), its columns heads 2t, 2t + 1
  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // heads 2t, 2t + 1; l over this lane's rows
  // int8: o holds the state over the V scale of the last piece with a
  // nonzero one (vs_o), so that a piece rescales o once: o (alpha vs_o /
  // vs) + P V, times vs at the end
  float vs_o = 1.f;
  // int8: lane j holds the page scales of the warp's piece j (of each 32),
  // looked up by the warp itself while the first copies are in flight
  float kscale = 1.f, vscale = 1.f;

  for (int k = warp, it = 0; k < n; k += kWarps, ++it) {
    if (INT8 && (it & 31) == 0) {
      const int kl = k + lane * kWarps;
      if (kl < n) {
        int slab, row;
        locate<PAGED>(a, b, hk, p0 + kl, slab, row);
        kscale = a.k_scale[slab];
        vscale = a.v_scale[slab];
      }
    }
    const int st = k % kStages;
    wait_full(&sm.full[st], (k / kStages) & 1);
    const unsigned char* kt = ring + st * F::kStageBytes;
    const unsigned char* vt = kt + F::kTileBytes;
    const int nv = min(PIECE, len - (p0 + k) * PIECE);  // rows of the piece inside the length
    const int mat = lane >> 3, r8 = lane & 7;           // ldmatrix: this lane's matrix and row

    // S^T = K q^T: s[0], s[1] position r, heads 2t, 2t + 1; s[2], s[3] position r + 8
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (!INT8) {
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        // K as A: matrices rows 0-7 and 8-15 at d chunk 2ks, then at 2ks + 1
        const int row = (mat & 1) * 8 + r8, g = 2 * ks + (mat >> 1);
        uint32_t f[4];
        ldmatrix_x4(f, kt + ((g >> 3) * kBox) + swz(row, g & 7));
        mma_bf16(s, f, qb[ks]);
      }
    } else {
#pragma unroll
      for (int kp = 0; kp < 4; ++kp) {
        // matrices: rows 0-7 and 8-15 at chunk 2kp, then at chunk 2kp + 1
        const int row = (mat & 1) * 8 + r8, c = 2 * kp + (mat >> 1);
        uint32_t f[4];
        ldmatrix_x4(f, kt + swz(row, c));
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const uint32_t y0 = f[2 * u] ^ 0x80808080u, y1 = f[2 * u + 1] ^ 0x80808080u;
          const uint32_t ak[4] = {codes<0, 1>(y0), codes<0, 1>(y1), codes<2, 3>(y0),
                                  codes<2, 3>(y1)};
          mma_f16(s, ak, qb[2 * kp + u]);
        }
      }
      const float ksc = __shfl_sync(kFullMask, kscale, it & 31);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] *= ksc;
    }
    if (a.soft_cap > 0.f) {  // uniform: whole pieces on one side
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] = tanhf(s[e] / a.soft_cap) * a.soft_cap;
    }
    if (nv < PIECE) {  // uniform: the last, partial piece
      s[0] = r < nv ? s[0] : kNegInf;
      s[1] = r < nv ? s[1] : kNegInf;
      s[2] = r + 8 < nv ? s[2] : kNegInf;
      s[3] = r + 8 < nv ? s[3] : kNegInf;
    }

    // the online softmax of each head's row: over the two positions of this
    // lane and the 8 lanes of its column
    float alpha[2], p[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = fmaxf(s[e], s[e + 2]);
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 16));
      const float mn = fmaxf(m[e], mx);
      alpha[e] = __expf(m[e] - mn);
      p[e] = __expf(s[e] - mn);
      p[e + 2] = __expf(s[e + 2] - mn);
      l[e] = l[e] * alpha[e] + (p[e] + p[e + 2]);
      m[e] = mn;
    }
    // P^T as the B operand of O^T: S's accumulators rounded to bf16, each
    // 8 x 8 block (positions x heads) transposed in registers
    uint32_t pb[2];
    {
      const uint32_t lo = operand2<INT8>(p[0], p[1]), hi = operand2<INT8>(p[2], p[3]);
      asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(pb[0]) : "r"(lo));
      asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(pb[1]) : "r"(hi));
    }
    // V's rows past the length out of the last, partial piece's fragments
    // (positions 2t, 2t + 1 in the low and high half of a positions 0-7
    // fragment; 8 + those in 8-15's)
    uint32_t mk0 = 0xffffffffu, mk1 = 0xffffffffu;
    if (nv < PIECE) {  // uniform
      mk0 = (2 * t < nv ? 0xffffu : 0u) | (2 * t + 1 < nv ? 0xffff0000u : 0u);
      mk1 = (8 + 2 * t < nv ? 0xffffu : 0u) | (9 + 2 * t < nv ? 0xffff0000u : 0u);
    }
    // int8: a zero V scale adds nothing (and leaves vs_o as it is)
    bool pv = true;
    if (INT8) {
      const float vsc = __shfl_sync(kFullMask, vscale, it & 31);
      pv = vsc != 0.f;
      if (pv) {
        alpha[0] = alpha[0] * vs_o / vsc;
        alpha[1] = alpha[1] * vs_o / vsc;
        vs_o = vsc;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[1];
      o[i][2] *= alpha[0];
      o[i][3] *= alpha[1];
    }
    if (pv) {
      if (!INT8) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // V^T as A: matrices positions 0-7 at d chunk 2i, 2i + 1, then
          // positions 8-15 at the same
          const int row = (mat >> 1) * 8 + r8, g = 2 * i + (mat & 1);
          uint32_t f[4];
          ldmatrix_x4_trans(f, vt + ((g >> 3) * kBox) + swz(row, g & 7));
          f[0] &= mk0;
          f[1] &= mk0;
          f[2] &= mk1;
          f[3] &= mk1;
          mma_bf16(o[i], f, pb);
        }
      } else {
        // a matrix of 8 positions x 16 codes gives a tile of rows d = 16c
        // + 2r (bytes 0 and 2 of a lane's word) and + 1 (bytes 1 and 3)
#pragma unroll
        for (int cp = 0; cp < 4; ++cp) {
          const int row = (mat & 1) * 8 + r8, c = 2 * cp + (mat >> 1);
          uint32_t f[4];
          ldmatrix_x4_trans(f, vt + swz(row, c));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const uint32_t y0 = (f[2 * u] & mk0) ^ 0x80808080u;
            const uint32_t y1 = (f[2 * u + 1] & mk1) ^ 0x80808080u;
            const uint32_t av[4] = {codes<0, 2>(y0), codes<1, 3>(y0), codes<0, 2>(y1),
                                    codes<1, 3>(y1)};
            mma_f16(o[2 * cp + u], av, pb);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(kFullMask, l[e], 4);
    l[e] += __shfl_xor_sync(kFullMask, l[e], 8);
    l[e] += __shfl_xor_sync(kFullMask, l[e], 16);
  }
  if (INT8)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] *= vs_o;

  // push the state: element (h, d) goes to block (h D + d) / kPer, as source
  // rank * kWarps + warp; m and l to every block whose slice lies in head h
  constexpr int kPer = Smem<G>::kPer;
  const int src = rank * kWarps + warp;
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // every block has started
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int h = 2 * t + e;
    if (h >= G) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (INT8) {  // d = 16i + 2r and + 1: one pair
        const int x = h * D + 16 * i + 2 * r;
        st_remote2(remote(&sm.acc[src][x % kPer], x / kPer), o[i][e], o[i][e + 2]);
      } else {  // d = 16i + r and + 8
        const int x = h * D + 16 * i + r;
        st_remote(remote(&sm.acc[src][x % kPer], x / kPer), o[i][e]);
        st_remote(remote(&sm.acc[src][(x + 8) % kPer], (x + 8) / kPer), o[i][e + 2]);
      }
    }
    if (r == 0)
      for (int q = h * D / kPer; q <= (h * D + D - 1) / kPer; ++q) {
        st_remote(remote(&sm.m[src], q), m[e]);
        st_remote(remote(&sm.l[src], q), l[e]);
      }
  }
}

template <int G, bool PAGED, bool INT8>
__global__ void __launch_bounds__(kThreads, 3) decode_cluster(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  unsigned char* ring = wg::stages(dyn);
  Smem<G>& sm = *reinterpret_cast<Smem<G>*>(ring + kStages * Form<INT8>::kStageBytes);
  const int rank = blockIdx.x;  // the cluster spans x: rank == %cluster_ctarank
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int len = seq_len(a, b);
  const int pieces = (len + PIECE - 1) / PIECE;
  const int p0 = rank * pieces / kCluster, n = (rank + 1) * pieces / kCluster - p0;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == kWarps * 32) {  // the maps' descriptors, on their way before the first copy
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&a.mk)) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&a.mv)) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&sm.full[s], 1);
      wg::mbar_init(&sm.empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (warp == kWarps) {
    produce<G, PAGED, INT8>(a, sm, ring, b, hk, p0, n);
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  } else {
    consume<G, PAGED, INT8>(a, sm, ring, b, hk, p0, n, len, rank, warp);
  }
  // every source's pushed state has landed and is visible
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");

  // this block's slice of the outputs, from the sources' states in (rank,
  // warp) order: warp 0 weighs the sources, then each thread merges one
  // output with the weights
  constexpr int kPer = Smem<G>::kPer;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    const float ms = sm.m[lane];  // kSources == 32: a lane a source
    float mn = ms;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mn = fmaxf(mn, __shfl_xor_sync(kFullMask, mn, o));
    const float c = __expf(ms - mn);
    float den = sm.l[lane] * c;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(kFullMask, den, o);
    sm.c[lane] = c;
    if (lane == 0) sm.den = den;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i < kPer) {
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < kSources; ++s) num += sm.acc[s][i] * sm.c[s];
    const float den = sm.den;
    a.out[(static_cast<size_t>(b * a.Hkv + hk) * G) * D + rank * kPer + i] =
        __float2bfloat16_rn(den > 0.f ? num / den : 0.f);
  }
}

// ---------------------------------------------------------------------------
// host side

// A (D, rows, slabs) map of `base`, innermost first: boxes of 16 rows of 128
// bytes (64 bf16 or 128 int8 values), the 128-byte swizzle, zeros past the
// rows (a contiguous cache's capacity need not be a multiple of 16).
inline cudaError_t make_map(CUtensorMap* m, const void* base, bool int8, uint64_t rows,
                            uint64_t slabs) {
  const uint64_t row_bytes = int8 ? D : 2 * D;
  return wg::make_map(m, base, D, rows, slabs, row_bytes, row_bytes * rows, PIECE,
                      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      int8 ? 128u : 64u);
}

template <int G, bool PAGED, bool INT8>
cudaError_t launch(const Args& a, int pairs, cudaStream_t stream) {
  auto kernel = decode_cluster<G, PAGED, INT8>;
  constexpr int smem = smem_bytes<G, INT8>();
  // the shared-memory limit is set once an instantiation and device, not on
  // every call (a decode step makes one call a layer)
  static std::atomic<uint64_t> set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!(set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    set.fetch_or(bit, std::memory_order_relaxed);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, pairs, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool PAGED, bool INT8>
cudaError_t dispatch_g(int G, const Args& a, int pairs, cudaStream_t st) {
  switch (G) {
    case 1: return launch<1, PAGED, INT8>(a, pairs, st);
    case 2: return launch<2, PAGED, INT8>(a, pairs, st);
    case 4: return launch<4, PAGED, INT8>(a, pairs, st);
    case 8: return launch<8, PAGED, INT8>(a, pairs, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dc
}  // namespace tdt

// q (B, H, 128) bf16 and out (B, H, 128) bf16.  Contiguous cache (table
// null): k/v (B, Hkv, capacity, 128) bf16.  Paged: k/v (pool_pages, Hkv,
// page_size, 128) pools of bf16, or of int8 codes with k_scale/v_scale
// (pool_pages * Hkv) f32, table (B, max_pages) int32, capacity = max_pages *
// page_size, page_size a multiple of 16.  Sequence b's length is lens[b *
// lens_stride] (lens_stride 0: one length for all), or len_const when lens
// is null.  Returns the cudaError_t of the map encoding or the launch.
extern "C" int tdt_decode_cluster(const void* q, const void* k, const void* v, const int* lens,
                                  int lens_stride, int len_const, const int* table,
                                  const float* k_scale, const float* v_scale, void* out, int B,
                                  int H, int Hkv, int capacity, int page_size, int max_pages,
                                  int pool_pages, float sm_scale, float soft_cap, void* stream) {
  using namespace tdt;
  using namespace tdt::dc;
  const bool paged = table != nullptr, int8 = k_scale != nullptr;
  if (Hkv <= 0 || H % Hkv || (int8 && (!paged || !v_scale)) ||
      (paged && (page_size <= 0 || page_size % PIECE)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  const uint64_t rows = paged ? page_size : capacity;
  const uint64_t slabs = static_cast<uint64_t>(paged ? pool_pages : B) * Hkv;
  cudaError_t err = make_map(&a.mk, k, int8, rows, slabs);
  if (err == cudaSuccess) err = make_map(&a.mv, v, int8, rows, slabs);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.q = static_cast<const bf16*>(q);
  a.out = static_cast<bf16*>(out);
  a.lens = lens;
  a.table = table;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.lens_stride = lens_stride;
  a.len_const = len_const;
  a.Hkv = Hkv;
  a.capacity = capacity;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.sm_scale = sm_scale;
  a.soft_cap = soft_cap;
  const int G = H / Hkv, pairs = B * Hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8) return static_cast<int>(dispatch_g<true, true>(G, a, pairs, st));
  if (paged) return static_cast<int>(dispatch_g<true, false>(G, a, pairs, st));
  return static_cast<int>(dispatch_g<false, false>(G, a, pairs, st));
}
