// K4's device stages, shared by the attention megakernel (fused_decode.cu)
// and the persistent decode kernel K16 (persistent_decode.cu), which runs
// them one layer at a time between rank-wide barriers: project_tile (a
// slice of K rows of one head's wqkv columns, every sequence, f32
// partials), finalize_tile (the slices summed, qk-RMSNorm, RoPE, the token's
// in-place append), and combine_fold (the prefix splits merged, the token
// folded in, normalized).  The attention splits themselves are
// decode_split.cuh's split_state.  Data another block of the launch wrote is
// read through L2 (ld.global.cg): K16 rewrites x, q_buf and the partials
// every layer.
#pragma once

#include "decode_split.cuh"

namespace tdt {

constexpr int kProjBatch = 4;   // sequences per pass over a weight tile
constexpr int kProjUnroll = 8;  // weight rows in flight per lane group

struct FusedArgs {
  const void* x;             // (B, K) T
  const void* wqkv;          // (K, N) T, N = (Hq + 2 Hkv) D, columns [q | k | v]
  const void* q_norm;        // (D,) T, null without qk-norm
  const void* k_norm;
  void* pool_k;              // (P, Hkv, ps, D) S
  void* pool_v;
  const float* k_scale;      // (P * Hkv) f32 for int8 pools, else null
  const float* v_scale;
  const int* table;          // (B, max_pages)
  const int* lens;           // (B,) position of the new token
  const float* inv_freq;     // (D / 2) RoPE inverse frequencies
  void* out;                 // (B, Hq, D) T
  void* q_buf;               // (B, Hq, D) T: the normed, rotated queries
  void* k_tok;               // (B, Hkv, D) T: the new token's k and v
  void* v_tok;
  float* part_proj;          // (n_kslice, B, N) f32 projection partials
  float* part_acc;           // (B * Hkv * n_split, G, D) f32 split states
  float* part_ml;            // (B * Hkv * n_split, G, 2)
  int* sync;                 // [work, exit, tile tickets (Hkv (G + 2)), head
                             //  tickets (Hkv), ready (Hkv), split tickets
                             //  (B Hkv)], zero at rest
  int B, K, Hkv, page_size, max_pages, n_kslice, k_chunk, n_split, chunk;
  float sm_scale, soft_cap, eps;
  // rank-folded launches (tp = n co-located ranks): n ranks, rank r's wqkv
  // at wqkv + r * w_rank_stride elements (rank-stacked (n, K, N)); x is one
  // replicated (B, K) copy; the table, lens, pools and outputs fold the
  // rank into the batch (rank r's sequences at [r B, (r + 1) B))
  int n_ranks;
  long long w_rank_stride;
};

// Rank r's view of a rank-folded launch: the tp = 1 arguments of its B
// sequences and its weight block.  At r = 0 every pointer is unchanged.
template <typename T, int D, int G>
__device__ __forceinline__ FusedArgs at_rank(const FusedArgs& a, int r) {
  FusedArgs o = a;
  const size_t N = static_cast<size_t>(a.Hkv) * (G + 2) * D;
  const size_t rows = static_cast<size_t>(r) * a.B;
  o.wqkv = static_cast<const T*>(a.wqkv) + r * a.w_rank_stride;
  o.table = a.table + rows * a.max_pages;
  o.lens = a.lens + rows;
  o.out = static_cast<T*>(a.out) + rows * a.Hkv * G * D;
  o.q_buf = static_cast<T*>(a.q_buf) + rows * a.Hkv * G * D;
  o.k_tok = static_cast<T*>(a.k_tok) + rows * a.Hkv * D;
  o.v_tok = static_cast<T*>(a.v_tok) + rows * a.Hkv * D;
  o.part_proj = a.part_proj + static_cast<size_t>(r) * a.n_kslice * a.B * N;
  o.part_acc = a.part_acc + rows * a.Hkv * a.n_split * G * D;
  o.part_ml = a.part_ml + rows * a.Hkv * a.n_split * G * 2;
  return o;
}

__device__ __forceinline__ float ldcg_f32(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f32(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// Every thread's writes become visible, then thread 0 counts this block in;
// true (in every thread) for the block that brings the count to `total`.
__device__ __forceinline__ bool arrive_last(int* counter, int total) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == total - 1;
  __syncthreads();
  const bool last = s_last;
  if (last) __threadfence();
  __syncthreads();  // s_last may be reused
  return last;
}

__device__ __forceinline__ void raise_flag(int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(flag, 1);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Waits for a flag another block raises, polling with plain acquire loads
// (no read-modify-write traffic on the flag's L2 line).  The wait is
// bounded: a flag still down after about 2^26 polls (seconds, where a step
// takes microseconds) means corrupt counters, and the kernel traps, which
// fails the launch, rather than spin on.
__device__ __forceinline__ void wait_flag(const int* flag) {
  if (threadIdx.x == 0) {
    unsigned polls = 0;
    while (load_acquire(flag) == 0) {
      __nanosleep(64);
      if (++polls == (1u << 26)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// First wqkv column of tile `tile` of kv head h: tiles 0..G-1 are its query
// heads, G its k head, G + 1 its v head.
template <int D, int G>
__device__ __forceinline__ int column0(int tile, int h, int Hkv) {
  const int Hq = Hkv * G;
  if (tile < G) return (h * G + tile) * D;
  return (Hq + (tile == G ? 0 : Hkv) + h) * D;
}

// Phase 1: partial sums of x[b] . wqkv[k0:k1, col0:col0 + D] for every b.
// L2_X: read x through L2 (K16, whose x is rewritten by other blocks every
// layer); K4's x was written before the launch and is read through L1.
template <typename T, int D, bool L2_X = false>
__device__ void project_tile(const FusedArgs& a, int N, int col0, int ks) {
  constexpr int E = 16 / sizeof(T);  // weight columns per 16-byte load
  constexpr int LPW = D / E;         // lanes per weight row of the tile
  constexpr int RPW = 32 / LPW;      // weight rows per warp
  constexpr int RPB = kWarps * RPW;  // weight rows per block and step
  constexpr int U = kProjUnroll;
  constexpr int PB = kProjBatch;
  static_assert(LPW <= 32 && 32 % LPW == 0, "unsupported head dim");
  __shared__ float s_red[kWarps][PB][D];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w = static_cast<const T*>(a.wqkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPW, row = warp * RPW + lane / LPW;
  const int k0 = ks * a.k_chunk, k1 = min(a.K, k0 + a.k_chunk);
  for (int b0 = 0; b0 < a.B; b0 += PB) {
    float acc[PB][E];
#pragma unroll
    for (int bb = 0; bb < PB; ++bb)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[bb][e] = 0.f;
    for (int kk = k0 + row; kk < k1; kk += RPB * U) {
      uint4 wr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + u * RPB;
        wr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (k < k1)
          wr[u] = __ldg(reinterpret_cast<const uint4*>(
              w + static_cast<size_t>(k) * N + col0 + sub * E));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + u * RPB;
        if (k < k1) {
          float wf[E];
          unpack16(wr[u], wf, T());
#pragma unroll
          for (int bb = 0; bb < PB; ++bb) {
            if (b0 + bb < a.B) {
              const size_t xi = static_cast<size_t>(b0 + bb) * a.K + k;
              const float xv = L2_X ? ldcg_f32(x + xi) : to_f32(x[xi]);
#pragma unroll
              for (int e = 0; e < E; ++e) acc[bb][e] = fmaf(xv, wf[e], acc[bb][e]);
            }
          }
        }
      }
    }
    // the rows of a warp, then the warps
#pragma unroll
    for (int off = LPW; off < 32; off <<= 1)
#pragma unroll
      for (int bb = 0; bb < PB; ++bb)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[bb][e] += __shfl_xor_sync(kFullMask, acc[bb][e], off);
    if (lane < LPW) {
#pragma unroll
      for (int bb = 0; bb < PB; ++bb)
#pragma unroll
        for (int e = 0; e < E; ++e) s_red[warp][bb][sub * E + e] = acc[bb][e];
    }
    __syncthreads();
    for (int i = tid; i < PB * D; i += kThreads) {
      const int bb = i / D, c = i % D;
      if (b0 + bb < a.B) {
        float sum = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) sum += s_red[wp][bb][c];
        a.part_proj[(static_cast<size_t>(ks) * a.B + b0 + bb) * N + col0 + c] = sum;
      }
    }
    __syncthreads();
  }
}

// Column tile `tile` of kv head h (a query head, or its k or v) for every
// sequence, from the projection partials: one warp per sequence, D / 32
// elements per lane, so the norm is a warp reduction and each RoPE pair
// (d, d + D / 2) sits in one lane.
template <typename T, typename S, int D, int G>
__device__ void finalize_tile(const FusedArgs& a, int N, int h, int tile) {
  constexpr bool QUANT = sizeof(S) == 1;
  constexpr int J = D / 32;
  constexpr int HJ = J / 2;
  constexpr int KU = 4;   // slices whose loads are in flight together
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Hq = a.Hkv * G;
  const int col0 = column0<D, G>(tile, h, a.Hkv);
  const bool is_v = tile == G + 1;
  const T* nw = static_cast<const T*>(tile < G ? a.q_norm : a.k_norm);
  for (int b = warp; b < a.B; b += kWarps) {
    const float* part = a.part_proj + static_cast<size_t>(b) * N + col0 + lane;
    const size_t slice = static_cast<size_t>(a.B) * N;
    float val[J];
#pragma unroll
    for (int j = 0; j < J; ++j) val[j] = 0.f;
    for (int ks = 0; ks < a.n_kslice; ks += KU) {
      float t[KU][J];
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j)
          t[u][j] = ks + u < a.n_kslice ? __ldcg(part + (ks + u) * slice + 32 * j) : 0.f;
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int j = 0; j < J; ++j) val[j] += t[u][j];
    }
#pragma unroll
    for (int j = 0; j < J; ++j) val[j] = round_to<T>(val[j]);
    if (!is_v) {
      if (nw != nullptr) {
        float ss = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) ss = fmaf(val[j], val[j], ss);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFullMask, ss, off);
        const float inv = rsqrtf(ss / D + a.eps);
#pragma unroll
        for (int j = 0; j < J; ++j)
          val[j] = round_to<T>(val[j] * inv * to_f32(nw[lane + 32 * j]));
      }
      const float pos = static_cast<float>(__ldg(a.lens + b));
#pragma unroll
      for (int j = 0; j < HJ; ++j) {
        const float ang = pos * __ldg(a.inv_freq + lane + 32 * j);
        const float cs = cosf(ang), sn = sinf(ang);
        const float x1 = val[j], x2 = val[j + HJ];
        val[j] = round_to<T>(x1 * cs - x2 * sn);
        val[j + HJ] = round_to<T>(x2 * cs + x1 * sn);
      }
    }
    if (tile < G) {
      T* qb = static_cast<T*>(a.q_buf) + (static_cast<size_t>(b) * Hq + h * G + tile) * D;
#pragma unroll
      for (int j = 0; j < J; ++j) qb[lane + 32 * j] = from_f32<T>(val[j]);
    } else {
      T* tok = static_cast<T*>(is_v ? a.v_tok : a.k_tok) +
               (static_cast<size_t>(b) * a.Hkv + h) * D;
#pragma unroll
      for (int j = 0; j < J; ++j) tok[lane + 32 * j] = from_f32<T>(val[j]);
      if constexpr (!QUANT) {
        const int pos = __ldg(a.lens + b);
        const int pg = min(pos / a.page_size, a.max_pages - 1);
        const int page = __ldg(a.table + static_cast<size_t>(b) * a.max_pages + pg);
        S* pool = static_cast<S*>(is_v ? a.pool_v : a.pool_k) +
                  ((static_cast<size_t>(page) * a.Hkv + h) * a.page_size +
                   pos % a.page_size) * D;
#pragma unroll
        for (int j = 0; j < J; ++j) pool[lane + 32 * j] = from_f32<S>(val[j]);
      }
    }
  }
}

// Merge the splits of (sequence b, kv head h), fold in the new token, and
// write the G normalized outputs.
template <typename T, int D, int G>
__device__ void combine_fold(const FusedArgs& a, int b, int h) {
  __shared__ float s_mx[G], s_alpha[G], s_pr[G], s_den[G];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Hq = a.Hkv * G;
  const size_t first = (static_cast<size_t>(b) * a.Hkv + h) * a.n_split;
  const T* q = static_cast<const T*>(a.q_buf) + (static_cast<size_t>(b) * Hq + h * G) * D;
  const T* kt = static_cast<const T*>(a.k_tok) + (static_cast<size_t>(b) * a.Hkv + h) * D;
  const T* vt = static_cast<const T*>(a.v_tok) + (static_cast<size_t>(b) * a.Hkv + h) * D;
  for (int g = warp; g < G; g += kWarps) {
    float mn, den;
    merge_ml(a.part_ml, first, a.n_split, G, g, mn, den);
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s = fmaf(round_to<T>(ldcg_f32(q + g * D + d) * a.sm_scale), ldcg_f32(kt + d), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
    if (a.soft_cap > 0.f) s = tanhf(s / a.soft_cap) * a.soft_cap;
    const float m_cur = fmaxf(mn, s);
    const float p = expf(s - m_cur);
    const float alpha = expf(mn - m_cur);
    if (lane == 0) {
      s_mx[g] = mn;
      s_alpha[g] = alpha;
      s_pr[g] = round_to<T>(p);
      s_den[g] = den * alpha + p;
    }
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out) + (static_cast<size_t>(b) * Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float num = merge_acc(a.part_acc, a.part_ml, first, a.n_split, G, D, g, d, s_mx[g]);
    const float acc = num * s_alpha[g] + s_pr[g] * ldcg_f32(vt + d);
    out[static_cast<size_t>(g) * D + d] = from_f32<T>(s_den[g] > 0.f ? acc / s_den[g] : 0.f);
  }
}

}  // namespace tdt
