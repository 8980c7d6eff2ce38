// K4: the decode attention megakernel for Hopper (sm_90a): one launch per
// layer and decode step does the qkv projection, qk-RMSNorm, RoPE, the
// ragged append of the new token's K/V into the paged pool, and the
// block-table flash decode over the cached prefix with the new token folded
// in last.
//
// Replaces triton_distributed_tpu/ops/fused_decode.py::_fused_attn_kernel
// (:112, pallas_call :321) in both of its forms: pages in the activations'
// type, appended in place; and int8 pages with per-(page, head) f32 scales,
// which are streamed and dequantized but not appended (the caller's exact
// requantizing append takes the returned k_tok/v_tok).
//
// Bound on the H100: bytes.  At Qwen3-8B (B = 4, K = 4096, 32 q / 8 kv heads
// of 128) a step reads the 50.3 MB of wqkv and the cached K/V (17.3 MB in
// bf16 at position 1056); the products are 2 * B flops per weight, far below
// the 295 flops per byte where the tensor cores would limit.  The TPU kernel
// runs a (kv head, sequence) grid that re-reads a head's weight columns for
// every sequence; here every weight is read once per step for all B rows:
//
//   * Phase 1, projection: a work item is one head's D columns of wqkv and a
//     slice of the K rows (`n_kslice` slices), for all B sequences; it
//     writes f32 partial sums.  Items are spread over all SMs.
//   * The last item to finish a column tile's K slices (an atomic ticket)
//     finalizes that tile for every sequence, one warp per sequence: it sums
//     the slices in a fixed order (deterministic), rounds to T as the JAX
//     dot's `.astype` does, applies RMSNorm in f32 and rotate-half RoPE at
//     pos = seq_lens[b] with f32 angles, and writes q, or the token's k or v,
//     to scratch; a k or v tile also appends the token into the pool slot
//     (table[b, min(pos / ps, mp - 1)], h, pos % ps), once per (sequence,
//     head).  The last of a kv head's G + 2 tiles to be finalized raises the
//     head's ready flag.
//   * Phase 2, attention: a work item is one (kv head, sequence, split of
//     the prefix [0, pos)), run by split_state (decode_split.cuh, shared with
//     K2/K3).  The last split of a (sequence, head) to finish merges the
//     splits and folds the new token in from scratch (its score, then
//     l * alpha + p and acc * alpha + round(p) * v), and normalizes.
//
// Hand-off without deadlock: a block takes its work item from an atomic
// counter when it starts, so items are handed out in order: projection
// items first.  An attention item waits only on a head's ready flag, which
// a projection item sets, and every projection item was handed to a block
// that had already started when the attention item was taken.  So the wait
// never depends on a block that is not resident.  The slot the append writes
// lies at position pos, outside the prefix the attention reads.  The last
// block to exit clears the counters for the next launch; launches on one
// stream are ordered, and the counters belong to one stream at a time.
//
// Rounding follows the JAX kernel: q, k, v are rounded to T after the f32
// projection, after the norm and after RoPE; q is scaled in f32 and rounded
// before its products; p is rounded to T before it multiplies V.
#include "decode_split.cuh"

namespace tdt {
namespace {

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
};

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
template <typename T, int D>
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
              const float xv = to_f32(x[static_cast<size_t>(b0 + bb) * a.K + k]);
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

template <typename T, typename S, int D, int G>
__global__ void __launch_bounds__(kThreads) fused_attn_decode_kernel(const FusedArgs a) {
  __shared__ int s_item;
  int* work = a.sync;
  int* exited = a.sync + 1;
  int* tile_ticket = a.sync + 2;
  int* head_ticket = tile_ticket + a.Hkv * (G + 2);
  int* ready = head_ticket + a.Hkv;
  int* split_ticket = ready + a.Hkv;
  const int N = (a.Hkv * G + 2 * a.Hkv) * D;
  const int per_head = (G + 2) * a.n_kslice;
  const int n_proj = a.Hkv * per_head;
  if (threadIdx.x == 0) s_item = atomicAdd(work, 1);
  __syncthreads();
  const int item = s_item;
  if (item < n_proj) {
    const int h = item / per_head, tile = (item % per_head) / a.n_kslice;
    project_tile<T, D>(a, N, column0<D, G>(tile, h, a.Hkv), item % a.n_kslice);
    if (arrive_last(tile_ticket + h * (G + 2) + tile, a.n_kslice)) {
      finalize_tile<T, S, D, G>(a, N, h, tile);
      if (arrive_last(head_ticket + h, G + 2)) raise_flag(ready + h);
    }
  } else {
    const int i = item - n_proj;
    const int h = i / (a.B * a.n_split);
    const int b = (i / a.n_split) % a.B, split = i % a.n_split;
    wait_flag(ready + h);
    const int capacity = a.max_pages * a.page_size;
    const int len = min(max(__ldg(a.lens + b), 0), capacity);
    const int start = split * a.chunk, end = min(start + a.chunk, len);
    const size_t pair = static_cast<size_t>(b) * a.Hkv + h;
    const size_t state = pair * a.n_split + split;
    split_state<T, S, D, G, true>(
        static_cast<const T*>(a.q_buf) + pair * G * D,
        static_cast<const S*>(a.pool_k), static_cast<const S*>(a.pool_v),
        a.k_scale, a.v_scale, a.table + static_cast<size_t>(b) * a.max_pages, h,
        a.Hkv, capacity, a.page_size, start, end, a.sm_scale, a.soft_cap,
        a.part_acc + state * G * D, a.part_ml + state * G * 2);
    if (arrive_last(split_ticket + pair, a.n_split)) combine_fold<T, D, G>(a, b, h);
  }
  // the last block out clears the counters for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(exited, 1) == static_cast<int>(gridDim.x) - 1) {
      const int n = 2 + a.Hkv * (G + 2) + 2 * a.Hkv + a.B * a.Hkv;
      for (int k = 0; k < n; ++k) a.sync[k] = 0;
      __threadfence();
    }
  }
}

template <typename T, typename S, int D>
cudaError_t dispatch_g(int G, const FusedArgs& a, cudaStream_t st) {
  // one block per work item: the projection items, then the attention items
  const int n_attn = a.B * a.Hkv * a.n_split;
  switch (G) {
#define TDT_FUSED_CASE(g)                                                      \
    case g:                                                                   \
      fused_attn_decode_kernel<T, S, D, g>                                    \
          <<<a.Hkv * (g + 2) * a.n_kslice + n_attn, kThreads, 0, st>>>(a);    \
      return cudaGetLastError();
    TDT_FUSED_CASE(1)
    TDT_FUSED_CASE(2)
    TDT_FUSED_CASE(4)
    TDT_FUSED_CASE(8)
#undef TDT_FUSED_CASE
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename S>
cudaError_t dispatch_d(int D, int G, const FusedArgs& a, cudaStream_t st) {
  if (D == 128) return dispatch_g<T, S, 128>(G, a, st);
  if (D == 64) return dispatch_g<T, S, 64>(G, a, st);
  return cudaErrorInvalidValue;
}

template <typename K>
int occupancy(K kernel) {
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0) ==
                 cudaSuccess ? n : -1;
}

template <typename T, typename S, int D>
int blocks_per_sm(int G) {
  switch (G) {
    case 1: return occupancy(fused_attn_decode_kernel<T, S, D, 1>);
    case 2: return occupancy(fused_attn_decode_kernel<T, S, D, 2>);
    case 4: return occupancy(fused_attn_decode_kernel<T, S, D, 4>);
    case 8: return occupancy(fused_attn_decode_kernel<T, S, D, 8>);
    default: return -1;
  }
}

template <typename T, typename S>
int blocks_per_sm_d(int D, int G) {
  if (D == 128) return blocks_per_sm<T, S, 128>(G);
  if (D == 64) return blocks_per_sm<T, S, 64>(G);
  return -1;
}

}  // namespace
}  // namespace tdt

// x (B, K); wqkv (K, (H + 2 Hkv) D); q_norm/k_norm (D,) or both null;
// pool_k/pool_v (P, Hkv, page_size, D) in x's type (written in place at each
// sequence's position) or int8 codes with k_scale/v_scale (P * Hkv) f32
// (read only); table (B, max_pages) and lens (B,) int32; inv_freq (D / 2)
// f32.  Outputs: out (B, H, D), and k_tok/v_tok (B, Hkv, D), the new token's
// k and v.  Scratch: q_buf (B, H, D), part_proj (n_kslice * B * (H + 2 Hkv) *
// D) f32, part_acc (B * Hkv * n_split * G * D) f32, part_ml (B * Hkv *
// n_split * G * 2) f32, and sync (2 + Hkv (G + 2) + 2 Hkv + B Hkv) int32, zero
// at rest and left zero.  K row slice s covers [s * k_chunk, (s + 1) * k_chunk); split s
// of the prefix covers positions [s * chunk, (s + 1) * chunk).  eps: the
// qk-norm epsilon.  dtype (of x): 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launch.
extern "C" int tdt_fused_attn_decode(
    const void* x, const void* wqkv, const void* q_norm, const void* k_norm,
    void* pool_k, void* pool_v, const float* k_scale, const float* v_scale,
    const int* table, const int* lens, const float* inv_freq, void* out,
    void* q_buf, void* k_tok, void* v_tok, float* part_proj, float* part_acc,
    float* part_ml, int* sync, int B, int K, int H, int Hkv, int D,
    int page_size, int max_pages, int n_kslice, int k_chunk, int n_split,
    int chunk, float sm_scale, float soft_cap, float eps, int dtype,
    void* stream) {
  using namespace tdt;
  if ((q_norm == nullptr) != (k_norm == nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{x, wqkv, q_norm, k_norm, pool_k, pool_v, k_scale, v_scale,
                    table, lens, inv_freq, out, q_buf, k_tok, v_tok, part_proj,
                    part_acc, part_ml, sync, B, K, Hkv, page_size, max_pages,
                    n_kslice, k_chunk, n_split, chunk, sm_scale, soft_cap, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  const bool int8_pages = k_scale != nullptr;
  if (dtype == 1)
    return int8_pages ? dispatch_d<bf16, int8_t>(D, G, a, st)
                      : dispatch_d<bf16, bf16>(D, G, a, st);
  if (dtype == 0)
    return int8_pages ? dispatch_d<float, int8_t>(D, G, a, st)
                      : dispatch_d<float, float>(D, G, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many blocks of the kernel for (D, G, dtype, int8 pages) fit on one SM
// at once (registers and shared memory); -1 for a shape it does not cover.
// The wrapper sizes the projection items to one full wave of them.
extern "C" int tdt_fused_attn_decode_blocks_per_sm(int D, int G, int dtype,
                                                   int int8_pages) {
  using namespace tdt;
  if (dtype == 1)
    return int8_pages ? blocks_per_sm_d<bf16, int8_t>(D, G) : blocks_per_sm_d<bf16, bf16>(D, G);
  if (dtype == 0)
    return int8_pages ? blocks_per_sm_d<float, int8_t>(D, G) : blocks_per_sm_d<float, float>(D, G);
  return -1;
}
