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
// Rank-folded (tp = n co-located ranks, n_ranks > 1): one launch serves every
// rank.  Items are handed out every rank's projection items first, then every
// rank's attention items, so the argument above holds across ranks; an item
// of rank r runs on rank r's view of the arguments (fused_stages.cuh
// at_rank: its wqkv block, its B sequences of the folded table, lengths and
// pools, its outputs and scratch) with rank r's counters.  x is read with
// stride 0 over the ranks.  That launch is its own instantiation (FOLDED,
// full-precision pages only: int8 pages are served at tp = 1); the tp = 1
// launch takes its arguments as they are, the kernel it was.
//
// Rounding follows the JAX kernel: q, k, v are rounded to T after the f32
// projection, after the norm and after RoPE; q is scaled in f32 and rounded
// before its products; p is rounded to T before it multiplies V.
#include "fused_stages.cuh"

namespace tdt {
namespace {

// The per-rank counters of the sync buffer: tile tickets Hkv (G + 2), head
// tickets Hkv, ready flags Hkv, split tickets B Hkv.
template <int G>
__device__ __forceinline__ int rank_sync_words(const FusedArgs& a) {
  return a.Hkv * (G + 2) + 2 * a.Hkv + a.B * a.Hkv;
}

// One work item: projection item i, or attention item i, of rank r, on that
// rank's view `ar` of the arguments (at tp = 1, `a` itself).
template <typename T, typename S, int D, int G>
__device__ __forceinline__ void fused_item(const FusedArgs& a, const FusedArgs& ar, int r,
                                           bool proj, int i) {
  const int N = (a.Hkv * G + 2 * a.Hkv) * D;
  const int per_head = (G + 2) * a.n_kslice;
  int* tile_ticket = a.sync + 2 + r * rank_sync_words<G>(a);
  int* head_ticket = tile_ticket + a.Hkv * (G + 2);
  int* ready = head_ticket + a.Hkv;
  int* split_ticket = ready + a.Hkv;
  if (proj) {
    const int h = i / per_head, tile = (i % per_head) / a.n_kslice;
    project_tile<T, D>(ar, N, column0<D, G>(tile, h, a.Hkv), i % a.n_kslice);
    if (arrive_last(tile_ticket + h * (G + 2) + tile, a.n_kslice)) {
      finalize_tile<T, S, D, G>(ar, N, h, tile);
      if (arrive_last(head_ticket + h, G + 2)) raise_flag(ready + h);
    }
  } else {
    const int h = i / (a.B * a.n_split);
    const int b = (i / a.n_split) % a.B, split = i % a.n_split;
    wait_flag(ready + h);
    const int capacity = a.max_pages * a.page_size;
    const int len = min(max(__ldg(ar.lens + b), 0), capacity);
    const int start = split * a.chunk, end = min(start + a.chunk, len);
    const size_t pair = static_cast<size_t>(b) * a.Hkv + h;
    const size_t state = pair * a.n_split + split;
    split_state<T, S, D, G, true>(
        static_cast<const T*>(ar.q_buf) + pair * G * D,
        static_cast<const S*>(a.pool_k), static_cast<const S*>(a.pool_v),
        a.k_scale, a.v_scale, ar.table + static_cast<size_t>(b) * a.max_pages, h,
        a.Hkv, capacity, a.page_size, start, end, a.sm_scale, a.soft_cap,
        ar.part_acc + state * G * D, ar.part_ml + state * G * 2);
    if (arrive_last(split_ticket + pair, a.n_split)) combine_fold<T, D, G>(ar, b, h);
  }
}

// FOLDED: a rank-folded launch (n_ranks > 1, full-precision pages only);
// the tp = 1 launch uses its arguments as they are, with no rank view.
template <typename T, typename S, int D, int G, bool FOLDED>
__global__ void __launch_bounds__(kThreads) fused_attn_decode_kernel(const FusedArgs a) {
  __shared__ int s_item;
  int* work = a.sync;
  int* exited = a.sync + 1;
  const int n_proj = a.Hkv * (G + 2) * a.n_kslice;   // a rank's projection items
  const int n_attn = a.B * a.Hkv * a.n_split;        // a rank's attention items
  if (threadIdx.x == 0) s_item = atomicAdd(work, 1);
  __syncthreads();
  const int item = s_item;
  if constexpr (FOLDED) {
    const bool proj = item < a.n_ranks * n_proj;
    const int i = proj ? item : item - a.n_ranks * n_proj;
    const int r = proj ? i / n_proj : i / n_attn;
    const FusedArgs ar = at_rank<T, D, G>(a, r);
    fused_item<T, S, D, G>(a, ar, r, proj, proj ? i % n_proj : i % n_attn);
  } else {
    const bool proj = item < n_proj;
    fused_item<T, S, D, G>(a, a, 0, proj, proj ? item : item - n_proj);
  }
  // the last block out clears the counters for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(exited, 1) == static_cast<int>(gridDim.x) - 1) {
      const int n = 2 + a.n_ranks * rank_sync_words<G>(a);
      for (int k = 0; k < n; ++k) a.sync[k] = 0;
      __threadfence();
    }
  }
}

template <typename T, typename S, int D, int G>
cudaError_t launch_kernel(const FusedArgs& a, cudaStream_t st) {
  // one block per work item: every rank's projection items, then every
  // rank's attention items
  const int blocks = a.n_ranks * (a.Hkv * (G + 2) * a.n_kslice + a.B * a.Hkv * a.n_split);
  if (a.n_ranks == 1) {
    fused_attn_decode_kernel<T, S, D, G, false><<<blocks, kThreads, 0, st>>>(a);
  } else {
    if constexpr (sizeof(S) == 1) return cudaErrorInvalidValue;   // int8 pages: tp = 1 only
    else fused_attn_decode_kernel<T, S, D, G, true><<<blocks, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T, typename S, int D>
cudaError_t dispatch_g(int G, const FusedArgs& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch_kernel<T, S, D, 1>(a, st);
    case 2: return launch_kernel<T, S, D, 2>(a, st);
    case 4: return launch_kernel<T, S, D, 4>(a, st);
    case 8: return launch_kernel<T, S, D, 8>(a, st);
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
    case 1: return occupancy(fused_attn_decode_kernel<T, S, D, 1, false>);
    case 2: return occupancy(fused_attn_decode_kernel<T, S, D, 2, false>);
    case 4: return occupancy(fused_attn_decode_kernel<T, S, D, 4, false>);
    case 8: return occupancy(fused_attn_decode_kernel<T, S, D, 8, false>);
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
//
// n_ranks > 1 (tp = n on co-located ranks, one launch for every rank): H and
// Hkv are one rank's heads, wqkv is rank-stacked (n_ranks, K, (H + 2 Hkv) D),
// x stays one (B, K) copy, and table, lens, out, k_tok, v_tok are those of
// n_ranks B sequences (rank r's at [r B, (r + 1) B)) over the folded pools;
// the scratch and the sync buffer grow n_ranks-fold (sync: 2 + n_ranks (Hkv
// (G + 2) + 2 Hkv + B Hkv)).
extern "C" int tdt_fused_attn_decode(
    const void* x, const void* wqkv, const void* q_norm, const void* k_norm,
    void* pool_k, void* pool_v, const float* k_scale, const float* v_scale,
    const int* table, const int* lens, const float* inv_freq, void* out,
    void* q_buf, void* k_tok, void* v_tok, float* part_proj, float* part_acc,
    float* part_ml, int* sync, int B, int K, int H, int Hkv, int D,
    int page_size, int max_pages, int n_kslice, int k_chunk, int n_split,
    int chunk, float sm_scale, float soft_cap, float eps, int dtype,
    int n_ranks, void* stream) {
  using namespace tdt;
  if ((q_norm == nullptr) != (k_norm == nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) || H % Hkv != 0 || n_ranks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long w_rank_stride = static_cast<long long>(K) * (H + 2 * Hkv) * D;
  const FusedArgs a{x, wqkv, q_norm, k_norm, pool_k, pool_v, k_scale, v_scale,
                    table, lens, inv_freq, out, q_buf, k_tok, v_tok, part_proj,
                    part_acc, part_ml, sync, B, K, Hkv, page_size, max_pages,
                    n_kslice, k_chunk, n_split, chunk, sm_scale, soft_cap, eps,
                    n_ranks, w_rank_stride};
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
