// K2, K3 and K7: single-token decode attention for Hopper (sm_90a), over a
// contiguous KV cache and over a paged one.  K2 and K3 with bf16 queries at
// D = 128, the served form, run decode_cluster.cu's one clustered launch
// instead; their f32 and D = 64 forms run the split + combine pass below.
//
// K2 replaces triton_distributed_tpu/ops/attention.py::_decode_fused_kernel
// (split-KV decode over a contiguous (B, Hkv, Smax, D) cache with ragged
// kv_len, normalized output).  K3 replaces ::_paged_decode_kernel (decode
// through block_table[b, j] into a (P, Hkv, page_size, D) page pool with
// ragged seq_lens), whose per-page states the JAX code merges with
// merge_decode_states + safe_normalize_decode, in both of its forms: pages in
// the query's type, and int8 pages with one f32 scale per (page, head)
// (`k_scale`/`v_scale`, JAX ops/attention.py:1218-1270).  All of them run
// split_state (decode_split.cuh), which K4 (fused_decode.cu) shares; only
// the address of kv position `pos` and the storage type differ.
//
// K7 replaces ::_decode_kernel (decode_attention_state: the unnormalized
// (num, m, l) state of each split of a contiguous cache, for
// merge_decode_states and the cross-rank merge of SP flash-decode) and
// serves the _state form of K3 (paged_decode_attention_state: one state per
// logical page).  It is the split pass of K2/K3 with the state written out
// in the JAX layout, (B, H, n_split, D) and (B, H, n_split), instead of
// merged: split s of a contiguous cache covers JAX's boundaries
// [s * Skv / n_split, (s + 1) * Skv / n_split), a page is a split of
// page_size positions, and an empty split or page (past kv_len) gives
// exactly num = 0, m = -1e30, l = 0, as the JAX kernel's masked tile does.
//
// Bound on the H100: the K and V bytes.  A decode step reads each cached row
// once and does 4 * G flops per element of it, far below the 295 flops per
// byte where the tensor cores would become the limit.  So the design is about
// bytes and about filling 132 SMs:
//   * one block owns one (batch, kv head) and one split of the sequence, and
//     reads each K/V row once for all G = H / Hkv query heads of its group
//     (the GQA reuse);
//   * each row is read with 16-byte vector loads, D / 8 (bf16) lanes per row
//     (8-byte loads of int8 codes, so a lane holds as many elements as with
//     bf16), and each group of lanes keeps four rows of K and V in flight;
//   * Qwen3-8B at B = 4 has 32 (batch, kv head) pairs, so the sequence is cut
//     into splits sized for about four blocks per SM, and a second small
//     kernel merges the splits' (m, l, acc) states (the counterpart of
//     merge_decode_states + safe_normalize_decode);
//   * positions at or past a sequence's length are skipped, not masked, so
//     the contiguous cache reads kv_len rows and not Smax, and a page past
//     seq_lens is never read;
//   * a sequence of length 0 returns zeros.
// Rounding follows the JAX kernels: q is scaled in f32 and cast to the
// storage type, p is cast to the V type before it multiplies V, and the
// state is f32.
#include "decode_split.cuh"

namespace tdt {
namespace {

// Split-KV pass: the (m, l, acc) state of one split for the G heads of one
// (batch, kv head).  `table` is null for the contiguous layout; k_scale and
// v_scale are null unless S is int8.
template <typename T, typename S, int D, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const S* __restrict__ k,
             const S* __restrict__ v, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ lens,
             const int* __restrict__ table, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int Hkv, int capacity, int page_size,
             int max_pages, int chunk, float sm_scale, float soft_cap) {
  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y, n_split = gridDim.y;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int len = min(max(lens[b], 0), capacity);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  const size_t state = static_cast<size_t>(bk) * n_split + split;
  split_state<T, S, D, G, PAGED>(
      q + static_cast<size_t>(bk) * G * D, k, v, k_scale, v_scale,
      PAGED ? table + static_cast<size_t>(b) * max_pages : nullptr,
      PAGED ? hk : bk, Hkv, capacity, page_size, start, end, sm_scale,
      soft_cap, part_acc + state * G * D, part_ml + state * G * 2);
}

// K7: the same split pass, each head's state written to its own row of the
// JAX layout: num (B, H, n_split, D), m and l (B, H, n_split), head
// hk * G + h of the group, split blockIdx.y.
template <typename T, typename S, int D, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_state(const T* __restrict__ q, const S* __restrict__ k,
             const S* __restrict__ v, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ lens,
             const int* __restrict__ table, float* __restrict__ num,
             float* __restrict__ m, float* __restrict__ l, int Hkv,
             int capacity, int page_size, int max_pages, int chunk,
             float sm_scale, float soft_cap) {
  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y, n_split = gridDim.y;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int len = min(max(lens[b], 0), capacity);
  const int start = split * chunk;
  const int end = min(start + chunk, len);
  // (b * H + hk * G) = bk * G: the group's first query head
  const size_t row = static_cast<size_t>(bk) * G * n_split + split;
  split_state_to<T, S, D, G, PAGED>(
      q + static_cast<size_t>(bk) * G * D, k, v, k_scale, v_scale,
      PAGED ? table + static_cast<size_t>(b) * max_pages : nullptr,
      PAGED ? hk : bk, Hkv, capacity, page_size, start, end, sm_scale,
      soft_cap, num + row * D, n_split * D, m + row, l + row, n_split);
}

// Merge the splits of one (batch, query head) and normalize; l == 0 (no
// valid position) gives zeros.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_combine(const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, T* __restrict__ out, int H,
               int G, int D, int n_split) {
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int Hkv = H / G;
  const int hg = h % G;
  const size_t first = static_cast<size_t>(b * Hkv + h / G) * n_split;
  float mn, den;
  merge_ml(part_ml, first, n_split, G, hg, mn, den);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float num = merge_acc(part_acc, part_ml, first, n_split, G, D, hg, d, mn);
    out[static_cast<size_t>(bh) * D + d] = from_f32<T>(den > 0.f ? num / den : 0.f);
  }
}

struct DecodeArgs {
  const void *q, *k, *v;
  const float *k_scale, *v_scale;
  const int *lens, *table;
  float *part_acc, *part_ml;
  void* out;
  int B, Hkv, capacity, page_size, max_pages, n_split, chunk;
  float sm_scale, soft_cap;
  cudaStream_t stream;
};

template <typename T, typename S, int D, int G, bool PAGED>
void launch_split(const DecodeArgs& a) {
  decode_split<T, S, D, G, PAGED><<<dim3(a.B * a.Hkv, a.n_split), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.k_scale, a.v_scale, a.lens, a.table,
      a.part_acc, a.part_ml, a.Hkv, a.capacity, a.page_size, a.max_pages,
      a.chunk, a.sm_scale, a.soft_cap);
}

// The layouts served: contiguous and paged pages in the query's type T, and
// paged int8 pages.
template <typename T, int D, int G>
cudaError_t launch(const DecodeArgs& a, bool int8_pages) {
  if (int8_pages) {
    launch_split<T, int8_t, D, G, true>(a);
  } else if (a.table != nullptr) {
    launch_split<T, T, D, G, true>(a);
  } else {
    launch_split<T, T, D, G, false>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<a.B * a.Hkv * G, kThreads, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.Hkv * G, G, D, a.n_split);
  return cudaGetLastError();
}

// K7: part_acc, part_ml and out of the args carry num, m and l.
template <typename T, typename S, int D, int G, bool PAGED>
void launch_state_split(const DecodeArgs& a) {
  decode_state<T, S, D, G, PAGED><<<dim3(a.B * a.Hkv, a.n_split), kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.k),
      static_cast<const S*>(a.v), a.k_scale, a.v_scale, a.lens, a.table,
      a.part_acc, a.part_ml, static_cast<float*>(a.out), a.Hkv, a.capacity,
      a.page_size, a.max_pages, a.chunk, a.sm_scale, a.soft_cap);
}

template <typename T, int D, int G>
cudaError_t launch_state(const DecodeArgs& a, bool int8_pages) {
  if (int8_pages) {
    launch_state_split<T, int8_t, D, G, true>(a);
  } else if (a.table != nullptr) {
    launch_state_split<T, T, D, G, true>(a);
  } else {
    launch_state_split<T, T, D, G, false>(a);
  }
  return cudaGetLastError();
}

template <typename T, int D, int G>
cudaError_t launch_any(const DecodeArgs& a, bool int8_pages, bool state) {
  return state ? launch_state<T, D, G>(a, int8_pages) : launch<T, D, G>(a, int8_pages);
}

template <typename T, int D>
cudaError_t dispatch_g(int G, const DecodeArgs& a, bool int8_pages, bool state) {
  switch (G) {
    case 1: return launch_any<T, D, 1>(a, int8_pages, state);
    case 2: return launch_any<T, D, 2>(a, int8_pages, state);
    case 4: return launch_any<T, D, 4>(a, int8_pages, state);
    case 8: return launch_any<T, D, 8>(a, int8_pages, state);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int H, int D, int dtype, const DecodeArgs& a, bool state) {
  const bool int8_pages = a.k_scale != nullptr;
  if (int8_pages && (a.table == nullptr || a.v_scale == nullptr))
    return cudaErrorInvalidValue;
  const int G = H / a.Hkv;
  if (dtype == 1 && D == 128) return dispatch_g<bf16, 128>(G, a, int8_pages, state);
  if (dtype == 1 && D == 64) return dispatch_g<bf16, 64>(G, a, int8_pages, state);
  if (dtype == 0 && D == 128) return dispatch_g<float, 128>(G, a, int8_pages, state);
  if (dtype == 0 && D == 64) return dispatch_g<float, 64>(G, a, int8_pages, state);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tdt

// q (B, H, D); contiguous layout: k/v (B, Hkv, capacity, D) and table null;
// paged layout: k/v (P, Hkv, page_size, D) pools, table (B, max_pages) int32
// and capacity = max_pages * page_size; int8 pages: k/v hold int8 codes and
// k_scale/v_scale (P * Hkv) f32 their per-(page, head) scales (both null
// otherwise).  lens (B,) int32.  part_acc holds B * Hkv * n_split * G * D
// floats, part_ml B * Hkv * n_split * G * 2; split s covers positions
// [s * chunk, (s + 1) * chunk).  out (B, H, D) in q's type.
// dtype (of q): 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches.
extern "C" int tdt_decode_attention(const void* q, const void* k, const void* v,
                                    const int* lens, const int* table,
                                    const float* k_scale, const float* v_scale,
                                    float* part_acc, float* part_ml, void* out,
                                    int B, int H, int Hkv, int D, int capacity,
                                    int page_size, int max_pages, int n_split,
                                    int chunk, float sm_scale, float soft_cap,
                                    int dtype, void* stream) {
  using namespace tdt;
  const DecodeArgs a{q, k, v, k_scale, v_scale, lens, table, part_acc, part_ml,
                     out, B, Hkv, capacity, page_size, max_pages, n_split,
                     chunk, sm_scale, soft_cap, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(H, D, dtype, a, false));
}

// K7: the split states without the merge.  The layouts of q, k, v, lens,
// table and the scales are tdt_decode_attention's; split s covers positions
// [s * chunk, (s + 1) * chunk) (for pages: chunk = page_size, n_split =
// max_pages).  num (B, H, n_split, D), m and l (B, H, n_split), f32.
extern "C" int tdt_decode_attention_state(
    const void* q, const void* k, const void* v, const int* lens,
    const int* table, const float* k_scale, const float* v_scale, float* num,
    float* m, float* l, int B, int H, int Hkv, int D, int capacity,
    int page_size, int max_pages, int n_split, int chunk, float sm_scale,
    float soft_cap, int dtype, void* stream) {
  using namespace tdt;
  const DecodeArgs a{q, k, v, k_scale, v_scale, lens, table, num, m, l, B,
                     Hkv, capacity, page_size, max_pages, n_split, chunk,
                     sm_scale, soft_cap, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch(H, D, dtype, a, true));
}
