// K2 and K3: single-token decode attention for Hopper (sm_90a), over a
// contiguous KV cache and over a paged one.
//
// K2 replaces triton_distributed_tpu/ops/attention.py::_decode_fused_kernel
// (split-KV decode over a contiguous (B, Hkv, Smax, D) cache with ragged
// kv_len, normalized output).  K3 replaces ::_paged_decode_kernel (decode
// through block_table[b, j] into a (P, Hkv, page_size, D) page pool with
// ragged seq_lens), whose per-page states the JAX code merges with
// merge_decode_states + safe_normalize_decode.  Both run the same device
// function; only the address of kv position `pos` differs.
//
// Bound on the H100: the K and V bytes.  A decode step reads each cached row
// once and does 4 * G flops per element of it, far below the 295 flops per
// byte where the tensor cores would become the limit.  So the design is about
// bytes and about filling 132 SMs:
//   * one block owns one (batch, kv head) and one split of the sequence, and
//     reads each K/V row once for all G = H / Hkv query heads of its group
//     (the GQA reuse);
//   * each row is read with 16-byte vector loads, D / 8 (bf16) lanes per row,
//     and each group of lanes keeps four rows of K and V in flight at once;
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
#include "common.cuh"

namespace tdt {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Split-KV pass: the (m, l, acc) state of one split for the G heads of one
// (batch, kv head).  `table` is null for the contiguous layout.
template <typename T, int D, int G, bool PAGED>
__global__ void __launch_bounds__(kThreads)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lens,
             const int* __restrict__ table, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int Hkv, int capacity, int page_size,
             int max_pages, int chunk, float sm_scale, float soft_cap) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = D / E;         // lanes per kv row
  constexpr int RPW = 32 / LPR;      // row groups per warp
  constexpr int NG = kWarps * RPW;   // row groups in the block
  constexpr int R = 4;               // rows per row group per step
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "unsupported head dim");

  __shared__ float s_acc[kWarps][G][D];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];

  const int bk = blockIdx.x;  // b * Hkv + kv head
  const int split = blockIdx.y, n_split = gridDim.y;
  const int b = bk / Hkv, hk = bk % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR;                  // 16-byte slice of the row
  const int grp = warp * RPW + lane / LPR;     // row group in the block
  const int len = min(max(lens[b], 0), capacity);
  const int start = split * chunk;
  const int end = min(start + chunk, len);

  float qv[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    load16(q + (static_cast<size_t>(bk) * G + h) * D + sub * E, qv[h]);
#pragma unroll
    for (int e = 0; e < E; ++e) qv[h][e] = round_to<T>(qv[h][e] * sm_scale);
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  // Each row group takes R rows per step, rows base + r * NG + grp, and
  // issues all 2R of its 16-byte K/V loads before it uses any: the loads of
  // a step are in flight together, and the softmax state is rescaled once
  // per step rather than once per row.  The trip count is warp-uniform, so
  // every lane of a warp runs every shuffle.
  for (int base = start; base < end; base += NG * R) {
    uint4 kraw[R], vraw[R];
    bool valid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pos = base + r * NG + grp;
      valid[r] = pos < end;
      kraw[r] = vraw[r] = make_uint4(0u, 0u, 0u, 0u);
      if (valid[r]) {
        size_t row;
        if (PAGED) {
          const int page = table[b * max_pages + pos / page_size];
          row = (static_cast<size_t>(page) * Hkv + hk) * page_size + pos % page_size;
        } else {
          row = static_cast<size_t>(bk) * capacity + pos;
        }
        kraw[r] = *reinterpret_cast<const uint4*>(k + row * D + sub * E);
        vraw[r] = *reinterpret_cast<const uint4*>(v + row * D + sub * E);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float kf[E];
        unpack16(kraw[r], kf, T());
        s[r] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s[r] = fmaf(qv[h][e], kf[e], s[r]);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) s[r] += __shfl_xor_sync(kFullMask, s[r], off);
      }
      float mn = m[h];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (soft_cap > 0.f) s[r] = tanhf(s[r] / soft_cap) * soft_cap;
        if (valid[r]) mn = fmaxf(mn, s[r]);
      }
      const float alpha = expf(m[h] - mn);
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!valid[r]) continue;
        const float p = expf(s[r] - mn);
        const float pr = round_to<T>(p);
        l[h] += p;
        float vf[E];
        unpack16(vraw[r], vf, T());
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);
      }
      m[h] = mn;
    }
  }

  // merge the row groups of the warp (same d slice, different rows)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float mo = __shfl_xor_sync(kFullMask, m[h], off);
      const float lo = __shfl_xor_sync(kFullMask, l[h], off);
      const float mn = fmaxf(m[h], mo);
      const float a = expf(m[h] - mn), c = expf(mo - mn);
      l[h] = l[h] * a + lo * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(kFullMask, acc[h][e], off);
        acc[h][e] = acc[h][e] * a + ao * c;
      }
      m[h] = mn;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[warp][h][sub * E + e] = acc[h][e];
      if (lane == 0) {
        s_m[warp][h] = m[h];
        s_l[warp][h] = l[h];
      }
    }
  }
  __syncthreads();

  // merge the warps and write this split's state
  const size_t state = static_cast<size_t>(bk) * n_split + split;
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mn = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, s_m[w][h]);
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num += s_acc[w][h][d] * expf(s_m[w][h] - mn);
    part_acc[(state * G + h) * D + d] = num;
    if (d == 0) {
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) den += s_l[w][h] * expf(s_m[w][h] - mn);
      part_ml[(state * G + h) * 2] = mn;
      part_ml[(state * G + h) * 2 + 1] = den;
    }
  }
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
  float mn = kNegInf;
  for (int s = 0; s < n_split; ++s) mn = fmaxf(mn, part_ml[((first + s) * G + hg) * 2]);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + ((first + s) * G + hg) * 2;
    den += ml[1] * expf(ml[0] - mn);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const size_t st = (first + s) * G + hg;
      num += part_acc[st * D + d] * expf(part_ml[st * 2] - mn);
    }
    out[static_cast<size_t>(bh) * D + d] = from_f32<T>(den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lens, const int* table, float* part_acc,
                   float* part_ml, void* out, int B, int Hkv, int capacity,
                   int page_size, int max_pages, int n_split, int chunk,
                   float sm_scale, float soft_cap, cudaStream_t stream) {
  const dim3 grid(B * Hkv, n_split);
  if (table != nullptr) {
    decode_split<T, D, G, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lens, table, part_acc, part_ml, Hkv,
        capacity, page_size, max_pages, chunk, sm_scale, soft_cap);
  } else {
    decode_split<T, D, G, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), lens, nullptr, part_acc, part_ml, Hkv,
        capacity, page_size, max_pages, chunk, sm_scale, soft_cap);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T><<<B * Hkv * G, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), Hkv * G, G, D, n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const int* lens, const int* table, float* part_acc,
                       float* part_ml, void* out, int B, int Hkv, int capacity,
                       int page_size, int max_pages, int n_split, int chunk,
                       float sm_scale, float soft_cap, cudaStream_t st) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
    case 2: return launch<T, D, 2>(q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
    case 4: return launch<T, D, 4>(q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
    case 8: return launch<T, D, 8>(q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace tdt

// q (B, H, D); contiguous layout: k/v (B, Hkv, capacity, D) and table null;
// paged layout: k/v (P, Hkv, page_size, D) pools, table (B, max_pages) int32
// and capacity = max_pages * page_size.  lens (B,) int32.  part_acc holds
// B * Hkv * n_split * G * D floats, part_ml B * Hkv * n_split * G * 2; split s
// covers positions [s * chunk, (s + 1) * chunk).  out (B, H, D).
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launches.
extern "C" int tdt_decode_attention(const void* q, const void* k, const void* v,
                                    const int* lens, const int* table,
                                    float* part_acc, float* part_ml, void* out,
                                    int B, int H, int Hkv, int D, int capacity,
                                    int page_size, int max_pages, int n_split,
                                    int chunk, float sm_scale, float soft_cap,
                                    int dtype, void* stream) {
  using namespace tdt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
  if (dtype == 1 && D == 128)
    return dispatch_g<bf16, 128>(G, q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
  if (dtype == 1 && D == 64)
    return dispatch_g<bf16, 64>(G, q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
  if (dtype == 0 && D == 128)
    return dispatch_g<float, 128>(G, q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
  if (dtype == 0 && D == 64)
    return dispatch_g<float, 64>(G, q, k, v, lens, table, part_acc, part_ml, out, B, Hkv, capacity, page_size, max_pages, n_split, chunk, sm_scale, soft_cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
