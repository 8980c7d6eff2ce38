// K16's kernel (persistent_decode.cu describes it), included by the four
// sources that instantiate it, one per element type and head dim, and by
// persistent_decode.cu, which holds the C entry points.
#pragma once

#include "fused_ar.cuh"
#include "stamps.cuh"

namespace tdt {
namespace far {

constexpr int kLayerPtrs = 8;  // ln1, wqkv, q_norm, k_norm, wo, ln2, gate_up, down
enum { kLn1, kWqkv, kQNorm, kKNorm, kWo, kLn2, kGateUp, kDown };
// per-rank scratch regions (byte offsets from the rank's base)
enum { kX, kH, kAtt, kAct, kQBuf, kKTok, kVTok, kPartProj, kPartAcc, kPartMl, kPart, kRegions };

// core/symm.py PersistentArgs, field for field.  c.x: the ring's product
// entries (n chunks of B cn); c.out: the reduced chunks, two parities of n
// chunks; c.land: the receive slots; c.flags: the pad.  layers: (L,
// kLayerPtrs) device addresses, rank r's weight at + r * w_stride[kind]
// bytes.  x_in (B, K); pools (L, n P, hk, ps, D); table (n B, mp), lens
// (n B) folded; scratch: one base per rank, regions at off[]; x_out (B, K).
struct PersistentArgs {
  dl::CollArgs c;
  const long long* layers;
  long long w_stride[kLayerPtrs];
  const void* x_in;
  void* x_out;
  void* pool_k;
  void* pool_v;
  const int* table;
  const int* lens;
  const float* inv_freq;
  dl::Peers scratch;
  long long off[kRegions];
  long long layer_pool_elems;
  int L, B, K, F, hk, ps, mp;
  int proj_nks, proj_kchunk, n_split, chunk;
  Gemv o, up, dn;
  float sm_scale, soft_cap, qk_eps, rms_eps;
  int qk_norm;
};

template <typename T>
__device__ __forceinline__ const T* weight(const PersistentArgs& a, int l, int kind, int r) {
  const long long p = a.layers[static_cast<long long>(l) * kLayerPtrs + kind];
  return p ? reinterpret_cast<const T*>(p + r * a.w_stride[kind]) : nullptr;
}

template <typename T>
__device__ __forceinline__ T* region(const PersistentArgs& a, const dl::Rank& c, int which) {
  return reinterpret_cast<T*>(a.scratch.p[c.slot(c.me)] + a.off[which]);
}

// h = RMSNorm(x) * w, rounded to T, a row per work item (JAX rms_norm: the
// mean square in f32, x * rsqrt(ms + eps) * w in f32).
template <typename T>
__device__ void rms_rows(const PersistentArgs& a, const T* x, const T* w, T* h) {
  __shared__ float s_part[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const T* xr = x + static_cast<long long>(b) * a.K;
    float ss = 0.f;
    for (int k = threadIdx.x; k < a.K; k += kThreads) {
      const float v = ldcg_f32(xr + k);
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFullMask, ss, off);
    if (lane == 0) s_part[warp] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) tot += s_part[wp];
    const float inv = rsqrtf(tot / a.K + a.rms_eps);
    for (int k = threadIdx.x; k < a.K; k += kThreads)
      h[static_cast<long long>(b) * a.K + k] = from_f32<T>(ldcg_f32(xr + k) * inv * to_f32(w[k]));
    __syncthreads();
  }
}

// x += the reduced chunks (chunk-major (n, B, cn) in c.a.out), this lane's
// ring slice of every chunk (the elements it received), rounded once.
template <typename T>
__device__ void residual(const dl::Rank& c, const PersistentArgs& a, T* x, int cn) {
  long long lo, hi;
  ring_slice<T>(c, lo, hi);
  for (int ch = 0; ch < c.n(); ++ch) {
    const T* red = c.at<T>(c.a.out, c.me, ch);
    for (long long e = lo + threadIdx.x; e < hi; e += kThreads) {
      T* px = x + e / cn * a.K + static_cast<long long>(ch) * cn + e % cn;
      *px = from_f32<T>(ldcg_f32(px) + ldcg_f32(red + e));
    }
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads) persistent_decode_kernel(
    const __grid_constant__ PersistentArgs a) {
  const dl::Rank c0(a.c);
  const int r = c0.me, n = c0.n();
  const int hloc = a.hk * G, N = (hloc + 2 * a.hk) * D, cn = a.K / n;
  T* X = region<T>(a, c0, kX);
  T* H = region<T>(a, c0, kH);
  T* ATT = region<T>(a, c0, kAtt);
  T* ACT = region<T>(a, c0, kAct);
  float* part = region<float>(a, c0, kPart);
  int gen = 0, parity = 0;
  // each rank's residual stream starts as the embedded tokens
  {
    const long long total = static_cast<long long>(a.B) * a.K;
    const T* xin = static_cast<const T*>(a.x_in);
    for (long long e = blockIdx.x * kThreads + threadIdx.x; e < total;
         e += static_cast<long long>(gridDim.x) * kThreads)
      X[e] = xin[e];
  }
  dl::rank_sync(c0, gen);
  dl::collective_prologue(c0, true);
  // the instance's view: c.out is the reduced chunks of its parity
  dl::CollArgs ca = a.c;
  FusedArgs fa{};
  fa.x = H;
  fa.inv_freq = a.inv_freq;
  fa.out = ATT;
  fa.q_buf = region<T>(a, c0, kQBuf);
  fa.k_tok = region<T>(a, c0, kKTok);
  fa.v_tok = region<T>(a, c0, kVTok);
  fa.part_proj = region<float>(a, c0, kPartProj);
  fa.part_acc = region<float>(a, c0, kPartAcc);
  fa.part_ml = region<float>(a, c0, kPartMl);
  fa.table = a.table + static_cast<long long>(r) * a.B * a.mp;
  fa.lens = a.lens + static_cast<long long>(r) * a.B;
  fa.B = a.B;
  fa.K = a.K;
  fa.Hkv = a.hk;
  fa.page_size = a.ps;
  fa.max_pages = a.mp;
  fa.n_kslice = a.proj_nks;
  fa.k_chunk = a.proj_kchunk;
  fa.n_split = a.n_split;
  fa.chunk = a.chunk;
  fa.sm_scale = a.sm_scale;
  fa.soft_cap = a.soft_cap;
  fa.eps = a.qk_eps;
  fa.n_ranks = 1;
  const int per_head = (G + 2) * a.proj_nks;
  const int capacity = a.mp * a.ps;
  int instance = 0;
  for (int l = 0; l < a.L; ++l) {
    // -- attention side --------------------------------------------------
    TDT_STAMP(l, 0);
    rms_rows<T>(a, X, weight<T>(a, l, kLn1, 0), H);
    TDT_STAMP(l, 1);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 2);
    fa.wqkv = weight<T>(a, l, kWqkv, r);
    fa.q_norm = a.qk_norm ? weight<T>(a, l, kQNorm, 0) : nullptr;
    fa.k_norm = a.qk_norm ? weight<T>(a, l, kKNorm, 0) : nullptr;
    fa.pool_k = static_cast<T*>(a.pool_k) + l * a.layer_pool_elems;
    fa.pool_v = static_cast<T*>(a.pool_v) + l * a.layer_pool_elems;
    for (int it = blockIdx.x; it < a.hk * per_head; it += gridDim.x) {
      const int h = it / per_head, tile = (it % per_head) / a.proj_nks;
      project_tile<T, D, true>(fa, N, column0<D, G>(tile, h, a.hk), it % a.proj_nks);
    }
    TDT_STAMP(l, 3);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 4);
    for (int it = blockIdx.x; it < a.hk * (G + 2); it += gridDim.x)
      finalize_tile<T, T, D, G>(fa, N, it / (G + 2), it % (G + 2));
    TDT_STAMP(l, 5);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 6);
    for (int it = blockIdx.x; it < a.hk * a.B * a.n_split; it += gridDim.x) {
      const int h = it / (a.B * a.n_split);
      const int b = (it / a.n_split) % a.B, split = it % a.n_split;
      const int len = min(max(__ldg(fa.lens + b), 0), capacity);
      const int start = split * a.chunk, end = min(start + a.chunk, len);
      const size_t pair = static_cast<size_t>(b) * a.hk + h;
      const size_t state = pair * a.n_split + split;
      split_state<T, T, D, G, true>(
          static_cast<const T*>(fa.q_buf) + pair * G * D, static_cast<const T*>(fa.pool_k),
          static_cast<const T*>(fa.pool_v), nullptr, nullptr,
          fa.table + static_cast<size_t>(b) * a.mp, h, a.hk, capacity, a.ps, start, end,
          a.sm_scale, a.soft_cap, fa.part_acc + state * G * D, fa.part_ml + state * G * 2);
    }
    TDT_STAMP(l, 7);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 8);
    for (int it = blockIdx.x; it < a.B * a.hk; it += gridDim.x)
      combine_fold<T, D, G>(fa, it / a.hk, it % a.hk);
    TDT_STAMP(l, 9);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 10);
    // -- o-projection + AllReduce (instance 2l), residual ------------------
    for (int s = 0; s < n; ++s)
      ca.out.p[a.c.slot[c0.group * n + s]] =
          a.c.out.p[a.c.slot[c0.group * n + s]] +
          static_cast<long long>(instance & 1) * n * a.c.chunk_elems * sizeof(T);
    {
      const dl::Rank c(ca);
      ar_instance<T, T, T>(c, ATT, hloc * D, weight<T>(a, l, kWo, r), a.K, a.o, part, gen, parity,
                           instance > 0);
      residual<T>(c, a, X, cn);
    }
    ++instance;
    TDT_STAMP(l, 11);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 12);
    // -- MLP + AllReduce (instance 2l + 1), residual -----------------------
    rms_rows<T>(a, X, weight<T>(a, l, kLn2, 0), H);
    TDT_STAMP(l, 13);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 14);
    gemv_lane<T, T>(H, a.K, weight<T>(a, l, kGateUp, r), 2LL * a.F, a.up, part);
    TDT_STAMP(l, 15);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 16);
    {
      const long long plane = static_cast<long long>(a.B) * a.up.cols,
                      total = static_cast<long long>(a.B) * a.F;
      for (long long e = blockIdx.x * kThreads + threadIdx.x; e < total;
           e += static_cast<long long>(gridDim.x) * kThreads) {
        const long long b = e / a.F, f = e % a.F;
        float gs = 0.f, us = 0.f;
        for (int ks = 0; ks < a.up.n_kslice; ++ks) {
          gs += __ldcg(part + ks * plane + b * a.up.cols + f);
          us += __ldcg(part + ks * plane + b * a.up.cols + a.F + f);
        }
        const float gv = round_to<T>(gs), uv = round_to<T>(us);
        ACT[e] = from_f32<T>(gv / (1.f + expf(-gv)) * uv);
      }
    }
    TDT_STAMP(l, 17);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 18);
    for (int s = 0; s < n; ++s)
      ca.out.p[a.c.slot[c0.group * n + s]] =
          a.c.out.p[a.c.slot[c0.group * n + s]] +
          static_cast<long long>(instance & 1) * n * a.c.chunk_elems * sizeof(T);
    {
      const dl::Rank c(ca);
      ar_instance<T, T, T>(c, ACT, a.F, weight<T>(a, l, kDown, r), a.K, a.dn, part, gen, parity,
                           true);
      residual<T>(c, a, X, cn);
    }
    ++instance;
    TDT_STAMP(l, 19);
    dl::rank_sync(c0, gen);
    TDT_STAMP(l, 20);
  }
  if (n > 1) dl::rs_ack_drain(c0);
  // rank 0's residual stream is the step's output
  if (r == 0) {
    const long long total = static_cast<long long>(a.B) * a.K;
    T* xo = static_cast<T*>(a.x_out);
    for (long long e = blockIdx.x * kThreads + threadIdx.x; e < total;
         e += static_cast<long long>(gridDim.x) * kThreads)
      xo[e] = X[e];
  }
  dl::rank_sync_exit(c0);
}

template <typename T, int D, int G>
cudaError_t launch_g(PersistentArgs* a, cudaStream_t st, long long* lanes) {
  if (lanes != nullptr)
    return dl::resident_lanes(persistent_decode_kernel<T, D, G>, a->c.n * a->c.groups, kThreads,
                              0, lanes);
  return dl::cooperative_launch(persistent_decode_kernel<T, D, G>, a, &a->c, dl::kMaxLanes, 0,
                                st, kThreads);
}

template <typename T, int D>
cudaError_t launch_d(int G, PersistentArgs* a, cudaStream_t st, long long* lanes) {
  switch (G) {
    case 1: return launch_g<T, D, 1>(a, st, lanes);
    case 2: return launch_g<T, D, 2>(a, st, lanes);
    case 4: return launch_g<T, D, 4>(a, st, lanes);
    case 8: return launch_g<T, D, 8>(a, st, lanes);
    default: return cudaErrorInvalidValue;
  }
}

// One (element type, head dim)'s instantiations, G 1, 2, 4 and 8, each in a
// translation unit of its own (persistent_decode_{bf16,f32}_d{64,128}.cu),
// so that nvcc builds the four quarters in parallel.
cudaError_t launch_bf16_d128(int G, PersistentArgs* a, cudaStream_t st, long long* lanes);
cudaError_t launch_bf16_d64(int G, PersistentArgs* a, cudaStream_t st, long long* lanes);
cudaError_t launch_f32_d128(int G, PersistentArgs* a, cudaStream_t st, long long* lanes);
cudaError_t launch_f32_d64(int G, PersistentArgs* a, cudaStream_t st, long long* lanes);

}  // namespace far
}  // namespace tdt
