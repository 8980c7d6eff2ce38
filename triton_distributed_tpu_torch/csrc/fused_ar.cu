// K15: the fused decode MLP / row-parallel projection + AllReduce on ranks
// co-located on one Hopper card (sm_90a), in one cooperative launch over
// every rank.
//
// Replaces triton_distributed_tpu/ops/fused_decode.py::_fused_mlp_ar_kernel
// (:507, pallas_call :623) in both of its forms:
//   swiglu  AllReduce(act_r @ down_r), act_r = silu(x @ gate_r) * (x @ up_r):
//           the prologue (the gate/up product and SwiGLU) in the kernel,
//           then the ring; x (B, K) is one replicated copy, gate_up_r
//           (K, 2F) rank r's [gate_r | up_r] columns, down_r (F, N).
//   linear  AllReduce(h_r @ w_r): h_r (B, F), w_r (F, N) (the decode
//           o-projection).
// The ring is JAX's column-chunked GEMM + two-shot AllReduce
// (comm/ring.py gemm_rs_chunk_phase, then ag_ring_phase): chunk j is the
// output columns [j cn, (j + 1) cn), cn = N / n; its (B, cn) product is
// made just before the ReduceScatter step that sends it, each hop adds the
// travelling partial in f32 and rounds once, and the AllGather ring returns
// every reduced chunk to every rank.  B is free: the ring cuts columns, not
// rows.  The schedule is comm/ring.py's rs_ring_phase / ag_ring_phase
// (Python mirror ops/fused_decode.py::ar_program, walked by the plain
// versions), the device steps are fused_ar.cuh's.
//
// Rounding follows JAX _mlp_act_host: g and u are f32 sums rounded to the
// output dtype, silu(g) * u is taken in f32 and rounded to it; each chunk
// product is an f32 sum rounded to the output dtype; each hop's add is K10's.
//
// Bound on the H100: bytes.  Qwen3-8B at tp = 4, B = 4: the four ranks'
// gate_up and down are 302 MB (0.090 ms at 3.35 TB/s), the o-projection's
// 33.6 MB (0.010 ms); the flops are 2 B per weight.  Every weight is read
// once a call, with 16-byte loads, by items spread over every lane of every
// rank (fused_ar.cuh); the ring's bytes are B N per hop, small beside them.
// Every lane of a rank meets the others at a rank-wide barrier once per
// product (dl.cuh rank_sync: the chunk's partials come from every lane), so
// a call at n ranks passes n + 2 (swiglu) or n (linear) barriers.
//
// The result is also written once in the (B, N) row layout: rank c's lanes
// copy their slices of its reduced chunk c there, so the caller needs no
// transpose of the chunk-major copies.
#include "fused_ar.cuh"

namespace tdt {
namespace far {

// core/symm.py FusedArArgs, field for field.  c.x: the product entries
// (n chunks of B cn OT per rank); c.out: every rank's reduced chunks (n
// chunks); c.land: the two receive slots; a: the activations (swiglu: x,
// every slot the same copy; linear: h_r (B, F)); w_up: gate_up_r (K, 2F);
// w: down_r / w_r (F, N); act: the SwiGLU output (B, F) of OT per rank;
// part: f32 partials per rank; rows_out: the (B, N) result.
struct FusedArArgs {
  dl::CollArgs c;
  dl::Peers a, w_up, w, act, part;
  void* rows_out;
  int K, F, N;
  Gemv up, dn;
};

template <typename T, typename OT, bool SWIGLU>
__global__ void __launch_bounds__(kThreads) fused_ar_kernel(const __grid_constant__ FusedArArgs g) {
  const dl::Rank c(g.c);
  int gen = 0, parity = 0;
  float* part = reinterpret_cast<float*>(g.part.p[c.slot(c.me)]);
  const T* W = reinterpret_cast<const T*>(g.w.p[c.slot(c.me)]);
  if constexpr (SWIGLU) {
    // the prologue: [g | u] = x @ gate_up_r, then act = silu(g) * u
    const T* x = reinterpret_cast<const T*>(g.a.p[c.slot(c.me)]);
    gemv_lane<T, T>(x, g.K, reinterpret_cast<const T*>(g.w_up.p[c.slot(c.me)]), 2LL * g.F, g.up,
                    part);
    dl::rank_sync(c, gen);
    OT* act = reinterpret_cast<OT*>(g.act.p[c.slot(c.me)]);
    const long long plane = static_cast<long long>(g.up.B) * g.up.cols, total = g.up.B * g.F;
    for (long long e = blockIdx.x * kThreads + threadIdx.x; e < total;
         e += static_cast<long long>(gridDim.x) * kThreads) {
      const long long b = e / g.F, f = e % g.F;
      float gs = 0.f, us = 0.f;
      for (int ks = 0; ks < g.up.n_kslice; ++ks) {
        gs += __ldcg(part + ks * plane + b * g.up.cols + f);
        us += __ldcg(part + ks * plane + b * g.up.cols + g.F + f);
      }
      const float gv = round_to<OT>(gs), uv = round_to<OT>(us);
      act[e] = from_f32<OT>(gv / (1.f + expf(-gv)) * uv);
    }
    dl::rank_sync(c, gen);
    dl::collective_prologue(c, true);
    ar_instance<OT, T, OT>(c, act, g.F, W, g.N, g.dn, part, gen, parity, false);
  } else {
    dl::collective_prologue(c, true);
    ar_instance<T, T, OT>(c, reinterpret_cast<const T*>(g.a.p[c.slot(c.me)]), g.F, W, g.N, g.dn,
                          part, gen, parity, false);
  }
  dl::rs_ack_drain(c);
  // this rank's reduced chunk, in the row layout
  long long lo, hi;
  ring_slice<OT>(c, lo, hi);
  const int cn = g.dn.cols;
  const OT* mine = c.at<OT>(c.a.out, c.me, c.me);
  OT* rows = reinterpret_cast<OT*>(g.rows_out);
  for (long long e = lo + threadIdx.x; e < hi; e += kThreads)
    rows[e / cn * g.N + static_cast<long long>(c.me) * cn + e % cn] = mine[e];
  dl::rank_sync_exit(c);
}

template <typename T, typename OT>
cudaError_t launch_as(FusedArArgs* g, bool swiglu, cudaStream_t st) {
  const long long want = dl::kMaxLanes;
  return swiglu ? dl::cooperative_launch(fused_ar_kernel<T, OT, true>, g, &g->c, want, 0, st,
                                         kThreads)
                : dl::cooperative_launch(fused_ar_kernel<T, OT, false>, g, &g->c, want, 0, st,
                                         kThreads);
}

template <typename T, typename OT>
cudaError_t lanes_as(bool swiglu, int ranks, long long* lanes) {
  return swiglu ? dl::resident_lanes(fused_ar_kernel<T, OT, true>, ranks, kThreads, 0, lanes)
                : dl::resident_lanes(fused_ar_kernel<T, OT, false>, ranks, kThreads, 0, lanes);
}

template <typename T> struct Ty { typedef T type; };

// (dtype, out_dtype) codes: 0 f32, 1 bf16.  Built: bf16 -> bf16, bf16 -> f32,
// f32 -> f32.
template <typename F>
cudaError_t by_dtype(int dt, int ot, F f) {
  if (dt == 1 && ot == 1) return f(Ty<bf16>(), Ty<bf16>());
  if (dt == 1 && ot == 0) return f(Ty<bf16>(), Ty<float>());
  if (dt == 0 && ot == 0) return f(Ty<float>(), Ty<float>());
  return cudaErrorInvalidValue;
}

bool aligned16(const dl::Peers& p, int ranks) {
  for (int s = 0; s < ranks; ++s)
    if (reinterpret_cast<uintptr_t>(p.p[s]) % 16) return false;
  return true;
}

}  // namespace far
}  // namespace tdt

using tdt::far::FusedArArgs;

// K15.  g->c.n >= 2 ranks a team; F, N / n and (swiglu) K multiples of 8;
// every operand 16-byte aligned; g->up / g->dn the products' plans
// (dn.cols = N / n).  swiglu: 1 for the MLP form.  Returns the launch's
// cudaError_t.
extern "C" int tdt_fused_ar(FusedArArgs* g, int swiglu, void* stream) {
  using namespace tdt::far;
  const int ranks = g->c.n * g->c.groups;
  if (g->c.n < 2 || ranks > tdt::dl::kMaxRanks || g->F % 8 || g->N % g->c.n ||
      (g->N / g->c.n) % 8 || (swiglu && g->K % 8) || g->dn.cols != g->N / g->c.n ||
      g->dn.n_kslice < 1 || (swiglu && (g->up.n_kslice < 1 || g->up.cols != 2 * g->F)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(g->w, ranks) || (swiglu && !aligned16(g->w_up, ranks)) ||
      !aligned16(g->c.x, ranks) || !aligned16(g->c.out, ranks) || !aligned16(g->c.land, ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(g->c.dtype, g->c.out_dtype, [&](auto t, auto ot) {
    return launch_as<typename decltype(t)::type, typename decltype(ot)::type>(g, swiglu != 0, st);
  }));
}

// The lanes a K15 launch over `ranks` ranks gets (what is co-resident,
// split among them), for the host's product plans; negative on error.
extern "C" int tdt_fused_ar_lanes(int dtype, int out_dtype, int swiglu, int ranks) {
  using namespace tdt::far;
  long long lanes = 0;
  const cudaError_t e = by_dtype(dtype, out_dtype, [&](auto t, auto ot) {
    return lanes_as<typename decltype(t)::type, typename decltype(ot)::type>(swiglu != 0, ranks,
                                                                           &lanes);
  });
  return e == cudaSuccess ? static_cast<int>(lanes) : -static_cast<int>(e);
}
