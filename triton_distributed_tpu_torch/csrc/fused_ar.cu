// K15: the fused decode MLP / row-parallel projection + AllReduce on ranks
// co-located on one Hopper card (sm_90a), in one cooperative launch over
// every rank.  Its linear form also serves K14 (GEMM-AllReduce,
// ops/gemm_ar.py) at decode sizes.
//
// Replaces triton_distributed_tpu/ops/fused_decode.py::_fused_mlp_ar_kernel
// (:507, pallas_call :623) in both of its forms:
//   swiglu  AllReduce(act_r @ down_r), act_r = silu(x @ gate_r) * (x @ up_r):
//           the prologue (the gate/up product and SwiGLU) in the kernel,
//           then the reduction; x (B, K) is one replicated copy, gate_up_r
//           (K, 2F) rank r's [gate_r | up_r] columns, down_r (F, N).
//   linear  AllReduce(h_r @ w_r): h_r (B, F), w_r (F, N) (the decode
//           o-projection).
// The reduction takes one of two forms, chosen on the host by the size rule
// of K11 (comm/allreduce.py choose_method on the (B, N) partial's bytes)
// and passed as c.method:
//   0 one-shot (decode sizes): the whole (B, N) product in one pass over the
//     weight by every lane of the rank (each work item's rows of A staged in
//     shared memory), one rank-wide barrier, each lane's slice rounded once
//     and pushed into slot `me` of every rank, the n slots summed in slot
//     order in f32 and rounded once (fused_ar.cuh oneshot_instance; Python
//     mirror ops/fused_decode.py::oneshot_program, the product then
//     comm/allreduce.py::one_shot_program).  The exchange's flags and fences
//     are at device scope: every rank is a block of this launch on this
//     card.  Every rank's copy is written to c.out, (B, N) per rank.
//   1 ring: JAX's column-chunked GEMM + two-shot AllReduce (comm/ring.py
//     gemm_rs_chunk_phase, then ag_ring_phase): chunk j is the output
//     columns [j cn, (j + 1) cn), cn = N / n; its (B, cn) product is made
//     just before the ReduceScatter step that sends it, each hop adds the
//     travelling partial in f32 and rounds once, and the AllGather ring
//     returns every reduced chunk to every rank (Python mirror
//     ops/fused_decode.py::ar_program).  The result is written once in the
//     (B, N) row layout (rows_out): rank c's lanes copy their slices of its
//     reduced chunk c there.  K16 runs this form.
// B is free in both.
//
// Rounding follows JAX _mlp_act_host: g and u are f32 sums rounded to the
// output dtype, silu(g) * u is taken in f32 and rounded to it; each product
// (the whole partial, or a chunk) is an f32 sum rounded to the output dtype;
// the one-shot's slot sum is K11's, each ring hop's add is K10's.
//
// Bound on the H100: bytes.  Qwen3-8B at tp = 4, B = 4: the four ranks'
// gate_up and down are 302 MB (0.090 ms at 3.35 TB/s), the o-projection's
// 33.6 MB (0.010 ms); the flops are 2 B per weight.  Every weight is read
// once a call, with 16-byte loads, by items spread over every lane of every
// rank (fused_ar.cuh); the exchange moves B N per rank and peer, small
// beside them.  Every lane of a rank meets the others at a rank-wide barrier
// once per product (dl.cuh rank_sync: the partial comes from every lane):
// the one-shot passes 3 (swiglu) or 1 (linear) and one hop; the ring n + 2
// or n, and 2 (n - 1) hops, each product a quarter of the weight (n = 4)
// made between two of them.
#include "fused_ar.cuh"

namespace tdt {
namespace far {

// core/symm.py FusedArArgs, field for field.  c.x: the product entries
// (one-shot: one (B, N) partial of OT per rank; ring: n chunks of B cn);
// c.out: every rank's result (one-shot: (B, N) per rank; ring: the n
// reduced chunks); c.land: the receive slots (one-shot: n partials; ring:
// two chunks); a: the activations (swiglu: x, every slot the same copy;
// linear: h_r (B, F)); w_up: gate_up_r (K, 2F); w: down_r / w_r (F, N);
// act: the SwiGLU output (B, F) of OT per rank; part: f32 partials per
// rank; rows_out: the ring's (B, N) result; up, dn: the products' plans
// (dn.cols = N one-shot, N / n ring).
struct FusedArArgs {
  dl::CollArgs c;
  dl::Peers a, w_up, w, act, part;
  void* rows_out;
  int K, F, N;
  Gemv up, dn;
};

// AllReduce(A @ W) on this rank's activations A (B, F), in the launch's form.
template <typename TA, typename T, typename OT, bool ONESHOT>
__device__ void reduce_product(const FusedArArgs& g, const dl::Rank& c, const TA* A, float* part,
                               int& gen) {
  const T* W = reinterpret_cast<const T*>(g.w.p[c.slot(c.me)]);
  if constexpr (ONESHOT) {
    oneshot_instance<TA, T, OT>(c, A, g.F, W, g.N, g.dn, part, gen);
  } else {
    int parity = 0;
    dl::collective_prologue(c, true);
    ar_instance<TA, T, OT>(c, A, g.F, W, g.N, g.dn, part, gen, parity, false);
    dl::rs_ack_drain(c);
    // this rank's reduced chunk, in the row layout
    long long lo, hi;
    ring_slice<OT>(c, lo, hi);
    const int cn = g.dn.cols;
    const OT* mine = c.at<OT>(c.a.out, c.me, c.me);
    OT* rows = reinterpret_cast<OT*>(g.rows_out);
    for (long long e = lo + threadIdx.x; e < hi; e += kThreads)
      rows[e / cn * g.N + static_cast<long long>(c.me) * cn + e % cn] = mine[e];
  }
}

template <typename T, typename OT, bool SWIGLU, bool ONESHOT>
__global__ void __launch_bounds__(kThreads) fused_ar_kernel(const __grid_constant__ FusedArArgs g) {
  const dl::Rank c(g.c);
  int gen = 0;
  float* part = reinterpret_cast<float*>(g.part.p[c.slot(c.me)]);
  if constexpr (SWIGLU) {
    // the prologue: [g | u] = x @ gate_up_r, then act = silu(g) * u
    const T* x = reinterpret_cast<const T*>(g.a.p[c.slot(c.me)]);
    gemv_lane<T, T, ONESHOT>(x, g.K, reinterpret_cast<const T*>(g.w_up.p[c.slot(c.me)]),
                             2LL * g.F, g.up, part);
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
    reduce_product<OT, T, OT, ONESHOT>(g, c, act, part, gen);
  } else {
    reduce_product<T, T, OT, ONESHOT>(g, c, reinterpret_cast<const T*>(g.a.p[c.slot(c.me)]), part,
                                      gen);
  }
  dl::rank_sync_exit(c);
}

template <typename T, typename OT, bool SWIGLU, bool ONESHOT>
struct Form {
  static cudaError_t launch(FusedArArgs* g, cudaStream_t st) {
    return dl::cooperative_launch(fused_ar_kernel<T, OT, SWIGLU, ONESHOT>, g, &g->c,
                                  dl::kMaxLanes, 0, st, kThreads);
  }
  static cudaError_t lanes(int ranks, long long* out) {
    return dl::resident_lanes(fused_ar_kernel<T, OT, SWIGLU, ONESHOT>, ranks, kThreads, 0, out);
  }
};

// f(Form<T, OT, swiglu, oneshot>()) for the runtime form
template <typename T, typename OT, typename F>
cudaError_t by_form(bool swiglu, bool oneshot, F f) {
  if (swiglu) return oneshot ? f(Form<T, OT, true, true>()) : f(Form<T, OT, true, false>());
  return oneshot ? f(Form<T, OT, false, true>()) : f(Form<T, OT, false, false>());
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

// The two forms' codes in c.method (comm/allreduce.py _CODES)
constexpr int kOneShot = 0, kRing = 1;

// K15.  g->c.n >= 2 ranks a team; g->c.method 0 one-shot, 1 ring; F and
// (swiglu) K multiples of 8; one-shot: N a multiple of 8, dn.cols = N,
// c.chunk_elems = B N, the plans' k_chunk at most kStageRows; ring: N / n a
// multiple of 8, dn.cols = N / n, c.chunk_elems = B N / n; every operand
// 16-byte aligned; g->up / g->dn the products' plans.  swiglu: 1 for the
// MLP form.  Returns the launch's cudaError_t.
extern "C" int tdt_fused_ar(FusedArArgs* g, int swiglu, void* stream) {
  using namespace tdt::far;
  const int ranks = g->c.n * g->c.groups;
  const bool oneshot = g->c.method == kOneShot;
  const int cols = oneshot ? g->N : g->N / g->c.n;
  if (g->c.n < 2 || ranks > tdt::dl::kMaxRanks || (!oneshot && g->c.method != kRing) ||
      g->F % 8 || (!oneshot && g->N % g->c.n) || cols % 8 || (swiglu && g->K % 8) ||
      g->dn.cols != cols || g->c.chunk_elems != static_cast<long long>(g->dn.B) * cols ||
      g->dn.n_kslice < 1 || (swiglu && (g->up.n_kslice < 1 || g->up.cols != 2 * g->F)) ||
      (oneshot && (g->dn.k_chunk > kStageRows || (swiglu && g->up.k_chunk > kStageRows))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(g->w, ranks) || (swiglu && !aligned16(g->w_up, ranks)) ||
      !aligned16(g->c.x, ranks) || !aligned16(g->c.out, ranks) || !aligned16(g->c.land, ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(g->c.dtype, g->c.out_dtype, [&](auto t, auto ot) {
    return by_form<typename decltype(t)::type, typename decltype(ot)::type>(
        swiglu != 0, oneshot, [&](auto form) { return decltype(form)::launch(g, st); });
  }));
}

// The lanes a K15 launch of the given form (method 0 one-shot, 1 ring) over
// `ranks` ranks gets (what is co-resident, split among them), for the
// host's product plans; negative on error.
extern "C" int tdt_fused_ar_lanes(int dtype, int out_dtype, int swiglu, int method, int ranks) {
  using namespace tdt::far;
  long long lanes = 0;
  const cudaError_t e = by_dtype(dtype, out_dtype, [&](auto t, auto ot) {
    return by_form<typename decltype(t)::type, typename decltype(ot)::type>(
        swiglu != 0, method == kOneShot,
        [&](auto form) { return decltype(form)::lanes(ranks, &lanes); });
  });
  return e == cudaSuccess ? static_cast<int>(lanes) : -static_cast<int>(e);
}
