// K16: the persistent decode kernel on ranks co-located on one Hopper card
// (sm_90a): every layer of a dense Qwen3 decode step, for every rank, in one
// cooperative launch.
//
// Replaces triton_distributed_tpu/ops/persistent_decode.py::
// _persistent_decode_kernel (:368, pallas_call :592).  Per layer l and rank
// r, as the JAX body: RMSNorm; the qkv product, qk-RMSNorm, RoPE, the
// token's in-place append into layer l's pages and the block-table flash
// decode with the token folded in (K4's stages, fused_stages.cuh); the
// o-projection's AllReduce instance (fused_ar.cuh ar_instance, K15's ring);
// the residual; RMSNorm; the gate/up product and SwiGLU; the down
// projection's instance; the residual.  Embed, the final norm, the lm_head
// and the argmax stay outside, as in JAX's _persistent_step.
//
// Co-residency.  One cooperative launch of n ranks x `lanes` blocks of 128
// threads, sized by the occupancy API, so every block is resident and every
// spin wait is safe.  Each stage deals its work items to the rank's lanes in
// turn; a stage that reads what other lanes wrote comes after a rank-wide
// barrier (dl.cuh rank_sync): x before each RMSNorm, h before each product,
// the projection partials before their finalize, q/k/v before attention,
// the split states before their merge, the attention output before the
// o-projection, the gate/up partials before SwiGLU, act before the down
// projection, and each chunk's partials before its ring step.  A layer
// passes 2n + 10 of them (ar_instance: one a chunk), 12 at n = 1.
//
// The chain of 2L ring instances shares one set of flags.  Instance j + 1
// first takes instance j's outstanding ACK credits (JAX _chained_ar's armed
// wait), and one rs_ack_drain runs at exit, so every flag is back at zero
// when the launch ends (and rank_sync_exit clears the barrier's counters).
// The reduced chunks (c.out) are double-buffered by instance parity: a peer's
// AllGather put of instance j + 2 lands only after that peer's armed wait of
// j + 2 took this rank's ACK credits of instance j + 1, which this rank's
// lanes give in instance j + 1's ReduceScatter, after the barrier of its
// first product, which no lane passes before every lane of the rank has
// read instance j's chunks into its residual.  (With one buffer, instance
// j + 1's puts would be gated only by credits of instance j, given before
// the residual of instance j reads them.)
//
// The append: layer l's token goes into layer l's pages in place
// (finalize_tile), at (table[b, min(pos / ps, mp - 1)], pos % ps); the same
// layer's attention reads the prefix [0, pos) from the pool and folds the
// token in from scratch (combine_fold), never from the page it wrote.
// Weights are read through the layer table (per layer: ln1, wqkv, q_norm,
// k_norm, wo, ln2, gate_up, down, each rank-stacked at a per-kind stride):
// nothing is copied.
//
// Bound on the H100: bytes.  Qwen3-8B at tp = 4, B = 4: the step's weights
// (36 x 385.9 MB = 13.89 GB) and the KV prefix (0.62 GB at position 1056),
// ~4.3 ms at 3.35 TB/s.  Each weight is read once a step with 16-byte loads
// by items spread over every lane; what this first form spends beyond that
// is in the barriers and the lanes a stage leaves idle (RMSNorm: B rows).
#include "persistent_decode.cuh"

namespace tdt {
namespace far {

// The instantiations live in four sources, one per element type and head
// dim (persistent_decode_{bf16,f32}_d{64,128}.cu), built in parallel.
cudaError_t dispatch(int D, int G, PersistentArgs* a, cudaStream_t st, long long* lanes) {
  if (a->c.dtype == 1 && D == 128) return launch_bf16_d128(G, a, st, lanes);
  if (a->c.dtype == 1 && D == 64) return launch_bf16_d64(G, a, st, lanes);
  if (a->c.dtype == 0 && D == 128) return launch_f32_d128(G, a, st, lanes);
  if (a->c.dtype == 0 && D == 64) return launch_f32_d64(G, a, st, lanes);
  return cudaErrorInvalidValue;
}

}  // namespace far
}  // namespace tdt

using tdt::far::PersistentArgs;

TDT_STAMPS_ENTRY(tdt_persistent_stamps)

// K16.  One decode step of every layer for every rank (n = a->c.n >= 1, one
// team).  D: head dim (64, 128); G: query heads per kv head (1, 2, 4, 8).
// The host sizes the plans (ops/persistent_decode.py) from
// tdt_persistent_lanes.  Returns the launch's cudaError_t.
extern "C" int tdt_persistent_decode(PersistentArgs* a, int D, int G, void* stream) {
  if (a->c.n < 1 || a->c.groups != 1 || a->c.n > tdt::dl::kMaxRanks || a->K % a->c.n ||
      (a->K / a->c.n) % 8 || a->F % 8 || a->o.cols != a->K / a->c.n ||
      a->dn.cols != a->K / a->c.n || a->up.cols != 2 * a->F)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      tdt::far::dispatch(D, G, a, static_cast<cudaStream_t>(stream), nullptr));
}

// The lanes a K16 launch of (D, G, dtype) over n ranks gets; negative on
// error.
extern "C" int tdt_persistent_lanes(int D, int G, int dtype, int n) {
  PersistentArgs a{};
  a.c.n = n;
  a.c.groups = 1;
  a.c.dtype = dtype;
  long long lanes = 0;
  const cudaError_t e = tdt::far::dispatch(D, G, &a, nullptr, &lanes);
  return e == cudaSuccess ? static_cast<int>(lanes) : -static_cast<int>(e);
}
