// K16's served form: the persistent decode kernel for bf16 at head dim 128
// and B <= 4 (Qwen3-8B at tp = 1, and at tp = 4 with 2 kv heads a rank), on
// ranks co-located on one Hopper card (sm_90a).  Every layer of a dense
// Qwen3 decode step, for every rank, in one cooperative launch.  The f32 and
// head dim 64 forms keep persistent_decode.cu's body.
//
// Replaces triton_distributed_tpu/ops/persistent_decode.py::
// _persistent_decode_kernel (:368, pallas_call :592), and computes what it
// computes: per layer and rank the RMSNorm, the qkv product, qk-RMSNorm,
// RoPE, the in-place append, block-table flash decode with the token folded
// in, the o-projection's AllReduce, the residual, the RMSNorm, gate/up and
// SwiGLU, the down projection's AllReduce and the residual.
//
// Bound on the H100: bytes.  Qwen3-8B at B = 4 streams 385.9 MB of weights a
// layer (13.9 GB a step) and the KV prefix (0.62 GB at position 1056): ~4.3
// ms at 3.35 TB/s.  The design is about keeping every SM's loads in flight:
//
// - One weight stream per thread.  Persistent blocks of 256 threads, two an
//   SM.  Each thread keeps kStages - 1 16-byte cp.async loads of weight in
//   flight in a ring of its own in shared memory (32 KB a block), and the
//   ring is fed in the order the block will read it over every product of
//   every layer: at a stage's end, its barrier or the attention cell, the
//   next product's first loads are already on their way.  A thread reads back
//   only what it loaded itself, so the ring needs no block barrier.  (A
//   product streams at 3.1 TB/s on an H100 this way; the loop has no spill.)
// - Every lane streams the same bytes.  A product's output columns are cut
//   into tiles of 128 (a qkv head; 64 gate columns and their 64 up columns),
//   each over the whole depth, in passes of 16 rows; the passes of all tiles
//   are laid end to end and cut into one run per lane (stream-K).  A tile cut
//   between lanes is summed by the last of its lanes to arrive, in lane order,
//   from f32 partials of 2 KB a lane in L2 (a ticket a tile), so no pass over
//   split-K planes and no barrier between a product and its epilogue.
// - A's rows (B <= 4) that the lane's run needs are staged in shared memory
//   as bf16 (the values are bf16 already) once, before its first pass, 8 rows
//   of all four sequences a thread (64 contiguous bytes); RMSNorm is applied
//   as they are staged, each block taking the norm of x itself from L2 (32
//   KB), so no norm stage and no barrier before a product.  FMAs on CUDA
//   cores: 32 a 16-byte weight load.
// - The small stages fold into the products' epilogues: qk-RMSNorm, RoPE and
//   the append in the block that ends a head's tile, SwiGLU in the gate/up
//   tile's, the residual add in o's and down's, at n = 1 straight into x.
// - The attention cell needs no barrier before it: its (sequence, kv head,
//   split) items wait on a count of the kv head's finished qkv tiles; splits
//   are cut from the length on the card; the last split to arrive (a ticket)
//   merges the states and folds the token in.
// - So a layer passes 4 rank-wide barriers (dl.cuh rank_sync): after the
//   attention cell, o, gate/up and down; a step 1 + 4 L (145 at 36 layers,
//   against 1 + (10 + 2n) L for persistent_decode.cu's body).
// - At n > 1 each o and down tile is one device-scope one-shot exchange (K15's
//   form, fused_ar.cuh oneshot_instance): the block that ends tile t pushes
//   its rounded partial into slot `me` of tile t on every rank's landing,
//   credits each rank's arrival count of tile t, waits for n arrivals of its
//   own and sums the n slots in slot order in f32, rounded once, into x.
//
// Landing slots are double-buffered by instance parity (o of layer l is
// instance 2l, down 2l + 1).  A peer pushes instance j + 2 into the slots of
// instance j only after its own barrier after instance j + 1, which it passes
// only once every tile of j + 1 has n arrivals there, this rank's included;
// this rank pushes anything of j + 1 only after its barrier after instance j,
// which no lane passes before every tile of j has been summed.  With one
// buffer, a peer could push j + 1 into a slot this rank has not summed for j
// (its arrivals of j need only this rank's pushes of j, not its sums).  The
// arrival counts, tickets and head counts only grow during a launch; the
// lanes clear them after its last barrier, when every peer's last credit has
// been counted, so the pad is at rest after every launch.
#include "persistent_decode_v2.cuh"

using tdt::pd2::StreamArgs;

TDT_STAMPS_ENTRY(tdt_persistent_v2_stamps)

namespace {

cudaError_t dispatch(int G, StreamArgs* a, cudaStream_t st, long long* lanes) {
  switch (G) {
    case 4: return tdt::pd2::launch_g<4>(a, st, lanes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K16's served form: one decode step of every layer for every rank (n =
// a->c.n >= 1, one team), bf16, head dim 128, G query heads a kv head (4).
// The host sizes the regions (ops/persistent_decode.py) from
// tdt_persistent_v2_lanes.  Returns the launch's cudaError_t.
extern "C" int tdt_persistent_v2(StreamArgs* a, int G, void* stream) {
  using namespace tdt::pd2;
  const int tiles_qkv = a->hk * (G + 2);
  if (a->c.n < 1 || a->c.groups != 1 || a->c.n > tdt::dl::kMaxRanks || a->c.dtype != 1 ||
      a->B < 1 || a->B > kMaxB || a->K % kD || a->F % 64 || a->K / kD > kReady - kArrive ||
      a->hk > kSplitTicket - kReady || a->B * a->hk > kTicket - kSplitTicket ||
      a->F / 64 > kTicketStride || tiles_qkv > kTicketStride || a->n_split < 1 ||
      a->n_split > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(G, a, static_cast<cudaStream_t>(stream), nullptr));
}

// The lanes a rank gets in a launch of the served form over n ranks;
// negative on error.
extern "C" int tdt_persistent_v2_lanes(int G, int n) {
  StreamArgs a{};
  a.c.n = n;
  a.c.groups = 1;
  long long lanes = 0;
  const cudaError_t e = dispatch(G, &a, nullptr, &lanes);
  return e == cudaSuccess ? static_cast<int>(lanes) : -static_cast<int>(e);
}
