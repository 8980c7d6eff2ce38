// K17: the expert-parallel all-to-all (dispatch and combine) on ranks
// co-located on one Hopper card (sm_90a).
//
// Replaces triton_distributed_tpu/comm/all_to_all.py _a2a_push_kernel (:69),
// pallas_call :144, schedule for schedule (comm/ring.py a2a_push_phase is
// the Python mirror, which the plain versions walk).  Every rank pushes
// counts[dst] rows of its x, starting at row offs[dst], into zone `me` of
// each peer dst's landing buffer, in `chunk`-row puts, the peers in the
// static order of AllToAllConfig.schedule (offset p: dst = me + p mod n);
// each put credits the destination's arrival flag recv[me] (one counting
// flag per source, dl.cuh kRecv + source), then every rank waits for
// ceil(expected[p] / chunk) arrivals from each source p.  Combine is the
// same kernel with the roles swapped (comm/all_to_all.py passes the counts
// it received as the counts it sends, the zone offsets as offs).
//
// The counts, offsets and expected counts are device int32 arrays, read here:
// no count reaches the host.  The grid is sized from the static worst case,
// one full chunk: its bytes cut into lane slices (blockIdx.x), each lane with
// its own row of flags running the whole protocol over its slices; a lane
// loops over the chunks the device counts give and credits every chunk,
// also one whose rows end before its slice.  A put copies exact rows (the
// TPU's chunk-rounded DMAs dragged neighbouring rows into the zone tails;
// here a zone's rows past its count are never written and have no defined
// value).  Rows move as bytes in 16-byte vectors, so bf16, f32 and packed
// u8 rows take the one kernel; row_bytes % 16 != 0 is refused.
//
// The JAX send semaphores and their drain have no counterpart (a put is the
// block's own stores, done when it returns); the entry barrier (the hub
// barrier, lang.collective_prologue) and every arrival count stay, and every
// flag is back at zero after the call.
//
// Bound: bytes.  The function moves each real row once: read once from the
// source, written once into a zone.  Co-located ranks exchange through device
// memory: NVLink is not exercised.
#include "dl.cuh"

namespace tdt {
namespace dl {

// core/symm.py A2aArgs, field for field
struct A2aArgs {
  CollArgs c;            // x: each rank's source rows; out: each rank's zones
  const int* counts;     // (mesh slots, n): rows each rank sends each team peer
  const int* offs;       // (mesh slots, n): first source row of each peer's rows
  const int* expected;   // (mesh slots, n): rows each team peer sends each rank
  long long row_bytes;
  int chunk;             // rows a put
  int z;                 // rows a zone
  int order[kMaxRanks];  // peer offsets in emission order
};

namespace {

constexpr long long kMinUnitsPerLane = 2 * kThreads;

__global__ void __launch_bounds__(kThreads) a2a_push_kernel(const __grid_constant__ A2aArgs a) {
  const Rank c(a.c);
  const int n = c.n();
  const int me_slot = c.slot(c.me);
  const long long row_units = a.row_bytes / 16;
  const long long chunk_units = a.chunk * row_units;
  const long long per_lane = (chunk_units + gridDim.x - 1) / gridDim.x;
  const long long lo = per_lane * c.lane;
  collective_prologue(c, false);
  for (int i = 0; i < n; ++i) {
    const int dst = (c.me + a.order[i]) % n;
    const int rows = a.counts[me_slot * n + dst];
    const long long first = a.offs[me_slot * n + dst];
    const uint4* src = reinterpret_cast<const uint4*>(a.c.x.p[me_slot]) + first * row_units;
    uint4* zone = reinterpret_cast<uint4*>(a.c.out.p[c.slot(dst)]) +
                  static_cast<long long>(c.me) * a.z * row_units;
    for (int ch = 0; ch * a.chunk < rows; ++ch) {
      const long long here = min(a.chunk, rows - ch * a.chunk) * row_units;
      const long long base = static_cast<long long>(ch) * chunk_units;
      uint4* d = zone + base;
      copy_units<uint4>(&d, 1, src + base, lo, min(lo + per_lane, here));
      put_fence();
      credit(c, dst, kRecv + c.me);
    }
  }
  for (int p = 0; p < n; ++p) {
    const int rows = a.expected[me_slot * n + p];
    for (int ch = 0; ch * a.chunk < rows; ++ch) wait(c, kRecv + p, 1);
  }
}

bool aligned16(const Peers& p, int ranks) {
  for (int s = 0; s < ranks; ++s)
    if (reinterpret_cast<uintptr_t>(p.p[s]) % 16) return false;
  return true;
}

}  // namespace
}  // namespace dl
}  // namespace tdt

// K17.  args->c: the source rows (x) and landing zones (out) of every mesh
// slot, the pad, the team layout; row_bytes a multiple of 16, 16-byte aligned
// bases; counts/offs/expected device int32 (mesh slots, n).  Returns the
// launch's cudaError_t.
extern "C" int tdt_all_to_all(tdt::dl::A2aArgs* args, void* stream) {
  using namespace tdt::dl;
  const int ranks = args->c.n * args->c.groups;
  if (args->row_bytes <= 0 || args->row_bytes % 16 || args->chunk < 1 || args->z < args->chunk ||
      ranks > kMaxRanks || !aligned16(args->c.x, ranks) || !aligned16(args->c.out, ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long units = args->chunk * args->row_bytes / 16;
  return static_cast<int>(cooperative_launch(a2a_push_kernel, args, &args->c,
                                             (units + kMinUnitsPerLane - 1) / kMinUnitsPerLane,
                                             0, static_cast<cudaStream_t>(stream)));
}
