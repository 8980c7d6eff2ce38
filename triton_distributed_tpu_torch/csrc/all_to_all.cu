// K17: the expert-parallel all-to-all (dispatch and combine) on ranks
// co-located on one Hopper card (sm_90a).
//
// Replaces triton_distributed_tpu/comm/all_to_all.py _a2a_push_kernel (:69),
// pallas_call :144.  What moves where is JAX's (comm/ring.py a2a_push_phase
// is the rank-level schedule, which the plain versions walk): every rank
// pushes counts[dst] rows of its x, starting at row offs[dst], into zone `me`
// of each peer dst's landing buffer, the peers in the static order of
// AllToAllConfig.schedule (offset p: dst = me + p mod n), its own zone
// included.  Combine is the same kernel with the roles swapped
// (comm/all_to_all.py passes the counts it received as the counts it sends,
// the zone offsets as offs).
//
// How it moves them is Hopper's, and departs from JAX's one credit per
// `chunk`-row put (comm/lanes.py walks it lane by lane):
// - The lanes (blockIdx.x) are as many as the card holds at once, capped
//   by the static worst case, a zone of z rows from one source with four
//   16-byte vectors a thread (the counts stay on the device, so the host
//   sizes the grid without them).  Each lane copies a contiguous share of
//   the rows to each destination (zero, for a lane past a small count).
// - One fence and one credit per (lane, destination), after the lane's whole
//   share, a share of zero rows included; each on a thread of its own
//   (credit_each).  The receiving lane then waits exactly once per source
//   on its own row's recv[source] (wait_each), whatever the counts:
//   `expected` no longer sets the number of waits.  AllToAllConfig.chunk
//   keeps its meaning for the zones (zone_geometry), so the layout and the
//   plain version do not change.
// - Device scope (CollArgs::scope 0) for the fences, credits, waits and
//   drains, and no entry barrier: every rank is a block of this one launch,
//   and the previous call's launch finished on the same stream before this
//   one began (a captured graph keeps that order), so no zone is still being
//   read and every flag is at zero.  Scope 1 (the multi-card host, where a
//   peer is another process) keeps JAX's hub barrier (lang.collective_
//   prologue) and system-scope flags, in the same kernel.
// A put copies exact rows (the TPU's chunk-rounded DMAs dragged neighbouring
// rows into the zone tails; here a zone's rows past its count are never
// written and have no defined value).  Rows move as bytes in 16-byte
// vectors, so bf16, f32 and packed u8 rows take the one kernel; row_bytes %
// 16 != 0 is refused.  The waits are bounded (dl.cuh), and every flag is back
// at zero after the call.
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
  long long row_bytes;
  int z;                 // rows a zone
  int order[kMaxRanks];  // peer offsets in emission order
};

namespace {

// Lanes that leave each thread four 16-byte vectors of a full zone.
constexpr long long kUnitsPerLane = 4 * kThreads;

template <Scope S>
__global__ void __launch_bounds__(kThreads) a2a_push_kernel(const __grid_constant__ A2aArgs a) {
  const Rank c(a.c);
  const int n = c.n();
  const int me_slot = c.slot(c.me);
  const long long row_units = a.row_bytes / 16;
  if constexpr (S == kSys) collective_prologue<S>(c, false);
  for (int i = 0; i < n; ++i) {
    const int dst = (c.me + a.order[i]) % n;
    const long long units = a.counts[me_slot * n + dst] * row_units;
    const long long per = (units + gridDim.x - 1) / gridDim.x;
    const uint4* src = reinterpret_cast<const uint4*>(a.c.x.p[me_slot]) +
                       a.offs[me_slot * n + dst] * row_units;
    uint4* zone = reinterpret_cast<uint4*>(a.c.out.p[c.slot(dst)]) +
                  static_cast<long long>(c.me) * a.z * row_units;
    copy_units<uint4>(&zone, 1, src, min(units, per * c.lane), min(units, per * (c.lane + 1)));
  }
  credit_each<S>(c, -1);
  wait_each<S>(c, -1);
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
// slot, the pad, the team layout, the scope; row_bytes a multiple of 16,
// 16-byte aligned bases; counts/offs device int32 (mesh slots, n).  Returns
// the launch's cudaError_t.
extern "C" int tdt_all_to_all(tdt::dl::A2aArgs* args, void* stream) {
  using namespace tdt::dl;
  const int ranks = args->c.n * args->c.groups;
  if (args->row_bytes <= 0 || args->row_bytes % 16 || args->z < 1 || ranks > kMaxRanks ||
      !aligned16(args->c.x, ranks) || !aligned16(args->c.out, ranks))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (args->z * (args->row_bytes / 16) + kUnitsPerLane - 1) / kUnitsPerLane;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      args->c.scope ? cooperative_launch(a2a_push_kernel<kSys>, args, &args->c, want, 0, st)
                    : cooperative_launch(a2a_push_kernel<kGpu>, args, &args->c, want, 0, st));
}
