// K9, K10, K11: AllGather, ReduceScatter and AllReduce on ranks co-located
// on one Hopper card (sm_90a).
//
// Replace, schedule for schedule (comm/ring.py and the bodies in comm/ hold
// the Python mirrors, which the plain versions walk):
//   K9  triton_distributed_tpu/comm/allgather.py _ag_push_kernel (:80),
//       _ag_ring_kernel (:107), _ag_ring_bidir_kernel (:121), pallas_call :180
//   K10 triton_distributed_tpu/comm/reduce_scatter.py _rs_ring_kernel (:50),
//       pallas_call :128
//   K11 triton_distributed_tpu/comm/allreduce.py _ar_one_shot_kernel (:89),
//       _ar_two_shot_kernel (:131), pallas_call :240
// Each takes from the JAX body which chunk goes to which rank's which offset
// or slot at which step, and which count gates it; the DMA descriptors and
// send semaphores are gone (dl.cuh).  One cooperative launch runs every rank
// of every team of the mesh (blockIdx.y = team * n + rank), each rank with
// the same number of lanes (blockIdx.x), a lane moving one slice of every
// chunk with its own row of flags.
//
// Bound: bytes.  The collectives compute nothing but adds, so on one card
// the least time is the function's bytes through device memory at
// 3.35 TB/s: every rank's input read once and every rank's output written
// once.  The schedules' landing writes and reads (a ring's forwarded chunks,
// the receive and one-shot slots) come on top of that.  The design moves
// 16 bytes a thread per load (ld.global.cg, four in flight) with as many
// lanes as the card holds at once, and fuses each ReduceScatter hop's add
// into its put (no send buffer).  Co-located ranks exchange through device
// memory: NVLink, and the ordering between processes of a multi-card host,
// are not exercised here.
//
// K11's one-shot moves a few KB a rank, so its time is flag latency: it runs
// at device scope (CollArgs::scope 0; scope 1 keeps JAX's entry barrier and
// system-scope flags for the multi-card host), without the entry barrier,
// its n - 1 credits and n - 1 waits each on a thread of their own, and one
// 16-byte unit a thread (ring.cuh one_shot_phase).
//
// K9 runs at device scope the same way (scope 0): no entry barrier (the
// push's hub barrier and the rings' neighbours' barrier are gone, for the
// reason one_shot_phase gives), fences, credits and waits at kGpu, and one
// 16-byte unit a thread, so a gather at the decode width takes a lane or
// two a rank and a large one as many lanes as the card holds at once.  The
// push writes its shard into every rank's out-chunk `me` in one pass, then
// credits each peer and waits on each peer once, a thread each
// (push_each_phase); the rings' first put reads x and writes out-chunk `me`
// here and on the neighbours at once (ag_ring_phase, bidir_ring_phase with
// FROM_X), and every later hop is a chunk forwarded behind its own credit.
// Scope 1 keeps the first design for the multi-card host: the barriers,
// system-scope flags, lanes of at least two units a thread.
#include "ring.cuh"

namespace tdt {
namespace dl {
namespace {

// Lanes that leave each thread at least two units of a chunk (the
// system-scope forms of K9, K10, K11's two-shot); the device-scope forms
// (K9, K11's one-shot), whose time at small sizes is flag latency, not
// bytes, take one unit a thread, as many lanes as that asks for up to what
// the card holds at once.
constexpr long long kMinUnitsPerLane = 2 * kThreads;
constexpr long long kOneShotUnitsPerLane = kThreads;

// K9: the gather copies bytes, so the chunk is counted in bytes and moved in
// units U (16 bytes where every chunk and base allows).  S: CollArgs::scope.
template <typename U, int METHOD, Scope S>
__global__ void __launch_bounds__(kThreads)
    all_gather_kernel(const __grid_constant__ CollArgs a) {
  const Rank c(a);
  long long lo, hi;
  c.slice(sizeof(U), sizeof(U), lo, hi);
  if constexpr (S == kGpu) {
    if constexpr (METHOD == 0) push_each_phase<unsigned char, U>(c, a.out, lo, hi);
    else if constexpr (METHOD == 1)
      ag_ring_phase<unsigned char, U, sizeof(U), NoStep, kGpu, true>(c);
    else
      bidir_ring_phase<unsigned char, U, sizeof(U), NoStep, kGpu, true>(c);
  } else if (METHOD == 0) {
    push_phase<unsigned char, U>(c, a.out, lo, hi);
  } else {
    {  // own shard into out-chunk me (a put to oneself, which nobody waits for)
      U* d = reinterpret_cast<U*>(c.at<unsigned char>(a.out, c.me, c.me));
      copy_units<U>(&d, 1, reinterpret_cast<const U*>(c.at<unsigned char>(a.x, c.me, 0)), lo,
                    hi);
    }
    put_fence();  // out-chunk me is read back by this block's next put
    collective_prologue(c, true);
    if (METHOD == 1) ag_ring_phase<unsigned char, U, sizeof(U)>(c);
    else bidir_ring_phase<unsigned char, U, sizeof(U)>(c);
  }
}

// K10
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    reduce_scatter_kernel(const __grid_constant__ CollArgs a) {
  const Rank c(a);
  collective_prologue(c, true);
  rs_ring_phase<T, T, VEC, false>(c, 0);
  rs_ack_drain(c);
}

// K11; S is the one-shot's scope (CollArgs::scope), the two-shot's is system
template <typename T, typename OT, bool VEC, int METHOD, Scope S = kSys>
__global__ void __launch_bounds__(kThreads)
    all_reduce_kernel(const __grid_constant__ CollArgs a) {
  const Rank c(a);
  if (METHOD == 0) {
    // one-shot: the partial into slot `me` of every peer, then the f32 sum
    // of the n partials in slot order
    long long lo, hi;
    c.slice(Elems<T, VEC>::G, quantum<VEC>(), lo, hi);
    one_shot_phase<T, OT, VEC, S>(c, lo, hi);
  } else {
    // two-shot: the RS ring with its last fold in f32 into out-chunk me,
    // then the AG ring of the reduced chunks
    collective_prologue(c, true);
    rs_ring_phase<T, OT, VEC, true>(c, c.me);
    ag_ring_phase<OT, Unit<OT, VEC>, quantum<VEC>()>(c);
    rs_ack_drain(c);
  }
}

// ---------------------------------------------------------------------------
// host side

bool aligned16(const Peers& p, int ranks) {
  for (int s = 0; s < ranks; ++s)
    if (reinterpret_cast<uintptr_t>(p.p[s]) % 16) return false;
  return true;
}

// One cooperative launch of `kernel`: lanes as many as the chunk's units ask
// for (`per` units a lane), at most what is co-resident.
template <typename K>
cudaError_t launch(K kernel, CollArgs* args, long long units, cudaStream_t st,
                   long long per = kMinUnitsPerLane) {
  return cooperative_launch(kernel, args, args, (units + per - 1) / per, 0, st);
}

template <typename U, Scope S>
cudaError_t gather_scoped(CollArgs* a, cudaStream_t st) {
  const long long units = a->chunk_elems / sizeof(U);
  const long long per = S == kGpu ? kOneShotUnitsPerLane : kMinUnitsPerLane;
  if (a->method == 0) return launch(all_gather_kernel<U, 0, S>, a, units, st, per);
  if (a->method == 1) return launch(all_gather_kernel<U, 1, S>, a, units, st, per);
  if (a->method == 2) return launch(all_gather_kernel<U, 2, S>, a, units, st, per);
  return cudaErrorInvalidValue;
}

template <typename U>
cudaError_t gather_as(CollArgs* a, cudaStream_t st) {
  return a->scope ? gather_scoped<U, kSys>(a, st) : gather_scoped<U, kGpu>(a, st);
}

template <typename T, typename OT, bool VEC>
cudaError_t reduce_as(CollArgs* a, cudaStream_t st) {
  const long long units = a->chunk_elems / Elems<T, VEC>::G;
  if (a->method == 0)
    return a->scope ? launch(all_reduce_kernel<T, OT, VEC, 0, kSys>, a, units, st,
                             kOneShotUnitsPerLane)
                    : launch(all_reduce_kernel<T, OT, VEC, 0, kGpu>, a, units, st,
                             kOneShotUnitsPerLane);
  if (a->method == 1) return launch(all_reduce_kernel<T, OT, VEC, 1>, a, units, st);
  return cudaErrorInvalidValue;
}

template <typename T, typename OT>
cudaError_t reduce_vec(CollArgs* a, bool vec, cudaStream_t st) {
  return vec ? reduce_as<T, OT, true>(a, st) : reduce_as<T, OT, false>(a, st);
}

// 16-byte units when every chunk of x, out and the landing slots is a whole
// number of 16-byte vectors and every base is 16-byte aligned
bool vec_ok(const CollArgs* a, int in_size, int out_size, bool land) {
  const int ranks = a->n * a->groups;
  return a->chunk_elems * in_size % 16 == 0 && a->chunk_elems * out_size % 16 == 0 &&
         aligned16(a->x, ranks) && aligned16(a->out, ranks) && (!land || aligned16(a->land, ranks));
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

volatile int* g_record = nullptr;  // mapped host memory, device-visible
int* g_record_dev = nullptr;

cudaError_t record_words(int** dev) {
  if (!g_record) {
    void* h = nullptr;
    cudaError_t e = cudaHostAlloc(&h, 8 * sizeof(int), cudaHostAllocMapped);
    if (e != cudaSuccess) return e;
    for (int i = 0; i < 8; ++i) static_cast<int*>(h)[i] = 0;
    e = cudaHostGetDevicePointer(reinterpret_cast<void**>(&g_record_dev), h, 0);
    if (e != cudaSuccess) return e;
    g_record = static_cast<volatile int*>(h);
  }
  *dev = g_record_dev;
  return cudaSuccess;
}

}  // namespace dl
}  // namespace tdt

using tdt::dl::CollArgs;

// K9.  args->chunk_elems: elements of one shard (x's per-rank part), of
// args->elsize bytes each, any dtype; method 0 push, 1 ring, 2 two-way ring;
// scope 0 device, 1 system.  Returns the launch's cudaError_t.
extern "C" int tdt_all_gather(CollArgs* args, void* stream) {
  using namespace tdt::dl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long elems = args->chunk_elems;
  args->chunk_elems = elems * args->elsize;  // the kernel counts bytes
  const int ranks = args->n * args->groups;
  const long long bytes = args->chunk_elems;
  const bool al16 = aligned16(args->x, ranks) && aligned16(args->out, ranks);
  cudaError_t e;
  if (bytes % 16 == 0 && al16) e = gather_as<uint4>(args, st);
  else if (bytes % 4 == 0 && al16) e = gather_as<unsigned int>(args, st);
  else e = gather_as<unsigned char>(args, st);
  args->chunk_elems = elems;
  return static_cast<int>(e);
}

// K10.  args->chunk_elems: elements of one output chunk (M / n rows); x holds
// n of them per rank, the landing slots two.  dtype 0 f32, 1 bf16.
extern "C" int tdt_reduce_scatter(CollArgs* args, void* stream) {
  using namespace tdt::dl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (args->dtype != args->out_dtype || args->dtype < 0 || args->dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int es = elem_size(args->dtype);
  const bool vec = vec_ok(args, es, es, true);
  const long long units = args->chunk_elems / (vec ? 16 / es : 1);
  cudaError_t e;
  if (args->dtype == 0)
    e = vec ? launch(reduce_scatter_kernel<float, true>, args, units, st)
            : launch(reduce_scatter_kernel<float, false>, args, units, st);
  else
    e = vec ? launch(reduce_scatter_kernel<tdt::bf16, true>, args, units, st)
            : launch(reduce_scatter_kernel<tdt::bf16, false>, args, units, st);
  return static_cast<int>(e);
}

// K11.  method 0 one-shot (chunk: the whole partial; landing: n slots; scope
// 0 device, 1 system), 1 two-shot (chunk: M / n rows; landing: two slots).
// dtype and out_dtype 0 f32, 1 bf16.
extern "C" int tdt_all_reduce(CollArgs* args, void* stream) {
  using namespace tdt::dl;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (args->dtype < 0 || args->dtype > 1 || args->out_dtype < 0 || args->out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = vec_ok(args, elem_size(args->dtype), elem_size(args->out_dtype), true);
  cudaError_t e;
  if (args->dtype == 0)
    e = args->out_dtype == 0 ? reduce_vec<float, float>(args, vec, st)
                             : reduce_vec<float, tdt::bf16>(args, vec, st);
  else
    e = args->out_dtype == 0 ? reduce_vec<tdt::bf16, float>(args, vec, st)
                             : reduce_vec<tdt::bf16, tdt::bf16>(args, vec, st);
  return static_cast<int>(e);
}

// The record a wait that ran out left: {set, rank, team, mesh slot, lane,
// flag id, value seen, value wanted}, all zero if none.  Reads host memory
// only, so it works after the failed launch has ruined the context.
extern "C" int tdt_coll_wait_record(int* out) {
  for (int i = 0; i < 8; ++i) out[i] = tdt::dl::g_record ? tdt::dl::g_record[i] : 0;
  return 0;
}
