// The device vocabulary of the collectives: signal, wait, put, barriers.
//
// Counterpart of triton_distributed_tpu/lang/primitives.py, whose host-side
// mirror is triton_distributed_tpu_torch/lang/primitives.py.  A mesh's ranks
// are co-located on one card: every rank owns its buffers in device memory,
// and a peer's buffer is addressed through a table of base addresses, one
// per mesh slot (Peers), passed by value in the launch.  The code below knows
// only that table and a rank, so a host that runs one process per card and
// fills the table with peer addresses over NVLink changes no device code.
// Co-located ranks exchange through device memory: NVLink is not exercised.
//
// One launch carries every rank of every team of the mesh: blockIdx.y is
// group * n + rank, and blockIdx.x is the lane.  Each chunk is cut into
// gridDim.x slices; block b of every rank (lane b) moves slice b of every
// chunk, so a lane runs the whole protocol on its slices, with its own row
// of flags.  The launch is cooperative (grid sized to what is co-resident):
// a block that spins on a flag can then never keep the block it waits for
// from running.
//
// Flags are int32 counts (the TPU's counting semaphores):
//   notify(f)       a release atomic add of one at system scope (.sys, so
//                   that it also holds for NVLink peers; no schedule here
//                   credits more than one at a time);
//   wait(f, v)      an acquire spin until f >= v, then f -= v, so every count
//                   is back at zero when the protocol's drains are done.
// These two, the put's fence and the barriers built on them take the
// memory scope as a template argument: system (kSys) unless a kernel asks
// for device scope (kGpu), which is enough where every rank is a block of
// the one launch on this card, as in K14's and K15's one-shot exchange, and
// in K9, K11's one-shot and K17 unless CollArgs::scope asks for system scope.
// On an H100 a system-scope release costs microseconds a notify (a hub
// barrier of four ranks took 11-19 us at system scope, ~3 us at device
// scope).
// A wait is bounded: after kWaitNs of %globaltimer it records (rank, flag,
// value seen, value wanted) in mapped host memory and traps, which fails the
// launch; a protocol bug fails the run by name instead of hanging it.
//
// put: a block-cooperative 16-byte vectorized copy (or fused add) into a
// peer's buffer, then a fence.  The block's own stores make the put, and they
// are done when it returns, so the JAX package's send semaphores (wait_send)
// have no counterpart here; every receive count and ACK credit stays.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {
namespace dl {

constexpr int kMaxRanks = 8;
constexpr int kFlagsPerLane = 32;           // lang/primitives.py FLAGS_PER_LANE
constexpr int kMaxLanes = 2048;             // core/symm.py MAX_LANES
constexpr int kThreads = 256;
constexpr unsigned long long kWaitNs = 2000000000ull;  // ~2 s

// A lane's row of flags (lang/primitives.py FLAG_IDS)
constexpr int kBarrier = 0;
constexpr int kRsRecv = 1;   // + slot (0, 1): the ReduceScatter ring's arrivals
constexpr int kAck = 3;      // + slot: consumption credits of those slots
// Rank-wide barrier counters, in lane 0's row only (rank_sync)
constexpr int kSyncArrive = 5;
constexpr int kSyncLeave = 6;
constexpr int kRecv = 8;     // + chunk or one-shot slot: arrivals
// K12's per-chunk counts of lanes whose slice is here, and the count of
// lanes past their last read of them, in lane 0's row only
constexpr int kReady = 16;   // + chunk
constexpr int kReadyLeave = 24;
// K13's per-tile arrival flags: the second half of a rank's pad (lanes of
// K12/K13 stay below kMaxLanes / 2), one flag per (hop, tile); a wait that
// runs out records kTileId + the flag's index
constexpr int kTileFlagBase = kMaxLanes / 2 * kFlagsPerLane;
constexpr int kTileFlags = kMaxLanes * kFlagsPerLane - kTileFlagBase;
constexpr int kTileId = 1 << 16;

struct Peers {
  char* p[kMaxRanks];  // base address, per mesh slot
};

// core/symm.py CollArgs, field for field
struct CollArgs {
  Peers x, out, land, flags;
  int* record;            // mapped host words of a wait that ran out
  long long chunk_elems;  // elements of one chunk (every put moves one)
  int n, groups;
  int slot[kMaxRanks];    // slot[g * n + r]: mesh slot of rank r of team g
  int method, dtype, out_dtype, elsize;
  int stall_rank;         // tests only: this rank credits no arrival
  int scope;              // K9, K11's one-shot and K17: 0 device scope (every rank
                          // a block of the one launch on this card), 1 system
                          // scope (the multi-card host); other kernels fix theirs
};

// one claim per module: the first wait that runs out writes the record
static __device__ int g_timeout_claimed;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The memory scope of a protocol's flags and fences.
enum Scope { kSys, kGpu };

template <Scope S = kSys>
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  if constexpr (S == kSys)
    asm volatile("ld.acquire.sys.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <Scope S = kSys>
__device__ __forceinline__ void red_release_add(int* p, int v) {
  if constexpr (S == kSys)
    asm volatile("red.release.sys.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  else
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One rank's view of the launch: who it is, and its lane's slice of a chunk.
struct Rank {
  const CollArgs& a;
  int me, group, lane;

  __device__ Rank(const CollArgs& args)
      : a(args), me(blockIdx.y % args.n), group(blockIdx.y / args.n),
        lane(blockIdx.x) {}

  __device__ int n() const { return a.n; }
  __device__ int slot(int r) const { return a.slot[group * a.n + r]; }
  __device__ int left() const { return (me + a.n - 1) % a.n; }
  __device__ int right() const { return (me + 1) % a.n; }
  __device__ int* flag(int r, int id) const {
    return reinterpret_cast<int*>(a.flags.p[slot(r)]) + lane * kFlagsPerLane + id;
  }
  // entry `index` (a chunk or a slot) of rank r's buffer, as T
  template <typename T>
  __device__ T* at(const Peers& buf, int r, int index) const {
    return reinterpret_cast<T*>(buf.p[slot(r)]) + index * a.chunk_elems;
  }
  // [lo, hi) of this lane's slice of a chunk, in units of `per` elements.
  // Lanes cut the chunk at multiples of `quantum` elements (a multiple of
  // every unit in use), so phases that move different units (the two-shot's
  // T-typed ring and OT-typed gather) give a lane the same elements.
  __device__ void slice(int per, int quantum, long long& lo, long long& hi) const {
    const long long groups = (a.chunk_elems + quantum - 1) / quantum;
    const long long per_lane = (groups + gridDim.x - 1) / gridDim.x * quantum;
    lo = min(a.chunk_elems, per_lane * lane) / per;
    hi = min(a.chunk_elems, per_lane * (lane + 1)) / per;
  }
};

static __device__ __noinline__ void timed_out(const Rank& c, int id, int seen, int want) {
  if (atomicCAS(&g_timeout_claimed, 0, 1) == 0) {
    volatile int* rec = c.a.record;
    rec[1] = c.me;
    rec[2] = c.group;
    rec[3] = c.slot(c.me);
    rec[4] = c.lane;
    rec[5] = id;
    rec[6] = seen;
    rec[7] = want;
    __threadfence_system();
    rec[0] = 1;
    __threadfence_system();
  }
  __trap();
}

// Credit rank r's flag `id` (this lane's row) by one, once every thread of
// the block is done with what the credit announces.
template <Scope S = kSys>
__device__ __forceinline__ void notify(const Rank& c, int r, int id) {
  __syncthreads();
  if (threadIdx.x == 0) red_release_add<S>(c.flag(r, id), 1);
}

// The calling thread spins until one's own flag `id` reaches v, then takes
// v off it (bounded: a wait that runs out records and traps).
template <Scope S = kSys>
__device__ __forceinline__ void take(const Rank& c, int id, int v) {
  int* f = c.flag(c.me, id);
  int seen = ld_acquire<S>(f);
  if (seen < v) {
    const unsigned long long t0 = globaltimer();
    while ((seen = ld_acquire<S>(f)) < v) {
      if (globaltimer() - t0 > kWaitNs) timed_out(c, id, seen, v);
      __nanosleep(32);
    }
  }
  if constexpr (S == kSys) atomicSub_system(f, v);
  else atomicSub(f, v);
}

// Wait until one's own flag `id` reaches v, then take v off it.
template <Scope S = kSys>
__device__ __forceinline__ void wait(const Rank& c, int id, int v = 1) {
  if (threadIdx.x == 0) take<S>(c, id, v);
  __syncthreads();
}

// The calling thread's fence at the scope.
template <Scope S = kSys>
__device__ __forceinline__ void fence() {
  if constexpr (S == kSys) __threadfence_system();
  else __threadfence();
}

// The arrival credit of a put (skipped by stall_rank, in the tests of the
// bounded waits).
template <Scope S = kSys>
__device__ __forceinline__ void credit(const Rank& c, int r, int id) {
  if (c.me != c.a.stall_rank) notify<S>(c, r, id);
}

// After a put's stores: every thread's done, then a fence at the scope.
template <Scope S = kSys>
__device__ __forceinline__ void put_fence() {
  __syncthreads();
  if (threadIdx.x == 0) fence<S>();
}

// One credit per team rank at once (K11's one-shot, K17): once every thread
// of the block is done with its puts, thread t < n (t != skip) fences and
// credits rank t's recv[me] in this lane's row.  Skipped by stall_rank.
template <Scope S>
__device__ __forceinline__ void credit_each(const Rank& c, int skip) {
  __syncthreads();
  const int t = threadIdx.x;
  if (t < c.n() && t != skip && c.me != c.a.stall_rank) {
    fence<S>();
    red_release_add<S>(c.flag(t, kRecv + c.me), 1);
  }
}

// One wait per source at once: thread t < n (t != skip) takes one credit of
// recv[t] in this lane's row, so no wait queues behind another; then the
// block meets.
template <Scope S>
__device__ __forceinline__ void wait_each(const Rank& c, int skip) {
  const int t = threadIdx.x;
  if (t < c.n() && t != skip) take<S>(c, kRecv + t, 1);
  __syncthreads();
}

// Hub barrier over the team (lane by lane): arrivals only at rank 0,
// releases only at the others, so rounds cannot mix.
template <Scope S = kSys>
__device__ __forceinline__ void barrier_all(const Rank& c) {
  if (c.n() == 1) return;
  if (c.me != 0) {
    notify<S>(c, 0, kBarrier);
    wait<S>(c, kBarrier, 1);
  } else {
    wait<S>(c, kBarrier, c.n() - 1);
    for (int i = 1; i < c.n(); ++i) notify<S>(c, i, kBarrier);
  }
}

__device__ __forceinline__ void barrier_neighbors(const Rank& c) {
  if (c.n() == 1) return;
  notify(c, c.left(), kBarrier);
  notify(c, c.right(), kBarrier);
  wait(c, kBarrier, 2);
}

template <Scope S = kSys>
__device__ __forceinline__ void collective_prologue(const Rank& c, bool neighbors_only) {
  if (neighbors_only) barrier_neighbors(c);
  else barrier_all<S>(c);
}

// A rank-wide barrier that a launch may pass any number of times (K14's ring's
// chunks, K15's and K16's stages: each reads what other lanes of the rank
// wrote; a GEMM tile reads whole rows of a chunk that moves in lane slices,
// and writes columns that every lane's slice covers): the
// lanes' arrivals count up in lane 0's row at kSyncArrive, and the g-th
// barrier of the launch waits until g * gridDim.x lanes have arrived.  Each
// lane keeps `gen`, its own count of barriers passed; every lane passes the
// same barriers in the same order.  The lanes of a rank are always on one
// card, so the fence, the arrival and the polls are at device scope (a
// peer's flags keep system scope).  rank_sync_exit, after a lane's last
// barrier, clears both counters once the last lane is past it, so the pad
// is at rest after the launch.  Bounded like wait().
__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void rank_sync(const Rank& c, int& gen) {
  __syncthreads();
  ++gen;
  if (threadIdx.x == 0) {
    __threadfence();
    int* arrive = reinterpret_cast<int*>(c.a.flags.p[c.slot(c.me)]) + kSyncArrive;
    const int want = gen * static_cast<int>(gridDim.x);
    asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(arrive), "r"(1) : "memory");
    int seen = ld_acquire_gpu(arrive);
    if (seen < want) {
      const unsigned long long t0 = globaltimer();
      while ((seen = ld_acquire_gpu(arrive)) < want) {
        if (globaltimer() - t0 > kWaitNs) timed_out(c, kSyncArrive, seen, want);
        __nanosleep(32);
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void rank_sync_exit(const Rank& c) {
  if (threadIdx.x == 0) {
    int* row = reinterpret_cast<int*>(c.a.flags.p[c.slot(c.me)]);
    if (atomicAdd_system(row + kSyncLeave, 1) == static_cast<int>(gridDim.x) - 1) {
      atomicExch_system(row + kSyncArrive, 0);
      atomicExch_system(row + kSyncLeave, 0);
    }
  }
}

// ---------------------------------------------------------------------------
// data movement over a lane's slice, in units of U; loads through L2 only
// (ld.global.cg): the data was written by another block of the launch.

template <typename U>
__device__ __forceinline__ U ldcg(const U* p) { return __ldcg(p); }

// dst[k][i] = src[i] for k < ndst, i in [lo, hi): one read, ndst writes.
// Strided by the block's threads (K9-K14 run kThreads, K15/K16 fewer).
template <typename U>
__device__ __forceinline__ void copy_units(U* const* dst, int ndst, const U* src,
                                           long long lo, long long hi) {
  constexpr int kUnroll = 4;
  const int nt = blockDim.x;
  long long i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * nt < hi; i += kUnroll * nt) {
    U v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ldcg(src + i + u * nt);
    for (int k = 0; k < ndst; ++k)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) dst[k][i + u * nt] = v[u];
  }
  for (; i < hi; i += nt) {
    const U v = ldcg(src + i);
    for (int k = 0; k < ndst; ++k) dst[k][i] = v;
  }
}

// ---------------------------------------------------------------------------
// host side: the cooperative launch every collective kernel makes

// The device address of the mapped host words a wait that ran out writes
// (allocated at the first call; collectives.cu).
cudaError_t record_words(int** dev);

// The lanes a cooperative launch of `kernel` over `ranks` ranks can have
// (blocks of `threads` threads with `smem` bytes of dynamic shared memory):
// what the card holds at once, split among the ranks; 0 if none fit.
template <typename K>
cudaError_t resident_lanes(K kernel, int ranks, int threads, int smem, long long* lanes) {
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  *lanes = min(static_cast<long long>(per_sm) * sms / max(ranks, 1),
               static_cast<long long>(kMaxLanes));
  return cudaSuccess;
}

// One cooperative launch of `kernel(*args)` over (lanes, n * groups) blocks
// of `threads` with `smem` bytes of dynamic shared memory: `want` lanes, at
// most what the card holds at once (every block must be resident: blocks
// spin on each other's flags).  `coll` is the CollArgs inside `args`.
template <typename K, typename Args>
cudaError_t cooperative_launch(K kernel, Args* args, CollArgs* coll, long long want,
                               int smem, cudaStream_t st, int threads = kThreads) {
  cudaError_t e = record_words(&coll->record);
  if (e != cudaSuccess) return e;
  const int ranks = coll->n * coll->groups;
  if (coll->n < 1 || ranks > kMaxRanks) return cudaErrorInvalidValue;
  long long fit = 0;
  if ((e = resident_lanes(kernel, ranks, threads, smem, &fit)) != cudaSuccess) return e;
  if (fit < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long lanes = max(1LL, min(want, fit));
  Args copy = *args;
  void* params[] = {&copy};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(static_cast<unsigned>(lanes), ranks), dim3(threads),
                                     params, smem, st);
}

}  // namespace dl
}  // namespace tdt
