// The ring phases of the collectives, on the card: the device counterparts
// of triton_distributed_tpu_torch/comm/ring.py (push_phase, ag_ring_phase,
// bidir_ring_phase, rs_ring_phase, rs_ack_drain), step for step, on the
// vocabulary of dl.cuh.  The overlapped GEMMs (overlap_gemm.cu) run the
// same phases with a step of their own: the AllGather rings call
// `consume(chunk)` once a chunk is here and forwarded, the ReduceScatter ring
// calls `produce(chunk)` before each local chunk is read (the JAX
// ``consume=`` of bidir_ring_phase and the matmul before each hop of
// gemm_rs.py); the collectives pass NoStep.
//
// Element types: T is the input's (float or bf16), OT the output's.  With
// VEC every chunk is a whole number of 16-byte vectors and each thread moves
// 16 bytes a load (G = 16 / sizeof(T) elements); without it, one element.
// Adds are in float and rounded once to their destination's type: the ring's
// hops to T (JAX blocks.add_body: x + y in the input dtype; the float sum
// of two bf16 values rounded to nearest is the bf16 sum), the f32 folds to
// OT (blocks.sum_body), so the results are bitwise those of the plain
// versions, which do the same adds in the same order.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "dl.cuh"

namespace tdt {
namespace dl {

// The step a phase runs per chunk when the caller has none.
struct NoStep {
  __device__ void operator()(int) const {}
};

// The scalar storage a load of one T moves (bf16 as its 16 bits).
template <typename T> struct RawOf { typedef T type; };
template <> struct RawOf<bf16> { typedef unsigned short type; };

template <typename T, bool VEC>
using Unit = typename std::conditional<VEC, uint4, typename RawOf<T>::type>::type;

template <typename T, bool VEC>
struct Elems { static constexpr int G = VEC ? 16 / static_cast<int>(sizeof(T)) : 1; };

// The lane cut of the element-typed phases: 16 elements with VEC (a whole
// number of 16-byte vectors of float and of bf16), else one.
template <bool VEC>
__host__ __device__ constexpr int quantum() { return VEC ? 16 : 1; }

__device__ __forceinline__ void widen(float r, float* f, float) { f[0] = r; }
__device__ __forceinline__ void widen(unsigned short r, float* f, bf16) {
  f[0] = __bfloat162float(__ushort_as_bfloat16(r));
}
template <typename T>
__device__ __forceinline__ void widen(const uint4& r, float* f, T) { unpack16(r, f, T()); }

// G elements of T from unit i of p, as floats
template <typename T, bool VEC>
__device__ __forceinline__ void load(const T* p, long long i, float* f) {
  widen(ldcg(reinterpret_cast<const Unit<T, VEC>*>(p) + i), f, T());
}

// G floats rounded to OT into elements [i G, (i + 1) G) of p
template <typename OT, int G>
__device__ __forceinline__ void store(OT* p, long long i, const float* f) {
  OT* q = p + i * G;
  if constexpr (G * sizeof(OT) % 16 == 0) {
    constexpr int PER = 16 / sizeof(OT);
#pragma unroll
    for (int h = 0; h < G / PER; ++h) {
      uint4 r;
      if constexpr (std::is_same<OT, float>::value) {
        r = make_uint4(__float_as_uint(f[h * PER]), __float_as_uint(f[h * PER + 1]),
                       __float_as_uint(f[h * PER + 2]), __float_as_uint(f[h * PER + 3]));
      } else {
        unsigned w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const __nv_bfloat162 b =
              __floats2bfloat162_rn(f[h * PER + 2 * k], f[h * PER + 2 * k + 1]);
          w[k] = *reinterpret_cast<const unsigned*>(&b);
        }
        r = make_uint4(w[0], w[1], w[2], w[3]);
      }
      reinterpret_cast<uint4*>(q)[h] = r;
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) q[g] = from_f32<OT>(f[g]);
  }
}

// dst = src[0] + ... + src[ns - 1] over units [lo, hi): accumulated in float
// in the order given, rounded once to OT.
template <typename T, typename OT, bool VEC>
__device__ __forceinline__ void sum_units(OT* dst, const T* const* src, int ns,
                                          long long lo, long long hi) {
  constexpr int G = Elems<T, VEC>::G;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    float acc[G], v[G];
    load<T, VEC>(src[0], i, acc);
    for (int k = 1; k < ns; ++k) {
      load<T, VEC>(src[k], i, v);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += v[g];
    }
    store<OT, G>(dst, i, acc);
  }
}

// ---------------------------------------------------------------------------
// the phases (comm/ring.py).  K9's device-scope forms (push_each_phase and
// the rings with S = kGpu and FROM_X) are walked lane by lane in
// comm/lanes.py.

// Full-mesh push (the AllGather push and the one-shot AllReduce): this rank's
// x into entry `me` of `dst` on itself, the team barrier, the same units into
// entry `me` of `dst` on every peer (one read, n - 1 writes), their arrival
// credits, then the n - 1 arrivals of the peers' entries.  x and dst are
// indexed as E, moved in units U over [lo, hi); flags and fences at scope S.
template <typename E, typename U, Scope S = kSys>
__device__ void push_phase(const Rank& c, const Peers& dst, long long lo, long long hi) {
  const int n = c.n();
  const U* mine = reinterpret_cast<const U*>(c.at<E>(c.a.x, c.me, 0));
  U* d[kMaxRanks] = {};
  for (int off = 0; off < n; ++off)
    d[off] = reinterpret_cast<U*>(c.at<E>(dst, (c.me + off) % n, c.me));
  copy_units<U>(d, 1, mine, lo, hi);  // a put to oneself, which nobody waits for
  collective_prologue<S>(c, false);
  copy_units<U>(d + 1, n - 1, mine, lo, hi);
  put_fence<S>();
  for (int off = 1; off < n; ++off) credit<S>(c, (c.me + off) % n, kRecv + c.me);
  for (int off = 1; off < n; ++off) wait<S>(c, kRecv + (c.me + n - off) % n);
}

// K9's device-scope push (comm/lanes.py walks it lane by lane): this rank's
// x into entry `me` of `dst` on every rank, itself included (one read, n
// writes), then one fence and credit per peer and one wait per peer, each on
// a thread of its own (credit_each, wait_each).  No entry barrier, for the
// reason one_shot_phase gives: every rank is a block of this one launch, and
// the previous call's launch finished on the same stream before this one
// began, so no entry is still being read and every flag is at zero.
template <typename E, typename U>
__device__ void push_each_phase(const Rank& c, const Peers& dst, long long lo, long long hi) {
  const int n = c.n();
  U* d[kMaxRanks] = {};
  for (int r = 0; r < n; ++r) d[r] = reinterpret_cast<U*>(c.at<E>(dst, r, c.me));
  copy_units<U>(d, n, reinterpret_cast<const U*>(c.at<E>(c.a.x, c.me, 0)), lo, hi);
  credit_each<kGpu>(c, c.me);
  wait_each<kGpu>(c, c.me);
}

// K11's one-shot AllReduce (comm/lanes.py walks it lane by lane): this
// rank's partial into entry `me` of the landing slots of every peer (one
// read, n - 1 writes), one fence and credit per peer, one wait per peer, all
// at once (credit_each, wait_each), then the f32 sum of the n partials in
// slot order into out, rounded once to OT (entry me read from x in place: a
// put to oneself would copy the same values).  At system scope (the
// multi-card host) the team barrier comes first, as in push_phase: a peer
// process may still be reading its slots from the previous call.  At device
// scope there is none: every rank is a block of this one launch, and the
// previous call's launch finished on the same stream before this one began
// (a captured graph keeps that order), so no slot is still being read and
// every flag is at zero.
template <typename T, typename OT, bool VEC, Scope S>
__device__ void one_shot_phase(const Rank& c, long long lo, long long hi) {
  typedef Unit<T, VEC> U;
  const int n = c.n();
  const T* mine = c.at<T>(c.a.x, c.me, 0);
  U* d[kMaxRanks] = {};
  for (int off = 1; off < n; ++off)
    d[off - 1] = reinterpret_cast<U*>(c.at<T>(c.a.land, (c.me + off) % n, c.me));
  if constexpr (S == kSys) barrier_all<S>(c);
  copy_units<U>(d, n - 1, reinterpret_cast<const U*>(mine), lo, hi);
  credit_each<S>(c, c.me);
  wait_each<S>(c, c.me);
  const T* src[kMaxRanks];
  for (int i = 0; i < n; ++i) src[i] = i == c.me ? mine : c.at<T>(c.a.land, c.me, i);
  sum_units<T, OT, VEC>(c.at<OT>(c.a.out, c.me, 0), src, n, lo, hi);
}

// One-way AllGather ring over out-chunks of OT already at their final
// offsets; out-chunk `me` holds this rank's part.  Moved in units U, the
// lanes cut at QUANTUM elements.  Each chunk is forwarded before it is
// consumed, and consumed before the next arrival is waited for.  Flags and
// fences at scope S.  FROM_X (K9's device-scope ring): out-chunk `me` is not
// there yet, and the first put reads this rank's x and writes it into
// out-chunk `me` here and on the right neighbour at once (one read, two
// writes).
template <typename OT, typename U, int QUANTUM, typename Consume = NoStep, Scope S = kSys,
          bool FROM_X = false>
__device__ void ag_ring_phase(const Rank& c, Consume consume = Consume()) {
  const int n = c.n();
  long long lo, hi;
  c.slice(sizeof(U) / sizeof(OT), QUANTUM, lo, hi);
  for (int step = 0; step < n - 1; ++step) {
    const int cs = (c.me + n - step) % n;
    U* d = reinterpret_cast<U*>(c.at<OT>(c.a.out, c.right(), cs));
    if (FROM_X && step == 0) {
      U* both[2] = {d, reinterpret_cast<U*>(c.at<OT>(c.a.out, c.me, cs))};
      copy_units<U>(both, 2, reinterpret_cast<const U*>(c.at<OT>(c.a.x, c.me, 0)), lo, hi);
    } else {
      copy_units<U>(&d, 1, reinterpret_cast<const U*>(c.at<OT>(c.a.out, c.me, cs)), lo, hi);
    }
    put_fence<S>();
    credit<S>(c, c.right(), kRecv + cs);
    consume(cs);
    wait<S>(c, kRecv + (c.me + n - step - 1) % n);
  }
  consume((c.me + 1) % n);
}

// Two-way AllGather ring: ceil((n-1)/2) chunks travel right, floor((n-1)/2)
// left, each forwarded right after its arrival, then consumed (one's own
// chunk after its two sends).  S and FROM_X as in ag_ring_phase: with FROM_X
// the own shard goes from x into out-chunk `me` here and on both neighbours
// in one pass (one read, up to three writes), then its two credits.
template <typename OT, typename U, int QUANTUM, typename Consume = NoStep, Scope S = kSys,
          bool FROM_X = false>
__device__ void bidir_ring_phase(const Rank& c, Consume consume = Consume()) {
  const int n = c.n(), n_cw = n / 2, n_ccw = (n - 1) / 2;
  long long lo, hi;
  c.slice(sizeof(U) / sizeof(OT), QUANTUM, lo, hi);
  auto send = [&](int r, int dst) {
    U* d = reinterpret_cast<U*>(c.at<OT>(c.a.out, dst, r));
    copy_units<U>(&d, 1, reinterpret_cast<const U*>(c.at<OT>(c.a.out, c.me, r)), lo, hi);
    put_fence<S>();
    credit<S>(c, dst, kRecv + r);
  };
  if constexpr (FROM_X) {
    U* d[3] = {reinterpret_cast<U*>(c.at<OT>(c.a.out, c.me, c.me)),
               reinterpret_cast<U*>(c.at<OT>(c.a.out, c.right(), c.me)),
               reinterpret_cast<U*>(c.at<OT>(c.a.out, c.left(), c.me))};
    copy_units<U>(d, 1 + (n_cw >= 1) + (n_ccw >= 1),
                  reinterpret_cast<const U*>(c.at<OT>(c.a.x, c.me, 0)), lo, hi);
    put_fence<S>();
    if (n_cw >= 1) credit<S>(c, c.right(), kRecv + c.me);
    if (n_ccw >= 1) credit<S>(c, c.left(), kRecv + c.me);
  } else {
    if (n_cw >= 1) send(c.me, c.right());
    if (n_ccw >= 1) send(c.me, c.left());
  }
  consume(c.me);
  for (int step = 0; step < max(n_cw, n_ccw); ++step) {
    if (step < n_cw) {
      const int r = (c.me + n - step - 1) % n;
      wait<S>(c, kRecv + r);
      if (step + 1 < n_cw) send(r, c.right());
      consume(r);
    }
    if (step < n_ccw) {
      const int r = (c.me + step + 1) % n;
      wait<S>(c, kRecv + r);
      if (step + 1 < n_ccw) send(r, c.left());
      consume(r);
    }
  }
}

// The ReduceScatter ring over x's n chunks, its partials in the two landing
// slots of each rank (`land`, entries of one chunk).  Each hop's add is fused
// into its put: received partial + local chunk, rounded to T, written into
// the right neighbour's slot.  The last hop lands in entry `last_index` of
// `out`: in T, or (LAST_F32, two-shot AllReduce) as the f32 sum rounded to OT.
// `produce(j)` runs before local chunk j is first read.
template <typename T, typename OT, bool VEC, bool LAST_F32, typename Produce = NoStep>
__device__ void rs_ring_phase(const Rank& c, int last_index, Produce produce = Produce()) {
  const int n = c.n();
  long long lo, hi;
  c.slice(Elems<T, VEC>::G, quantum<VEC>(), lo, hi);
  produce((c.me + n - 1) % n);
  {
    typedef Unit<T, VEC> U;
    U* d = reinterpret_cast<U*>(c.at<T>(c.a.land, c.right(), 0));
    copy_units<U>(&d, 1, reinterpret_cast<const U*>(c.at<T>(c.a.x, c.me, (c.me + n - 1) % n)),
                  lo, hi);
    put_fence();
    credit(c, c.right(), kRsRecv + 0);
  }
  for (int s = 1; s < n; ++s) {
    const int j = (c.me + n - s - 1) % n, slot_in = (s - 1) % 2;
    produce(j);
    wait(c, kRsRecv + slot_in);
    const T* src[2] = {c.at<T>(c.a.land, c.me, slot_in), c.at<T>(c.a.x, c.me, j)};
    if (s == n - 1) {
      if constexpr (LAST_F32)
        sum_units<T, OT, VEC>(c.at<OT>(c.a.out, c.me, last_index), src, 2, lo, hi);
      else
        sum_units<T, T, VEC>(c.at<T>(c.a.out, c.me, last_index), src, 2, lo, hi);
    } else {
      const int slot_out = s % 2;
      if (s >= 2) wait(c, kAck + slot_out);
      sum_units<T, T, VEC>(c.at<T>(c.a.land, c.right(), slot_out), src, 2, lo, hi);
      put_fence();
      credit(c, c.right(), kRsRecv + slot_out);
    }
    notify(c, c.left(), kAck + slot_in);
  }
}

// The ACK credits still outstanding after the ring: one when n == 2, else
// the last two sends'.
__device__ __forceinline__ void rs_ack_drain(const Rank& c) {
  const int n = c.n();
  if (n == 2) {
    wait(c, kAck + 0);
  } else {
    wait(c, kAck + (n - 3) % 2);
    wait(c, kAck + (n - 2) % 2);
  }
}

}  // namespace dl
}  // namespace tdt
