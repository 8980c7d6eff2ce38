// K12, K13, K14: the overlapped GEMMs on ranks co-located on one Hopper card
// (sm_90a): AllGather-GEMM, GEMM-ReduceScatter and GEMM-AllReduce.
//
// Replace, schedule for schedule (comm/ring.py and ops/{ag_gemm,gemm_rs,
// gemm_ar}.py hold the Python mirrors, which the plain versions walk;
// comm/tiles.py mirrors K12's and K13's lanes and tiles):
//   K12 triton_distributed_tpu/ops/ag_gemm.py _ag_gemm_kernel (:66) and
//       _ag_gemm_bidir_kernel (:123), pallas_call :188
//   K13 triton_distributed_tpu/ops/gemm_rs.py _gemm_rs_kernel (:57),
//       pallas_call :160
//   K14 triton_distributed_tpu/ops/gemm_ar.py _gemm_ar_kernel (:59),
//       pallas_call :161
//
// What they compute, per team of n ranks (rank-stacked operands, one
// cooperative launch over every rank of every team, as K9-K11):
//   K12  C_r = AllGather(A) @ B_r: the ring (one-way or two-way) of K9 over
//        the gathered chunks, each chunk forwarded as soon as it is here and
//        multiplied once it is, the local chunk first; the gathered A is an
//        output too.
//   K13  the ReduceScatter of the partials A_r @ B_r (A_r: M x k_loc): the
//        ring of K10 in the output dtype, chunk j's partial starting at rank
//        j + 1 and ending at rank j; each chunk's product is rounded to the
//        output dtype, then added to the received partial in f32 and rounded
//        once (JAX blocks.add_body).
//   K14  K13's phase with its last add landing in out-chunk `me` of the
//        replicated output, then K11's AllGather ring of the reduced chunks
//        (the ring form, above the one-shot threshold of
//        comm/allreduce.py choose_method; at decode sizes ops/gemm_ar.py
//        launches K15's one-shot linear form in fused_ar.cu instead).
//
// K12 and K13 (bf16 operands) run wgmma_tile.cuh's main loop: a block is a
// lane (blockIdx.x) of a rank (blockIdx.y) and walks its share of the rank's
// tiles, 128 x 256, with a TMA producer warp and two wgmma consumer
// warpgroups; f32 operands take gemm_tile.cuh's scalar f32 loop on 64 x 64
// tiles (parity, not speed) in the same protocol.  No lane waits for the
// other lanes of its rank, except where a tile needs their data:
//   K12  tile i of a rank's sequence (chunks in the ring's arrival order,
//        every tile of a chunk, then the next chunk) goes to lane i % lanes.
//        Chunk me's tiles read the rank's own shard in place.  Before the
//        first tile of another chunk r the producer waits until every
//        lane's slice of r is here: the count ready[r] in lane 0's row,
//        which a lane's three spare warps raise when its slice of r arrives.
//        Those warps run the ring of K9 on the lane's slices beside the
//        products (the own shard sent on first, straight from x), so the
//        copies stay off the consumers' path; the last lane out puts the
//        counts back to zero.
//   K13  tile (s, t), hop s of the ring and tile t of a chunk, goes to lane
//        (s T + t) % lanes, hop by hop.  At s > 0 the tile first waits for
//        its partial from the left neighbour (the flag tile[(s - 1) T + t])
//        and loads it, then runs its product; the epilogue rounds the
//        product, adds the partial in f32 and rounds once, writes the result
//        into the right neighbour's landing slot s (or this rank's output at
//        the last hop) and credits tile[s T + t] there.  n - 1 landing slots,
//        one a hop, are each written once a call, so no slot is reused
//        within a launch and no acknowledgement is needed; no chunk's
//        product goes through device memory and back.
// A hop-s tile waits only on hop s - 1 tiles, a lane takes its tiles hop by
// hop (K12: chunk by chunk) and every block is resident (the cooperative
// launch): the waits cannot close a cycle.  Flags and fences are at device
// scope: every rank is a block of the one launch on this card.  Each flag is
// back at zero when the launch ends (K13's tile flags are each credited
// once and taken once).
//
// K14's ring form keeps the first design: gemm_tile.cuh's mma.sync loop,
// one product buffer entry per chunk, the lanes of a rank meeting at
// dl.cuh's rank_sync once a chunk.
//
// Bound on the H100: operations at the prefill shapes (Qwen3-8B, tp = 4,
// 4 x 1024 rows: 400-1500 flops a byte); K14's ring form, at decode sizes,
// bytes.
#include <type_traits>

#include "gemm_tile.cuh"
#include "ring.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace dl {

// core/symm.py GemmArgs, field for field.  c.x is the input the ring reads
// (K12: the A shard; K14: the product buffer), c.out the ring's output (K12:
// the gathered A; K13: the output chunk; K14: the replicated output), c.land
// the ReduceScatter's receive slots (K13: n - 1, one a hop; K14: two); a the
// A operand (K13/K14), b the B operand, y the GEMM's output (K12: C; K14:
// the product buffer, n entries of one chunk).  A chunk's product is
// (m_loc, k) @ (k, n_cols); c.chunk_elems counts the elements of one ring
// chunk.
struct GemmArgs {
  CollArgs c;
  Peers a, b, y;
  int m_loc, k, n_cols;
};

// K12's and K13's launch: the GemmArgs and, for bf16 operands, each mesh
// slot's tensor maps of A (K12: the gathered A; K13: A), of B, and (K12)
// of its own shard, which its tiles of chunk me read.
struct WgArgs {
  GemmArgs g;
  CUtensorMap ma[kMaxRanks], mb[kMaxRanks], mx[kMaxRanks];
};

namespace {

template <typename T> constexpr bool kBf16 = std::is_same<T, bf16>::value;

// A chunk's tiles (BM x BN: 128 x 256 for bf16, 64 x 64 for f32), m-major.
template <typename T>
struct Tiles {
  static constexpr int BM = kBf16<T> ? wg::BM : gemm::kF32BM;
  static constexpr int BN = kBf16<T> ? wg::BN : gemm::kF32BN;
  int tm, count;
  __host__ __device__ Tiles(int rows, int cols)
      : tm((rows + BM - 1) / BM), count(tm * ((cols + BN - 1) / BN)) {}
  __host__ __device__ int m0(int t) const { return (t % tm) * BM; }
  __host__ __device__ int n0(int t) const { return (t / tm) * BN; }
};

template <typename T>
__device__ __forceinline__ T* base(const Peers& p, const Rank& c) {
  return reinterpret_cast<T*>(p.p[c.slot(c.me)]);
}

__device__ __forceinline__ int* pad(const Rank& c, int r) {
  return reinterpret_cast<int*>(c.a.flags.p[c.slot(r)]);
}

// One thread: wait until *f >= v (acquire at device scope), then take v off
// it when `take`.  Bounded: after `ns` it records (rank, id, seen, v) and
// traps.
__device__ __forceinline__ void wait_flag(const Rank& c, int* f, int id, int v, bool take,
                                          unsigned long long ns = kWaitNs) {
  int seen = ld_acquire<kGpu>(f);
  if (seen < v) {
    const unsigned long long t0 = globaltimer();
    while ((seen = ld_acquire<kGpu>(f)) < v) {
      if (globaltimer() - t0 > ns) timed_out(c, id, seen, v);
      __nanosleep(32);
    }
  }
  if (take) atomicSub(f, v);
}

// The sums of one consumer thread as (row, column, x, y) pairs of adjacent
// columns: P pairs, read at compile-time indices once unrolled.
struct WgFrag {  // wgmma_tile.cuh's m64n256 sums
  static constexpr int P = wg::kAccRegs / 2;
  const float (&d)[wg::kAccRegs];
  int r0, c0;
  __device__ WgFrag(const float (&acc)[wg::kAccRegs])
      : d(acc), r0(wg::acc_row0()), c0(wg::acc_col0()) {}
  __device__ int row(int q) const { return r0 + 8 * (q & 1); }
  __device__ int col(int q) const { return 8 * (q >> 1) + c0; }
  __device__ float x(int q) const { return d[4 * (q >> 1) + 2 * (q & 1)]; }
  __device__ float y(int q) const { return d[4 * (q >> 1) + 2 * (q & 1) + 1]; }
};

struct F32Frag {  // gemm_tile.cuh's f32_acc sums
  static constexpr int P = 8;
  const float (&a)[4][4];
  int r0, c0;
  __device__ F32Frag(const float (&acc)[4][4])
      : a(acc), r0(threadIdx.x / 16), c0((threadIdx.x % 16) * 4) {}
  __device__ int row(int q) const { return r0 + 16 * (q >> 1); }
  __device__ int col(int q) const { return c0 + 2 * (q & 1); }
  __device__ float x(int q) const { return a[q >> 1][2 * (q & 1)]; }
  __device__ float y(int q) const { return a[q >> 1][2 * (q & 1) + 1]; }
};

// Two adjacent values of OT as loaded (bf16: one 32-bit word), through L2
// only (written by another block), and widened to floats.
template <typename OT> struct RawPair { typedef float2 type; };
template <> struct RawPair<bf16> { typedef unsigned type; };

template <typename OT>
__device__ __forceinline__ typename RawPair<OT>::type load_pair(const OT* p) {
  return __ldcg(reinterpret_cast<const typename RawPair<OT>::type*>(p));
}
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ float2 widen(unsigned u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The tile's sums rounded once to OT into C (row-major, `rows` x N; the
// tile at (m0, n0)), rows and columns past the matrix left out.
template <typename OT, class F>
__device__ __forceinline__ void store_tile(const F& f, OT* C, int rows, int N, int m0, int n0) {
#pragma unroll
  for (int q = 0; q < F::P; ++q) {
    const int row = m0 + f.row(q), col = n0 + f.col(q);
    if (row < rows && col < N)
      gemm::Pair<OT>::store(C + static_cast<long long>(row) * N + col, f.x(q), f.y(q));
  }
}

// bf16 outputs of the wgmma sums go out as whole 16-byte row pieces
// (wgmma_tile.cuh's quad transpose, shared with K5).
using wg::pack_bf16;
using wg::piece_col;
using wg::row_piece;

// The row of piece (h, k) in the tile.
__device__ __forceinline__ int piece_row(const WgFrag& f, int h) { return f.r0 + 8 * h; }

// x + y of eight bf16 pairs, in f32, rounded once.
__device__ __forceinline__ uint4 add_bf16x8(const uint4& a, const uint4& b) {
  const unsigned* pa = reinterpret_cast<const unsigned*>(&a);
  const unsigned* pb = reinterpret_cast<const unsigned*>(&b);
  unsigned r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = widen(pa[i]), y = widen(pb[i]);
    r[i] = pack_bf16(x.x + y.x, x.y + y.y);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

template <>
__device__ __forceinline__ void store_tile<bf16, WgFrag>(const WgFrag& f, bf16* C, int rows, int N,
                                                         int m0, int n0) {
  wg::store_pieces(f.d, C, rows, N, m0, n0);
}

// K13's received partial of one tile, as this consumer thread's pairs,
// loaded before the tile's main loop (which hides their latency) where they
// fit in registers (the f32 tiles' 8 pairs; bf16 wgmma sums: the
// specialisation below), else in batches by the epilogue (wgmma sums into
// f32 outputs).
template <typename OT, class F>
struct Partial {
  static constexpr bool kAhead = F::P <= 16;
  typename RawPair<OT>::type v[kAhead ? F::P : 1];

  template <class G>
  __device__ __forceinline__ void load(const G& geo, const OT* src, int rows, int N, int m0,
                                       int n0) {
    if constexpr (kAhead) {
#pragma unroll
      for (int q = 0; q < F::P; ++q) {
        const int row = m0 + geo.row(q), col = n0 + geo.col(q);
        if (row < rows && col < N) v[q] = load_pair(src + static_cast<long long>(row) * N + col);
      }
    }
  }
};

// K13's epilogue of one tile: the product rounded to OT; with `src` (hop >
// 0) plus the received partial in f32 (`part`, or loaded here in batches),
// rounded once (JAX blocks.add_body); into `dst`.
template <typename OT, class F>
__device__ __forceinline__ void ring_tile(const F& f, const Partial<OT, F>& part, const OT* src,
                                          OT* dst, int rows, int N, int m0, int n0) {
  constexpr int BATCH = Partial<OT, F>::kAhead ? F::P : 16;
#pragma unroll
  for (int q0 = 0; q0 < F::P; q0 += BATCH) {
    typename RawPair<OT>::type got[Partial<OT, F>::kAhead ? 1 : BATCH];
    if constexpr (!Partial<OT, F>::kAhead) {
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int row = m0 + f.row(q0 + k), col = n0 + f.col(q0 + k);
        if (src && row < rows && col < N)
          got[k] = load_pair(src + static_cast<long long>(row) * N + col);
      }
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int q = q0 + k, row = m0 + f.row(q), col = n0 + f.col(q);
      if (row >= rows || col >= N) continue;
      float x = round_to<OT>(f.x(q)), y = round_to<OT>(f.y(q));
      if (src) {
        float2 p;
        if constexpr (Partial<OT, F>::kAhead) p = widen(part.v[q]);
        else p = widen(got[k]);
        x = p.x + x;
        y = p.y + y;
      }
      gemm::Pair<OT>::store(dst + static_cast<long long>(row) * N + col, x, y);
    }
  }
}

// bf16 wgmma sums: the partial as the thread's 16 row pieces (64 registers),
// loaded before the tile's main loop.
template <>
struct Partial<bf16, WgFrag> {
  uint4 v[16];

  template <class G>
  __device__ __forceinline__ void load(const G& geo, const bf16* src, int rows, int N, int m0,
                                       int n0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int row = m0 + piece_row(geo, h), col = n0 + piece_col(k);
        if (row < rows && col < N)
          v[8 * h + k] =
              __ldcg(reinterpret_cast<const uint4*>(src + static_cast<long long>(row) * N + col));
      }
  }
};

template <>
__device__ __forceinline__ void ring_tile<bf16, WgFrag>(const WgFrag& f,
                                                        const Partial<bf16, WgFrag>& part,
                                                        const bf16* src, bf16* dst, int rows,
                                                        int N, int m0, int n0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + piece_row(f, h);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint4 v = row_piece(f.d, h, k);
      const int col = n0 + piece_col(k);
      if (row < rows && col < N) {
        if (src) v = add_bf16x8(part.v[8 * h + k], v);
        *reinterpret_cast<uint4*>(dst + static_cast<long long>(row) * N + col) = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K12: AllGather-GEMM

// The ring's arrival order of chunks (ci = 0, 1, ...): the local chunk,
// then one-way me - 1, me - 2, ...; two-way me - 1, me + 1, me - 2, ...
template <bool BIDIR>
__device__ __forceinline__ int ag_chunk(int me, int n, int ci) {
  if (!BIDIR || ci == 0) return (me + n - ci) % n;
  const int s = (ci - 1) / 2;
  return ci % 2 ? (me + n - s - 1) % n : (me + s + 1) % n;
}

// Bytes a spare thread has in flight while it copies: K12's copies stage
// through shared memory (cp.async, no registers held), 16 units of 16 bytes
// a thread, 24 KB a lane.
constexpr int kStageUnits = 16;
constexpr int kCopyStage = wg::kSpareThreads * kStageUnits * 16;

// A lane's spare warps (96 threads on named barrier wg::kSpareBar): its
// slices of K12's ring, as ring.cuh's ag_ring_phase / bidir_ring_phase move
// them, each chunk forwarded as it arrives, with ready[r] raised on this
// rank once its slice of chunk r is here (before it is forwarded on: the
// copy warps forward it right after, and the other lanes' tiles need not
// wait for that).  The own shard is sent on straight from x, and copied
// into gathered chunk me last: no tile reads that copy (chunk me's tiles
// read x in place), so the first puts go out at once.  `stage`: kCopyStage
// bytes of shared memory.
template <typename T, bool BIDIR>
__device__ void ag_copies(const Rank& c, const GemmArgs& g, uint4* stage) {
  const int tid = threadIdx.x - (wg::kProducerWarp + 1) * 32, n = c.n();
  auto sync = [] { wg::named_sync(wg::kSpareBar, wg::kSpareThreads); };
  long long lo, hi;
  c.slice(16 / sizeof(T), 16, lo, hi);
  // this lane's slice of `from` into `to` and, when given, `to2` (one read)
  auto copy = [&](const T* from, T* to, T* to2) {
    const uint4* s = reinterpret_cast<const uint4*>(from);
    uint4* d = reinterpret_cast<uint4*>(to);
    uint4* d2 = reinterpret_cast<uint4*>(to2);
    constexpr int kStep = wg::kSpareThreads * kStageUnits;
    for (long long i0 = lo + tid; i0 < hi; i0 += kStep) {
#pragma unroll
      for (int u = 0; u < kStageUnits; ++u) {
        const long long i = i0 + u * wg::kSpareThreads;
        if (i < hi) cp_async16(stage + u * wg::kSpareThreads + tid, s + i, true);
      }
      cp_async_commit();
      cp_async_wait<0>();
#pragma unroll
      for (int u = 0; u < kStageUnits; ++u) {
        const long long i = i0 + u * wg::kSpareThreads;
        if (i < hi) {
          const uint4 v = stage[u * wg::kSpareThreads + tid];
          d[i] = v;
          if (d2) d2[i] = v;
        }
      }
    }
  };
  // chunk r to rank dst (and dst2), each credited once the group's stores
  // are done (the barrier, then a device-scope release)
  auto send = [&](int r, int dst, int dst2 = -1) {
    copy(r == c.me ? c.at<T>(g.c.x, c.me, 0) : c.at<T>(g.c.out, c.me, r),
         c.at<T>(g.c.out, dst, r), dst2 < 0 ? nullptr : c.at<T>(g.c.out, dst2, r));
    sync();
    if (tid == 0 && c.me != c.a.stall_rank) {
      red_release_add<kGpu>(c.flag(dst, kRecv + r), 1);
      if (dst2 >= 0) red_release_add<kGpu>(c.flag(dst2, kRecv + r), 1);
    }
  };
  auto arrive = [&](int r) {  // chunk r is here: ready[r] on this rank
    if (tid == 0) {
      wait_flag(c, c.flag(c.me, kRecv + r), kRecv + r, 1, true);
      red_release_add<kGpu>(pad(c, c.me) + kReady + r, 1);
    }
    sync();
  };
  // the neighbours' barrier (collective_prologue), before the first put
  sync();
  if (tid == 0) {
    red_release_add<kGpu>(c.flag(c.left(), kBarrier), 1);
    red_release_add<kGpu>(c.flag(c.right(), kBarrier), 1);
    wait_flag(c, c.flag(c.me, kBarrier), kBarrier, 2, true);
  }
  sync();
  if (!BIDIR) {
    for (int step = 0; step < n - 1; ++step) {
      send((c.me + n - step) % n, c.right());
      arrive((c.me + n - step - 1) % n);
    }
  } else {
    // the own shard both ways in one pass; at each step both arrivals
    // before either forward, so neither direction waits on the other's copy
    const int n_cw = n / 2, n_ccw = (n - 1) / 2;
    send(c.me, c.right(), n_ccw >= 1 ? c.left() : -1);
    for (int step = 0; step < max(n_cw, n_ccw); ++step) {
      const int cw = (c.me + n - step - 1) % n, ccw = (c.me + step + 1) % n;
      if (step < n_cw) arrive(cw);
      if (step < n_ccw) arrive(ccw);
      if (step + 1 < n_cw) send(cw, c.right());
      if (step + 1 < n_ccw) send(ccw, c.left());
    }
  }
  copy(c.at<T>(g.c.x, c.me, 0), c.at<T>(g.c.out, c.me, c.me), nullptr);  // own shard
}

// Before a tile of chunk r: every lane's slice of r is here.  Twice the
// ring's bound: a stalled ring runs out on its own flag first, and names it.
__device__ __forceinline__ void wait_ready(const Rank& c, int r) {
  wait_flag(c, pad(c, c.me) + kReady + r, kReady + r, static_cast<int>(gridDim.x), false,
            2 * kWaitNs);
}

// After a lane's last read of the ready counts: the last lane out clears them.
__device__ __forceinline__ void ready_leave(const Rank& c) {
  int* row = pad(c, c.me);
  __threadfence();
  if (atomicAdd(row + kReadyLeave, 1) == static_cast<int>(gridDim.x) - 1) {
    for (int r = 0; r < c.n(); ++r) atomicExch(row + kReady + r, 0);
    atomicExch(row + kReadyLeave, 0);
  }
}

template <typename T, typename OT, bool BIDIR>
__global__ void __launch_bounds__(wg::THREADS, 1) ag_gemm_kernel(const __grid_constant__ WgArgs w) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ wg::Bars bars;
  const GemmArgs& g = w.g;
  const Rank c(g.c);
  const Tiles<T> tl(g.m_loc, g.n_cols);
  const int n = c.n(), total = n * tl.count, warp = threadIdx.x / 32;
  const long long chunk_c = static_cast<long long>(g.m_loc) * g.n_cols;
  unsigned char* st = wg::stages(dyn);
  wg::init_bars(bars);
  if (warp >= wg::kProducerWarp) {
    if constexpr (kBf16<T>) wg::set_max_regs_dec<40>();
    if (warp == wg::kProducerWarp) {
      if constexpr (kBf16<T>) {
        if ((threadIdx.x & 31) == 0) {
          // chunk me is the rank's own shard: its tiles read it in place
          wg::Ring ring;
          const int ktiles = (g.k + wg::BK - 1) / wg::BK, slot = c.slot(c.me);
          int seen = 0;
          for (int i = blockIdx.x; i < total; i += gridDim.x) {
            const int ci = i / tl.count, t = i % tl.count, r = ag_chunk<BIDIR>(c.me, n, ci);
            if (ci != seen) {
              wait_ready(c, r);
              wg::fence_proxy_async();
              seen = ci;
            }
            wg::load_tile(st, bars, ring, ci ? &w.ma[slot] : &w.mx[slot], &w.mb[slot],
                          wg::TileAt{ci ? r : 0, 0, tl.m0(t), tl.n0(t)}, ktiles);
          }
        }
      }
    } else {
      ag_copies<T, BIDIR>(
          c, g, reinterpret_cast<uint4*>(st + (kBf16<T> ? wg::STAGES * wg::STAGE_BYTES : 0)));
    }
    if constexpr (kBf16<T>) {
      __syncwarp();
      wg::named_sync(wg::kProducerBar, 128);
      if (threadIdx.x == wg::kProducerWarp * 32) ready_leave(c);
    }
  } else {
    OT* C = base<OT>(g.y, c);
    if constexpr (kBf16<T>) {
      wg::set_max_regs_inc<232>();
      wg::Ring ring;
      const int ktiles = (g.k + wg::BK - 1) / wg::BK;
      float d[wg::kAccRegs];
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int t = i % tl.count, r = ag_chunk<BIDIR>(c.me, n, i / tl.count);
        wg::mma_tile(st, bars, ring, ktiles, d);
        store_tile<OT>(WgFrag(d), C + r * chunk_c, g.m_loc, g.n_cols, tl.m0(t), tl.n0(t));
      }
    } else {
      const T* B = base<const T>(g.b, c);
      int seen = 0;
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int ci = i / tl.count, t = i % tl.count, r = ag_chunk<BIDIR>(c.me, n, ci);
        if (ci != seen) {
          if (threadIdx.x == 0) wait_ready(c, r);
          wg::named_sync(wg::kConsumerBar, wg::CONSUMERS);
          seen = ci;
        }
        float acc[4][4] = {};
        gemm::f32_acc<gemm::Sync<wg::CONSUMERS>>(
            ci ? c.at<T>(g.c.out, c.me, r) : c.at<T>(g.c.x, c.me, 0), B, g.m_loc, g.n_cols,
            g.k, tl.m0(t), tl.n0(t), acc);
        store_tile<OT>(F32Frag(acc), C + r * chunk_c, g.m_loc, g.n_cols, tl.m0(t), tl.n0(t));
      }
    }
  }
  if constexpr (!kBf16<T>) {
    __syncthreads();
    if (threadIdx.x == 0) ready_leave(c);
  }
}

// ---------------------------------------------------------------------------
// K13: GEMM-ReduceScatter

__device__ __forceinline__ int* tile_flag(const Rank& c, int r, int idx) {
  return pad(c, r) + kTileFlagBase + idx;
}

// Before hop s of tile t (s T + t in the rank's sequence), s > 0: the left
// neighbour's partial of the tile is here (tile[(s - 1) T + t]); it is
// loaded ahead into `part` where it fits in registers.
template <typename OT, class F>
__device__ __forceinline__ void rs_receive(const Rank& c, const GemmArgs& g, const F& geo,
                                           Partial<OT, F>& part, int s, int t, int count,
                                           int m0, int n0) {
  if (s == 0) return;
  const int idx = (s - 1) * count + t;
  if (threadIdx.x == 0) wait_flag(c, tile_flag(c, c.me, idx), kTileId + idx, 1, true);
  wg::named_sync(wg::kConsumerBar, wg::CONSUMERS);
  part.load(geo, c.at<OT>(g.c.land, c.me, s - 1), g.m_loc, g.n_cols, m0, n0);
}

// Hop s of tile t after its product: add, round, write on, credit the right
// neighbour (or land in this rank's output at the last hop).
template <typename OT, class F>
__device__ __forceinline__ void rs_epilogue(const Rank& c, const GemmArgs& g, wg::Bars& bars,
                                            const F& f, const Partial<OT, F>& part, int s,
                                            int t, int count, int m0, int n0) {
  const int n = c.n();
  wg::mbar_wait(&bars.start, 0);  // the neighbours' barrier is passed
  const OT* src = s > 0 ? c.at<OT>(g.c.land, c.me, s - 1) : nullptr;
  OT* dst = s < n - 1 ? c.at<OT>(g.c.land, c.right(), s) : c.at<OT>(g.c.out, c.me, 0);
  ring_tile<OT>(f, part, src, dst, g.m_loc, g.n_cols, m0, n0);
  if (s < n - 1) {  // every consumer's stores done: one device-scope release
    wg::named_sync(wg::kConsumerBar, wg::CONSUMERS);
    if (threadIdx.x == 0 && c.me != c.a.stall_rank)
      red_release_add<kGpu>(tile_flag(c, c.right(), s * count + t), 1);
  }
}

template <typename T, typename OT>
__global__ void __launch_bounds__(wg::THREADS, 1) gemm_rs_kernel(const __grid_constant__ WgArgs w) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ wg::Bars bars;
  const GemmArgs& g = w.g;
  const Rank c(g.c);
  const Tiles<T> tl(g.m_loc, g.n_cols);
  const int n = c.n(), total = n * tl.count, warp = threadIdx.x / 32;
  wg::init_bars(bars);
  // hop s = i / T: chunk j = me - s - 1, the one that travels farthest first
  auto chunk = [&](int i) { return (c.me + 2 * n - i / tl.count - 1) % n; };
  if (warp >= wg::kProducerWarp) {
    if constexpr (kBf16<T>) wg::set_max_regs_dec<40>();
    if (warp == wg::kProducerWarp) {
      if constexpr (kBf16<T>) {
        if ((threadIdx.x & 31) == 0) {
          wg::Ring ring;
          const int ktiles = (g.k + wg::BK - 1) / wg::BK;
          for (int i = blockIdx.x; i < total; i += gridDim.x) {
            const int t = i % tl.count;
            wg::load_tile(wg::stages(dyn), bars, ring, &w.ma[c.slot(c.me)],
                          &w.mb[c.slot(c.me)], wg::TileAt{chunk(i), 0, tl.m0(t), tl.n0(t)},
                          ktiles);
          }
        }
      }
    } else if (threadIdx.x == (wg::kProducerWarp + 1) * 32) {
      // the neighbours' barrier (collective_prologue), before the first put
      red_release_add<kGpu>(c.flag(c.left(), kBarrier), 1);
      red_release_add<kGpu>(c.flag(c.right(), kBarrier), 1);
      wait_flag(c, c.flag(c.me, kBarrier), kBarrier, 2, true);
      wg::mbar_arrive(&bars.start);
    }
  } else {
    if constexpr (kBf16<T>) {
      wg::set_max_regs_inc<232>();
      wg::Ring ring;
      const int ktiles = (g.k + wg::BK - 1) / wg::BK;
      float d[wg::kAccRegs];
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int s = i / tl.count, t = i % tl.count;
        const WgFrag f(d);
        Partial<OT, WgFrag> part;
        rs_receive<OT>(c, g, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
        wg::mma_tile(wg::stages(dyn), bars, ring, ktiles, d);
        rs_epilogue<OT>(c, g, bars, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
      }
    } else {
      const T* A = base<const T>(g.a, c);
      const T* B = base<const T>(g.b, c);
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int s = i / tl.count, t = i % tl.count;
        float acc[4][4] = {};
        const F32Frag f(acc);
        Partial<OT, F32Frag> part;
        rs_receive<OT>(c, g, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
        gemm::f32_acc<gemm::Sync<wg::CONSUMERS>>(
            A + static_cast<long long>(chunk(i)) * g.m_loc * g.k, B, g.m_loc, g.n_cols, g.k,
            tl.m0(t), tl.n0(t), acc);
        rs_epilogue<OT>(c, g, bars, f, part, s, t, tl.count, tl.m0(t), tl.n0(t));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the main loop alone: Y_r = X_r @ W_r for R rank-stacked matrices, tiles
// dealt to blocks in turn (chip_smoke.py's chains of K12 and K13)

struct ProductArgs {
  const void* x;
  const void* w;
  void* y;
  int R, M, K, N;
  CUtensorMap ma, mb;
};

template <typename T, typename OT>
__global__ void __launch_bounds__(wg::THREADS, 1) product_kernel(const __grid_constant__ ProductArgs p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ wg::Bars bars;
  const Tiles<T> tl(p.M, p.N);
  const int total = p.R * tl.count, warp = threadIdx.x / 32;
  const long long mn = static_cast<long long>(p.M) * p.N;
  wg::init_bars(bars);
  if (warp >= wg::kProducerWarp) {
    if constexpr (kBf16<T>) {
      wg::set_max_regs_dec<40>();
      if (threadIdx.x == wg::kProducerWarp * 32) {
        wg::Ring ring;
        const int ktiles = (p.K + wg::BK - 1) / wg::BK;
        for (int i = blockIdx.x; i < total; i += gridDim.x) {
          const int r = i / tl.count, t = i % tl.count;
          wg::load_tile(wg::stages(dyn), bars, ring, &p.ma, &p.mb,
                        wg::TileAt{r, r, tl.m0(t), tl.n0(t)}, ktiles);
        }
      }
    }
  } else {
    OT* Y = static_cast<OT*>(p.y);
    if constexpr (kBf16<T>) {
      wg::set_max_regs_inc<232>();
      wg::Ring ring;
      const int ktiles = (p.K + wg::BK - 1) / wg::BK;
      float d[wg::kAccRegs];
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int r = i / tl.count, t = i % tl.count;
        wg::mma_tile(wg::stages(dyn), bars, ring, ktiles, d);
        store_tile<OT>(WgFrag(d), Y + r * mn, p.M, p.N, tl.m0(t), tl.n0(t));
      }
    } else {
      const T* X = static_cast<const T*>(p.x);
      const T* W = static_cast<const T*>(p.w);
      for (int i = blockIdx.x; i < total; i += gridDim.x) {
        const int r = i / tl.count, t = i % tl.count;
        float acc[4][4] = {};
        gemm::f32_acc<gemm::Sync<wg::CONSUMERS>>(X + r * static_cast<long long>(p.M) * p.K,
                                                 W + r * static_cast<long long>(p.K) * p.N,
                                                 p.M, p.N, p.K, tl.m0(t), tl.n0(t), acc);
        store_tile<OT>(F32Frag(acc), Y + r * mn, p.M, p.N, tl.m0(t), tl.n0(t));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K14's ring form: gemm_tile.cuh's tiles, a rank barrier a chunk

constexpr long long kMinUnitsPerLane = 2 * kThreads;  // as K9-K11

typedef gemm::Tile<128, 128, 32, 2, 4, 4> Bf16Tile;
static_assert(Bf16Tile::THREADS == kThreads, "a lane's block is one GEMM tile's block");

template <typename T> struct TileOf;
template <> struct TileOf<bf16> {
  static constexpr int BM = Bf16Tile::BM, BN = Bf16Tile::BN, SMEM = Bf16Tile::SMEM_BYTES;
};
template <> struct TileOf<float> {
  static constexpr int BM = gemm::kF32BM, BN = gemm::kF32BN, SMEM = 0;
};

// This lane's tiles of C = A @ B, A (M, K), B (K, N), C (M, N), row-major.
template <typename T, typename OT>
__device__ void lane_tiles(const T* A, const T* B, OT* C, int M, int N, int K,
                           unsigned char* smem) {
  constexpr int BM = TileOf<T>::BM, BN = TileOf<T>::BN;
  const int tiles_m = (M + BM - 1) / BM, tiles = tiles_m * ((N + BN - 1) / BN);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
    if constexpr (kBf16<T>)
      gemm::bf16_tile<Bf16Tile, OT>(A, B, C, M, N, K, m0, n0, reinterpret_cast<bf16*>(smem));
    else
      gemm::f32_tile<OT>(A, B, C, M, N, K, m0, n0);
  }
}

// K14's ring form.  The ring runs in OT, the products' dtype.
template <typename T, typename OT>
__global__ void __launch_bounds__(kThreads) gemm_ar_kernel(const __grid_constant__ GemmArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Rank c(g.c);
  int gen = 0;  // rank_sync's count
  collective_prologue(c, true);
  const T* A = base<const T>(g.a, c);
  const T* B = base<const T>(g.b, c);
  auto produce = [&](int j) {
    lane_tiles<T, OT>(A + static_cast<long long>(j) * g.m_loc * g.k, B,
                      c.at<OT>(g.c.x, c.me, j), g.m_loc, g.n_cols, g.k, smem);
    rank_sync(c, gen);
  };
  rs_ring_phase<OT, OT, true, false>(c, c.me, produce);
  ag_ring_phase<OT, uint4, 16>(c);
  rs_ack_drain(c);
  rank_sync_exit(c);
}

// K14's ring loop alone: every rank's product y[r] = x[r] @ w[r] by
// lane_tiles, one block a tile, grid (tiles, R).  Not a step of any path:
// chip_smoke.py's chain of K14's ring is built on it.
template <typename T, typename OT>
__global__ void __launch_bounds__(kThreads)
ring_loop_kernel(const T* x, const T* w, OT* y, int M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r = blockIdx.y;
  lane_tiles<T, OT>(x + r * M * K, w + r * K * N, y + r * M * N, M, N, K, smem);
}

// ---------------------------------------------------------------------------
// host side

bool aligned16(const Peers& p, int ranks) {
  for (int s = 0; s < ranks; ++s)
    if (reinterpret_cast<uintptr_t>(p.p[s]) % 16) return false;
  return true;
}

// Shapes and layouts the kernels take: K and the product's columns
// multiples of 8 (16-byte rows for TMA and for gemm_tile.cuh), every part
// 16-byte aligned, two ranks or more a team.
cudaError_t check_args(const GemmArgs* g, bool with_a, bool with_land) {
  const int ranks = g->c.n * g->c.groups;
  if (g->c.n < 2 || ranks > kMaxRanks || g->m_loc < 1 || g->k < 8 || g->k % 8 ||
      g->n_cols < 8 || g->n_cols % 8)
    return cudaErrorInvalidValue;
  if (!aligned16(g->c.x, ranks) || !aligned16(g->c.out, ranks) || !aligned16(g->b, ranks) ||
      !aligned16(g->y, ranks) || (with_a && !aligned16(g->a, ranks)) ||
      (with_land && !aligned16(g->c.land, ranks)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// K12/K13's launch arguments: the tensor maps of every mesh slot's A (K12:
// the gathered A, `a` null; K13: `a`) in chunks of m_loc rows, and its B.
template <typename T>
cudaError_t wg_args(const GemmArgs* g, const Peers* a, WgArgs* w) {
  w->g = *g;
  if constexpr (kBf16<T>) {
    const int ranks = g->c.n * g->c.groups;
    for (int s = 0; s < ranks; ++s) {
      cudaError_t e = wg::map_a(&w->ma[s], a ? a->p[s] : g->c.out.p[s], g->k, g->m_loc, g->c.n);
      if (e == cudaSuccess) e = wg::map_b(&w->mb[s], g->b.p[s], g->k, g->n_cols, 1);
      if (e == cudaSuccess && !a) e = wg::map_a(&w->mx[s], g->c.x.p[s], g->k, g->m_loc, 1);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

// Every lane co-resident, at most kMaxLanes / 2 (K13's tile flags take the
// pads' second half): one a tile of the rank's sequence, or more where the
// ring's slices ask for more (K9-K11's rule).
template <typename T>
long long wg_lanes(const GemmArgs* g, long long units) {
  const long long tiles = static_cast<long long>(g->c.n) * Tiles<T>(g->m_loc, g->n_cols).count;
  return min(max(tiles, (units + kMinUnitsPerLane - 1) / kMinUnitsPerLane),
             static_cast<long long>(kMaxLanes / 2));
}

constexpr int wg_smem(bool bf) { return bf ? wg::SMEM_BYTES : 0; }

template <typename T, typename OT>
cudaError_t ag_gemm_as(GemmArgs* g, bool bidir, cudaStream_t st) {
  WgArgs w;
  cudaError_t e = wg_args<T>(g, nullptr, &w);
  if (e != cudaSuccess) return e;
  const long long want = wg_lanes<T>(g, g->c.chunk_elems * static_cast<long long>(sizeof(T)) / 16);
  const int smem = (kBf16<T> ? wg::SMEM_BYTES : 1024) + kCopyStage;
  return bidir ? cooperative_launch(ag_gemm_kernel<T, OT, true>, &w, &w.g.c, want, smem, st,
                                    wg::THREADS)
               : cooperative_launch(ag_gemm_kernel<T, OT, false>, &w, &w.g.c, want, smem, st,
                                    wg::THREADS);
}

template <typename T, typename OT>
cudaError_t gemm_rs_as(GemmArgs* g, cudaStream_t st) {
  if (static_cast<long long>(g->c.n - 1) * Tiles<T>(g->m_loc, g->n_cols).count > kTileFlags)
    return cudaErrorInvalidValue;
  WgArgs w;
  cudaError_t e = wg_args<T>(g, &g->a, &w);
  if (e != cudaSuccess) return e;
  return cooperative_launch(gemm_rs_kernel<T, OT>, &w, &w.g.c, wg_lanes<T>(g, 0),
                            wg_smem(kBf16<T>), st, wg::THREADS);
}

// K14's ring: one lane per tile of a chunk, or more where the ring's slices
// ask for more.
template <typename T, typename OT>
cudaError_t gemm_ar_as(GemmArgs* g, cudaStream_t st) {
  const long long tiles =
      static_cast<long long>((g->m_loc + TileOf<T>::BM - 1) / TileOf<T>::BM) *
      ((g->n_cols + TileOf<T>::BN - 1) / TileOf<T>::BN);
  const long long units = g->c.chunk_elems * static_cast<long long>(sizeof(OT)) / 16;
  return cooperative_launch(gemm_ar_kernel<T, OT>, g, &g->c,
                            max(tiles, (units + kMinUnitsPerLane - 1) / kMinUnitsPerLane),
                            TileOf<T>::SMEM, st);
}

template <typename T, typename OT>
cudaError_t product_as(ProductArgs* p, cudaStream_t st) {
  if constexpr (kBf16<T>) {
    cudaError_t e = wg::map_a(&p->ma, p->x, p->K, p->M, p->R);
    if (e == cudaSuccess) e = wg::map_b(&p->mb, p->w, p->K, p->N, p->R);
    if (e != cudaSuccess) return e;
  }
  auto kernel = product_kernel<T, OT>;
  const int smem = wg_smem(kBf16<T>);
  long long fit = 0;
  cudaError_t e = resident_lanes(kernel, 1, wg::THREADS, smem, &fit);
  if (e != cudaSuccess) return e;
  const long long tiles = static_cast<long long>(p->R) * Tiles<T>(p->M, p->N).count;
  const unsigned grid = static_cast<unsigned>(max(1LL, min(tiles, fit)));
  kernel<<<grid, wg::THREADS, smem, st>>>(*p);
  return cudaGetLastError();
}

template <typename T, typename OT>
cudaError_t ring_product_as(const void* x, const void* w, void* y, int R, int M, int K, int N,
                            cudaStream_t st) {
  auto kernel = ring_loop_kernel<T, OT>;
  constexpr int smem = TileOf<T>::SMEM;
  cudaError_t e;
  if (smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return e;
  const long long tiles = static_cast<long long>((M + TileOf<T>::BM - 1) / TileOf<T>::BM) *
                          ((N + TileOf<T>::BN - 1) / TileOf<T>::BN);
  if (tiles >= (1LL << 31) || R > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(static_cast<unsigned>(tiles), R), kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<OT*>(y), M, K, N);
  return cudaGetLastError();
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

}  // namespace
}  // namespace dl
}  // namespace tdt

using tdt::dl::GemmArgs;

// K12.  c.x: A shards (m_loc, k) of dtype; c.out: the gathered A (n m_loc,
// k) of dtype; y: C (n m_loc, n_cols) of out_dtype; b: B (k, n_cols);
// c.chunk_elems = m_loc k.  bidir: the two-way ring.  Returns the launch's
// cudaError_t.
extern "C" int tdt_ag_gemm(GemmArgs* g, int bidir, void* stream) {
  using namespace tdt::dl;
  cudaError_t e = check_args(g, false, false);
  if (e == cudaSuccess)
    e = by_dtype(g->c.dtype, g->c.out_dtype, [&](auto t, auto ot) {
      return ag_gemm_as<typename decltype(t)::type, typename decltype(ot)::type>(
          g, bidir != 0, static_cast<cudaStream_t>(stream));
    });
  return static_cast<int>(e);
}

// K13.  a: A (n m_loc, k) of dtype; b: B (k, n_cols); c.land: n - 1 slots
// of (m_loc, n_cols) of out_dtype; c.out: the output chunk (m_loc, n_cols);
// c.x and y unused (any 16-byte aligned tensor); c.chunk_elems = m_loc
// n_cols.
extern "C" int tdt_gemm_rs(GemmArgs* g, void* stream) {
  using namespace tdt::dl;
  cudaError_t e = check_args(g, true, true);
  if (e == cudaSuccess)
    e = by_dtype(g->c.dtype, g->c.out_dtype, [&](auto t, auto ot) {
      return gemm_rs_as<typename decltype(t)::type, typename decltype(ot)::type>(
          g, static_cast<cudaStream_t>(stream));
    });
  return static_cast<int>(e);
}

// K14's ring form.  a: A (n m_loc, k); b: B (k, n_cols); y (= c.x): the
// product buffer, n chunks of (m_loc, n_cols) of out_dtype; c.land: two
// such slots; c.out: the replicated output (n m_loc, n_cols).
extern "C" int tdt_gemm_ar(GemmArgs* g, void* stream) {
  using namespace tdt::dl;
  cudaError_t e = check_args(g, true, true);
  if (e == cudaSuccess)
    e = by_dtype(g->c.dtype, g->c.out_dtype, [&](auto t, auto ot) {
      return gemm_ar_as<typename decltype(t)::type, typename decltype(ot)::type>(
          g, static_cast<cudaStream_t>(stream));
    });
  return static_cast<int>(e);
}

// K12's and K13's main loop alone, as a rank-stacked product: y[r] = x[r] @
// w[r] for r < R, x (R, M, K) and w (R, K, N) of dtype, y (R, M, N) of
// out_dtype, row-major and 16-byte aligned, K and N multiples of 8.  Not a
// step of any path: chip_smoke.py's chains of K12 and K13 are built on it.
extern "C" int tdt_wgmma_product(const void* x, const void* w, void* y, int R, int M, int K,
                                 int N, int dtype, int out_dtype, void* stream) {
  using namespace tdt::dl;
  if (R < 1 || M < 1 || K < 8 || K % 8 || N < 8 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  ProductArgs p{x, w, y, R, M, K, N, {}, {}};
  return static_cast<int>(by_dtype(dtype, out_dtype, [&](auto t, auto ot) {
    return product_as<typename decltype(t)::type, typename decltype(ot)::type>(
        &p, static_cast<cudaStream_t>(stream));
  }));
}

// K14's ring loop alone (gemm_tile.cuh's tiles as the ring's lanes run
// them), as a rank-stacked product with tdt_wgmma_product's arguments.  Not
// a step of any path: chip_smoke.py's chain of K14's ring is built on it.
extern "C" int tdt_ring_product(const void* x, const void* w, void* y, int R, int M, int K,
                                int N, int dtype, int out_dtype, void* stream) {
  using namespace tdt::dl;
  if (R < 1 || M < 1 || K < 8 || K % 8 || N < 8 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_dtype(dtype, out_dtype, [&](auto t, auto ot) {
    return ring_product_as<typename decltype(t)::type, typename decltype(ot)::type>(
        x, w, y, R, M, K, N, static_cast<cudaStream_t>(stream));
  }));
}
