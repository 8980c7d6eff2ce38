// The decode-shaped product and the two AllReduce(A @ W) instances built on
// it: the one-shot form (K15 and K14 at decode sizes, fused_ar.cu) and the
// column-chunked ring (K15 above the one-shot threshold, and K16,
// persistent_decode.cu).
//
// The product.  At decode a product has B <= a few rows and a weight of
// megabytes: it is bound by the weight's bytes, which every SM should
// stream.  A work item is a tile of kTileCols output columns and a slice of
// the K rows, for every row of A (kProjBatch rows per pass over the weight
// slice); it reads each weight element of its tile and slice once, with
// 16-byte loads, and writes f32 partial sums, one (B, cols) plane per K
// slice.  The slices are then summed in a fixed order and rounded once
// (finalize_range), so the result does not depend on the lanes' timing.
// No padding rows: a B = 4 product is 4 rows, not a 128-row tensor-core tile
// with 124 rows of padding (K14's ring tile).
//
// The one-shot instance (oneshot_instance): the whole (B, N) product in one
// pass over the weight by every lane of the rank, one rank-wide barrier,
// each lane's slice of the partial summed and rounded once, then K11's
// one-shot exchange of that slice (collectives.cu all_reduce_kernel<..., 0>:
// push into slot `me` of every rank, n - 1 arrivals, the n slots summed in
// slot order in f32 and rounded once).  One hop of latency; what the JAX
// package's _ar_one_shot_kernel does after a product, chosen by the same
// size rule (comm/allreduce.py choose_method).
//
// The ring instance (ChunkProduct + ar_instance): AllReduce(A @ W) over
// OUTPUT column chunks, JAX comm/ring.py gemm_rs_chunk_phase then
// ag_ring_phase, on ring.cuh's phases.  Chunk j is W's columns [j cn,
// (j + 1) cn); its product is made just before the ring step that reads it
// (`produce`): every lane of the rank takes its items of the chunk, the
// lanes meet at a rank-wide barrier (the items write partials every lane's
// slice reads), and each lane then sums and rounds exactly its own ring slice
// of the chunk into the chunk's product entry, which only it sends.  The
// partials are double-buffered by product parity: a lane writes the partials
// of product p + 2 only after the barrier of product p + 1, which no lane
// passes before every lane is done reading product p's.
#pragma once

#include "fused_stages.cuh"
#include "ring.cuh"

namespace tdt {
namespace far {

constexpr int kTileCols = 64;  // output columns of a product work item
constexpr int kRowGranule = 64;
// K rows of A a staged work item holds in shared memory (the one-shot
// form's plans cut K no coarser; ops/fused_decode.py GEMV_STAGE_ROWS)
constexpr int kStageRows = 512;

// One product's plan (the host sizes it, ops/fused_decode.py::gemv_plan):
// B rows, depth Kd, `cols` output columns, the K rows cut into n_kslice
// slices of k_chunk.
struct Gemv {
  int B, Kd, cols, n_kslice, k_chunk;
};

__device__ __forceinline__ int gemv_items(const Gemv& g) {
  return (g.cols + kTileCols - 1) / kTileCols * g.n_kslice;
}

// Work item `item` of A (B, Kd; row stride lda) @ W[:, 0:cols] (row stride
// ldw): its tile's columns and its K slice, every row of A, as f32 partial
// sums into part[(ks * B + b) * cols + c].  cols is a multiple of 16 /
// sizeof(TW) (a lane's load is whole or outside), W 16-byte aligned.
// STAGE (the one-shot form; k_chunk <= kStageRows): the item's K rows of
// A's rows are first copied into shared memory, one L2 read each, so the
// weight loop reads A there; otherwise each product term reads its A value
// through L2 (ld.global.cg), one round trip per unrolled weight row.
template <typename TA, typename TW, bool STAGE = false>
__device__ void gemv_item(const TA* A, int lda, const TW* W, long long ldw, const Gemv& g,
                          int item, float* part) {
  constexpr int E = 16 / sizeof(TW);     // weight columns per 16-byte load
  constexpr int LPW = kTileCols / E;     // lanes per weight row of the tile
  constexpr int RPW = 32 / LPW;          // weight rows per warp
  constexpr int RPB = kWarps * RPW;      // weight rows per block and step
  constexpr int U = kProjUnroll;
  constexpr int PB = kProjBatch;
  __shared__ float s_red[kWarps][PB][kTileCols];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPW, row = warp * RPW + lane / LPW;
  const int ks = item % g.n_kslice, c0 = item / g.n_kslice * kTileCols;
  const int col = c0 + sub * E;
  const bool live = col < g.cols;
  const int k0 = ks * g.k_chunk, k1 = min(g.Kd, k0 + g.k_chunk);
  float* s_a = nullptr;  // STAGE: A's PB rows of this slice, [bb][k - k0]
  if constexpr (STAGE) {
    __shared__ float s_stage[PB * kStageRows];
    s_a = s_stage;
  }
  for (int b0 = 0; b0 < g.B; b0 += PB) {
    if constexpr (STAGE) {
      const int rows = k1 - k0;
      for (int i = tid; i < PB * rows; i += kThreads) {
        const int bb = i / rows, kk = i % rows;
        s_a[bb * kStageRows + kk] =
            b0 + bb < g.B ? ldcg_f32(A + static_cast<long long>(b0 + bb) * lda + k0 + kk) : 0.f;
      }
      __syncthreads();
    }
    float acc[PB][E];
#pragma unroll
    for (int bb = 0; bb < PB; ++bb)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[bb][e] = 0.f;
    for (int kk = k0 + row; kk < k1; kk += RPB * U) {
      uint4 wr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + u * RPB;
        wr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (live && k < k1)
          wr[u] = __ldg(reinterpret_cast<const uint4*>(W + static_cast<long long>(k) * ldw + col));
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + u * RPB;
        if (k < k1) {
          float wf[E];
          unpack16(wr[u], wf, TW());
#pragma unroll
          for (int bb = 0; bb < PB; ++bb) {
            if (b0 + bb < g.B) {
              float xv;
              if constexpr (STAGE) xv = s_a[bb * kStageRows + k - k0];
              else xv = ldcg_f32(A + static_cast<long long>(b0 + bb) * lda + k);
#pragma unroll
              for (int e = 0; e < E; ++e) acc[bb][e] = fmaf(xv, wf[e], acc[bb][e]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int off = LPW; off < 32; off <<= 1)
#pragma unroll
      for (int bb = 0; bb < PB; ++bb)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[bb][e] += __shfl_xor_sync(kFullMask, acc[bb][e], off);
    if (lane < LPW) {
#pragma unroll
      for (int bb = 0; bb < PB; ++bb)
#pragma unroll
        for (int e = 0; e < E; ++e) s_red[warp][bb][sub * E + e] = acc[bb][e];
    }
    __syncthreads();
    for (int i = tid; i < PB * kTileCols; i += kThreads) {
      const int bb = i / kTileCols, c = i % kTileCols;
      if (b0 + bb < g.B && c0 + c < g.cols) {
        float sum = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) sum += s_red[wp][bb][c];
        part[(static_cast<long long>(ks) * g.B + b0 + bb) * g.cols + c0 + c] = sum;
      }
    }
    __syncthreads();
  }
}

// This lane's items of a product (items are dealt to the rank's lanes in
// turn).
template <typename TA, typename TW, bool STAGE = false>
__device__ __forceinline__ void gemv_lane(const TA* A, int lda, const TW* W, long long ldw,
                                          const Gemv& g, float* part) {
  const int items = gemv_items(g);
  for (int it = blockIdx.x; it < items; it += gridDim.x)
    gemv_item<TA, TW, STAGE>(A, lda, W, ldw, g, it, part);
}

// dst[e] = the K slices' partials of element e summed in slice order and
// rounded once to OT, for e in [e0, e1) of one (B, cols) plane.
template <typename OT>
__device__ __forceinline__ void finalize_range(const float* part, const Gemv& g, OT* dst,
                                               long long e0, long long e1) {
  const long long plane = static_cast<long long>(g.B) * g.cols;
  for (long long e = e0 + threadIdx.x; e < e1; e += blockDim.x) {
    float s = 0.f;
    for (int ks = 0; ks < g.n_kslice; ++ks) s += __ldcg(part + ks * plane + e);
    dst[e] = from_f32<OT>(s);
  }
}

// One AllReduce(A @ W) instance in the one-shot form, n >= 2 ranks: every
// lane takes its items of the whole (B, g.cols) product (A staged, so
// g.k_chunk <= kStageRows), the lanes meet at
// one rank-wide barrier, each lane sums and rounds its slice of the partial
// into product entry 0 of c.a.x, then runs K11's one-shot on that slice
// (collectives.cu all_reduce_kernel<OT, OT, true, 0>): a push into slot `me`
// of every rank's landing (c.a.land, n slots of one partial) and the n
// slots summed in slot order into entry 0 of c.a.out, rank me's copy of the
// result.  c.a.chunk_elems = B g.cols, a multiple of 16 bytes of OT.  The
// push takes every credit it gives (its barrier and the n - 1 arrivals).
template <typename TA, typename TW, typename OT>
__device__ void oneshot_instance(const dl::Rank& c, const TA* A, int lda, const TW* W,
                                 long long ldw, const Gemv& g, float* part, int& gen) {
  constexpr int G = dl::Elems<OT, true>::G;
  gemv_lane<TA, TW, true>(A, lda, W, ldw, g, part);
  dl::rank_sync(c, gen);
  long long lo, hi;  // this lane's slice, in 16-byte units of OT
  c.slice(G, dl::quantum<true>(), lo, hi);
  finalize_range<OT>(part, g, c.at<OT>(c.a.x, c.me, 0), lo * G, hi * G);
  __syncthreads();  // the slice is read back in 16-byte units by other threads
  // every rank is a block of this launch on this card: device-scope flags
  dl::push_phase<OT, uint4, dl::kGpu>(c, c.a.land, lo, hi);
  const OT* src[dl::kMaxRanks];
  for (int i = 0; i < c.n(); ++i) src[i] = c.at<OT>(c.a.land, c.me, i);
  dl::sum_units<OT, OT, true>(c.at<OT>(c.a.out, c.me, 0), src, c.n(), lo, hi);
}

// [lo, hi) elements of this lane's ring slice of a (B, cn) chunk of OT (the
// cut rs_ring_phase<OT, OT, true> and ag_ring_phase<OT, uint4, 16> make).
template <typename OT>
__device__ __forceinline__ void ring_slice(const dl::Rank& c, long long& lo, long long& hi) {
  constexpr int G = dl::Elems<OT, true>::G;
  c.slice(G, dl::quantum<true>(), lo, hi);
  lo *= G;
  hi *= G;
}

// The ring's `produce`: chunk j of A @ W (W's columns [j cols, (j + 1)
// cols)) into entry j of `dst` (the rank's product entries, or at n = 1
// the reduced output itself).
template <typename TA, typename TW, typename OT>
struct ChunkProduct {
  const dl::Rank& c;
  const dl::Peers& dst;
  const TA* A;
  int lda;
  const TW* W;
  long long ldw;
  Gemv g;
  float* part;  // two planes of n_kslice (B, cols) each, by product parity
  int& gen;     // rank_sync's count
  int& parity;  // products made so far

  __device__ void operator()(int j) const {
    float* p = part + static_cast<long long>(parity & 1) * g.n_kslice * g.B * g.cols;
    gemv_lane<TA, TW>(A, lda, W + static_cast<long long>(j) * g.cols, ldw, g, p);
    dl::rank_sync(c, gen);
    long long lo, hi;
    ring_slice<OT>(c, lo, hi);
    finalize_range<OT>(p, g, c.at<OT>(dst, c.me, j), lo, hi);
    __syncthreads();
    ++parity;
  }
};

// One AllReduce(A @ W) ring instance over output column chunks (JAX
// persistent_decode.py _chained_ar): ring ReduceScatter of the chunk
// products (each hop's add in f32, rounded once to OT), then the AllGather
// ring of the reduced chunks into c.a.out (chunk-major, n (B, cn) chunks).
// `armed`: not the first instance on these flags; it first takes the
// previous instance's outstanding ACK credits, which a standalone call
// drains at its end (the caller drains the last instance's).  At n = 1 the
// product goes straight to chunk 0 of c.a.out.
template <typename TA, typename TW, typename OT>
__device__ void ar_instance(const dl::Rank& c, const TA* A, int lda, const TW* W,
                            long long ldw, const Gemv& g, float* part, int& gen,
                            int& parity, bool armed) {
  if (c.n() == 1) {
    ChunkProduct<TA, TW, OT>{c, c.a.out, A, lda, W, ldw, g, part, gen, parity}(0);
    return;
  }
  if (armed) dl::rs_ack_drain(c);
  dl::rs_ring_phase<OT, OT, true, false>(
      c, c.me, ChunkProduct<TA, TW, OT>{c, c.a.x, A, lda, W, ldw, g, part, gen, parity});
  dl::ag_ring_phase<OT, uint4, 16>(c);
}

}  // namespace far
}  // namespace tdt
