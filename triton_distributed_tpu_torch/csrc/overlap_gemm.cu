// K12, K13, K14: the overlapped GEMMs on ranks co-located on one Hopper card
// (sm_90a): AllGather-GEMM, GEMM-ReduceScatter and GEMM-AllReduce.
//
// Replace, schedule for schedule (comm/ring.py and ops/{ag_gemm,gemm_rs,
// gemm_ar}.py hold the Python mirrors, which the plain versions walk):
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
//        then multiplied, the local chunk first; the gathered A is an output
//        too.
//   K13  the ReduceScatter of the partials A_r @ B_r (A_r: M x k_loc): the
//        ring of K10 in the output dtype, where chunk j's fresh product is
//        computed just before the hop that reads it (the chunk that travels
//        farthest first), rounded to the output dtype, then added to the
//        received partial in f32 and rounded once (JAX blocks.add_body).
//   K14  K13's phase with its last add landing in out-chunk `me` of the
//        replicated output, then K11's AllGather ring of the reduced chunks,
//        no barrier between them (every put of the second is gated by its
//        own flag).
// The arithmetic is the chains' (K9 then K6, K6 then K10, K6 then K11's
// two-shot) at the tile K6 runs: gemm_tile.cuh's tiles give the same bits
// for every tile shape, and the ring adds are K10's.  So each kernel is
// bitwise equal to its chain.
//
// Design.  A block is a lane (blockIdx.x) of a rank (blockIdx.y): it moves
// its slice of every chunk, as in K9-K11, and computes GEMM tiles of the
// chunk at hand, tile t of a chunk on lane t % lanes (gemm_tile.cuh's main
// loop: mma.sync bf16 -> f32 on 128 x 128 x 32 tiles of 8 warps, a 4-stage
// cp.async ring; f32 by scalar FMA on 64 x 64 tiles).  A tile reads whole
// rows of a chunk and writes columns that every lane's slice covers, so the
// lanes of a rank meet at dl.cuh's rank_sync before a chunk is multiplied
// (K12: every slice is here) or sent (K13/K14: every tile is written).  The
// grid is sized by the occupancy API to what is co-resident, split among
// the ranks; no block waits on a flag that only it, or a block that is not
// resident, would set.  K13/K14 keep one product buffer entry per chunk (JAX
// keeps two, mm_buf[s % 2]): a lane that runs ahead then never overwrites a
// product that a slower lane of its rank has yet to send.
//
// Bound on the H100: operations at the prefill shapes (Qwen3-8B, tp = 4,
// 4 x 1024 rows: 400-1500 flops a byte), bytes at the decode shapes
// (4 rows: the weights dominate).  This first form does not reach either:
// it runs K6's mma.sync main loop (no wgmma, no TMA) and joins the lanes
// once a chunk.  K14 here is the ring form, for partials above the one-shot
// threshold (comm/allreduce.py choose_method): a row chunk of a decode
// batch is a 128-row tile with one real row, and each chunk reads the whole
// weight panel.  At decode sizes ops/gemm_ar.py launches K15's one-shot
// linear form instead (fused_ar.cu: one pass over the weight, one barrier,
// one hop).
#include <type_traits>

#include "gemm_tile.cuh"
#include "ring.cuh"

namespace tdt {
namespace dl {

// core/symm.py GemmArgs, field for field.  c.x is the input the ring reads
// (K12: the A shard; K13/K14: the product buffer), c.out the ring's output
// (K12: the gathered A; K13: the output chunk; K14: the replicated output),
// c.land the ReduceScatter's two receive slots; a the A operand (K13/K14),
// b the B operand, y the GEMM's output (K12: C; K13/K14: the product
// buffer, n entries of one chunk).  A chunk's product is (m_loc, k) @
// (k, n_cols); c.chunk_elems counts the elements of one ring chunk.
struct GemmArgs {
  CollArgs c;
  Peers a, b, y;
  int m_loc, k, n_cols;
};

namespace {

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

template <typename T>
__device__ __forceinline__ T* base(const Peers& p, const Rank& c) {
  return reinterpret_cast<T*>(p.p[c.slot(c.me)]);
}

// This lane's tiles of C = A @ B, A (M, K), B (K, N), C (M, N), row-major.
template <typename T, typename OT>
__device__ void lane_tiles(const T* A, const T* B, OT* C, int M, int N, int K,
                           unsigned char* smem) {
  constexpr int BM = TileOf<T>::BM, BN = TileOf<T>::BN;
  const int tiles_m = (M + BM - 1) / BM, tiles = tiles_m * ((N + BN - 1) / BN);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * BM, n0 = (t / tiles_m) * BN;
    if constexpr (std::is_same<T, bf16>::value)
      gemm::bf16_tile<Bf16Tile, OT>(A, B, C, M, N, K, m0, n0, reinterpret_cast<bf16*>(smem));
    else
      gemm::f32_tile<OT>(A, B, C, M, N, K, m0, n0);
  }
}

// K12
template <typename T, typename OT, bool BIDIR>
__global__ void __launch_bounds__(kThreads) ag_gemm_kernel(const __grid_constant__ GemmArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Rank c(g.c);
  int gen = 0;  // rank_sync's count
  {  // own shard into gathered chunk me: this lane's slice, as the ring cuts it
    long long lo, hi;
    c.slice(16 / sizeof(T), 16, lo, hi);
    uint4* d = reinterpret_cast<uint4*>(c.at<T>(g.c.out, c.me, c.me));
    copy_units<uint4>(&d, 1, reinterpret_cast<const uint4*>(c.at<T>(g.c.x, c.me, 0)), lo, hi);
  }
  put_fence();  // gathered chunk me is read back by this block's first put
  collective_prologue(c, true);
  const T* B = base<const T>(g.b, c);
  OT* C = base<OT>(g.y, c);
  auto consume = [&](int r) {
    rank_sync(c, gen);
    lane_tiles<T, OT>(c.at<T>(g.c.out, c.me, r), B,
                      C + static_cast<long long>(r) * g.m_loc * g.n_cols, g.m_loc, g.n_cols,
                      g.k, smem);
  };
  if (BIDIR) bidir_ring_phase<T, uint4, 16>(c, consume);
  else ag_ring_phase<T, uint4, 16>(c, consume);
  rank_sync_exit(c);
}

// K13 (AR false) and K14 (AR true).  The ring runs in OT, the products'
// dtype.
template <typename T, typename OT, bool AR>
__global__ void __launch_bounds__(kThreads) gemm_rs_kernel(const __grid_constant__ GemmArgs g) {
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
  rs_ring_phase<OT, OT, true, false>(c, AR ? c.me : 0, produce);
  if (AR) ag_ring_phase<OT, uint4, 16>(c);
  rs_ack_drain(c);
  rank_sync_exit(c);
}

bool aligned16(const Peers& p, int ranks) {
  for (int s = 0; s < ranks; ++s)
    if (reinterpret_cast<uintptr_t>(p.p[s]) % 16) return false;
  return true;
}

// The lanes a call asks for: one per tile of a chunk, or more where the
// ring's slices ask for more (K9-K11's rule), at most what is co-resident.
template <typename T, typename RT>
long long lanes_wanted(const GemmArgs* g) {
  const long long tiles =
      static_cast<long long>((g->m_loc + TileOf<T>::BM - 1) / TileOf<T>::BM) *
      ((g->n_cols + TileOf<T>::BN - 1) / TileOf<T>::BN);
  const long long units = g->c.chunk_elems * static_cast<long long>(sizeof(RT)) / 16;
  return max(tiles, (units + kMinUnitsPerLane - 1) / kMinUnitsPerLane);
}

// Shapes and layouts the kernels take: K and the product's columns
// multiples of 8 (gemm_tile.cuh), every part 16-byte aligned, two ranks or
// more a team.
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

template <typename T, typename OT>
cudaError_t ag_gemm_as(GemmArgs* g, bool bidir, cudaStream_t st) {
  const long long want = lanes_wanted<T, T>(g);
  return bidir ? cooperative_launch(ag_gemm_kernel<T, OT, true>, g, &g->c, want,
                                    TileOf<T>::SMEM, st)
               : cooperative_launch(ag_gemm_kernel<T, OT, false>, g, &g->c, want,
                                    TileOf<T>::SMEM, st);
}

template <typename T, typename OT, bool AR>
cudaError_t gemm_rs_as(GemmArgs* g, cudaStream_t st) {
  return cooperative_launch(gemm_rs_kernel<T, OT, AR>, g, &g->c, lanes_wanted<T, OT>(g),
                            TileOf<T>::SMEM, st);
}

template <typename T> struct Ty { typedef T type; };

// (dtype, out_dtype) codes: 0 f32, 1 bf16.  Built: bf16 -> bf16, bf16 -> f32,
// f32 -> f32.
template <typename F>
cudaError_t by_dtype(const GemmArgs* g, F f) {
  const int dt = g->c.dtype, ot = g->c.out_dtype;
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
    e = by_dtype(g, [&](auto t, auto ot) {
      return ag_gemm_as<typename decltype(t)::type, typename decltype(ot)::type>(
          g, bidir != 0, static_cast<cudaStream_t>(stream));
    });
  return static_cast<int>(e);
}

// K13.  a: A (n m_loc, k) of dtype; b: B (k, n_cols); y (= c.x): the product
// buffer, n chunks of (m_loc, n_cols) of out_dtype; c.land: two such slots;
// c.out: the output chunk (m_loc, n_cols); c.chunk_elems = m_loc n_cols.
extern "C" int tdt_gemm_rs(GemmArgs* g, void* stream) {
  using namespace tdt::dl;
  cudaError_t e = check_args(g, true, true);
  if (e == cudaSuccess)
    e = by_dtype(g, [&](auto t, auto ot) {
      return gemm_rs_as<typename decltype(t)::type, typename decltype(ot)::type, false>(
          g, static_cast<cudaStream_t>(stream));
    });
  return static_cast<int>(e);
}

// K14.  As K13, c.out the replicated output (n m_loc, n_cols).
extern "C" int tdt_gemm_ar(GemmArgs* g, void* stream) {
  using namespace tdt::dl;
  cudaError_t e = check_args(g, true, true);
  if (e == cudaSuccess)
    e = by_dtype(g, [&](auto t, auto ot) {
      return gemm_rs_as<typename decltype(t)::type, typename decltype(ot)::type, true>(
          g, static_cast<cudaStream_t>(stream));
    });
  return static_cast<int>(e);
}
