// K6: the local tiled GEMM C = A @ B for Hopper (sm_90a), f32 accumulation.
//
// Replaces triton_distributed_tpu/ops/matmul.py::_build_matmul (the Pallas
// (m, n, k)-grid GEMM over blocks.matmul_body: bf16 operands, an f32
// accumulator in VMEM, the tile cast to out_dtype once).  The Pallas grid
// walks k in order on one core, accumulating in scratch; here a block runs
// the whole k loop of an output tile itself, so nothing is carried between
// blocks and the tile is rounded once, in the epilogue.
//
// Bound on the H100: at the shapes the port runs (bench.py's 7168^3 and
// 4096 x 7168 x 7168, Qwen3-8B's prefill projections at 4096 rows) a product
// does 2 M N K flops on (M K + K N + M N) * 2 bytes, 400-1800 flops a byte,
// above the 295 where the bf16 tensor cores become the limit: the bound is
// operations, 0.14-5.2 ms at 989 TFLOP/s.  So the design keeps the tensor
// cores fed.
//
// bf16 operands run wgmma_tile.cuh's loop (K12's, K13's and K5's) on
// 128 x 256 x 64 tiles: 384-thread blocks, warp 8 the TMA producer,
// warpgroups 0-1 consuming on wgmma m64n256k16 with A and B from shared
// memory, a 4-stage ring of 48 KB stages; one persistent block an SM (the ring and the consumers' 232
// registers fill it) walks the output tiles t = blockIdx.x, + gridDim.x, ...
// in the grouped order the first design launched its blocks in: groups of
// kGroupM m-tiles, each walked down its n-columns, so the ~132 tiles in
// flight at once share a few A row panels and B column panels in the 50 MB
// L2.  The producer runs ahead across tiles, so a tile's epilogue overlaps
// the next tile's first loads.  TMA zero-fills the M edge and the ragged K
// and N edges; the stores are predicated (K and N multiples of 8: TMA's
// 16-byte pitch, and an 8-column piece lies wholly inside or past N).  An
// output element's sum runs over k in 16-deep wgmma steps in order, so a
// result is deterministic and independent of the tile's place in the walk.
// bf16 results leave as 16-byte row pieces after a quad transpose, f32
// results as float pairs.
//
// f32 operands run in full f32 by scalar FMA (gemm_tile.cuh::f32_tile,
// 64x64x16, 256 threads, one block a tile in the same grouped order), as the
// JAX contract of true f32 accumulation asks (JAX ops/matmul.py:72-78); that
// path serves parity, not speed.
//
// The tiles (bm, bn, bk) built here are the ones ops/matmul.py::KERNEL_TILES
// lists, and ops/matmul.py::tile_walk mirrors the walk.
#include <type_traits>

#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace {

constexpr int kGroupM = 8;  // m-tiles a group walks down one n-column

// Tile b of a (tiles_m x tiles_n) grid in grouped order: groups of kGroupM
// m-tiles, each walked column by column, so consecutive tiles share B
// panels and a group's tiles share A panels.
__device__ __forceinline__ void tile_of(int b, int tiles_m, int tiles_n,
                                        int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int group = b / per_group;
  const int first = group * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int in_group = b % per_group;
  tm = first + in_group % rows;
  tn = in_group / rows;
}

// bf16: the wgmma loop on a persistent walk.  A (K, M, 1) and B (N, K, 1)
// as TMA maps; C (M, N) of OutT.
struct WgArgs {
  CUtensorMap ma, mb;
  void* c;
  int M, N, K;
};

template <typename OutT>
__global__ void __launch_bounds__(wg::THREADS, 1) matmul_wgmma(const __grid_constant__ WgArgs p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ wg::Bars bars;
  wg::init_bars(bars);
  const int tiles_m = (p.M + wg::BM - 1) / wg::BM, tiles_n = (p.N + wg::BN - 1) / wg::BN;
  const int tiles = tiles_m * tiles_n, ktiles = (p.K + wg::BK - 1) / wg::BK;
  unsigned char* st = wg::stages(dyn);
  int tm, tn;
  if (threadIdx.x / 32 >= wg::kProducerWarp) {
    wg::set_max_regs_dec<40>();
    if (threadIdx.x == wg::kProducerWarp * 32) {
      wg::Ring ring;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        tile_of(t, tiles_m, tiles_n, tm, tn);
        wg::load_tile(st, bars, ring, &p.ma, &p.mb, wg::TileAt{0, 0, tm * wg::BM, tn * wg::BN},
                      ktiles);
      }
    }
    return;
  }
  wg::set_max_regs_inc<232>();
  wg::Ring ring;
  float d[wg::kAccRegs];
  OutT* C = static_cast<OutT*>(p.c);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    tile_of(t, tiles_m, tiles_n, tm, tn);
    wg::mma_tile(st, bars, ring, ktiles, d);
    const int m0 = tm * wg::BM, n0 = tn * wg::BN;
    if constexpr (std::is_same<OutT, bf16>::value) {
      wg::store_pieces(d, C, p.M, p.N, m0, n0);
    } else {
      const int r0 = wg::acc_row0(), c0 = wg::acc_col0();
#pragma unroll
      for (int q = 0; q < wg::kAccRegs / 2; ++q) {
        const int row = m0 + r0 + 8 * (q & 1), col = n0 + 8 * (q >> 1) + c0;
        if (row < p.M && col < p.N)
          *reinterpret_cast<float2*>(C + static_cast<long long>(row) * p.N + col) =
              make_float2(d[4 * (q >> 1) + 2 * (q & 1)], d[4 * (q >> 1) + 2 * (q & 1) + 1]);
      }
    }
  }
}

template <typename OutT>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int M, int N, int K,
                         cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16)
    return cudaErrorInvalidValue;
  const long long tiles =
      static_cast<long long>((M + wg::BM - 1) / wg::BM) * ((N + wg::BN - 1) / wg::BN);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  WgArgs p{};
  cudaError_t e = wg::map_a(&p.ma, a, K, M, 1);
  if (e == cudaSuccess) e = wg::map_b(&p.mb, b, K, N, 1);
  if (e != cudaSuccess) return e;
  p.c = c;
  p.M = M, p.N = N, p.K = K;
  auto kernel = matmul_wgmma<OutT>;
  constexpr int smem = wg::SMEM_BYTES;
  long long fit = 0;  // one block an SM
  if ((e = dl::resident_lanes(kernel, 1, wg::THREADS, smem, &fit)) != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(max(1LL, min(fit, tiles)));
  kernel<<<grid, wg::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// f32: scalar FMA in full f32 (no TF32), gemm_tile.cuh::f32_tile.
using gemm::kF32BK;
using gemm::kF32BM;
using gemm::kF32BN;
using gemm::kF32Threads;

template <typename OutT>
__global__ void __launch_bounds__(kF32Threads)
matmul_f32(const float* __restrict__ A, const float* __restrict__ B,
           OutT* __restrict__ C, int M, int N, int K) {
  const int tiles_m = (M + kF32BM - 1) / kF32BM, tiles_n = (N + kF32BN - 1) / kF32BN;
  int tm, tn;
  tile_of(blockIdx.x, tiles_m, tiles_n, tm, tn);
  gemm::f32_tile<OutT>(A, B, C, M, N, K, tm * kF32BM, tn * kF32BN);
}

template <typename OutT>
cudaError_t launch_f32(const void* a, const void* b, void* c, int M, int N,
                       int K, cudaStream_t st) {
  const long long blocks = static_cast<long long>((M + kF32BM - 1) / kF32BM) *
                           ((N + kF32BN - 1) / kF32BN);
  matmul_f32<OutT><<<static_cast<unsigned>(blocks), kF32Threads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<OutT*>(c), M, N, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tdt

// a (M, K), b (K, N), c (M, N), row-major and contiguous, 16-byte aligned;
// K and N multiples of 8.  dtype (of a and b): 0 f32, 1 bf16; out_dtype the
// same codes.  (bm, bn, bk) picks a built tile: 128x256x64 for bf16,
// 64x64x16 for f32.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for anything not built).
extern "C" int tdt_matmul(const void* a, const void* b, void* c, int M, int N,
                          int K, int bm, int bn, int bk, int dtype,
                          int out_dtype, void* stream) {
  using namespace tdt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && bm == wg::BM && bn == wg::BN && bk == wg::BK) {
    if (out_dtype == 1) return static_cast<int>(launch_wgmma<bf16>(a, b, c, M, N, K, st));
    if (out_dtype == 0) return static_cast<int>(launch_wgmma<float>(a, b, c, M, N, K, st));
  }
  if (dtype == 0 && bm == kF32BM && bn == kF32BN && bk == kF32BK) {
    if (out_dtype == 0) return static_cast<int>(launch_f32<float>(a, b, c, M, N, K, st));
    if (out_dtype == 1) return static_cast<int>(launch_f32<bf16>(a, b, c, M, N, K, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
