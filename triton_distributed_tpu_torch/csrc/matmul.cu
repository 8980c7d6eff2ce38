// K6: the local tiled GEMM C = A @ B for Hopper (sm_90a), f32 accumulation.
//
// Replaces triton_distributed_tpu/ops/matmul.py::_build_matmul (the Pallas
// (m, n, k)-grid GEMM over blocks.matmul_body: bf16 operands, an f32
// accumulator in VMEM, the tile cast to out_dtype once).  The Pallas grid
// walks k in order on one core, accumulating in scratch; here one block owns
// one (BM, BN) output tile and runs the whole k loop itself
// (gemm_tile.cuh::mainloop), so nothing is carried between blocks and the
// tile is rounded once, in the epilogue.
//
// Bound on the H100: at the shapes the port runs (bench.py's 7168^3 and
// 4096 x 7168 x 7168, Qwen3-8B's prefill projections at 4096 rows) a product
// does 2 M N K flops on (M K + K N + M N) * 2 bytes, 400-1800 flops a byte,
// above the 295 where the bf16 tensor cores become the limit: the bound is
// operations, 0.14-5.2 ms at 989 TFLOP/s.  So the design keeps the tensor
// cores fed: mma.sync m16n8k16 bf16 tiles, ldmatrix fragments, a 3- or
// 4-stage cp.async ring, 64 x 64 (or 32 x 64) outputs a warp, and blocks
// launched in groups of 8 m-tiles down each n-column group so that blocks
// running together share their A and B panels in the 50 MB L2.  `wgmma` with
// TMA and a persistent schedule are later work; the tuner
// (tune/autotuner.py) weighs each tile against cuBLAS per shape and crowns
// cuBLAS where K6 loses.
//
// The tiles (bm, bn, bk) built here are the ones ops/matmul.py::KERNEL_TILES
// lists: 128x128x32 (2x2 warps, 4 stages), 128x256x32 (2x4, 4), 256x128x32
// (4x2, 4), 64x128x64 (2x2, 3).  M edges are predicated (a partial last
// tile is allowed); K and N must be multiples of 8.  f32 operands run in
// full f32 by scalar FMA (64x64x16, 256 threads), as the JAX contract of
// true f32 accumulation asks (JAX ops/matmul.py:72-78); that path serves
// parity, not speed.
#include "gemm_tile.cuh"

namespace tdt {
namespace {

constexpr int kGroupM = 8;  // m-tiles a launch group walks down one n-column

// Block b of a (tiles_m x tiles_n) grid in grouped order: groups of kGroupM
// m-tiles, each walked column by column, so consecutive blocks share B
// panels and a group's blocks share A panels.
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

template <class L, typename OutT>
__global__ void __launch_bounds__(L::THREADS)
matmul_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B,
            OutT* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_m = (M + L::BM - 1) / L::BM, tiles_n = (N + L::BN - 1) / L::BN;
  int tm, tn;
  tile_of(blockIdx.x, tiles_m, tiles_n, tm, tn);
  gemm::bf16_tile<L, OutT>(A, B, C, M, N, K, tm * L::BM, tn * L::BN,
                           reinterpret_cast<bf16*>(smem_raw));
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

template <class L, typename OutT>
cudaError_t launch_bf16(const void* a, const void* b, void* c, int M, int N,
                        int K, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      matmul_bf16<L, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((M + L::BM - 1) / L::BM) *
                           ((N + L::BN - 1) / L::BN);
  matmul_bf16<L, OutT><<<static_cast<unsigned>(blocks), L::THREADS, L::SMEM_BYTES, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<OutT*>(c), M, N, K);
  return cudaGetLastError();
}

template <class L>
cudaError_t dispatch_out(const void* a, const void* b, void* c, int M, int N,
                         int K, int out_dtype, cudaStream_t st) {
  if (out_dtype == 1) return launch_bf16<L, bf16>(a, b, c, M, N, K, st);
  if (out_dtype == 0) return launch_bf16<L, float>(a, b, c, M, N, K, st);
  return cudaErrorInvalidValue;
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
// same codes.  (bm, bn, bk) picks a built tile: 128x128x32, 128x256x32,
// 256x128x32 or 64x128x64 for bf16, 64x64x16 for f32.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for anything not built).
extern "C" int tdt_matmul(const void* a, const void* b, void* c, int M, int N,
                          int K, int bm, int bn, int bk, int dtype,
                          int out_dtype, void* stream) {
  using namespace tdt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (bm == 128 && bn == 128 && bk == 32)
      return dispatch_out<gemm::Tile<128, 128, 32, 2, 2, 4>>(a, b, c, M, N, K, out_dtype, st);
    if (bm == 128 && bn == 256 && bk == 32)
      return dispatch_out<gemm::Tile<128, 256, 32, 2, 4, 4>>(a, b, c, M, N, K, out_dtype, st);
    if (bm == 256 && bn == 128 && bk == 32)
      return dispatch_out<gemm::Tile<256, 128, 32, 4, 2, 4>>(a, b, c, M, N, K, out_dtype, st);
    if (bm == 64 && bn == 128 && bk == 64)
      return dispatch_out<gemm::Tile<64, 128, 64, 2, 2, 3>>(a, b, c, M, N, K, out_dtype, st);
  }
  if (dtype == 0 && bm == kF32BM && bn == kF32BN && bk == kF32BK) {
    if (out_dtype == 0) return static_cast<int>(launch_f32<float>(a, b, c, M, N, K, st));
    if (out_dtype == 1) return static_cast<int>(launch_f32<bf16>(a, b, c, M, N, K, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
