// K19: the overlap probe for Hopper (sm_90a): three kernels over one tile
// pipeline whose times say how much of the memory stream the pipeline hides
// under the tensor-core work.
//
// Replaces triton_distributed_tpu/tools/overlap.py::_mm_kernel (the Pallas
// (m, n, k)-grid matmul in three modes).  Each mode computes what the JAX
// mode computes, on one (BM, BN) output tile a block, the k steps a loop in
// the block (gemm_tile.cuh):
//
// - fused: the pipelined product A @ B, f32 accumulation, rounded once:
//   gemm_tile.cuh's bf16_tile (its cp.async stage ring and mma.sync loop).
// - dma: the same grid and the same stage ring; every A and B block of every
//   k step lands in shared memory and is waited on, and no mma runs.  Tile
//   (i, j) is filled with the f32 sum of the (8, 128) corners of the last k
//   step's blocks, sum(A[i BM : +8, (nk - 1) BK : +128]) +
//   sum(B[(nk - 1) BK : +8, j BN : +128]), cut at the matrix edges, rounded
//   to the output type (JAX writes every step's touch; the last one stays).
// - mxu: the same grid and the same mma sequence over nk k steps, on A's
//   block (0, 0) and B's block (0, 0).  JAX pins the index maps and Mosaic
//   leaves the repeated fetch out; a pinned cp.async would still go to L2,
//   so the two blocks are loaded once and every k step's ldmatrix and mma
//   run from shared memory.  Tile (i, j) = the sum over the nk steps of
//   A00 @ B00, cut at the matrix edges.
//
// Bound on the H100: fused does 2 M N K operations (at bench.py's 4096^3,
// 0.139 ms at 989 TFLOP/s); dma streams A N / BN times and B M / BM times
// (1.61 GB, 0.48 ms at 3.35 TB/s for the 128 x 256 x 128 tile, less where
// the 50 MB L2 serves a re-read); mxu the same operations as fused out of
// shared memory.  If the pipeline hides one phase
// under the other, fused takes max(dma, mxu); if it serializes them, their
// sum (tools/overlap.py::hidden_pct).
//
// Tiles: the corner needs BK >= 128 and BN >= 128, which no tile of
// gemm_tile.cuh's other users has (K6's first design had BK 32), so K19
// instantiates its own: 128 x 128 x 128 (2 x 2 warps, 3
// stages, 204 KB), the tile of the JAX test, and 128 x 256 x 128 (2 x 4
// warps, 2 stages, 200 KB), the default.  f32 operands take K6's scalar f32
// form (gemm_tile.cuh f32_tile, 64 x 64 sub-tiles of a 128 x 128 x 128
// tile, 256 threads); it serves parity, not speed.  K and N must be
// multiples of 8 (16-byte chunks); M, N and K may end mid-tile.
#include "gemm_tile.cuh"

namespace tdt {
namespace {

enum Mode { kFused = 0, kDma = 1, kMxu = 2 };
constexpr int kGroupM = 8;   // K6's grouped block order (matmul.cu)
constexpr int kCornerRows = 8, kCornerCols = 128;

__device__ __forceinline__ void tile_of(int b, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = kGroupM * tiles_n;
  const int first = (b / per_group) * kGroupM;
  const int rows = min(tiles_m - first, kGroupM);
  const int in_group = b % per_group;
  tm = first + in_group % rows;
  tn = in_group / rows;
}

// The block's sum of `part` over all its threads (every thread gets it).
template <int THREADS>
__device__ __forceinline__ float block_sum(float part) {
  __shared__ float red[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) s += red[w];
  return s;
}

// 16 bytes holding copies of v rounded to T.
__device__ __forceinline__ uint32_t word_of(float v, float) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t word_of(float v, bf16) {
  const uint32_t h = __bfloat16_as_ushort(from_f32<bf16>(v));
  return h | (h << 16);
}

// Fill rows [m0, m0 + rows) x cols [n0, n0 + cols) of C (M x N), cut at the
// edges, with v rounded once to T: 16-byte stores (N and n0 are multiples of
// 8).
template <typename T, int THREADS>
__device__ __forceinline__ void fill(T* __restrict__ C, int M, int N, int m0, int n0,
                                     int rows, int cols, float v) {
  constexpr int kVec = 16 / sizeof(T);
  const uint32_t w = word_of(v, T());
  const uint4 pack = make_uint4(w, w, w, w);
  const int vcols = cols / kVec;
  for (int i = threadIdx.x; i < rows * vcols; i += THREADS) {
    const int r = m0 + i / vcols, c = n0 + (i % vcols) * kVec;
    if (r < M && c < N) *reinterpret_cast<uint4*>(C + static_cast<size_t>(r) * N + c) = pack;
  }
}

// One 16-deep-step pass of the block tile's mma sequence over a stage in
// shared memory (gemm_tile.cuh::mainloop's inner loop).
template <class L>
__device__ __forceinline__ void mma_stage(const bf16* sa, const bf16* sb,
                                          float (&acc)[L::MT][L::NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
#pragma unroll
  for (int kk = 0; kk < L::BK; kk += 16) {
    uint32_t a[L::MT][4], b[L::NT][2];
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
      ldmatrix_x4(a[i], sa + (wm * L::WM + i * 16 + (lane & 15)) * L::LDA + kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < L::NT; j += 2) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, sb + (kk + (lane & 15)) * L::LDB + wn * L::WN + j * 8 + (lane >> 4) * 8);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < L::MT; ++i)
#pragma unroll
      for (int j = 0; j < L::NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

template <class L>
__device__ __forceinline__ void dma_tile(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                         bf16* __restrict__ C, int M, int N, int K, int m0,
                                         int n0, bf16* smem) {
  static_assert(L::BK >= kCornerCols && L::BN >= kCornerCols && L::BM >= kCornerRows,
                "the touched corner lies inside the blocks");
  const int ktiles = (K + L::BK - 1) / L::BK;
#pragma unroll
  for (int st = 0; st < L::STAGES - 1; ++st) {
    if (st < ktiles) gemm::load_stage<L>(A, B, M, N, K, m0, n0, st * L::BK, smem + st * L::STAGE);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // block kt landed; buffer (kt - 1) % STAGES free
    const int next = kt + L::STAGES - 1;
    if (next < ktiles)
      gemm::load_stage<L>(A, B, M, N, K, m0, n0, next * L::BK, smem + (next % L::STAGES) * L::STAGE);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  // the last step's blocks (zero-filled past the edges); no load follows them
  const bf16* sa = smem + ((ktiles - 1) % L::STAGES) * L::STAGE;
  const bf16* sb = sa + L::A_ELEMS;
  float part = 0.f;
  for (int i = threadIdx.x; i < kCornerRows * kCornerCols; i += L::THREADS) {
    const int r = i / kCornerCols, c = i % kCornerCols;
    part += __bfloat162float(sa[r * L::LDA + c]) + __bfloat162float(sb[r * L::LDB + c]);
  }
  const float touch = block_sum<L::THREADS>(part);
  fill<bf16, L::THREADS>(C, M, N, m0, n0, L::BM, L::BN, touch);
}

template <class L>
__device__ __forceinline__ void mxu_tile(const bf16* __restrict__ A, const bf16* __restrict__ B,
                                         bf16* __restrict__ C, int M, int N, int K, int m0,
                                         int n0, bf16* smem) {
  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  gemm::load_stage<L>(A, B, M, N, K, 0, 0, 0, smem);   // blocks (0, 0), once
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int ktiles = (K + L::BK - 1) / L::BK;
  for (int kt = 0; kt < ktiles; ++kt) mma_stage<L>(smem, smem + L::A_ELEMS, acc);
  gemm::store_acc<L, bf16>(acc, C, M, N, m0, n0);
}

template <class L, int MODE>
__global__ void __launch_bounds__(L::THREADS)
probe_bf16(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
           int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  int tm, tn;
  tile_of(blockIdx.x, (M + L::BM - 1) / L::BM, (N + L::BN - 1) / L::BN, tm, tn);
  const int m0 = tm * L::BM, n0 = tn * L::BN;
  if (MODE == kFused) gemm::bf16_tile<L, bf16>(A, B, C, M, N, K, m0, n0, smem);
  else if (MODE == kDma) dma_tile<L>(A, B, C, M, N, K, m0, n0, smem);
  else mxu_tile<L>(A, B, C, M, N, K, m0, n0, smem);
}

// f32: one 64 x 64 sub-tile (gemm_tile.cuh's f32 tile) of a (bm, bn, bk)
// probe tile a block, 256 threads.
using gemm::kF32BK;
using gemm::kF32BM;
using gemm::kF32BN;
using gemm::kF32Threads;

// acc += A[pm : pm + 64, 0 : kd] @ B[0 : kd, pn : pn + 64], rows of A at or
// past ma and columns of B at or past nb zero: f32_tile's scalar FMA loop.
__device__ __forceinline__ void f32_acc(const float* __restrict__ A, const float* __restrict__ B,
                                        int K, int N, int pm, int pn, int ma, int nb, int kd,
                                        float (&acc)[4][4]) {
  __shared__ __align__(16) float as[kF32BK][kF32BM + 4];
  __shared__ __align__(16) float bs[kF32BK][kF32BN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int k0 = 0; k0 < kd; k0 += kF32BK) {
#pragma unroll
    for (int it = 0; it < kF32BM * kF32BK / kF32Threads; ++it) {
      const int i = tid + it * kF32Threads;
      const int m = i / kF32BK, k = i % kF32BK;
      as[k][m] = pm + m < ma && k0 + k < kd ? A[static_cast<size_t>(pm + m) * K + k0 + k] : 0.f;
    }
    {
      const int r = tid / 16, c = (tid % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < kd && pn + c < nb)
        v = *reinterpret_cast<const float4*>(B + static_cast<size_t>(k0 + r) * N + pn + c);
      *reinterpret_cast<float4*>(&bs[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = as[k][ty + 16 * i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
}

template <int MODE>
__global__ void __launch_bounds__(kF32Threads)
probe_f32(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
          int M, int N, int K, int bm, int bn, int bk) {
  const int tiles_n = (N + kF32BN - 1) / kF32BN;
  const int m0 = (blockIdx.x / tiles_n) * kF32BM, n0 = (blockIdx.x % tiles_n) * kF32BN;
  if (MODE == kFused) {
    gemm::f32_tile<float>(A, B, C, M, N, K, m0, n0);
    return;
  }
  const int nk = (K + bk - 1) / bk;
  const int tid = threadIdx.x;
  if (MODE == kDma) {
    // this sub-tile's rows of every A block and columns of every B block,
    // 16 deep at a time, into shared memory by cp.async, waited on
    __shared__ __align__(16) float sa[kF32BM][kF32BK];
    __shared__ __align__(16) float sb[kF32BK][kF32BN];
    for (int k0 = 0; k0 < nk * bk; k0 += kF32BK) {
      {
        const int r = tid / 4, c = (tid % 4) * 4;
        const bool in = m0 + r < M && k0 + c < K;
        cp_async16(&sa[r][c], in ? A + static_cast<size_t>(m0 + r) * K + k0 + c : A, in);
      }
      {
        const int r = tid / 16, c = (tid % 16) * 4;
        const bool in = k0 + r < K && n0 + c < N;
        cp_async16(&sb[r][c], in ? B + static_cast<size_t>(k0 + r) * N + n0 + c : B, in);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // the corners of the last step's blocks of this sub-tile's probe tile
    const int i0 = (m0 / bm) * bm, j0 = (n0 / bn) * bn, k0 = (nk - 1) * bk;
    float part = 0.f;
    for (int i = tid; i < kCornerRows * kCornerCols; i += kF32Threads) {
      const int r = i / kCornerCols, c = i % kCornerCols;
      if (i0 + r < M && k0 + c < K) part += A[static_cast<size_t>(i0 + r) * K + k0 + c];
      if (k0 + r < K && j0 + c < N) part += B[static_cast<size_t>(k0 + r) * N + j0 + c];
    }
    const float touch = block_sum<kF32Threads>(part);
    fill<float, kF32Threads>(C, M, N, m0, n0, kF32BM, kF32BN, touch);
    return;
  }
  // mxu: this sub-tile's part of sum over nk steps of A00 @ B00
  float acc[4][4] = {};
  const int pm = m0 % bm, pn = n0 % bn, kd = min(bk, K);
  for (int kt = 0; kt < nk; ++kt) f32_acc(A, B, K, N, pm, pn, min(bm, M), min(bn, N), kd, acc);
  const int ty = tid / 16, tx = tid % 16, col = n0 + tx * 4;
  if (col < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < M)
        *reinterpret_cast<float4*>(C + static_cast<size_t>(row) * N + col) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

template <class L, int MODE>
cudaError_t launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                        cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      probe_bf16<L, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>((M + L::BM - 1) / L::BM) *
                           ((N + L::BN - 1) / L::BN);
  probe_bf16<L, MODE><<<static_cast<unsigned>(blocks), L::THREADS, L::SMEM_BYTES, st>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

template <class L>
cudaError_t by_mode_bf16(const void* a, const void* b, void* c, int M, int N, int K, int mode,
                         cudaStream_t st) {
  if (mode == kFused) return launch_bf16<L, kFused>(a, b, c, M, N, K, st);
  if (mode == kDma) return launch_bf16<L, kDma>(a, b, c, M, N, K, st);
  if (mode == kMxu) return launch_bf16<L, kMxu>(a, b, c, M, N, K, st);
  return cudaErrorInvalidValue;
}

template <int MODE>
cudaError_t launch_f32(const void* a, const void* b, void* c, int M, int N, int K, int bm,
                       int bn, int bk, cudaStream_t st) {
  const long long blocks = static_cast<long long>((M + kF32BM - 1) / kF32BM) *
                           ((N + kF32BN - 1) / kF32BN);
  probe_f32<MODE><<<static_cast<unsigned>(blocks), kF32Threads, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c),
      M, N, K, bm, bn, bk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tdt

// a (M, K), b (K, N), c (M, N) of one dtype (0 f32, 1 bf16), row-major,
// contiguous, 16-byte aligned; K and N multiples of 8.  mode 0 fused, 1 dma,
// 2 mxu.  (bm, bn, bk) picks a built tile: 128x128x128 or 128x256x128 for
// bf16, 128x128x128 for f32.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for anything not built).
extern "C" int tdt_overlap_probe(const void* a, const void* b, void* c, int M, int N, int K,
                                 int bm, int bn, int bk, int dtype, int mode, void* stream) {
  using namespace tdt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    if (bm == 128 && bn == 128 && bk == 128)
      return static_cast<int>(by_mode_bf16<gemm::Tile<128, 128, 128, 2, 2, 3>>(a, b, c, M, N, K, mode, st));
    if (bm == 128 && bn == 256 && bk == 128)
      return static_cast<int>(by_mode_bf16<gemm::Tile<128, 256, 128, 2, 4, 2>>(a, b, c, M, N, K, mode, st));
  }
  if (dtype == 0 && bm == 128 && bn == 128 && bk == 128) {
    if (mode == kFused) return static_cast<int>(launch_f32<kFused>(a, b, c, M, N, K, bm, bn, bk, st));
    if (mode == kDma) return static_cast<int>(launch_f32<kDma>(a, b, c, M, N, K, bm, bn, bk, st));
    return static_cast<int>(launch_f32<kMxu>(a, b, c, M, N, K, bm, bn, bk, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
