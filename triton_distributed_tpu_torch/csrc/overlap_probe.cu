// K19: the overlap probe for Hopper (sm_90a): three kernels over one tile
// pipeline whose times say how much of the memory stream the pipeline hides
// under the tensor-core work.
//
// Replaces triton_distributed_tpu/tools/overlap.py::_mm_kernel (the Pallas
// (m, n, k)-grid matmul in three modes).  Each mode computes what the JAX
// mode computes.  The bf16 modes run the pipeline every served bf16 GEMM
// runs (K5, K6, K12, K13): wgmma_tile.cuh's loop, TMA into a ring of four
// mbarrier-guarded stages, one producer thread and two consumer warpgroups
// on wgmma, in one persistent block an SM that walks the (BM, BN) output
// tiles t = blockIdx.x, + gridDim.x, ... in K6's grouped order
// (ops/matmul.py::tile_walk mirrors it).  A probe k step of BK = 128 is two
// of the loop's 64-deep stages.  Every mode keeps the same walk:
//
// - fused: the pipelined product A @ B, f32 sums, rounded once: K6's
//   matmul_wgmma, tile for tile.
// - dma: the same producer and the same stage ring; the consumers wait on
//   each stage's barrier and release it with no wgmma.  While the last k
//   step's two stages are in shared memory they sum its (8, 128) corners,
//   and tile (i, j) is filled with that f32 sum, sum(A[i BM : +8,
//   (nk - 1) BK : +128]) + sum(B[(nk - 1) BK : +8, j BN : +128]), cut at
//   the matrix edges (TMA's zeros), rounded to bf16 (JAX writes every step's
//   touch; the last one stays).
// - mxu: A's block (0, 0) and B's block (0, 0), the first k step's two
//   stages, are loaded once; every tile of the walk issues the same nk k
//   steps of wgmma from those shared-memory descriptors (JAX pins the index
//   maps and Mosaic leaves the repeated fetch out).  Tile (i, j) = the sum
//   over the nk steps of A00 @ B00, cut at the matrix edges.
//
// Bound on the H100: fused does 2 M N K operations (at bench.py's 4096^3,
// 0.139 ms at 989 TFLOP/s); mxu the same operations out of shared memory;
// dma's own stream reads A N / BN times and B M / BM times (1.61 GB, 0.48 ms
// at 3.35 TB/s for the 128 x 256 x 128 tile), of which the grouped walk
// serves a share from the 50 MB L2.  If the pipeline hides one phase under
// the other, fused takes max(dma, mxu); if it serializes them, their sum
// (tools/overlap.py::hidden_pct).
//
// Tiles: the probe's contract is (BM, BN, BK) = 128 x 256 x 128, the
// default, and 128 x 128 x 128, the tile of the JAX test (the corner needs
// BK >= 128 and BN >= 128).  The wide one is the loop's own width (4 stages
// of 48 KB); the narrow one its 128-column form (wgmma m64n128k16, 4 stages
// of 32 KB).  f32 operands take K6's scalar f32 form (gemm_tile.cuh
// f32_tile, 64 x 64 sub-tiles of a 128 x 128 x 128 tile, 256 threads); it
// serves parity, not speed.  K and N must be multiples of 8 (16-byte TMA
// pitches); M, N and K may end mid-tile.
#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace {

enum Mode { kFused = 0, kDma = 1, kMxu = 2 };
constexpr int kGroupM = 8;   // K6's grouped tile order (matmul.cu)
constexpr int kCornerRows = 8, kCornerCols = 128;
constexpr int kProbeBK = 128;                  // a probe k step
constexpr int kHalves = kProbeBK / wg::BK;     // the loop's stages in one

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

// The consumers' sum of `part` (every consumer thread gets it), on their
// named barrier: the producer warpgroup takes no part.  The first barrier
// keeps a tile's writes from overtaking the last tile's reads.
__device__ __forceinline__ float consumer_sum(float part) {
  __shared__ float red[wg::CONSUMERS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  wg::named_sync(wg::kConsumerBar, wg::CONSUMERS);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  wg::named_sync(wg::kConsumerBar, wg::CONSUMERS);
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < wg::CONSUMERS / 32; ++w) s += red[w];
  return s;
}

// 16 bytes holding copies of v rounded to T.
__device__ __forceinline__ uint32_t word_of(float v, float) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t word_of(float v, bf16) {
  const uint32_t h = __bfloat16_as_ushort(from_f32<bf16>(v));
  return h | (h << 16);
}

// Fill rows [m0, m0 + rows) x cols [n0, n0 + cols) of C (M x N), cut at the
// edges, with v rounded once to T, by THREADS threads: 16-byte stores (N
// and n0 are multiples of 8).
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

// ---------------------------------------------------------------------------
// bf16: wgmma_tile.cuh's loop

// The value at row r, column c < 64 of a 64-column box in shared memory
// (128-byte rows under the 128-byte swizzle: the 16-byte piece c / 8 of row
// r sits at piece (c / 8) ^ (r % 8); the box is 1024-byte aligned).
__device__ __forceinline__ float box_at(const unsigned char* box, int r, int c) {
  const int off = r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
  return __bfloat162float(*reinterpret_cast<const bf16*>(box + off));
}

// A consumer thread's part of the corners in half `half` of the last probe
// k step (its stage `s`): A's rows 0-7 at the stage's 64 columns (columns
// 64 half + [0, 64) of the corner), and in half 0 B's k rows 0-7 at columns
// 0-127 (boxes 0 and 1).
template <int TBN>
__device__ __forceinline__ float corner_part(const unsigned char* s, int half) {
  static_assert(TBN >= kCornerCols, "the B corner lies inside the stage");
  float v = 0.f;
  for (int i = threadIdx.x; i < kCornerRows * wg::BOX; i += wg::CONSUMERS)
    v += box_at(s, i / wg::BOX, i % wg::BOX);
  if (half == 0) {
    for (int i = threadIdx.x; i < kCornerRows * kCornerCols; i += wg::CONSUMERS) {
      const int r = i / kCornerCols, c = i % kCornerCols;
      v += box_at(s + wg::A_BYTES + (c / wg::BOX) * wg::BK * 128, r, c % wg::BOX);
    }
  }
  return v;
}

// The bf16 probe's arguments: A (K, M, 1) and B (N, K, 1) as TMA maps, C
// (M, N) bf16.
struct ProbeArgs {
  CUtensorMap ma, mb;
  bf16* c;
  int M, N, K;
};

template <int TBN, int MODE>
__global__ void __launch_bounds__(wg::THREADS, 1) probe_wgmma(const __grid_constant__ ProbeArgs p) {
  constexpr int R = TBN / 2;   // f32 sums a consumer thread holds
  constexpr int kStage = wg::stage_bytes<TBN>();
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ wg::Bars bars;
  wg::init_bars(bars);
  const int tiles_m = (p.M + wg::BM - 1) / wg::BM, tiles_n = (p.N + TBN - 1) / TBN;
  const int tiles = tiles_m * tiles_n, ktiles = (p.K + wg::BK - 1) / wg::BK;
  const int nk = (p.K + kProbeBK - 1) / kProbeBK, halves = min(kHalves, ktiles);
  unsigned char* st = wg::stages(dyn);
  int tm, tn;
  if (threadIdx.x / 32 >= wg::kProducerWarp) {
    wg::set_max_regs_dec<40>();
    if (threadIdx.x == wg::kProducerWarp * 32) {
      wg::Ring ring;
      if constexpr (MODE == kMxu) {   // blocks (0, 0): the first k step's stages, once
        wg::load_tile<TBN>(st, bars, ring, &p.ma, &p.mb, wg::TileAt{0, 0, 0, 0}, halves);
      } else {
        for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
          tile_of(t, tiles_m, tiles_n, tm, tn);
          wg::load_tile<TBN>(st, bars, ring, &p.ma, &p.mb,
                             wg::TileAt{0, 0, tm * wg::BM, tn * TBN}, ktiles);
        }
      }
    }
    return;
  }
  wg::set_max_regs_inc<232>();
  wg::Ring ring;
  float d[R];
  if constexpr (MODE == kMxu) {
    for (int h = 0; h < halves; ++h) wg::mbar_wait(&bars.full[h], 0);
  }
  const uint32_t a0 = smem_u32(st) + (threadIdx.x / 128) * (64 * 128);
  const uint32_t b0 = smem_u32(st) + wg::A_BYTES;
  const bool signal = (threadIdx.x & 31) == 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    tile_of(t, tiles_m, tiles_n, tm, tn);
    const int m0 = tm * wg::BM, n0 = tn * TBN;
    if constexpr (MODE == kFused) {
      wg::mma_tile(st, bars, ring, ktiles, d);
      wg::store_pieces(d, p.c, p.M, p.N, m0, n0);
    } else if constexpr (MODE == kMxu) {
      // nk k steps of A00 @ B00, one commit group a step (mma_tile's order)
      for (int s = 0; s < nk; ++s) {
        wg::fence_acc(d);
        wg::wgmma_fence();
        for (int h = 0; h < halves; ++h)
#pragma unroll
          for (int kk = 0; kk < wg::BK / 16; ++kk)
            wg::wgmma_n(d, wg::desc_a(a0 + h * kStage + kk * 32),
                        wg::desc_b(b0 + h * kStage + kk * 16 * 128), (s | h | kk) != 0);
        wg::wgmma_commit();
        wg::fence_acc(d);
        if (s > 0) wg::wgmma_wait<1>();
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(d);
      wg::store_pieces(d, p.c, p.M, p.N, m0, n0);
    } else {
      // dma: each stage waited on and released; the last k step's corners
      // read while its stages are here
      const int last = kHalves * (nk - 1);
      float part = 0.f;
      for (int kt = 0; kt < ktiles; ++kt) {
        wg::mbar_wait(&bars.full[ring.stage], ring.phase);
        if (kt >= last) part += corner_part<TBN>(st + ring.stage * kStage, kt - last);
        __syncwarp();
        if (signal) wg::mbar_arrive(&bars.empty[ring.stage]);
        ring.next();
      }
      fill<bf16, wg::CONSUMERS>(p.c, p.M, p.N, m0, n0, wg::BM, TBN, consumer_sum(part));
    }
  }
}

template <int TBN, int MODE>
cudaError_t launch_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                        cudaStream_t st) {
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16)
    return cudaErrorInvalidValue;
  const long long tiles =
      static_cast<long long>((M + wg::BM - 1) / wg::BM) * ((N + TBN - 1) / TBN);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  ProbeArgs p{};
  cudaError_t e = wg::map_a(&p.ma, a, K, M, 1);
  if (e == cudaSuccess) e = wg::map_b(&p.mb, b, K, N, 1);
  if (e != cudaSuccess) return e;
  p.c = static_cast<bf16*>(c);
  p.M = M, p.N = N, p.K = K;
  auto kernel = probe_wgmma<TBN, MODE>;
  constexpr int smem = wg::STAGES * wg::stage_bytes<TBN>() + 1024;  // + alignment slack
  long long fit = 0;  // one block an SM
  if ((e = dl::resident_lanes(kernel, 1, wg::THREADS, smem, &fit)) != cudaSuccess) return e;
  const unsigned grid = static_cast<unsigned>(max(1LL, min(fit, tiles)));
  kernel<<<grid, wg::THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int TBN>
cudaError_t by_mode_bf16(const void* a, const void* b, void* c, int M, int N, int K, int mode,
                         cudaStream_t st) {
  if (mode == kFused) return launch_bf16<TBN, kFused>(a, b, c, M, N, K, st);
  if (mode == kDma) return launch_bf16<TBN, kDma>(a, b, c, M, N, K, st);
  if (mode == kMxu) return launch_bf16<TBN, kMxu>(a, b, c, M, N, K, st);
  return cudaErrorInvalidValue;
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
  if (dtype == 1 && bm == wg::BM && bk == kProbeBK) {
    if (bn == 128) return static_cast<int>(by_mode_bf16<128>(a, b, c, M, N, K, mode, st));
    if (bn == wg::BN) return static_cast<int>(by_mode_bf16<wg::BN>(a, b, c, M, N, K, mode, st));
  }
  if (dtype == 0 && bm == 128 && bn == 128 && bk == 128) {
    if (mode == kFused) return static_cast<int>(launch_f32<kFused>(a, b, c, M, N, K, bm, bn, bk, st));
    if (mode == kDma) return static_cast<int>(launch_f32<kDma>(a, b, c, M, N, K, bm, bn, bk, st));
    return static_cast<int>(launch_f32<kMxu>(a, b, c, M, N, K, bm, bn, bk, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
