// The tiled GEMM main loop of the port: acc += A[m0:m0+BM, :] @ B[:, n0:n0+BN]
// for one block, bf16 operands, f32 accumulation, on mma.sync tensor-core
// tiles.  It is the Hopper form of triton_distributed_tpu/ops/blocks.py
// ::matmul_body (the MXU loop that the JAX matmul and every fused GEMM run
// per tile): K14's ring form (overlap_gemm.cu) runs it per tile.  K6's and
// K19's bf16 forms moved to wgmma_tile.cuh's loop; their f32 forms
// (matmul.cu, overlap_probe.cu) keep f32_tile here, as K14's f32 ring
// keeps f32_acc.
//
// Operands are row-major, A (M, K) and B (K, N), with K and N multiples of 8
// so that every 16-byte chunk of a row lies wholly inside or outside the
// matrix.  Rows of A past M, columns of B past N and k past K are zero-filled
// in shared memory without a read, so partial tiles on every edge are
// allowed; store_acc writes only the rows and columns inside the matrix.
// A block that runs several tiles in turn (the overlapped GEMMs' lanes)
// syncs its threads between them: the next tile's first loads reuse the
// buffers the last one read.
//
// f32 operands take f32_tile instead: scalar FMA in full f32 (no TF32), a
// 64 x 64 tile of 256 threads, as the JAX contract of true f32 accumulation
// asks; it serves parity, not speed.
//
// Operand tiles stream through a ring of STAGES shared-memory buffers with
// cp.async (tile kt + STAGES - 1 is in flight while tile kt is computed);
// rows are padded by 8 elements so the ldmatrix reads of eight rows hit
// distinct banks.  A fragments come by ldmatrix, B fragments by
// ldmatrix.trans from the (K, N) row-major tile.  Each warp owns a WM x WN
// piece of the block tile: MT x NT m16n8k16 products per 16-deep k step.
// An output element's sum runs over k in the same 16-deep steps whatever
// the tile and warp grid, so every tile shape gives the same bits.
#pragma once

#include "ptx.cuh"

namespace tdt {
namespace gemm {

// A block tile of BM x BN outputs, BK deep a stage, WARPS_M x WARPS_N warps.
template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8;             // mma tiles a warp
  static constexpr int LDA = BK + 8, LDB = BN + 8;            // padded rows
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;             // elements
  static constexpr int SMEM_BYTES = STAGES * STAGE * 2;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");
  static_assert((BM * BK / 8) % THREADS == 0 && (BK * BN / 8) % THREADS == 0,
                "every thread copies the same number of chunks a stage");
};

// Copy k-tile starting at k0 into `stage` (A then B), asynchronously.
template <class L>
__device__ __forceinline__ void load_stage(const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, bf16* stage) {
  const int tid = threadIdx.x;
  bf16* sa = stage;
  bf16* sb = stage + L::A_ELEMS;
#pragma unroll
  for (int it = 0; it < L::BM * L::BK / 8 / L::THREADS; ++it) {
    const int i = tid + it * L::THREADS;
    const int r = i / (L::BK / 8), c = (i % (L::BK / 8)) * 8;
    const bool in = m0 + r < M && k0 + c < K;
    cp_async16(sa + r * L::LDA + c,
               in ? A + static_cast<size_t>(m0 + r) * K + k0 + c : A, in);
  }
#pragma unroll
  for (int it = 0; it < L::BK * L::BN / 8 / L::THREADS; ++it) {
    const int i = tid + it * L::THREADS;
    const int r = i / (L::BN / 8), c = (i % (L::BN / 8)) * 8;
    const bool in = k0 + r < K && n0 + c < N;
    cp_async16(sb + r * L::LDB + c,
               in ? B + static_cast<size_t>(k0 + r) * N + n0 + c : B, in);
  }
}

// acc (this warp's MT x NT fragments, zeroed by the caller) += the block
// tile's product over all of K.  `smem` holds L::SMEM_BYTES.  Warp w owns
// rows (w / WARPS_N) * WM and columns (w % WARPS_N) * WN of the tile; the
// fragment acc[i][j][e] is row i * 16 + lane / 4 + (e / 2) * 8 and column
// j * 8 + 2 * (lane % 4) + e % 2 of that piece.
template <class L>
__device__ __forceinline__ void mainloop(const bf16* __restrict__ A,
                                         const bf16* __restrict__ B, int M,
                                         int N, int K, int m0, int n0,
                                         bf16* smem,
                                         float (&acc)[L::MT][L::NT][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  const int ktiles = (K + L::BK - 1) / L::BK;
#pragma unroll
  for (int st = 0; st < L::STAGES - 1; ++st) {
    if (st < ktiles) load_stage<L>(A, B, M, N, K, m0, n0, st * L::BK, smem + st * L::STAGE);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // tile kt landed for all; buffer (kt - 1) % STAGES free
    const int next = kt + L::STAGES - 1;
    if (next < ktiles)
      load_stage<L>(A, B, M, N, K, m0, n0, next * L::BK,
                    smem + (next % L::STAGES) * L::STAGE);
    cp_async_commit();
    const bf16* sa = smem + (kt % L::STAGES) * L::STAGE;
    const bf16* sb = sa + L::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < L::BK; kk += 16) {
      uint32_t a[L::MT][4], b[L::NT][2];
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
        ldmatrix_x4(a[i], sa + (wm * L::WM + i * 16 + (lane & 15)) * L::LDA
                              + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < L::NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (kk + (lane & 15)) * L::LDB + wn * L::WN
                                 + j * 8 + (lane >> 4) * 8);
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
  cp_async_wait<0>();
}

template <typename OutT> struct Pair;
template <> struct Pair<float> {
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <> struct Pair<bf16> {
  __device__ static void store(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// The tile's epilogue: the fragments of mainloop rounded once to OutT into
// C (row-major, M x N), rows and columns past the matrix left out.  N is a
// multiple of 8: a column pair lies wholly inside the matrix or past it.
template <class L, typename OutT>
__device__ __forceinline__ void store_acc(const float (&acc)[L::MT][L::NT][4],
                                          OutT* __restrict__ C, int M, int N,
                                          int m0, int n0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * L::WM + i * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const int col = n0 + wn * L::WN + j * 8 + 2 * t4;
        if (col < N)
          Pair<OutT>::store(C + static_cast<size_t>(row) * N + col,
                            acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

// One bf16 tile of C = A @ B at (m0, n0): zeroed fragments, the main loop,
// the epilogue.  Syncs first, so a block may run tiles back to back.
template <class L, typename OutT>
__device__ __forceinline__ void bf16_tile(const bf16* __restrict__ A,
                                          const bf16* __restrict__ B,
                                          OutT* __restrict__ C, int M, int N,
                                          int K, int m0, int n0, bf16* smem) {
  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  __syncthreads();
  mainloop<L>(A, B, M, N, K, m0, n0, smem, acc);
  store_acc<L, OutT>(acc, C, M, N, m0, n0);
}

// f32: 4 x 4 outputs a thread, A staged transposed so a thread's four rows
// are one broadcast read; every k step ends in a sync, so tiles may run
// back to back.  The sync is the block's (K6, K19), or with Sync<N> a named
// barrier over the block's first N threads (the overlapped GEMMs, whose
// other warps move data meanwhile).
constexpr int kF32BM = 64, kF32BN = 64, kF32BK = 16, kF32Threads = 256;

template <int N = 0> struct Sync {
  __device__ static void sync() {
    if constexpr (N == 0) __syncthreads();
    else asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
  }
};

// acc (zeroed by the caller) += the tile's product: acc[i][c] is row
// m0 + threadIdx.x / 16 + 16 i, column n0 + (threadIdx.x % 16) * 4 + c.
template <class S = Sync<>>
__device__ __forceinline__ void f32_acc(const float* __restrict__ A,
                                        const float* __restrict__ B, int M,
                                        int N, int K, int m0, int n0,
                                        float (&acc)[4][4]) {
  __shared__ __align__(16) float as[kF32BK][kF32BM + 4];
  __shared__ __align__(16) float bs[kF32BK][kF32BN];
  const int tid = threadIdx.x, tx = tid % 16;
  for (int k0 = 0; k0 < K; k0 += kF32BK) {
#pragma unroll
    for (int it = 0; it < kF32BM * kF32BK / kF32Threads; ++it) {
      const int i = tid + it * kF32Threads;
      const int m = i / kF32BK, k = i % kF32BK;
      const bool in = m0 + m < M && k0 + k < K;
      // through L2 only: A may have been written by another block of the
      // launch (K12's gathered chunks)
      as[k][m] = in ? __ldcg(A + static_cast<size_t>(m0 + m) * K + k0 + k) : 0.f;
    }
    {
      const int r = tid / 16, c = (tid % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < K && n0 + c < N)
        v = *reinterpret_cast<const float4*>(B + static_cast<size_t>(k0 + r) * N + n0 + c);
      *reinterpret_cast<float4*>(&bs[r][c]) = v;
    }
    S::sync();
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = as[k][tid / 16 + 16 * i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    S::sync();
  }
}

template <typename OutT, class S = Sync<>>
__device__ __forceinline__ void f32_tile(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         OutT* __restrict__ C, int M, int N,
                                         int K, int m0, int n0) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  f32_acc<S>(A, B, M, N, K, m0, n0, acc);
  const int col = n0 + tx * 4;
  if (col < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= M) continue;
      OutT* p = C + static_cast<size_t>(row) * N + col;
      Pair<OutT>::store(p, acc[i][0], acc[i][1]);
      Pair<OutT>::store(p + 2, acc[i][2], acc[i][3]);
    }
  }
}

}  // namespace gemm
}  // namespace tdt
