// K5: grouped (per-expert) GEMM over expert-sorted rows, for Hopper (sm_90a).
//
// Replaces triton_distributed_tpu/ops/group_gemm.py::_grouped_matmul_kernel
// (the tile-scheduled Pallas grouped matmul) and, on the port's MoE path,
// the `lax.ragged_dot` calls JAX makes for the same function: out[r] =
// x[r] @ w[g(r)] for every row r below sum(splits), g(r) the group whose
// rows [start, end) hold r; rows from sum(splits) to T are zeros; empty
// groups are allowed; f32 accumulation, the output rounded once.
//
// Schedule.  The Pallas kernel walks (m-tile, group) work units in order on
// one core and revisits an output tile once per overlapping group, adding
// into it.  Here each block owns one unit (slot) and one n-tile, and derives
// its slot from `splits` itself: the same schedule as
// ops/swizzle.py::grouped_tile_schedule (m-tiles of BM rows on one grid from
// row 0; a tile gets one slot per group that meets it, at least one), from
// two block-wide prefix sums in shared memory, so a product is one launch
// and nothing is read back to the host.  A block stores only its own
// group's rows of the tile, so slots need no ordering and no read-back of
// the output; the first slot of a tile also writes the zeros of its rows
// past sum(splits).  Padding slots (past the real count) exit at once.
//
// Bound on the H100 at the Qwen3-30B-A3B shapes: the prefill products
// (32768 rows, K 2048 -> N 1536 and K 768 -> N 2048, 128 experts) move
// 0.6-1.0 GB and compute 103-206 GFLOP, so the bytes bound them at
// 3.35 TB/s (0.18-0.31 ms); the decode products (32 rows) read only the
// weights of the experts touched, 3-6 MB each, and are bound by those bytes.
// The bf16 design keeps the products on the tensor cores with mma.sync
// m16n8k16 bf16 -> f32: operand tiles stream through a ring of STAGES
// shared-memory buffers with cp.async (rows padded by 8 elements so the
// ldmatrix reads hit distinct banks), A fragments by ldmatrix, B fragments
// by ldmatrix.trans from the (K, N) row-major weights.  Two tiles: 16 rows
// for the decode products (every warp its own 16 columns), 64 rows for
// prefill (2 x 2 warps of 32 x 64).  `wgmma`, TMA and a persistent schedule
// are later work.  The f32 path is plain scalar FMA in full f32 (no TF32),
// for parity checks, as JAX runs f32 at Precision.HIGHEST.
#include "common.cuh"

namespace tdt {
namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, k-major)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// the schedule

// In-place inclusive prefix sum of a[0, n) in shared memory, by the block.
template <int THREADS>
__device__ void block_scan(int* a, int n, int* warp_sums) {
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = threadIdx.x * per, hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) {
    sum += a[i];
    a[i] = sum;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFullMask, v, o);
      if (lane >= o) v += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = v;
  }
  __syncthreads();
  const int offset = x - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) a[i] += offset;
  __syncthreads();
}

// first i in [0, n) with a[i] > v (n if none); a nondecreasing
__device__ __forceinline__ int upper_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first i in [0, n) with a[i] >= v (n if none); a nondecreasing
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct Slot {
  int lo;          // first row of the m-tile
  int group;
  int row_start;   // the group's rows in this tile: [row_start, row_end)
  int row_end;
  int is_first;    // first slot of its tile: also writes the zero tail
  int total;       // sum(splits)
};

// Slot `s` of grouped_tile_schedule(splits, T, BM), derived by the whole
// block in `scratch` (E + cdiv(T, BM) ints of shared memory, free again on
// return).  Returns false for a padding slot (uniformly across the block).
template <int THREADS>
__device__ bool derive_slot(const int* __restrict__ splits, int E, int T,
                            int BM, int s, int* scratch, int* warp_sums,
                            Slot& slot) {
  const int nt = (T + BM - 1) / BM;
  int* ends = scratch;            // inclusive cumsum of splits
  int* slot_end = scratch + E;    // inclusive cumsum of slots per tile
  for (int i = threadIdx.x; i < E; i += THREADS) ends[i] = splits[i];
  __syncthreads();
  block_scan<THREADS>(ends, E, warp_sums);
  for (int t = threadIdx.x; t < nt; t += THREADS) {
    const int lo = t * BM;
    // groups meeting the tile: the first ending past its start to the last
    // starting before its end (starts are [0, ends[0], ..., ends[E-2]])
    const int first = upper_bound(ends, E, lo);
    const int last = lower_bound(ends, E - 1, lo + BM);
    slot_end[t] = max(last - first + 1, 1);
  }
  __syncthreads();
  block_scan<THREADS>(slot_end, nt, warp_sums);
  const bool valid = s < slot_end[nt - 1];
  if (valid) {
    const int tile = upper_bound(slot_end, nt, s);
    const int lo = tile * BM;
    const int rank = s - (tile ? slot_end[tile - 1] : 0);
    const int group = min(upper_bound(ends, E, lo) + rank, E - 1);
    slot.lo = lo;
    slot.group = group;
    slot.row_start = max(group ? ends[group - 1] : 0, lo);
    slot.row_end = min(ends[group], lo + BM);
    slot.is_first = rank == 0;
    slot.total = ends[E - 1];
  }
  __syncthreads();  // every thread has read the scratch before it is reused
  return valid;
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

// The zeros of the tile's rows past sum(splits), columns [n0, n0 + BN).
template <typename OutT, int THREADS>
__device__ void zero_tail(OutT* out, const Slot& sl, int BM, int BN, int n0,
                          int T, int N) {
  const int r0 = max(sl.lo, sl.total), r1 = min(sl.lo + BM, T);
  const int cols = min(BN, N - n0);
  for (int i = threadIdx.x; i < (r1 - r0) * cols; i += THREADS)
    out[static_cast<size_t>(r0 + i / cols) * N + n0 + i % cols] =
        from_f32<OutT>(0.f);
}

constexpr int kThreads = 128;

// ---------------------------------------------------------------------------
// bf16: mma.sync tiles, cp.async ring

template <int BM, int BN, int BK, int WARPS_M, int STAGES>
struct Tiles {
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BK + 8, LDB = BN + 8;  // padded rows, elements
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr int SMEM_BYTES = STAGES * STAGE * 2;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "tile shape");
};

template <int BM, int BN, int BK, int WARPS_M, int STAGES, typename OutT>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const int* __restrict__ splits, OutT* __restrict__ out,
                  int T, int K, int N, int E) {
  using L = Tiles<BM, BN, BK, WARPS_M, STAGES>;
  __shared__ __align__(16) bf16 smem[STAGES * L::STAGE];
  __shared__ int warp_sums[kThreads / 32];
  Slot sl;
  if (!derive_slot<kThreads>(splits, E, T, BM, blockIdx.y,
                             reinterpret_cast<int*>(smem), warp_sums, sl))
    return;
  const int n0 = blockIdx.x * BN;
  if (sl.is_first) zero_tail<OutT, kThreads>(out, sl, BM, BN, n0, T, N);
  if (sl.row_start >= sl.row_end) return;

  const bf16* wg = w + static_cast<size_t>(sl.group) * K * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / L::WARPS_N, wn = warp % L::WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;

  // k-tile kt -> ring buffer `buf`; rows outside the slot's rows, and
  // columns or k past the matrix, are zero-filled without a read
  auto load = [&](int kt, int buf) {
    bf16* sa = smem + buf * L::STAGE;
    bf16* sb = sa + L::A_ELEMS;
    const int k0 = kt * BK;
    for (int i = tid; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int row = sl.lo + r;
      const bool in = row >= sl.row_start && row < sl.row_end && k0 + c < K;
      cp_async16(sa + r * L::LDA + c,
                 in ? x + static_cast<size_t>(row) * K + k0 + c : x, in);
    }
    for (int i = tid; i < BK * BN / 8; i += kThreads) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool in = k0 + r < K && n0 + c < N;
      cp_async16(sb + r * L::LDB + c,
                 in ? wg + static_cast<size_t>(k0 + r) * N + n0 + c : wg, in);
    }
  };

  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int ktiles = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed for all; buffer (kt - 1) % STAGES free
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const bf16* sa = smem + (kt % STAGES) * L::STAGE;
    const bf16* sb = sa + L::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[L::MT][4], b[L::NT][2];
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
        ldmatrix_x4(a[i], sa + (wm * L::WM + i * 16 + (lane & 15)) * L::LDA
                              + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < L::NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (kk + (lane & 15)) * L::LDB
                                 + wn * L::WN + j * 8 + (lane >> 4) * 8);
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

  // store the slot's own rows; N is a multiple of 8, so a column pair is
  // either inside the matrix or past it
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = sl.lo + wm * L::WM + i * 16 + g + half * 8;
      if (row < sl.row_start || row >= sl.row_end) continue;
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const int col = n0 + wn * L::WN + j * 8 + 2 * t4;
        if (col < N)
          Pair<OutT>::store(out + static_cast<size_t>(row) * N + col,
                            acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMA in full f32

constexpr int kF32BM = 32, kF32BN = 64, kF32BK = 16, kF32Threads = 256;
constexpr int kF32ScratchInts = 4096;

__global__ void __launch_bounds__(kF32Threads)
grouped_gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
                 const int* __restrict__ splits, float* __restrict__ out,
                 int T, int K, int N, int E) {
  __shared__ __align__(16) int scratch[kF32ScratchInts];
  __shared__ int warp_sums[kF32Threads / 32];
  Slot sl;
  if (!derive_slot<kF32Threads>(splits, E, T, kF32BM, blockIdx.y, scratch,
                                warp_sums, sl))
    return;
  const int n0 = blockIdx.x * kF32BN;
  if (sl.is_first) zero_tail<float, kF32Threads>(out, sl, kF32BM, kF32BN, n0, T, N);
  if (sl.row_start >= sl.row_end) return;

  float* as = reinterpret_cast<float*>(scratch);        // [BK][BM + 4], transposed
  float* bs = as + kF32BK * (kF32BM + 4);               // [BK][BN]
  const float* wg = w + static_cast<size_t>(sl.group) * K * N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += kF32BK) {
    for (int i = tid; i < kF32BM * kF32BK; i += kF32Threads) {
      const int m = i / kF32BK, k = i % kF32BK;
      const int row = sl.lo + m;
      const bool in = row >= sl.row_start && row < sl.row_end && k0 + k < K;
      as[k * (kF32BM + 4) + m] = in ? x[static_cast<size_t>(row) * K + k0 + k] : 0.f;
    }
    {
      const int r = tid / 16, c = (tid % 16) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < K && n0 + c < N)
        v = *reinterpret_cast<const float4*>(wg + static_cast<size_t>(k0 + r) * N + n0 + c);
      *reinterpret_cast<float4*>(bs + r * kF32BN + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kF32BK; ++k) {
      const float a0 = as[k * (kF32BM + 4) + ty];
      const float a1 = as[k * (kF32BM + 4) + ty + 16];
      const float4 b = *reinterpret_cast<const float4*>(bs + k * kF32BN + tx * 4);
      acc[0][0] = fmaf(a0, b.x, acc[0][0]);
      acc[0][1] = fmaf(a0, b.y, acc[0][1]);
      acc[0][2] = fmaf(a0, b.z, acc[0][2]);
      acc[0][3] = fmaf(a0, b.w, acc[0][3]);
      acc[1][0] = fmaf(a1, b.x, acc[1][0]);
      acc[1][1] = fmaf(a1, b.y, acc[1][1]);
      acc[1][2] = fmaf(a1, b.z, acc[1][2]);
      acc[1][3] = fmaf(a1, b.w, acc[1][3]);
    }
    __syncthreads();
  }
  const int col = n0 + tx * 4;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = sl.lo + ty + 16 * i;
    if (row >= sl.row_start && row < sl.row_end)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * N + col) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

template <int BM, int BN, int BK, int WARPS_M, int STAGES, typename OutT>
int launch_bf16(const void* x, const void* w, const void* splits, void* out,
                int T, int K, int N, int E, cudaStream_t st) {
  using L = Tiles<BM, BN, BK, WARPS_M, STAGES>;
  const int nt = (T + BM - 1) / BM;
  if ((E + nt) * 4 > L::SMEM_BYTES) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, nt + E);
  grouped_gemm_bf16<BM, BN, BK, WARPS_M, STAGES, OutT><<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(splits), static_cast<OutT*>(out), T, K, N, E);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the schedule alone: derive_slot's result for every slot, written out so
// that the derivation can be held to ops/swizzle.py::grouped_tile_schedule

constexpr int kScheduleScratchInts = 11520;  // the largest E + cdiv(T, BM) K5 takes

__global__ void __launch_bounds__(kThreads)
grouped_schedule(const int* __restrict__ splits, int E, int T, int BM,
                 int* __restrict__ out) {
  __shared__ int scratch[kScheduleScratchInts];
  __shared__ int warp_sums[kThreads / 32];
  const int s = blockIdx.x, S = gridDim.x;
  Slot sl;
  const bool valid =
      derive_slot<kThreads>(splits, E, T, BM, s, scratch, warp_sums, sl);
  if (threadIdx.x == 0) {
    out[s] = valid;
    out[S + s] = valid ? sl.lo / BM : 0;
    out[2 * S + s] = valid ? sl.group : 0;
    out[3 * S + s] = valid ? sl.row_start : 0;
    out[4 * S + s] = valid ? sl.row_end : 0;
    out[5 * S + s] = valid ? sl.is_first : 0;
  }
}

}  // namespace
}  // namespace tdt

// x (T, K), w (E, K, N), splits (E,) int32, out (T, N), all on one device and
// contiguous; K and N multiples of 8.  dtype: 0 f32, 1 bf16; out_dtype the
// same codes (bf16 input only: bf16 or f32 out).  (bm, bn, bk) picks the
// tile: (16, 64, 64) or (64, 128, 32) for bf16, (32, 64, 16) for f32.
extern "C" int tdt_grouped_matmul(const void* x, const void* w,
                                  const void* splits, void* out, int T, int K,
                                  int N, int E, int bm, int bn, int bk,
                                  int dtype, int out_dtype, void* stream) {
  using namespace tdt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || E <= 0 || K % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && bm == 16 && bn == 64 && bk == 64) {
    if (out_dtype == 1) return launch_bf16<16, 64, 64, 1, 4, bf16>(x, w, splits, out, T, K, N, E, st);
    if (out_dtype == 0) return launch_bf16<16, 64, 64, 1, 4, float>(x, w, splits, out, T, K, N, E, st);
  }
  if (dtype == 1 && bm == 64 && bn == 128 && bk == 32) {
    if (out_dtype == 1) return launch_bf16<64, 128, 32, 2, 3, bf16>(x, w, splits, out, T, K, N, E, st);
    if (out_dtype == 0) return launch_bf16<64, 128, 32, 2, 3, float>(x, w, splits, out, T, K, N, E, st);
  }
  if (dtype == 0 && out_dtype == 0 && bm == kF32BM && bn == kF32BN && bk == kF32BK) {
    const int nt = (T + kF32BM - 1) / kF32BM;
    if (E + nt > kF32ScratchInts) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + kF32BN - 1) / kF32BN, nt + E);
    grouped_gemm_f32<<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(splits), static_cast<float*>(out), T, K, N, E);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The slots K5's blocks derive from splits (E,) for T rows in m-tiles of bm:
// out (6, E + cdiv(T, bm)) int32, rows valid, m-tile, group, row_start,
// row_end, is_first, zeros on the padding slots.  Computes no product.
extern "C" int tdt_grouped_schedule(const void* splits, int T, int E, int bm,
                                    void* out, void* stream) {
  using namespace tdt;
  if (T <= 0 || E <= 0 || bm <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int slots = E + (T + bm - 1) / bm;
  if (slots > kScheduleScratchInts) return static_cast<int>(cudaErrorInvalidValue);
  grouped_schedule<<<slots, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(splits), E, T, bm, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
