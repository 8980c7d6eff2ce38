// K5: grouped (per-expert) GEMM over expert-sorted rows, for Hopper (sm_90a).
//
// Replaces triton_distributed_tpu/ops/group_gemm.py::_grouped_matmul_kernel
// (the tile-scheduled Pallas grouped matmul) and, on the port's MoE path,
// the `lax.ragged_dot` calls JAX makes for the same function: out[r] =
// x[r] @ w[g(r)] for every row r below sum(splits), g(r) the group whose
// rows [start, end) hold r; rows from sum(splits) to T are zeros; empty
// groups are allowed; f32 accumulation, the output rounded once.
//
// Bound on the H100 at the Qwen3-30B-A3B shapes: the prefill products
// (32768 rows, K 2048 -> N 1536 and K 768 -> N 2048, 128 experts) move
// 0.59-1.04 GB (x once, the 128 experts' weights once, out once) and compute
// 103-206 GFLOP, so the bytes bound them at 3.35 TB/s (0.18-0.31 ms); the
// decode products (32 rows) read only the weights of the experts touched,
// 3-6 MB each, and are bound by those bytes.
//
// Three forms, chosen by the wrapper (ops/group_gemm.py) by rows and dtype:
//
// Prefill (bf16, 128 x 256 x 64, from 1024 rows): wgmma_tile.cuh's main
// loop on a persistent walk of per-group work units.  A unit is (group,
// m-tile, n-tile); a group's m-tiles start at its first row, so no tile
// spans two groups and a group of n rows costs ceil(n / 128) tiles, not the
// extra tile each group boundary adds on a grid fixed from row 0.  Units are
// ordered group-major, n-tile next, m-tile fastest: the ~132 blocks in flight
// work on one to a dozen experts at a time, each weight band (K x 256) is
// read by the group's m-tiles while it is in L2 and the group's rows by its
// n-tiles, so x, the touched experts' weights and out each cross HBM about
// once (1.04 GB for the up product, 0.59 GB for the down one).  min(#SMs,
// units) blocks are launched (units bounded on the host by (cdiv(T, 128) +
// E) * cdiv(N, 256): splits stays on the device); each derives the groups'
// row and tile ends once, from one block-wide prefix sum of E packed
// (tiles << 32 | rows) values in shared memory, then takes units u =
// blockIdx.x, u += gridDim.x, finding a unit's group by a binary search.
// The producer warp loads A boxes from the group's rows (rows of the next
// group are loaded, never stored; past T TMA fills zeros) and B boxes from
// the expert's slab of the (E, K, N) weights (zeros past K and N); a
// consumer warpgroup whose 64 rows lie wholly past the group's end skips
// its wgmmas.  The three spare warps write the zero rows from sum(splits)
// to T while the products run.  bf16 results leave as 16-byte row pieces
// (wgmma_tile.cuh's quad transpose), f32 ones as float pairs.  Sums run
// over k in 16-deep wgmma steps, in order: each output element is one f32
// sum of its K products, as in the earlier mma.sync form, but taken in
// another order inside the tensor cores, so a result may differ from that
// form's by the f32 rounding of a K-long sum (well below one bf16 ulp of the
// output; the f32 output by ~1e-6 relative).
//
// Decode (bf16, 16 x 64 x 64, below 1024 rows): each block owns one slot of
// ops/swizzle.py::grouped_tile_schedule (m-tiles of 16 rows on one grid from
// row 0; a tile gets one slot per group that meets it, at least one) and
// one n-tile, and derives its slot from `splits` itself with two block-wide
// prefix sums in shared memory.  A block stores only its own group's rows
// of the tile; the first slot of a tile also writes the zeros of its rows
// past sum(splits); padding slots exit at once.  Products on mma.sync
// m16n8k16 bf16 -> f32, operand tiles through a cp.async ring of four
// stages (rows padded by 8 elements so the ldmatrix reads hit distinct
// banks), every warp its own 16 columns: at 32 rows the weights' bytes
// bound it, not the tensor path.
//
// f32 (32 x 64 x 16): the decode form's schedule with plain scalar FMA in
// full f32 (no TF32), for parity checks, as JAX runs f32 at
// Precision.HIGHEST.
#include <type_traits>

#include "wgmma_tile.cuh"

namespace tdt {
namespace {

// ---------------------------------------------------------------------------
// the schedule

// In-place inclusive prefix sum of a[0, n) in shared memory, by the block.
template <int THREADS, typename V>
__device__ void block_scan(V* a, int n, V* warp_sums) {
  const int per = (n + THREADS - 1) / THREADS;
  const int lo = threadIdx.x * per, hi = min(lo + per, n);
  V sum = 0;
  for (int i = lo; i < hi; ++i) {
    sum += a[i];
    a[i] = sum;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V y = __shfl_up_sync(kFullMask, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    V v = lane < THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const V y = __shfl_up_sync(kFullMask, v, o);
      if (lane >= o) v += y;
    }
    if (lane < THREADS / 32) warp_sums[lane] = v;
  }
  __syncthreads();
  const V offset = x - sum + (warp ? warp_sums[warp - 1] : 0);
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
// bf16 prefill: wgmma_tile.cuh's loop on a persistent walk of per-group units

constexpr int kMaxGroups = 1024;

// The groups' ends, derived once a block: ends[g] packs the inclusive
// prefix sums of the groups' m-tiles, ceil(n_g / BM) (high 32 bits), and of
// their rows n_g (low 32 bits), one scan of E values.  sum(splits) < 2^31,
// so the rows never carry into the tiles.
struct Groups {
  const long long* ends;
  int E, total, tiles;  // sum(splits), sum of the groups' m-tiles
  __device__ int row_end(int g) const { return static_cast<int>(ends[g] & 0xffffffffLL); }
  __device__ int tile_end(int g) const { return static_cast<int>(ends[g] >> 32); }
  __device__ int row_start(int g) const { return g ? row_end(g - 1) : 0; }
  __device__ int tile_start(int g) const { return g ? tile_end(g - 1) : 0; }
};

template <int THREADS>
__device__ Groups derive_groups(const int* __restrict__ splits, int E, long long* ends,
                                long long* warp_sums) {
  for (int i = threadIdx.x; i < E; i += THREADS) {
    const long long n = splits[i];
    ends[i] = ((n + wg::BM - 1) / wg::BM) << 32 | n;
  }
  __syncthreads();
  block_scan<THREADS>(ends, E, warp_sums);
  return Groups{ends, E, static_cast<int>(ends[E - 1] & 0xffffffffLL),
                static_cast<int>(ends[E - 1] >> 32)};
}

// Work unit u of gr.tiles * nn (ops/swizzle.py::grouped_work_units): group
// g holds units [nn tile_start(g), nn tile_end(g)), n-tile-major with the
// m-tile fastest; its m-tile i covers rows [row_start(g) + BM i, ...) up to
// the group's end.
struct Unit {
  int group, m0, row_end, n0;
};

__device__ __forceinline__ Unit unit_at(const Groups& gr, int nn, int u) {
  // the first group whose tiles end past u / nn (empty groups end where the
  // one before does, so they are never chosen)
  const int v = u / nn;
  int lo = 0, hi = gr.E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (gr.tile_end(mid) <= v) lo = mid + 1; else hi = mid;
  }
  const int g = lo, t0 = gr.tile_start(g), tiles = gr.tile_end(g) - t0;
  const int local = u - nn * t0;
  return Unit{g, gr.row_start(g) + (local % tiles) * wg::BM, gr.row_end(g),
              (local / tiles) * wg::BN};
}

struct GroupedArgs {
  CUtensorMap ma, mb;  // A (K, T, 1); B (N, K, E)
  const int* splits;
  void* out;
  int T, K, N, E;
};

template <typename OutT>
__global__ void __launch_bounds__(wg::THREADS, 1)
grouped_gemm_wgmma(const __grid_constant__ GroupedArgs p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ wg::Bars bars;
  __shared__ long long ends[kMaxGroups];
  __shared__ long long warp_sums[wg::THREADS / 32];
  const Groups gr = derive_groups<wg::THREADS>(p.splits, p.E, ends, warp_sums);
  wg::init_bars(bars);
  const int nn = (p.N + wg::BN - 1) / wg::BN, units = gr.tiles * nn;
  const int ktiles = (p.K + wg::BK - 1) / wg::BK, warp = threadIdx.x / 32;
  unsigned char* st = wg::stages(dyn);
  OutT* out = static_cast<OutT*>(p.out);
  if (warp >= wg::kProducerWarp) {
    wg::set_max_regs_dec<40>();
    if (threadIdx.x == wg::kProducerWarp * 32) {
      wg::Ring ring;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_at(gr, nn, u);
        wg::load_tile(st, bars, ring, &p.ma, &p.mb, wg::TileAt{0, w.group, w.m0, w.n0}, ktiles);
      }
    } else if (warp > wg::kProducerWarp) {
      // the spare warps: rows [sum(splits), T) are zeros, in 16-byte pieces
      const long long n16 = static_cast<long long>(p.T - gr.total) * p.N * sizeof(OutT) / 16;
      uint4* z = reinterpret_cast<uint4*>(out + static_cast<long long>(gr.total) * p.N);
      const long long step = static_cast<long long>(gridDim.x) * wg::kSpareThreads;
      for (long long i = static_cast<long long>(blockIdx.x) * wg::kSpareThreads + threadIdx.x -
                         (wg::kProducerWarp + 1) * 32;
           i < n16; i += step)
        z[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    wg::set_max_regs_inc<232>();
    wg::Ring ring;
    float d[wg::kAccRegs];
    const int mine = (threadIdx.x / 128) * 64;  // this warpgroup's first row in a tile
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_at(gr, nn, u);
      const int rows = min(w.row_end, p.T);  // the group's rows that are stored
      wg::mma_tile(st, bars, ring, ktiles, d, w.m0 + mine < rows);
      if constexpr (std::is_same<OutT, bf16>::value) {
        wg::store_pieces(d, out, rows, p.N, w.m0, w.n0);
      } else {
        const int r0 = wg::acc_row0(), c0 = wg::acc_col0();
#pragma unroll
        for (int q = 0; q < wg::kAccRegs / 2; ++q) {
          const int row = w.m0 + r0 + 8 * (q & 1), col = w.n0 + 8 * (q >> 1) + c0;
          if (row < rows && col < p.N)
            *reinterpret_cast<float2*>(out + static_cast<long long>(row) * p.N + col) =
                make_float2(d[4 * (q >> 1) + 2 * (q & 1)], d[4 * (q >> 1) + 2 * (q & 1) + 1]);
        }
      }
    }
  }
}

// An upper bound of the units, known on the host without reading splits:
// sum(ceil(n_g / BM)) <= cdiv(T, BM) + E.
long long max_units(int T, int N, int E) {
  return (static_cast<long long>((T + wg::BM - 1) / wg::BM) + E) * ((N + wg::BN - 1) / wg::BN);
}

template <typename OutT>
int launch_wgmma(const void* x, const void* w, const void* splits, void* out, int T, int K,
                 int N, int E, cudaStream_t st) {
  if (E > kMaxGroups || max_units(T, N, E) >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  GroupedArgs p{};
  cudaError_t e = wg::map_a(&p.ma, x, K, T, 1);
  if (e == cudaSuccess) e = wg::map_b(&p.mb, w, K, N, E);
  if (e != cudaSuccess) return static_cast<int>(e);
  p.splits = static_cast<const int*>(splits);
  p.out = out;
  p.T = T, p.K = K, p.N = N, p.E = E;
  auto kernel = grouped_gemm_wgmma<OutT>;
  long long fit = 0;
  if ((e = dl::resident_lanes(kernel, 1, wg::THREADS, wg::SMEM_BYTES, &fit)) != cudaSuccess)
    return static_cast<int>(e);
  const unsigned grid = static_cast<unsigned>(max(1LL, min(fit, max_units(T, N, E))));
  kernel<<<grid, wg::THREADS, wg::SMEM_BYTES, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The prefill form's work list alone, as its blocks derive it: out (5, U)
// int32, U = max_units, rows valid, group, m0, row_end, n0, zeros past the
// real units (ops/swizzle.py::grouped_work_units is its mirror).
__global__ void __launch_bounds__(wg::THREADS)
grouped_units(const int* __restrict__ splits, int E, int N, int U, int* __restrict__ out) {
  __shared__ long long ends[kMaxGroups];
  __shared__ long long warp_sums[wg::THREADS / 32];
  const Groups gr = derive_groups<wg::THREADS>(splits, E, ends, warp_sums);
  const int nn = (N + wg::BN - 1) / wg::BN, units = gr.tiles * nn;
  for (int u = threadIdx.x; u < U; u += wg::THREADS) {
    const bool valid = u < units;
    const Unit w = valid ? unit_at(gr, nn, u) : Unit{0, 0, 0, 0};
    out[u] = valid;
    out[U + u] = w.group;
    out[2 * U + u] = w.m0;
    out[3 * U + u] = w.row_end;
    out[4 * U + u] = w.n0;
  }
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
// contiguous, 16-byte aligned; K and N multiples of 8.  dtype: 0 f32, 1 bf16;
// out_dtype the same codes (bf16 input only: bf16 or f32 out).  (bm, bn,
// bk) picks the form: (16, 64, 64) decode or (128, 256, 64) prefill for
// bf16, (32, 64, 16) for f32.
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
  if (dtype == 1 && bm == wg::BM && bn == wg::BN && bk == wg::BK) {
    if (out_dtype == 1) return launch_wgmma<bf16>(x, w, splits, out, T, K, N, E, st);
    if (out_dtype == 0) return launch_wgmma<float>(x, w, splits, out, T, K, N, E, st);
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

// The prefill form's work units for splits (E,), T rows and N columns: out
// (5, (cdiv(T, 128) + E) * cdiv(N, 256)) int32, rows valid, group, m0,
// row_end, n0, zeros past the real units.  Computes no product.
extern "C" int tdt_grouped_units(const void* splits, int T, int E, int N, void* out,
                                 void* stream) {
  using namespace tdt;
  if (T <= 0 || E <= 0 || E > kMaxGroups || N <= 0 || max_units(T, N, E) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  grouped_units<<<1, wg::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(splits), E, N, static_cast<int>(max_units(T, N, E)),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
