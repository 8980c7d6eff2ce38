// The Hopper main loop of the overlapped GEMMs K12 and K13 (overlap_gemm.cu),
// of K5's prefill form (group_gemm.cu), of K6, the tiled GEMM (matmul.cu),
// and of K19, the overlap probe (overlap_probe.cu): acc = A[m0:m0+128, :] @
// B[:, n0:n0+256] for bf16 operands, f32 sums, on wgmma with TMA loads, in a
// block that walks many tiles in turn.  It is the Hopper form of
// triton_distributed_tpu/ops/blocks.py::matmul_body, which gemm_tile.cuh's
// mma.sync loop (K14's ring) also runs.  K1's and K8's wgmma body
// (flash_attention.cu) takes its barriers, TMA, descriptors and register
// moves, not its loop.
//
// The block is three warpgroups (384 threads).  Warpgroup 2's first warp
// is the producer: one thread keeps TMA loads of A and B tiles in flight
// into a ring of STAGES shared-memory stages, running ahead across tiles,
// each stage guarded by an mbarrier pair (full: the bytes landed; empty:
// both consumers are done with it).  Its three other warps are free for the
// kernel's own data movement (K12's ring, K5's zero tail).  Warpgroups 0
// and 1 consume: each issues wgmma m64n256k16 (bf16 -> f32, A and B from
// shared memory) on its 64 rows of the 128-row tile, 4 per 64-deep stage,
// keeping one stage's products in flight while it releases the one before.
// A warpgroup whose rows the kernel will not store (K5: all past its
// group's end) may skip its products and only release the stages.
// setmaxnreg moves registers from the producer warpgroup (40) to the
// consumers (232): a consumer holds its 64 x 256 sums in 128 registers a
// thread.
//
// Layouts.  A is row-major (M, K): K-major for wgmma, one TMA box of 64 x
// 128 (a 128-byte row of k a tile row) a stage.  B is row-major (K, N):
// MN-major for wgmma (the descriptor's transpose bit), and a 128-byte
// swizzle limits a box to 64 columns, so a stage holds four 64 x 64 boxes,
// 8 KB apart.  Both use the 128-byte swizzle, which the descriptors name;
// the stages are 1024-byte aligned, as the swizzle's 8-row atoms ask.
// Every map is 3-D (innermost first): A (K, rows, slabs) and B (N, K,
// slabs), a slab being a chunk of rows (K12, K13), a rank's matrix (the
// rank-stacked product) or an expert's weights (K5), so a box never reads
// past its slab: TMA fills what lies outside the tensor with zeros.  K and
// N multiples of 8 make every pitch a multiple of 16 bytes, as TMA needs;
// the epilogues write only the rows and columns inside the matrix.
//
// An output element's sum runs over k in 16-deep wgmma steps, 64 a stage,
// in order, whatever the tile's place: a tile of a chunk and the same rows
// of the rank-stacked product give the same bits (chip_smoke.py holds K12
// and K13 to chains built on the product alone).
//
// Bound on the H100: operations at the prefill shapes (989 TFLOP/s bf16 of
// 400-1500 flops a byte).  A 128 x 256 x 64 stage is 48 KB, four stages
// 192 KB: one block an SM.
//
// The loop's width is BN = 256 columns; load_tile, mma_tile and
// store_pieces also take a tile 128 columns wide (wgmma m64n128k16, 64 sums
// a consumer thread, stages of 32 KB), which only K19's 128 x 128 probe tile
// uses.  The width is a template argument whose default is BN, so the
// other kernels' code is as it was.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda

#include "dl.cuh"
#include "ptx.cuh"

namespace tdt {
namespace wg {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int BOX = 64;                       // bf16 columns of a 128-byte row
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int B_BYTES = BK * BN * 2;          // 32 KB: four 64 x 64 boxes
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
constexpr int THREADS = 384, CONSUMERS = 256;
constexpr int kProducerWarp = 8;
// named barriers (0 is __syncthreads): the consumers, the producer
// warpgroup, its three spare warps
constexpr int kConsumerBar = 1, kProducerBar = 2, kSpareBar = 3;
constexpr int kSpareThreads = 96;
constexpr int kAccRegs = 128;  // f32 sums a consumer thread holds

// The bytes of a stage of a tile TBN columns wide (TBN = BN: STAGE_BYTES).
template <int TBN>
__host__ __device__ constexpr int stage_bytes() { return A_BYTES + BK * TBN * 2; }

// The mbarriers of a block: the stages' full/empty pairs, and `start`, a
// one-time signal of the kernel's own (K13: its ring's prologue is done).
struct Bars {
  uint64_t full[STAGES], empty[STAGES], start;
};

// The stage ring's position: stage and phase parity, carried across tiles.
struct Ring {
  int stage = 0, phase = 0;
  __device__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of parity `parity` to complete.  Bounded, like the
// flags' waits but twice as long (a stage that never fills is a fault of
// the launch, not of a peer: a flag's wait runs out first and names it).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try(a, parity)) return;
  const unsigned long long t0 = dl::globaltimer();
  while (!mbar_try(a, parity))
    if (dl::globaltimer() - t0 > 2 * dl::kWaitNs) __trap();
}

// Generic-proxy writes that a flag's acquire made visible, ordered before
// this thread's TMA (async-proxy) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void set_max_regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void set_max_regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One 3-D TMA box into shared memory, completing on `bar`'s byte count.
__device__ __forceinline__ void tma3(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                     int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units in the descriptor).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}
// A, K-major: 8-row groups 1024 bytes apart (the leading offset is unused
// with the swizzle); a 16-deep step is 32 bytes into the swizzled row.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) { return desc(addr, 16, 1024); }
// An MN-major operand stored as 64-column boxes of `box_rows` k rows each
// (box_rows * 128 bytes apart), 8-row k groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t box_rows) {
  return desc(addr, box_rows * 128, 1024);
}
// B, MN-major: 64-column boxes of BK rows, 8 KB apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) { return desc_mn(addr, BK); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of the sums across an
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32) = (scale_d ? d : 0) + A (64 x 16, K-major) @ B (16 x 256,
// MN-major), both in shared memory.
__device__ __forceinline__ void wgmma_256(float (&d)[kAccRegs], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128 f32) = (scale_d ? d : 0) + A (64 x 16, K-major) @ B (16 x 128,
// MN-major), both in shared memory (K19's 128 x 128 probe tile).
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The m64nN wgmma of a consumer holding R = N / 2 sums a thread.
template <int R>
__device__ __forceinline__ void wgmma_n(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  static_assert(R == kAccRegs || R == 64, "the loop is 256 or 128 columns wide");
  if constexpr (R == kAccRegs) wgmma_256(d, da, db, scale_d);
  else wgmma_128(d, da, db, scale_d);
}

// Where a tile's operands lie: A's box at rows m0 of slab a_slab, B's
// columns n0 of slab b_slab.
struct TileAt {
  int a_slab, b_slab, m0, n0;
};

// The block's stages, 1024-byte aligned inside its dynamic shared memory.
__device__ __forceinline__ unsigned char* stages(unsigned char* dyn) {
  const uint32_t a = smem_u32(dyn);
  return dyn + (((a + 1023) & ~1023u) - a);
}

// Thread 0: the stages' barriers (full: the producer's arrival and the TMA
// bytes; empty: one arrival per consumer warp) and `start` (one arrival).
// The whole block then syncs.
__device__ __forceinline__ void init_bars(Bars& b) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&b.full[s], 1);
      mbar_init(&b.empty[s], CONSUMERS / 32);
    }
    mbar_init(&b.start, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Producer (one thread): the `ktiles` stages of one tile TBN columns wide,
// after the ring's consumers have released each.
template <int TBN = BN>
__device__ __forceinline__ void load_tile(unsigned char* st, Bars& b, Ring& r,
                                          const CUtensorMap* ma, const CUtensorMap* mb,
                                          const TileAt& at, int ktiles) {
  constexpr int kStage = stage_bytes<TBN>();
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&b.empty[r.stage], r.phase ^ 1);
    mbar_expect_tx(&b.full[r.stage], kStage);
    unsigned char* s = st + r.stage * kStage;
    tma3(s, ma, &b.full[r.stage], kt * BK, at.m0, at.a_slab);
#pragma unroll
    for (int q = 0; q < TBN / BOX; ++q)
      tma3(s + A_BYTES + q * BK * 128, mb, &b.full[r.stage], at.n0 + q * BOX, kt * BK,
           at.b_slab);
    r.next();
  }
}

// Consumer warpgroup (threads [0, 256)): d = the tile's product over all
// `ktiles` stages for this warpgroup's 64 rows, R = TBN / 2 sums a thread.
// With `live` false the warpgroup only waits for each stage and releases it:
// d is left as it was.
template <int R>
__device__ __forceinline__ void mma_tile(unsigned char* st, Bars& b, Ring& r, int ktiles,
                                         float (&d)[R], bool live = true) {
  constexpr int kStage = stage_bytes<2 * R>();
  const uint32_t base = smem_u32(st) + (threadIdx.x / 128) * (64 * 128);
  const bool signal = (threadIdx.x & 31) == 0;
  if (!live) {
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&b.full[r.stage], r.phase);
      if (signal) mbar_arrive(&b.empty[r.stage]);
      r.next();
    }
    return;
  }
  int prev = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&b.full[r.stage], r.phase);
    const uint32_t a = base + r.stage * kStage;
    const uint32_t bb = smem_u32(st) + r.stage * kStage + A_BYTES;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_n(d, desc_a(a + kk * 32), desc_b(bb + kk * 16 * 128), (kt | kk) != 0);
    wgmma_commit();
    fence_acc(d);
    if (prev >= 0) {
      wgmma_wait<1>();
      if (signal) mbar_arrive(&b.empty[prev]);
    }
    prev = r.stage;
    r.next();
  }
  wgmma_wait<0>();
  fence_acc(d);
  if (signal) mbar_arrive(&b.empty[prev]);
}

// The output coordinates of this consumer thread's sums: d[4 j + 2 h + e]
// is row row0() + 8 h of the tile, column 8 j + col0() + e.
__device__ __forceinline__ int acc_row0() {
  const int t = threadIdx.x;
  return (t / 128) * 64 + ((t % 128) / 32) * 16 + (t & 31) / 4;
}
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x & 3); }

// ---------------------------------------------------------------------------
// bf16 epilogue: the sums of a wgmma m64nN accumulator (R = N / 2 registers
// a thread) leave as whole 16-byte row pieces.  The four threads of a quad
// hold columns 2q, 2q + 1 of the same 8-column block in each row, so a 4 x 4
// transpose within the quad (shuffles) gives thread q all eight columns of
// block 4k + q, one 16-byte load or store where four 4-byte ones would
// touch half a sector each.

__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const unsigned*>(&b);
}

__device__ __forceinline__ unsigned pick(const unsigned (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// out[k] = in[q] of quad lane k, for this thread's lane q of the quad.
__device__ __forceinline__ void quad_transpose(const unsigned (&in)[4], unsigned (&out)[4]) {
  const int lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int src = (q + r) & 3;
    const unsigned v = __shfl_sync(0xffffffffu, pick(in, (q - r) & 3), (lane & ~3) | src);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = k == src ? v : out[k];
  }
}

// Row half h, column blocks 4k..4k+3 of a thread's m64nN sums, rounded to
// bf16: the eight values of its row (acc_row0() + 8 h within the warpgroup's
// rows), columns 8 (4 k + q) + [0, 8); k < R / 16.
template <int R>
__device__ __forceinline__ uint4 row_piece(const float (&d)[R], int h, int k) {
  unsigned in[4], out[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = 4 * k + b;
    in[b] = pack_bf16(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  }
  quad_transpose(in, out);
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The first column of piece k in the tile.
__device__ __forceinline__ int piece_col(int k) { return 8 * (4 * k + (threadIdx.x & 3)); }

// The m64n(2R) sums of both consumer warpgroups rounded to bf16 into C
// (row-major, N columns), the tile at (m0, n0): rows from `rows` on and
// columns from N on left out (N a multiple of 8).
template <int R>
__device__ __forceinline__ void store_pieces(const float (&d)[R], bf16* C, int rows, int N,
                                             int m0, int n0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + acc_row0() + 8 * h;
#pragma unroll
    for (int k = 0; k < R / 16; ++k) {
      const uint4 v = row_piece(d, h, k);
      const int col = n0 + piece_col(k);
      if (row < rows && col < N)
        *reinterpret_cast<uint4*>(C + static_cast<long long>(row) * N + col) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps, cuTensorMapEncodeTiled found through the runtime (nothing
// links libcuda)

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// A 3-D map of `type` (bf16 unless given) at `base`: (d0, d1, d2) elements
// innermost first, d0 contiguous, pitches p1 and p2 in bytes; boxes of box0
// x box1 x 1 (box0 of 128 bytes: BOX bf16 values unless given) with the
// 128-byte swizzle, zeros outside the tensor.
inline cudaError_t make_map(CUtensorMap* m, const void* base, uint64_t d0, uint64_t d1,
                            uint64_t d2, uint64_t p1, uint64_t p2, uint32_t box1,
                            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            uint32_t box0 = BOX) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t pitch[2] = {p1, p2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t one[3] = {1, 1, 1};
  const CUresult r = enc(m, type, 3, const_cast<void*>(base), dims,
                         pitch, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The A operand's map: `slabs` slabs of (rows, k) row-major bf16, boxes of
// BM rows.
inline cudaError_t map_a(CUtensorMap* m, const void* base, int k, long long rows, int slabs) {
  return make_map(m, base, k, rows, slabs, 2ull * k, 2ull * k * rows, BM);
}
// The B operand's map: `slabs` matrices (k, n) row-major bf16, boxes of BK
// rows.
inline cudaError_t map_b(CUtensorMap* m, const void* base, int k, int n, int slabs) {
  return make_map(m, base, n, k, slabs, 2ull * n, 2ull * n * k, BK);
}

}  // namespace wg
}  // namespace tdt
