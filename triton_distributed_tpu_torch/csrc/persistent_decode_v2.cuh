// K16's served form (persistent_decode_v2.cu describes it): every layer of a
// dense Qwen3 decode step, bf16, head dim 128, B <= 4, for every co-located
// rank in one cooperative launch, built around one stream of weight loads
// per thread that never stops at a stage's end.
#pragma once

#include "common.cuh"
#include "dl.cuh"
#include "ptx.cuh"
#include "stamps.cuh"

namespace tdt {
namespace pd2 {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 128;           // head dim, and the output columns of a product tile
constexpr int kLanesPerRow = 16;  // threads that read one weight row of a tile (16 bytes each)
constexpr int kRowsPerPass = kThreads / kLanesPerRow;  // weight rows a pass of the block reads
constexpr int kStages = 8;        // each thread's ring of 16-byte weight loads
constexpr int kMaxB = 4;          // rows of A
constexpr int kWin = 4096;        // rows of A staged in shared memory at once
constexpr int kLayerPtrs = 8;     // ln1, wqkv, q_norm, k_norm, wo, ln2, gate_up, down
enum { kLn1, kWqkv, kQNorm, kKNorm, kWo, kLn2, kGateUp, kDown };
// a rank's scratch regions (byte offsets from its base; core/symm.py STREAM_REGIONS)
enum { kX, kAtt, kAct, kQ, kKTok, kVTok, kPart, kAcc, kMl, kLand, kRegions };
// the four products of a layer
enum { kQkv, kO, kGu, kDn, kProducts };
// counters, in the second half of each rank's pad (dl.cuh kTileFlagBase):
// the one-shot arrivals of each output tile of o and down, each kv head's
// finished qkv tiles, each (sequence, kv head)'s attention splits, and each
// product tile's K slices; all count up over the launch and are cleared at
// its end
constexpr int kArrive = 0, kReady = 1024, kSplitTicket = 1280, kTicket = 3328;
constexpr int kTicketStride = 2048;
constexpr int kCounters = kTicket + kProducts * kTicketStride;

// core/symm.py StreamArgs, field for field.  c: the team (c.flags is the
// pad; x, out and land are unused).  layers: (L, kLayerPtrs) device
// addresses, rank r's weight at + r * w_stride[kind] bytes.  x_in (B, K);
// pools (L, n P, hk, ps, D); table (n B, mp), lens (n B) rank-folded;
// scratch: one base per rank, regions at off[]; x_out (B, K).  F: a rank's
// intermediate columns; hk: a rank's kv heads.
struct StreamArgs {
  dl::CollArgs c;
  const long long* layers;
  long long w_stride[kLayerPtrs];
  const void* x_in;
  void* x_out;
  void* pool_k;
  void* pool_v;
  const int* table;
  const int* lens;
  const float* inv_freq;
  dl::Peers scratch;
  long long off[kRegions];
  long long layer_pool_elems;
  int L, B, K, F, hk, ps, mp, n_split;
  float sm_scale, soft_cap, qk_eps, rms_eps;
  int qk_norm;
};

struct Smem {
  uint4 ring[kStages][kThreads];   // each thread's weight loads in flight
  bf16 a[kWin * kMaxB];            // A's rows at row k: a[k * 4 + b]; the attention's
                                   // per-warp states reuse it
  float red[kWarps][kMaxB][kD];    // the product's per-warp sums
  float inv[kMaxB];
  float ss[kWarps];
  float alpha[8], pr[8], den[8];
  float wgt[8][32];  // each split's weight exp(m_s - m) in the fold, by query head
  int last;
};

__device__ __forceinline__ const bf16* weight(const StreamArgs& a, int l, int kind, int r) {
  const long long p = a.layers[static_cast<long long>(l) * kLayerPtrs + kind];
  return p ? reinterpret_cast<const bf16*>(p + r * a.w_stride[kind]) : nullptr;
}

template <typename T>
__device__ __forceinline__ T* region(const StreamArgs& a, int slot, int which) {
  return reinterpret_cast<T*>(a.scratch.p[slot] + a.off[which]);
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rnd(float v) { return round_to<bf16>(v); }

// One product's cut (ops/persistent_decode.py stream_geometry mirrors it):
// `tiles` tiles of 128 output columns (gate/up: 64 gate columns and the 64
// up columns that match them; qkv: one head) over the whole depth kd, in
// passes of kRowsPerPass rows; the tiles' passes are laid end to end and
// cut into gridDim.x equal runs, one a lane (stream-K), so every lane
// streams the same bytes.  A tile cut between lanes is summed by the last
// of them to arrive, in lane order.
struct Geo {
  const bf16* w;
  int ldw, kd, tiles, ppt, half;  // half: gate/up's first up column (F), else 0
  int q0, q1;                     // this lane's passes
};

template <int G>
__device__ __forceinline__ Geo geo(const StreamArgs& a, int l, int s, int r) {
  Geo g;
  const int hq = a.hk * G;
  int kind;
  if (s == kQkv) {
    kind = kWqkv;
    g.kd = a.K;
    g.tiles = hq + 2 * a.hk;
    g.ldw = g.tiles * kD;
  } else if (s == kO) {
    kind = kWo;
    g.kd = hq * kD;
    g.tiles = a.K / kD;
    g.ldw = a.K;
  } else if (s == kGu) {
    kind = kGateUp;
    g.kd = a.K;
    g.tiles = a.F / 64;
    g.ldw = 2 * a.F;
  } else {
    kind = kDown;
    g.kd = a.F;
    g.tiles = a.K / kD;
    g.ldw = a.K;
  }
  g.half = s == kGu ? a.F : 0;
  g.w = weight(a, l, kind, r);
  g.ppt = g.kd / kRowsPerPass;
  const long long P = static_cast<long long>(g.tiles) * g.ppt;
  g.q0 = static_cast<int>(P * blockIdx.x / gridDim.x);
  g.q1 = static_cast<int>(P * (blockIdx.x + 1) / gridDim.x);
  return g;
}

// The weight column of thread `sub`'s 8 columns of tile `tile`.
__device__ __forceinline__ int col_of(const Geo& g, int tile, int sub) {
  if (g.half) return sub < 8 ? tile * 64 + sub * 8 : g.half + tile * 64 + (sub - 8) * 8;
  return tile * kD + sub * 8;
}

// The lane whose run holds pass q of P.
__device__ __forceinline__ int lane_of(int q, int P) {
  return static_cast<int>(((q + 1LL) * gridDim.x - 1) / P);
}

// The producer side of a thread's ring: the thread's next 16-byte weight
// load, walking every product of every layer in the order the consumer
// reads them, so the loads of the next stage (or layer) are in flight while
// the block is still in this one's epilogue, its barrier or the attention.
template <int G>
struct Feed {
  const StreamArgs& a;
  int r;
  int l, s, tile;          // the product and tile of the next load
  int rem_tile, rem_run;   // passes left in that tile and in the lane's run of the product
  int step;                // elements from a pass's row to the next pass's
  int slot;                // the ring slot of the next load
  const bf16* p;           // this thread's 16 bytes of the next load

  __device__ Feed(const StreamArgs& args, int rank) : a(args), r(rank), l(0), s(0), slot(0) {
    enter();
  }

  // The first pass of the lane's run of product (l, s), or of the next
  // product in which the lane has one.
  __device__ __forceinline__ void enter() {
    while (l < a.L) {
      const Geo g = geo<G>(a, l, s, r);
      if (g.q0 < g.q1) {
        tile = g.q0 / g.ppt;
        const int kp = g.q0 % g.ppt;
        rem_tile = g.ppt - kp;
        rem_run = g.q1 - g.q0;
        step = kRowsPerPass * g.ldw;
        p = g.w + static_cast<long long>(kp * kRowsPerPass + threadIdx.x / kLanesPerRow) * g.ldw +
            col_of(g, tile, threadIdx.x % kLanesPerRow);
        return;
      }
      if (++s == kProducts) {
        s = 0;
        ++l;
      }
    }
  }

  __device__ __forceinline__ void next_tile() {
    const Geo g = geo<G>(a, l, s, r);
    ++tile;
    rem_tile = g.ppt;
    p = g.w + static_cast<long long>(threadIdx.x / kLanesPerRow) * g.ldw +
        col_of(g, tile, threadIdx.x % kLanesPerRow);
  }

  __device__ __forceinline__ void issue(uint4* ring) {
    const bool live = l < a.L;
    cp_async16(ring + slot * kThreads + threadIdx.x, live ? static_cast<const void*>(p) : a.x_in,
               live);
    cp_async_commit();
    slot = slot + 1 == kStages ? 0 : slot + 1;
    if (!live) return;
    if (--rem_run == 0) {
      if (++s == kProducts) {
        s = 0;
        ++l;
      }
      enter();
    } else if (--rem_tile == 0) {
      next_tile();
    } else {
      p += step;
    }
  }
};

// Thread 0 spins until *p >= want (acquire, device scope), then the block
// meets.  Bounded like dl::wait: a count still short after kWaitNs records
// (rank, tile[id], seen, want) and traps.
__device__ __forceinline__ void wait_at_least(const dl::Rank& c, const int* p, int want, int id) {
  if (threadIdx.x == 0) {
    int seen = dl::ld_acquire<dl::kGpu>(p);
    if (seen < want) {
      const unsigned long long t0 = dl::globaltimer();
      while ((seen = dl::ld_acquire<dl::kGpu>(p)) < want) {
        if (dl::globaltimer() - t0 > dl::kWaitNs) dl::timed_out(c, dl::kTileId + id, seen, want);
        __nanosleep(32);
      }
    }
  }
  __syncthreads();
}

// The block takes a ticket of `ctr` once every thread's writes are done;
// true (in every thread) for the block that completes a round of `count`
// tickets.  Only thread 0 fences (the block barrier before it makes the
// fence cover the other threads' writes), so the other threads' weight
// loads in flight are not drained.
__device__ __forceinline__ bool arrive_last(Smem& sm, int* ctr, int count) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = (atomicAdd(ctr, 1) + 1) % count == 0;
    if (last) __threadfence();
    sm.last = last;
  }
  __syncthreads();
  const bool last = sm.last;
  return last;
}

template <int G>
struct Step {
  const StreamArgs& a;
  const dl::Rank& c;
  Smem& sm;
  Feed<G>& f;
  int slot_c;  // the ring slot of the next pass read
  int r, n, hq, slot;
  int cur_layer;

  // this rank's regions and counters
  __device__ __forceinline__ bf16* X() const { return region<bf16>(a, slot, kX); }
  __device__ __forceinline__ bf16* ATT() const { return region<bf16>(a, slot, kAtt); }
  __device__ __forceinline__ bf16* ACT() const { return region<bf16>(a, slot, kAct); }
  __device__ __forceinline__ bf16* Q() const { return region<bf16>(a, slot, kQ); }
  __device__ __forceinline__ bf16* KT() const { return region<bf16>(a, slot, kKTok); }
  __device__ __forceinline__ bf16* VT() const { return region<bf16>(a, slot, kVTok); }
  __device__ __forceinline__ float* part() const { return region<float>(a, slot, kPart); }
  __device__ __forceinline__ float* st_acc() const { return region<float>(a, slot, kAcc); }
  __device__ __forceinline__ float* st_ml() const { return region<float>(a, slot, kMl); }
  __device__ __forceinline__ int* ctr() const {
    return reinterpret_cast<int*>(a.c.flags.p[slot]) + dl::kTileFlagBase;
  }

  // The next 16 bytes of this thread's weight stream (and the load that
  // refills its slot).
  __device__ __forceinline__ uint4 take() {
    cp_async_wait<kStages - 2>();
    const uint4 w = sm.ring[slot_c][threadIdx.x];
    slot_c = slot_c + 1 == kStages ? 0 : slot_c + 1;
    f.issue(&sm.ring[0][0]);
    return w;
  }

  // sm.inv[b] = 1 / rms(x[b]) (JAX rms_norm: the mean square in f32).
  __device__ void row_inv(const bf16* x) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = warp >> 1, half = a.K / 2;
    float ss = 0.f;
    if (b < a.B) {
      const bf16* xr = x + static_cast<long long>(b) * a.K + (warp & 1) * half;
      for (int k0 = lane * 8; k0 < half; k0 += 4 * 256) {
        uint4 raw[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          raw[u] = k0 + u * 256 < half
                       ? __ldcg(reinterpret_cast<const uint4*>(xr + k0 + u * 256))
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float v[8];
          unpack16(raw[u], v, bf16());
#pragma unroll
          for (int e = 0; e < 8; ++e) ss = fmaf(v[e], v[e], ss);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFullMask, ss, o);
    if (lane == 0) sm.ss[warp] = ss;
    __syncthreads();
    if (threadIdx.x < kMaxB)
      sm.inv[threadIdx.x] = rsqrtf((sm.ss[2 * threadIdx.x] + sm.ss[2 * threadIdx.x + 1]) / a.K +
                                   a.rms_eps);
    __syncthreads();
  }

  // Rows k0..k0 + 7 of A's four rows (8 bf16 of each in r[b]) into sm.a in
  // its [k][b] layout: 64 contiguous bytes, four 16-byte stores.
  __device__ __forceinline__ static void put_unit(bf16* dst, const uint4* r) {
    const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&r[0]);
    const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&r[1]);
    const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&r[2]);
    const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&r[3]);
    uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int j = 0; j < 4; ++j)  // rows k0 + 2j and k0 + 2j + 1
      out[j] = make_uint4(__byte_perm(w0[j], w1[j], 0x5410), __byte_perm(w2[j], w3[j], 0x5410),
                          __byte_perm(w0[j], w1[j], 0x7632), __byte_perm(w2[j], w3[j], 0x7632));
  }

  // A (B rows, row stride lda) of product s: x (qkv, gate/up), the attention
  // output (o) or the activation (down).
  __device__ __forceinline__ const bf16* a_src(int s, int& lda) const {
    if (s == kQkv || s == kGu) {
      lda = a.K;
      return X();
    }
    lda = s == kO ? hq * kD : a.F;
    return s == kO ? ATT() : ACT();
  }

  // A's rows [w0, w1) of product s into sm.a from row `dst` on (w0, w1, dst
  // multiples of 8), bf16; qkv and gate/up normed (x * inv * w, rounded, JAX
  // rms_norm, sm.inv from row_inv); rows past B zero.  A thread takes 8 rows
  // of all four of A's rows: four 16-byte loads, four 16-byte stores.
  __device__ void stage_a(int l, int s, int w0, int w1, int dst = 0) {
    int lda;
    const bf16* src = a_src(s, lda);
    const bf16* nw = s == kQkv || s == kGu ? weight(a, l, s == kQkv ? kLn1 : kLn2, 0) : nullptr;
    for (int k = w0 + threadIdx.x * 8; k < w1; k += kThreads * 8) {
      uint4 r[kMaxB];
#pragma unroll
      for (int b = 0; b < kMaxB; ++b)
        r[b] = b < a.B ? __ldcg(reinterpret_cast<const uint4*>(
                             src + static_cast<long long>(b) * lda + k))
                       : make_uint4(0u, 0u, 0u, 0u);
      if (nw != nullptr) {
        float wv[8];
        unpack16(__ldg(reinterpret_cast<const uint4*>(nw + k)), wv, bf16());
#pragma unroll
        for (int b = 0; b < kMaxB; ++b) {
          bf16* v = reinterpret_cast<bf16*>(&r[b]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = __float2bfloat16_rn(b < a.B ? rnd(bf(v[e]) * sm.inv[b] * wv[e]) : 0.f);
        }
      }
      put_unit(&sm.a[(dst + k - w0) * kMaxB], r);
    }
  }

  // One product stage: this lane's run of passes, a segment per tile; each
  // segment's sums go to the tile's epilogue, through the partials when
  // the tile is cut between lanes.  The rows of A of every segment of the
  // run are staged before the first pass when they fit in sm.a (so no
  // staging, and no gap in the weight stream, between segments), else a
  // segment's at a time, at most kWin rows at once.
  __device__ void product(int l, int s, int mark) {
    const Geo g = geo<G>(a, l, s, r);
    const int P = g.tiles * g.ppt;
    const int row = threadIdx.x / kLanesPerRow;
    const bool upfront = (g.q1 - g.q0) * kRowsPerPass <= kWin;
    TDT_STAMP(l, mark + 1);  // (a lane without passes stamps its three marks here)
    if (s == kQkv || s == kGu) row_inv(X());
    if (upfront) {
      __syncthreads();  // sm.a's last readers are done
      for (int q = g.q0, at = 0; q < g.q1;) {
        const int t0 = q / g.ppt * g.ppt, qe = min(g.q1, t0 + g.ppt);
        stage_a(l, s, (q - t0) * kRowsPerPass, (qe - t0) * kRowsPerPass, at);
        at += (qe - q) * kRowsPerPass;
        q = qe;
      }
      __syncthreads();
    }
    TDT_STAMP(l, mark);
    int at = 0;  // the segment's first row in sm.a (upfront)
    for (int q = g.q0; q < g.q1;) {
      const int tile = q / g.ppt, t0 = tile * g.ppt, qe = min(g.q1, t0 + g.ppt);
      float acc[kMaxB][8];
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[bb][e] = 0.f;
      for (int k0 = (q - t0) * kRowsPerPass, k1 = (qe - t0) * kRowsPerPass; k0 < k1;) {
        const int w0 = k0, w1 = upfront ? k1 : min(k1, w0 + kWin);
        if (!upfront) {
          __syncthreads();  // the last window's readers are done
          stage_a(l, s, w0, w1);
          __syncthreads();
        }
        const bf16* sa = sm.a + ((upfront ? at : 0) - w0) * kMaxB;
        for (int k = k0 + row; k < w1; k += kRowsPerPass) {
          const uint4 wr = take();
          const uint2 av = *reinterpret_cast<const uint2*>(sa + k * kMaxB);
          float x[kMaxB], wf[8];
          x[0] = __uint_as_float(av.x << 16);
          x[1] = __uint_as_float(av.x & 0xffff0000u);
          x[2] = __uint_as_float(av.y << 16);
          x[3] = __uint_as_float(av.y & 0xffff0000u);
          unpack16(wr, wf, bf16());
#pragma unroll
          for (int bb = 0; bb < kMaxB; ++bb)
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[bb][e] = fmaf(x[bb], wf[e], acc[bb][e]);
        }
        k0 = w1;
      }
      if (qe == g.q1) TDT_STAMP(l, mark + 1);
      // the two rows of a warp, then the warps: thread t ends with row t / 64's
      // columns t % 64 and t % 64 + 64 of the tile
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
      for (int bb = 0; bb < kMaxB; ++bb)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[bb][e] += __shfl_xor_sync(kFullMask, acc[bb][e], 16);
      if (lane < kLanesPerRow) {
#pragma unroll
        for (int bb = 0; bb < kMaxB; ++bb)
#pragma unroll
          for (int e = 0; e < 8; ++e) sm.red[warp][bb][lane * 8 + e] = acc[bb][e];
      }
      __syncthreads();
      const int b = threadIdx.x >> 6, cc = threadIdx.x & 63;
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        v0 += sm.red[w][b][cc];
        v1 += sm.red[w][b][cc + 64];
      }
      __syncthreads();  // sm.red is free for the next segment
      // the lanes whose runs hold the tile's passes: [l0, l1] less the empty
      // runs, which exist only when the passes are fewer than the lanes (then
      // every other run is one pass)
      const int l0 = lane_of(t0, P), l1 = lane_of(t0 + g.ppt - 1, P);
      const int holders = P >= static_cast<int>(gridDim.x) ? l1 - l0 + 1 : g.ppt;
      bool mine = true;
      if (holders > 1) {
        float* pt = part();
        float* pp = pt + (static_cast<long long>(tile + blockIdx.x) * kMaxB + b) * kD;
        pp[cc] = v0;
        pp[cc + 64] = v1;
        mine = arrive_last(sm, ctr() + kTicket + s * kTicketStride + tile, holders);
        if (mine) {
          v0 = v1 = 0.f;
          for (int j0 = l0; j0 <= l1; j0 += 4) {
            float t0[4], t1[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = j0 + u;
              // past l1, or an empty run: nothing to add
              const bool held = j <= l1 && static_cast<long long>(P) * (j + 1) / gridDim.x !=
                                               static_cast<long long>(P) * j / gridDim.x;
              const float* pj = pt + (static_cast<long long>(tile + j) * kMaxB + b) * kD;
              t0[u] = held ? __ldcg(pj + cc) : 0.f;
              t1[u] = held ? __ldcg(pj + cc + 64) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (j0 + u > l1) break;
              v0 += t0[u];
              v1 += t1[u];
            }
          }
        }
      }
      if (mine) epilogue(l, s, tile, b, cc, v0, v1);
      at += (qe - q) * kRowsPerPass;
      q = qe;
    }
  }

  __device__ void epilogue(int l, int s, int tile, int b, int cc, float v0, float v1) {
    if (s == kQkv) return qkv_tile(tile, b, cc, v0, v1);
    if (s == kGu) {
      if (b < a.B) {
        const float gv = rnd(v0), uv = rnd(v1);
        ACT()[static_cast<long long>(b) * a.F + tile * 64 + cc] =
            __float2bfloat16_rn(gv / (1.f + expf(-gv)) * uv);
      }
      return;
    }
    // o and down: the residual add, through the one-shot exchange at n > 1
    const long long x0 = static_cast<long long>(b) * a.K + tile * kD + cc;
    if (n == 1) {
      if (b < a.B) {
        X()[x0] = __float2bfloat16_rn(ldcg_bf(X() + x0) + rnd(v0));
        X()[x0 + 64] = __float2bfloat16_rn(ldcg_bf(X() + x0 + 64) + rnd(v1));
      }
      return;
    }
    const int inst = 2 * l + (s == kDn), par = inst & 1;
    const long long slot_elems = static_cast<long long>(a.B) * a.K;
    if (b < a.B) {
      const bf16 p0 = __float2bfloat16_rn(v0), p1 = __float2bfloat16_rn(v1);
      for (int p = 0; p < n; ++p) {
        bf16* land = region<bf16>(a, c.slot(p), kLand) + (par * n + r) * slot_elems + x0;
        land[0] = p0;
        land[64] = p1;
      }
    }
    __syncthreads();
    if (threadIdx.x < n && r != a.c.stall_rank)
      dl::red_release_add<dl::kGpu>(
          reinterpret_cast<int*>(a.c.flags.p[c.slot(threadIdx.x)]) + dl::kTileFlagBase + kArrive +
              tile, 1);
    wait_at_least(c, ctr() + kArrive + tile, n * (inst + 1), kArrive + tile);
    if (b < a.B) {
      const bf16* land = region<bf16>(a, c.slot(r), kLand) + par * n * slot_elems + x0;
      float s0 = 0.f, s1 = 0.f;
      for (int p = 0; p < n; ++p) {
        s0 += ldcg_bf(land + p * slot_elems);
        s1 += ldcg_bf(land + p * slot_elems + 64);
      }
      X()[x0] = __float2bfloat16_rn(ldcg_bf(X() + x0) + rnd(s0));
      X()[x0 + 64] = __float2bfloat16_rn(ldcg_bf(X() + x0 + 64) + rnd(s1));
    }
  }

  __device__ __forceinline__ float ldcg_bf(const bf16* p) {
    return __bfloat162float(
        __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
  }

  // One head's 128 columns for every sequence (K4's finalize_tile): rounded;
  // q and k normed (qk-RMSNorm) and rotated (RoPE at the sequence's
  // position); q into Q, k and v into the token buffers and appended in place
  // at (table[b, min(pos / ps, mp - 1)], pos % ps); then the kv head's count
  // of finished tiles goes up.
  __device__ void qkv_tile(int tile, int b, int cc, float v0, float v1) {
    const int kvh = tile < hq ? tile / G : (tile < hq + a.hk ? tile - hq : tile - hq - a.hk);
    const bool is_v = tile >= hq + a.hk;
    float x0 = rnd(v0), x1 = rnd(v1);
    const int warp = threadIdx.x >> 5;
    const bool live = b < a.B;
    // every load the epilogue needs, issued together
    const int pos = live ? __ldg(a.lens + r * a.B + b) : 0;
    const float freq = __ldg(a.inv_freq + cc);
    float nw0 = 1.f, nw1 = 1.f;
    if (a.qk_norm && !is_v) {
      const bf16* nw = weight(a, cur_layer, tile < hq ? kQNorm : kKNorm, 0);
      nw0 = bf(nw[cc]);
      nw1 = bf(nw[cc + 64]);
    }
    int page = 0;
    if (live && tile >= hq)
      page = __ldg(a.table + (static_cast<long long>(r) * a.B + b) * a.mp +
                   min(pos / a.ps, a.mp - 1));
    if (!is_v) {
      if (a.qk_norm) {
        float ss = x0 * x0 + x1 * x1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFullMask, ss, o);
        __syncthreads();  // sm.ss's last readers are done
        if ((threadIdx.x & 31) == 0) sm.ss[warp] = ss;
        __syncthreads();
        const float inv = rsqrtf((sm.ss[2 * b] + sm.ss[2 * b + 1]) / kD + a.qk_eps);
        x0 = rnd(x0 * inv * nw0);
        x1 = rnd(x1 * inv * nw1);
      }
      const float ang = static_cast<float>(pos) * freq;
      const float cs = cosf(ang), sn = sinf(ang);
      const float y0 = rnd(x0 * cs - x1 * sn), y1 = rnd(x1 * cs + x0 * sn);
      x0 = y0;
      x1 = y1;
    }
    if (live) {
      if (tile < hq) {
        bf16* qb = Q() + (static_cast<long long>(b) * hq + tile) * kD;
        qb[cc] = __float2bfloat16_rn(x0);
        qb[cc + 64] = __float2bfloat16_rn(x1);
      } else {
        bf16* tok = (is_v ? VT() : KT()) + (static_cast<long long>(b) * a.hk + kvh) * kD;
        tok[cc] = __float2bfloat16_rn(x0);
        tok[cc + 64] = __float2bfloat16_rn(x1);
        bf16* pool = static_cast<bf16*>(is_v ? a.pool_v : a.pool_k) +
                     cur_layer * a.layer_pool_elems +
                     ((static_cast<long long>(page) * a.hk + kvh) * a.ps + pos % a.ps) * kD;
        pool[cc] = __float2bfloat16_rn(x0);
        pool[cc + 64] = __float2bfloat16_rn(x1);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) dl::red_release_add<dl::kGpu>(ctr() + kReady + kvh, 1);
  }

  // The unnormalized state (acc, m, l) of positions [start, end) of one
  // (sequence, kv head) for its G query heads (decode_split.cuh
  // split_state_to, for this block's 8 warps): q scaled in f32 and rounded,
  // p rounded before it meets V.
  __device__ void split_state(const bf16* q, const bf16* pk, const bf16* pv, const int* table,
                              int head, int start, int end, float* acc_out, float* ml_out) {
    constexpr int E = 8, LPR = kD / E, RPW = 32 / LPR, NG = kWarps * RPW, R = 2;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int sub = lane % LPR, grp = warp * RPW + lane / LPR;
    // the G scaled queries in shared memory (after the first kD floats of
    // the per-warp (m, l) below), read a head at a time
    float* s_q = &sm.red[0][0][0] + kWarps * kD;
    __syncthreads();  // the shared regions' last readers are done
    for (int i = tid; i < G * kD; i += kThreads)
      s_q[i] = rnd(__bfloat162float(__ushort_as_bfloat16(
                       __ldcg(reinterpret_cast<const unsigned short*>(q + i)))) *
                   a.sm_scale);
    __syncthreads();
    float m[G], l[G], acc[G][E];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      m[h] = kNegInf;
      l[h] = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
    }
    for (int base = start; base < end; base += NG * R) {
      uint4 kr[R], vr[R];
      bool valid[R];
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int pos = base + rr * NG + grp;
        valid[rr] = pos < end;
        kr[rr] = vr[rr] = make_uint4(0u, 0u, 0u, 0u);
        if (valid[rr]) {
          const int page = table[pos / a.ps];
          const size_t row = (static_cast<size_t>(page) * a.hk + head) * a.ps + pos % a.ps;
          kr[rr] = *reinterpret_cast<const uint4*>(pk + row * kD + sub * E);
          vr[rr] = *reinterpret_cast<const uint4*>(pv + row * kD + sub * E);
        }
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float qv[E], sc[R];
        *reinterpret_cast<float4*>(qv) = *reinterpret_cast<const float4*>(s_q + h * kD + sub * E);
        *reinterpret_cast<float4*>(qv + 4) =
            *reinterpret_cast<const float4*>(s_q + h * kD + sub * E + 4);
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          float kf[E];
          unpack16(kr[rr], kf, bf16());
          sc[rr] = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) sc[rr] = fmaf(qv[e], kf[e], sc[rr]);
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) sc[rr] += __shfl_xor_sync(kFullMask, sc[rr], o);
        }
        float mn = m[h];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          if (a.soft_cap > 0.f) sc[rr] = tanhf(sc[rr] / a.soft_cap) * a.soft_cap;
          if (valid[rr]) mn = fmaxf(mn, sc[rr]);
        }
        const float alpha = expf(m[h] - mn);
        l[h] *= alpha;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          if (!valid[rr]) continue;
          const float p = expf(sc[rr] - mn);
          const float pr = rnd(p);
          l[h] += p;
          float vf[E];
          unpack16(vr[rr], vf, bf16());
#pragma unroll
          for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);
        }
        m[h] = mn;
      }
    }
    // the row groups of a warp, then the warps
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float mo = __shfl_xor_sync(kFullMask, m[h], o);
        const float lo = __shfl_xor_sync(kFullMask, l[h], o);
        const float mn = fmaxf(m[h], mo);
        const float x = expf(m[h] - mn), y = expf(mo - mn);
        l[h] = l[h] * x + lo * y;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ao = __shfl_xor_sync(kFullMask, acc[h][e], o);
          acc[h][e] = acc[h][e] * x + ao * y;
        }
        m[h] = mn;
      }
    }
    float* s_acc = reinterpret_cast<float*>(sm.a);          // [kWarps][G][kD]
    float* s_m = &sm.red[0][0][0];                          // [kWarps][G]
    float* s_l = s_m + kWarps * G;
    if (lane < LPR) {
#pragma unroll
      for (int h = 0; h < G; ++h) {
#pragma unroll
        for (int e = 0; e < E; ++e) s_acc[(warp * G + h) * kD + sub * E + e] = acc[h][e];
        if (lane == 0) {
          s_m[warp * G + h] = m[h];
          s_l[warp * G + h] = l[h];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * kD; i += kThreads) {
      const int h = i / kD, d = i % kD;
      float mn = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, s_m[w * G + h]);
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        num += s_acc[(w * G + h) * kD + d] * expf(s_m[w * G + h] - mn);
      acc_out[h * kD + d] = num;
      if (d == 0) {
        float den = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) den += s_l[w * G + h] * expf(s_m[w * G + h] - mn);
        ml_out[h * 2] = mn;
        ml_out[h * 2 + 1] = den;
      }
    }
  }

  // The last split of (b, h) merges the splits' states, folds in the new
  // token and writes the G normalized outputs (K4's combine_fold).
  __device__ void fold(int b, int h, int pair) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ns = a.n_split;
    const float* pacc = st_acc() + static_cast<long long>(pair) * ns * G * kD;
    const float* pml = st_ml() + static_cast<long long>(pair) * ns * G * 2;
    const bf16* q = Q() + (static_cast<long long>(b) * hq + h * G) * kD;
    const bf16* kt = KT() + (static_cast<long long>(b) * a.hk + h) * kD;
    const bf16* vt = VT() + (static_cast<long long>(b) * a.hk + h) * kD;
    for (int g = warp; g < G; g += kWarps) {
      // lane s holds split s's (m, l) (n_split <= 32)
      const float ms = lane < ns ? __ldcg(pml + (lane * G + g) * 2) : kNegInf;
      const float ls = lane < ns ? __ldcg(pml + (lane * G + g) * 2 + 1) : 0.f;
      float mn = ms;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mn = fmaxf(mn, __shfl_xor_sync(kFullMask, mn, o));
      const float w = lane < ns ? expf(ms - mn) : 0.f;
      float den = ls * w;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(kFullMask, den, o);
      sm.wgt[g][lane] = w;
      float sc = 0.f;
      for (int d = lane; d < kD; d += 32)
        sc = fmaf(rnd(ldcg_bf(q + g * kD + d) * a.sm_scale), ldcg_bf(kt + d), sc);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sc += __shfl_xor_sync(kFullMask, sc, o);
      if (a.soft_cap > 0.f) sc = tanhf(sc / a.soft_cap) * a.soft_cap;
      const float m_cur = fmaxf(mn, sc);
      const float p = expf(sc - m_cur), alpha = expf(mn - m_cur);
      if (lane == 0) {
        sm.alpha[g] = alpha;
        sm.pr[g] = rnd(p);
        sm.den[g] = den * alpha + p;
      }
    }
    __syncthreads();
    bf16* out = ATT() + (static_cast<long long>(b) * hq + h * G) * kD;
    for (int i = threadIdx.x; i < G * kD; i += kThreads) {
      const int g = i / kD, d = i % kD;
      float num = 0.f;
      for (int s0 = 0; s0 < ns; s0 += 8) {
        float t[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          t[u] = s0 + u < ns ? __ldcg(pacc + ((s0 + u) * G + g) * kD + d) : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (s0 + u < ns) num += t[u] * sm.wgt[g][s0 + u];
      }
      const float v = num * sm.alpha[g] + sm.pr[g] * ldcg_bf(vt + d);
      out[i] = __float2bfloat16_rn(sm.den[g] > 0.f ? v / sm.den[g] : 0.f);
    }
  }

  // The attention cell of layer l: (sequence, kv head, split) items dealt to
  // the lanes in turn; each waits for its kv head's G + 2 qkv tiles of this
  // layer, reads its split of the prefix [0, pos) (the splits are cut from
  // the length, on the card), and the last split to arrive folds.
  __device__ void attention(int l, int mark) {
    const int ns = a.n_split, pairs = a.B * a.hk, capacity = a.mp * a.ps;
    TDT_STAMP(l, mark);
    TDT_STAMP(l, mark + 1);
    const bf16* pk = static_cast<const bf16*>(a.pool_k) + l * a.layer_pool_elems;
    const bf16* pv = static_cast<const bf16*>(a.pool_v) + l * a.layer_pool_elems;
    for (int it = blockIdx.x; it < pairs * ns; it += gridDim.x) {
      const int pair = it / ns, split = it % ns, b = pair / a.hk, h = pair % a.hk;
      const int len = min(max(__ldg(a.lens + r * a.B + b), 0), capacity);
      const int chunk = ((len + ns - 1) / ns + 15) / 16 * 16;
      const int start = min(len, split * chunk), end = min(len, start + chunk);
      const int* table = a.table + (static_cast<long long>(r) * a.B + b) * a.mp;
      // the split's K and V rows into L2 while the kv head's qkv tiles finish
      for (int i = threadIdx.x; i < (end - start) * 4; i += kThreads) {
        const int pos = start + (i >> 2);
        const size_t row =
            (static_cast<size_t>(__ldg(table + pos / a.ps)) * a.hk + h) * a.ps + pos % a.ps;
        const bf16* line = ((i & 2) ? pv : pk) + row * kD + (i & 1) * 64;
        asm volatile("prefetch.global.L2 [%0];" ::"l"(line));
      }
      wait_at_least(c, ctr() + kReady + h, (l + 1) * (G + 2), kReady + h);
      if (it == static_cast<int>(blockIdx.x)) TDT_STAMP(l, mark);
      const long long state = static_cast<long long>(pair) * ns + split;
      split_state(Q() + (static_cast<long long>(b) * hq + h * G) * kD, pk, pv, table, h, start,
                  end, st_acc() + state * G * kD, st_ml() + state * G * 2);
      TDT_STAMP(l, mark + 1);
      if (arrive_last(sm, ctr() + kSplitTicket + pair, ns)) fold(b, h, pair);
    }
  }
};

template <int G>
__global__ void __launch_bounds__(kThreads, 2) stream_decode_kernel(
    const __grid_constant__ StreamArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const dl::Rank c(a.c);
  const int r = c.me, slot = c.slot(r);
  Feed<G> f(a, r);
  for (int i = 0; i < kStages - 1; ++i) f.issue(&sm.ring[0][0]);
  Step<G> st{a, c, sm, f, 0, r, c.n(), a.hk * G, slot, 0};
  const long long total = static_cast<long long>(a.B) * a.K;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  {
    const bf16* xin = static_cast<const bf16*>(a.x_in);
    for (long long e = blockIdx.x * kThreads + threadIdx.x; e < total; e += stride)
      st.X()[e] = xin[e];
  }
  int gen = 0;
  dl::rank_sync(c, gen);
  // the marks of a layer (csrc/stamps.cuh, scripts/torch_persistent_stamps.py):
  // 0 start; per product its A staged, its last pass read and its epilogue
  // done (qkv 1-3, o 8-10, gate/up 12-14, down 16-18); the attention's
  // first wait done (4), its last split (5) and its end (6); the releases of
  // the four barriers (7, 11, 15, 19)
  for (int l = 0; l < a.L; ++l) {
    st.cur_layer = l;
    TDT_STAMP(l, 0);
    st.product(l, kQkv, 1);
    TDT_STAMP(l, 3);
    st.attention(l, 4);
    TDT_STAMP(l, 6);
    dl::rank_sync(c, gen);
    TDT_STAMP(l, 7);
    st.product(l, kO, 8);
    TDT_STAMP(l, 10);
    dl::rank_sync(c, gen);
    TDT_STAMP(l, 11);
    st.product(l, kGu, 12);
    TDT_STAMP(l, 14);
    dl::rank_sync(c, gen);
    TDT_STAMP(l, 15);
    st.product(l, kDn, 16);
    TDT_STAMP(l, 18);
    dl::rank_sync(c, gen);
    TDT_STAMP(l, 19);
  }
  cp_async_wait<0>();
  // rank 0's residual stream is the step's output; the counters go back to zero
  if (r == 0) {
    bf16* xo = static_cast<bf16*>(a.x_out);
    for (long long e = blockIdx.x * kThreads + threadIdx.x; e < total; e += stride)
      xo[e] = st.X()[e];
  }
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < kCounters; i += gridDim.x * kThreads)
    st.ctr()[i] = 0;
  dl::rank_sync_exit(c);
}

template <int G>
cudaError_t launch_g(StreamArgs* a, cudaStream_t st, long long* lanes) {
  const int smem = static_cast<int>(sizeof(Smem));
  if (lanes != nullptr)
    return dl::resident_lanes(stream_decode_kernel<G>, a->c.n * a->c.groups, kThreads, smem,
                              lanes);
  return dl::cooperative_launch(stream_decode_kernel<G>, a, &a->c, dl::kMaxLanes, smem, st,
                                kThreads);
}

}  // namespace pd2
}  // namespace tdt
