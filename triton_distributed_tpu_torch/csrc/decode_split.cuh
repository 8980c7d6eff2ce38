// The split-KV decode state, shared by K2/K3 and K7 (decode_attention.cu)
// and K4 (fused_decode.cu): one block of kThreads threads reads positions
// [start, end) of one (sequence, kv head) once for all G query heads of the
// group and writes their unnormalized (acc, m, l) state; merge_* below
// combine the states of the splits.
//
// K/V storage S is the query type T (f32 or bf16) or int8 codes.  int8 rows
// follow the JAX tile update (triton_distributed_tpu/ops/attention.py
// _tile_update, :76-105): the codes are exact in T, the (page, head) K scale
// multiplies the f32 score after the product, p is rounded to T, and the V
// scale multiplies p before it meets the codes.  Scales are read per row at
// `scale[table[b, pos / page_size] * Hkv + h]`.
//
// Each lane group of D / E lanes holds one row; a group takes R rows per
// step and issues all 2R of its K/V loads before it uses any, so they are in
// flight together, and the softmax state is rescaled once per step.
#pragma once

#include "common.cuh"

namespace tdt {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// q: the (G, D) queries of this (sequence, kv head), not yet scaled (they are
// scaled in f32 and rounded to T here, the JAX `_scaled_q`).  Paged: `table`
// is this sequence's row of the block table and `head` the kv head; else
// `table` is null and `head` the (batch * Hkv + kv head) row block of a
// contiguous (B, Hkv, capacity, D) cache.  k_scale/v_scale: (P * Hkv) f32
// for int8 codes, else null.  Head h of the group receives its state at
// acc_out[h * acc_stride + (0..D)], m_out[h * ml_stride] and
// l_out[h * ml_stride]; an empty range gives m = kNegInf, l = 0, acc = 0,
// exactly.
template <typename T, typename S, int D, int G, bool PAGED>
__device__ __forceinline__ void split_state_to(
    const T* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ table, int head, int Hkv, int capacity,
    int page_size, int start, int end, float sm_scale, float soft_cap,
    float* __restrict__ acc_out, int acc_stride, float* __restrict__ m_out,
    float* __restrict__ l_out, int ml_stride) {
  constexpr bool QUANT = sizeof(S) == 1;
  typedef typename KVLoad<S>::Raw Raw;
  constexpr int E = KVLoad<S>::E;  // elements per lane load
  constexpr int LPR = D / E;       // lanes per kv row
  constexpr int RPW = 32 / LPR;    // row groups per warp
  constexpr int NG = kWarps * RPW; // row groups in the block
  constexpr int R = 4;             // rows per row group per step
  static_assert(LPR >= 1 && LPR <= 32 && 32 % LPR == 0, "unsupported head dim");

  __shared__ float s_acc[kWarps][G][D];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane % LPR;               // slice of the row
  const int grp = warp * RPW + lane / LPR;  // row group in the block

  float qv[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    load_cg<T, E>(q + h * D + sub * E, qv[h]);
#pragma unroll
    for (int e = 0; e < E; ++e) qv[h][e] = round_to<T>(qv[h][e] * sm_scale);
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[h][e] = 0.f;
  }

  // The trip count is warp-uniform, so every lane of a warp runs every
  // shuffle.
  for (int base = start; base < end; base += NG * R) {
    Raw kraw[R], vraw[R];
    float ks[R], vs[R];
    bool valid[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pos = base + r * NG + grp;
      valid[r] = pos < end;
      kraw[r] = vraw[r] = Raw();
      ks[r] = vs[r] = 1.f;
      if (valid[r]) {
        size_t row;
        if (PAGED) {
          const int page = table[pos / page_size];
          row = (static_cast<size_t>(page) * Hkv + head) * page_size + pos % page_size;
          if (QUANT) {
            ks[r] = __ldg(k_scale + static_cast<size_t>(page) * Hkv + head);
            vs[r] = __ldg(v_scale + static_cast<size_t>(page) * Hkv + head);
          }
        } else {
          row = static_cast<size_t>(head) * capacity + pos;
        }
        kraw[r] = *reinterpret_cast<const Raw*>(k + row * D + sub * E);
        vraw[r] = *reinterpret_cast<const Raw*>(v + row * D + sub * E);
      }
    }
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float kf[E];
        unpack16(kraw[r], kf, S());
        s[r] = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s[r] = fmaf(qv[h][e], kf[e], s[r]);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) s[r] += __shfl_xor_sync(kFullMask, s[r], off);
        if (QUANT) s[r] *= ks[r];
      }
      float mn = m[h];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (soft_cap > 0.f) s[r] = tanhf(s[r] / soft_cap) * soft_cap;
        if (valid[r]) mn = fmaxf(mn, s[r]);
      }
      const float alpha = expf(m[h] - mn);
      l[h] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!valid[r]) continue;
        const float p = expf(s[r] - mn);
        const float pr = round_to<T>(p) * vs[r];
        l[h] += p;
        float vf[E];
        unpack16(vraw[r], vf, S());
#pragma unroll
        for (int e = 0; e < E; ++e) acc[h][e] = fmaf(pr, vf[e], acc[h][e]);
      }
      m[h] = mn;
    }
  }

  // merge the row groups of the warp (same d slice, different rows)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float mo = __shfl_xor_sync(kFullMask, m[h], off);
      const float lo = __shfl_xor_sync(kFullMask, l[h], off);
      const float mn = fmaxf(m[h], mo);
      const float a = expf(m[h] - mn), c = expf(mo - mn);
      l[h] = l[h] * a + lo * c;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(kFullMask, acc[h][e], off);
        acc[h][e] = acc[h][e] * a + ao * c;
      }
      m[h] = mn;
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
#pragma unroll
      for (int e = 0; e < E; ++e) s_acc[warp][h][sub * E + e] = acc[h][e];
      if (lane == 0) {
        s_m[warp][h] = m[h];
        s_l[warp][h] = l[h];
      }
    }
  }
  __syncthreads();

  // merge the warps and write the state
  for (int i = tid; i < G * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mn = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, s_m[w][h]);
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num += s_acc[w][h][d] * expf(s_m[w][h] - mn);
    acc_out[h * acc_stride + d] = num;
    if (d == 0) {
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) den += s_l[w][h] * expf(s_m[w][h] - mn);
      m_out[h * ml_stride] = mn;
      l_out[h * ml_stride] = den;
    }
  }
  __syncthreads();  // the shared state may be reused by the caller
}

// split_state_to with the state of the G heads packed: acc_out (G, D) and
// ml_out (G, 2) = (m, l), the layout the merge below reads.
template <typename T, typename S, int D, int G, bool PAGED>
__device__ __forceinline__ void split_state(
    const T* __restrict__ q, const S* __restrict__ k, const S* __restrict__ v,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* __restrict__ table, int head, int Hkv, int capacity,
    int page_size, int start, int end, float sm_scale, float soft_cap,
    float* __restrict__ acc_out, float* __restrict__ ml_out) {
  split_state_to<T, S, D, G, PAGED>(q, k, v, k_scale, v_scale, table, head,
                                    Hkv, capacity, page_size, start, end,
                                    sm_scale, soft_cap, acc_out, D, ml_out,
                                    ml_out + 1, 2);
}

// The merged (m, l) of query head `h` of G over the n_split states starting
// at state `first` (each state holds (G, 2) floats).
__device__ __forceinline__ void merge_ml(const float* __restrict__ part_ml,
                                         size_t first, int n_split, int G,
                                         int h, float& mn, float& den) {
  mn = kNegInf;
  for (int s = 0; s < n_split; ++s)
    mn = fmaxf(mn, __ldcg(part_ml + ((first + s) * G + h) * 2));
  den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + ((first + s) * G + h) * 2;
    den += __ldcg(ml + 1) * expf(__ldcg(ml) - mn);
  }
}

// The merged accumulator of element d of query head h, given the merged m.
__device__ __forceinline__ float merge_acc(const float* __restrict__ part_acc,
                                           const float* __restrict__ part_ml,
                                           size_t first, int n_split, int G,
                                           int D, int h, int d, float mn) {
  float num = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t st = (first + s) * G + h;
    num += __ldcg(part_acc + st * D + d) * expf(__ldcg(part_ml + st * 2) - mn);
  }
  return num;
}

}  // namespace tdt
