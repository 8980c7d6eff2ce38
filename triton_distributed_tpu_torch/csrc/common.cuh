// Shared device helpers for the attention kernels of triton_distributed_tpu_torch.
//
// Storage types are float and __nv_bfloat16; all softmax state and every
// accumulator is float.  Conversions go through the intrinsics only, so the
// sources also build under -D__CUDA_NO_BFLOAT16_CONVERSIONS__.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

// The JAX kernels' "minus infinity": finite, so exp(kNegInf - m) is 0 for any
// finite m and a fully masked row never produces inf - inf = NaN.
constexpr float kNegInf = -1e30f;
constexpr unsigned kFullMask = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float to the storage type and back: the points where the JAX
// kernels cast (scaled q before the q.k dot, p before the p.v dot).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 16 bytes of storage, widened to 16 / sizeof(T) floats.
__device__ __forceinline__ void unpack16(const uint4& u, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}

__device__ __forceinline__ void unpack16(const uint4& u, float* out, bf16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 bytes of int8 codes, widened to 8 floats (exactly).
__device__ __forceinline__ void unpack16(const uint2& u, float* out, int8_t) {
  const char4 a = *reinterpret_cast<const char4*>(&u.x);
  const char4 b = *reinterpret_cast<const char4*>(&u.y);
  out[0] = static_cast<float>(a.x);
  out[1] = static_cast<float>(a.y);
  out[2] = static_cast<float>(a.z);
  out[3] = static_cast<float>(a.w);
  out[4] = static_cast<float>(b.x);
  out[5] = static_cast<float>(b.y);
  out[6] = static_cast<float>(b.z);
  out[7] = static_cast<float>(b.w);
}

// How a KV row of storage type S is read: E elements per lane and per load,
// as one `Raw` vector (16 bytes of f32 or bf16, 8 bytes of int8 codes).
template <typename S> struct KVLoad;
template <> struct KVLoad<float> { static constexpr int E = 4; typedef uint4 Raw; };
template <> struct KVLoad<bf16> { static constexpr int E = 8; typedef uint4 Raw; };
template <> struct KVLoad<int8_t> { static constexpr int E = 8; typedef uint2 Raw; };

// N consecutive elements of T from 16-byte aligned `p`, widened to float,
// through L2 only (`ld.global.cg`): the values may have been written by
// another block of the same kernel, after a fence.
template <typename T, int N>
__device__ __forceinline__ void load_cg(const T* __restrict__ p, float* out) {
  constexpr int PER = 16 / sizeof(T);
  static_assert(N % PER == 0, "load_cg reads whole 16-byte vectors");
#pragma unroll
  for (int i = 0; i < N / PER; ++i)
    unpack16(__ldcg(reinterpret_cast<const uint4*>(p) + i), out + i * PER, T());
}

}  // namespace tdt
