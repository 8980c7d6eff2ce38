// K18: the quantized wire pack on Hopper (sm_90a).
//
// Replaces triton_distributed_tpu/lang/quant.py _pack_kernel (:145),
// pallas_call :174: each row of H values (f32 or bf16) becomes H + 128
// bytes, H payload codes (e4m3 or int8) and then the row's f32 scale,
// little-endian, in bytes H..H+3, zeros to H + 128.  The recipe is the plain
// version's (lang/quant.py pack_rows_ref, JAX's _pack_rows_xla) bit for bit:
// absmax in f32; scale = absmax / qmax + eps, both IEEE (__fdiv_rn,
// __fadd_rn; no fast math in core/build.py's flags); each code x / scale
// (__fdiv_rn), then e4m3 by round to nearest even with saturation to +-448
// (the quotient never passes 448), or int8 by rintf and a clamp to +-127.
// The Pallas kernel took the scale as absmax * (1 / 448), one ulp off the
// IEEE quotient in most rows; the port follows the XLA producer.
//
// Bound: bytes (one read of the rows, one write of the message; a few
// operations an element).  One warp a row, eight rows a block: each lane
// reads 16-byte vectors (8 bf16 or 2 x 4 f32), the warp reduces the absmax
// with shuffles, then re-reads its vectors (from L1/L2) to write 8 codes
// a store; the sidecar is one 4-byte word a lane.  H must be a multiple of
// 16 (the wrapper raises otherwise).
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace tdt {
namespace {

constexpr int kSidecar = 128;
constexpr int kRowsPerBlock = 8;   // one warp a row

__device__ __forceinline__ void load8(const float* p, float* v) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), v, 0.f);
  unpack16(__ldg(reinterpret_cast<const uint4*>(p) + 1), v + 4, 0.f);
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), v, bf16());
}

template <int WIRE>
__device__ __forceinline__ uint8_t encode(float y);

template <>
__device__ __forceinline__ uint8_t encode<0>(float y) {  // int8
  const float r = fminf(fmaxf(rintf(y), -127.f), 127.f);
  return static_cast<uint8_t>(static_cast<int8_t>(r));
}

template <>
__device__ __forceinline__ uint8_t encode<1>(float y) {  // e4m3
  return static_cast<uint8_t>(__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
}

template <typename T, int WIRE>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    quant_pack_kernel(const T* __restrict__ x, uint8_t* __restrict__ out, long long rows,
                      int h, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * h;
  uint8_t* orow = out + row * static_cast<long long>(h + kSidecar);
  float amax = 0.f;
  for (int i = lane * 8; i < h; i += 32 * 8) {
    float v[8];
    load8(xr + i, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, off));
  const float qmax = WIRE == 1 ? 448.f : 127.f;
  const float scale = __fadd_rn(__fdiv_rn(amax, qmax), eps);
  for (int i = lane * 8; i < h; i += 32 * 8) {
    float v[8];
    load8(xr + i, v);
    uint2 word;
    uint8_t* b = reinterpret_cast<uint8_t*>(&word);
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = encode<WIRE>(__fdiv_rn(v[j], scale));
    *reinterpret_cast<uint2*>(orow + i) = word;
  }
  // the sidecar: the scale's bits in bytes h..h+3, zeros to h + 128
  reinterpret_cast<uint32_t*>(orow + h)[lane] = lane == 0 ? __float_as_uint(scale) : 0u;
}

template <typename T>
cudaError_t pack_as(const void* x, void* out, long long rows, int h, int wire, float eps,
                    cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const T* xt = static_cast<const T*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (wire == 1) quant_pack_kernel<T, 1><<<grid, kRowsPerBlock * 32, 0, st>>>(xt, o, rows, h, eps);
  else quant_pack_kernel<T, 0><<<grid, kRowsPerBlock * 32, 0, st>>>(xt, o, rows, h, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace tdt

// K18.  x: (rows, h) f32 (in_dtype 0) or bf16 (1), contiguous, 16-byte
// aligned; out: (rows, h + 128) uint8; wire 0 int8, 1 e4m3; eps the scale's
// additive floor (lang/quant.py SCALE_EPS as an f32).  Returns the launch's
// cudaError_t.
extern "C" int tdt_quant_pack(const void* x, void* out, long long rows, int h, int in_dtype,
                              int wire, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h % 16 || rows < 0 || (wire != 0 && wire != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  if (in_dtype == 0) return static_cast<int>(tdt::pack_as<float>(x, out, rows, h, wire, eps, st));
  if (in_dtype == 1) return static_cast<int>(tdt::pack_as<tdt::bf16>(x, out, rows, h, wire, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
