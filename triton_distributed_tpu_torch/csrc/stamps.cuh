// %globaltimer stamps of the persistent decode kernels (K16's two forms),
// compiled in only with -DTDT_PERSISTENT_STAMPS
// (scripts/torch_persistent_stamps.py builds such a library of its own; the
// served build has none, and TDT_STAMP is then empty).  Thread 0 of each of
// rank 0's lanes writes mark k of layer l at stamps[(l * marks + k) * lanes
// + lane]; the buffer and the marks a layer are set through the translation
// unit's tdt_*_stamps entry point before the launch.
#pragma once

#include "dl.cuh"

#ifdef TDT_PERSISTENT_STAMPS
static __device__ unsigned long long* g_stamps;
static __device__ int g_stamp_marks;
#define TDT_STAMP(l, k)                                                              \
  do {                                                                               \
    if (threadIdx.x == 0 && blockIdx.y == 0 && g_stamps != nullptr)                  \
      g_stamps[(static_cast<size_t>(l) * g_stamp_marks + (k)) * gridDim.x + blockIdx.x] = \
          ::tdt::dl::globaltimer();                                                  \
  } while (0)
#define TDT_STAMPS_ENTRY(name)                                                       \
  extern "C" int name(void* buf, int marks) {                                        \
    cudaError_t e = cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf));                 \
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_stamp_marks, &marks, sizeof(int)); \
    return static_cast<int>(e);                                                      \
  }
#else
#define TDT_STAMP(l, k) \
  do {                  \
  } while (0)
#define TDT_STAMPS_ENTRY(name)
#endif
