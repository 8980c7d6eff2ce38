// K16's first form, f32 with head dim 64: the instantiations for G 1, 2, 4
// and 8 (persistent_decode.cu has the kernel's notes and the C entry points).
#include "persistent_decode.cuh"

namespace tdt {
namespace far {

cudaError_t launch_f32_d64(int G, PersistentArgs* a, cudaStream_t st, long long* lanes) {
  return launch_d<float, 64>(G, a, st, lanes);
}

}  // namespace far
}  // namespace tdt
