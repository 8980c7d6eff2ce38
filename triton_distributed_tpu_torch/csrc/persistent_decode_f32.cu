// K16's f32 instantiations (persistent_decode.cu has the kernel's notes and
// the C entry points; the bf16 ones are built there).
#include "persistent_decode.cuh"

namespace tdt {
namespace far {

cudaError_t launch_f32(int D, int G, PersistentArgs* a, cudaStream_t st, long long* lanes) {
  return launch_t<float>(D, G, a, st, lanes);
}

}  // namespace far
}  // namespace tdt
