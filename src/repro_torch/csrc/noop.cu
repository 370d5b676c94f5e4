// An empty kernel: the floor of one launch on the card.  chip_smoke.py
// times it beside the port's kernels, so that a kernel whose time sits
// near the floor is seen to have little left to gain.  It replaces no TPU
// kernel and no path of the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" int quipt_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
