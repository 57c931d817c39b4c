// The launch floor beside K6a and K6b (csrc/maxsplat.cu): one empty kernel
// of one warp. Its time on the card alone (queued behind a sleep, as
// chip_smoke.py:device_time takes it) is the least time any one launch
// takes, the floor under a kernel whose bytes bound is shorter.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
