// K6: dense maximum-warp norm (the v2 Z-normaliser of the dense rollouts).
//
// Replaces slrsfs_tpu/ops/splat.py:maximum_warp_norm_splat (:240), i.e.
// max_splat (:214, _max_splat_single :191) followed by inverse_max_gather
// (:236, _inverse_max_gather_single :219), for one channel:
//
//   mx[c]   = max(-1000, max of z[s] * w over sources s with an in-grid
//                 bilinear corner on c)                    (max-splat)
//   out[s]  = max(z[s], mx at the in-grid corners of s)    (inverse gather)
//
// with s moved to (x + flow_x, y + flow_y) and weights computed in f32 as
// the JAX _corners does. -1000 is the reference's max-splat floor
// (softsplat.py:590); off-grid corners, including all four of the Euler
// OOB sentinel max(H, W) + 1, neither write nor are read.
//
// What bounds it on an H100: bytes, and at these sizes launch latency. Per
// call it reads z and the flow (12 B a pixel) and writes the output (4 B a
// pixel): ~1 MB at 256^2, against ~10^6 operations.
//
// Design: three launches on the caller's stream over B x H x W pixels:
// fill the scratch max map with -1000, then one thread per source pixel
// does a float atomic max (CAS loop) of z * w on each in-grid corner, then
// one thread per source pixel gathers the max back. Max is order-independent,
// so the result matches the plain PyTorch version bit for bit (up to the
// sign of a zero); the build disables FMA contraction so the weights round
// as PyTorch rounds them.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInit = -1000.0f;
constexpr int kThreads = 256;

// float max into global memory; the buffer only grows, so a stale first
// read can only make the loop try once more
__device__ __forceinline__ void atomic_max_f32(float* addr, float val) {
  int* a = (int*)addr;
  int old = *a;
  while (val > __int_as_float(old)) {
    const int assumed = old;
    old = atomicCAS(a, assumed, __float_as_int(val));
    if (old == assumed) break;
  }
}

struct Corners {
  int x0, y0;
  float w[4];
};

// corners (NW, NE, SW, SE) of pixel (x, y) moved by f
__device__ __forceinline__ Corners corners_of(int x, int y, float2 f) {
  const float ox = (float)x + f.x;
  const float oy = (float)y + f.y;
  const float x0f = floorf(ox);
  const float y0f = floorf(oy);
  const float dx = ox - x0f;
  const float dy = oy - y0f;
  Corners c;
  c.x0 = (int)x0f;
  c.y0 = (int)y0f;
  c.w[0] = (1.0f - dx) * (1.0f - dy);
  c.w[1] = dx * (1.0f - dy);
  c.w[2] = (1.0f - dx) * dy;
  c.w[3] = dx * dy;
  return c;
}

__global__ void fill_kernel(float* __restrict__ a, long long n, float v) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) a[i] = v;
}

__global__ void max_splat_kernel(const float* __restrict__ z,
                                 const float2* __restrict__ flow,
                                 float* __restrict__ mx, int B, int H,
                                 int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (i >= (long long)B * HW) return;
  const int b = (int)(i / HW);
  const int r = (int)(i - (long long)b * HW);
  const int y = r / W;
  const Corners c = corners_of(r - y * W, y, flow[i]);
  const float zi = z[i];
  float* m = mx + (size_t)b * HW;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = c.x0 + (k & 1);
    const int cy = c.y0 + (k >> 1);
    if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
      atomic_max_f32(&m[cy * W + cx], zi * c.w[k]);
    }
  }
}

__global__ void inverse_gather_kernel(const float* __restrict__ z,
                                      const float2* __restrict__ flow,
                                      const float* __restrict__ mx,
                                      float* __restrict__ out, int B, int H,
                                      int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (i >= (long long)B * HW) return;
  const int b = (int)(i / HW);
  const int r = (int)(i - (long long)b * HW);
  const int y = r / W;
  const Corners c = corners_of(r - y * W, y, flow[i]);
  const float* m = mx + (size_t)b * HW;
  float t = z[i];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = c.x0 + (k & 1);
    const int cy = c.y0 + (k >> 1);
    if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
      t = fmaxf(t, m[cy * W + cx]);
    }
  }
  out[i] = t;
}

}  // namespace

// z (B, H, W, 1) f32, flow (B, H, W, 2) f32, mx (B, H, W) f32 scratch;
// writes out (B, H, W, 1) f32.
extern "C" int maximum_warp_norm_splat(const void* z, const void* flow,
                                       void* mx, void* out, int B, int H,
                                       int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaError_t err;
  fill_kernel<<<blocks, kThreads, 0, s>>>((float*)mx, n, kNegInit);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  max_splat_kernel<<<blocks, kThreads, 0, s>>>(
      (const float*)z, (const float2*)flow, (float*)mx, B, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  inverse_gather_kernel<<<blocks, kThreads, 0, s>>>(
      (const float*)z, (const float2*)flow, (const float*)mx, (float*)out, B,
      H, W);
  return (int)cudaGetLastError();
}
