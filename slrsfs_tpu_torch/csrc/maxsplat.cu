// K6a and K6b: the two halves of the dense maximum-warp norm as entries of
// their own, for any number of channels.
//
// K6a, max_splat, replaces slrsfs_tpu/ops/splat.py:max_splat (:214,
// _max_splat_single :191): for inp (B, H, W, C) and flow (B, H, W, 2),
//
//   out[b, c, k] = max(-1000, max of inp[b, s, k] * w over the sources s
//                         with an in-grid bilinear corner on cell c)
//
// K6b, inverse_max_gather, replaces slrsfs_tpu/ops/splat.py:
// inverse_max_gather (:236, _inverse_max_gather_single :219), a pure gather:
//
//   out[b, s, k] = max(init[b, s, k], maxmap[b, c, k] at the in-grid
//                      corners c of source s)
//
// Run in turn, they are K6 (maxwarp.cu: maximum_warp_norm_splat), which
// does both in one cooperative launch for one channel; the port's
// maximum_warp_norm_splat runs this pair for C > 1. The corners, the grid
// test and the float atomic max come from maxwarp_corners.cuh, shared with
// K6: weights in f32 in _corners's order, with FMA contraction off, so that
// inp * w has the JAX bits; the atomic max gives fmaxf's bits up to the
// sign of a zero, which the checks against the plain versions treat as
// equal. fmaxf drops a NaN where torch.maximum keeps it: the inputs are
// finite, and no NaN parity is claimed.
//
// What bounds them on an H100: bytes. K6a reads inp and the flow and
// writes out (after the -1000 fill, which writes it once more): 4C + 8
// bytes a pixel in, 4C out; K6b reads maxmap, the flow and init and writes
// out, 12C + 8 bytes a pixel. At (1, 256, 256, 1) that is ~0.8 MB and
// ~1.3 MB, well under a microsecond at 3.35 TB/s, so a launch's fixed cost
// dominates.
//
// Design: simple and right first. One thread per (source pixel, channel)
// over the channels-last layout, in a grid-stride loop; each thread
// recomputes its pixel's corners (the C threads of a pixel read the same
// flow entry, from L1). K6a is two launches on the caller's stream, the
// -1000 fill of out and then the scatter with one atomic max per in-grid
// corner (off-grid corners write nothing); K6b is one launch, fmaxf over
// init and the in-grid corners, no atomics. Each entry returns
// cudaGetLastError() after its launches; no fallback: the wrapper raises.

#include <cuda_runtime.h>

#include "maxwarp_corners.cuh"

namespace {

using maxwarp::atomic_max_f32;
using maxwarp::Corners;
using maxwarp::corners_of;
using maxwarp::in_grid;
using maxwarp::kNegInit;

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

int blocks_for(long long n) {
  const long long need = (n + kThreads - 1) / kThreads;
  return (int)(need < kMaxBlocks ? need : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = kNegInit;
}

// the (b, y, x) of pixel p of a (B, H, W) grid, and b's offset in pixels
struct Pixel {
  int x, y;
  long long base;
};

__device__ __forceinline__ Pixel pixel_of(long long p, int H, int W) {
  const long long HW = (long long)H * W;
  const long long b = p / HW;
  const int r = (int)(p - b * HW);
  Pixel px;
  px.y = r / W;
  px.x = r - px.y * W;
  px.base = b * HW;
  return px;
}

__global__ void __launch_bounds__(kThreads)
max_splat_kernel(const float* __restrict__ inp, const float2* __restrict__ flow,
                 float* __restrict__ out, long long n, int H, int W, int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long p = i / C;
    const int k = (int)(i - p * C);
    const Pixel px = pixel_of(p, H, W);
    const Corners c = corners_of(px.x, px.y, flow[p]);
    const float v = inp[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cx = c.x0 + (j & 1);
      const int cy = c.y0 + (j >> 1);
      if (in_grid(cx, cy, H, W))
        atomic_max_f32(&out[(px.base + (long long)cy * W + cx) * C + k],
                       v * c.w[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
inverse_max_gather_kernel(const float* __restrict__ maxmap,
                          const float2* __restrict__ flow,
                          const float* __restrict__ init,
                          float* __restrict__ out, long long n, int H, int W,
                          int C) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long p = i / C;
    const int k = (int)(i - p * C);
    const Pixel px = pixel_of(p, H, W);
    const Corners c = corners_of(px.x, px.y, flow[p]);
    float t = init[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cx = c.x0 + (j & 1);
      const int cy = c.y0 + (j >> 1);
      if (in_grid(cx, cy, H, W))
        t = fmaxf(t, maxmap[(px.base + (long long)cy * W + cx) * C + k]);
    }
    out[i] = t;
  }
}

}  // namespace

// inp (B, H, W, C) f32, flow (B, H, W, 2) f32; writes out (B, H, W, C) f32
// (filled with -1000 first).
extern "C" int max_splat(const void* inp, const void* flow, void* out, int B,
                         int H, int W, int C, void* stream) {
  const long long n = (long long)B * H * W * C;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  fill_kernel<<<blocks_for(n), kThreads, 0, s>>>((float*)out, n);
  max_splat_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      (const float*)inp, (const float2*)flow, (float*)out, n, H, W, C);
  return (int)cudaGetLastError();
}

// maxmap, init (B, H, W, C) f32, flow (B, H, W, 2) f32; writes out
// (B, H, W, C) f32.
extern "C" int inverse_max_gather(const void* maxmap, const void* flow,
                                  const void* init, void* out, int B, int H,
                                  int W, int C, void* stream) {
  const long long n = (long long)B * H * W * C;
  if (n == 0) return 0;
  inverse_max_gather_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const float*)maxmap, (const float2*)flow, (const float*)init,
      (float*)out, n, H, W, C);
  return (int)cudaGetLastError();
}
