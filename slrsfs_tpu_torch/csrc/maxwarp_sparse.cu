// K5: sparse maximum-warp norm (the per-frame v2 Z-normaliser of the
// sparse rollouts).
//
// Replaces slrsfs_tpu/ops/splat.py:maximum_warp_norm_sparse (:492, with
// _shift2d :481). For every source pixel it gives the max of Z over the
// cells its bilinear splat reaches, where each cell holds the max of z*w
// over everything splatted onto it:
//
//   mx[c]        = max(mx_init[c], max of z_mov[p] * w over valid moving
//                      rows p with an in-grid corner on c)
//   mx_init[c]   = max(static[c] ? z[c] : -1000,
//                      static at W, N or NW of c ? 0 : -1000)
//   zmax_dense   = max(z, mx, mx_E, mx_S, mx_SE)          (-inf off the grid)
//   zmax_mov[p]  = max(z_mov[p], mx at p's in-grid corners)
//
// A static pixel never moves, so its max-splat is a fixed stencil: z at its
// own cell (weight 1) and 0 at its E, S and SE cells (weight 0, in-grid);
// -1000 is the reference's max-splat floor (softsplat.py:590). Moving rows
// scatter z_mov * w with weights computed in f32 exactly as the JAX version
// does. The JAX version scatters them into a separate buffer with a -inf
// floor and then takes the max with mx_init; max is exact and order-free,
// so scattering straight into mx_init gives the same bits.
//
// What bounds it on an H100: bytes, and at these sizes launch latency.
// Per frame it reads z and the static mask (2 x H x W f32), the moving rows
// (z_mov, positions, valid, disp: 24 B a row) and writes zmax_dense and
// zmax_mov: ~1.3 MB at 256^2 with P = 32768, against ~10^6 operations.
//
// Design: four launches on the caller's stream.
//  (1) one thread per cell writes mx_init;
//  (2) one thread per moving row computes its four corners and does a
//      float atomic max (CAS loop) on each in-grid corner; padded rows
//      (valid == 0) and off-grid corners (including all four of the OOB
//      sentinel max(H, W) + 1) write nothing;
//  (3) one thread per cell reads the 2x2 block of mx at and below-right of
//      it and writes zmax_dense;
//  (4) one thread per moving row reads mx at its in-grid corners and writes
//      zmax_mov. Like the JAX version this ignores valid: padded rows get a
//      value that the caller multiplies away.
// Max is order-independent, so the result matches the plain PyTorch version
// bit for bit (up to the sign of a zero); the build disables FMA contraction
// so the weights round as PyTorch rounds them.

#include <cuda_runtime.h>
#include <math_constants.h>

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

__device__ __forceinline__ float at_or(const float* __restrict__ a, int y,
                                       int x, int H, int W, float fill) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? a[y * W + x] : fill;
}

// target corners of source (px, py) moved by d: NW, NE, SW, SE
struct Corners {
  int x0, y0;
  float w[4];
};

__device__ __forceinline__ Corners corners_of(int2 src, float2 d) {
  const float ox = (float)src.x + d.x;
  const float oy = (float)src.y + d.y;
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

__global__ void mx_init_kernel(const float* __restrict__ z,
                               const float* __restrict__ static_mask,
                               float* __restrict__ mx, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W;
  const int x = i - y * W;
  // the JAX sum of the three shifted masks, in its order
  const float s = (at_or(static_mask, y, x - 1, H, W, 0.0f) +
                   at_or(static_mask, y - 1, x, H, W, 0.0f)) +
                  at_or(static_mask, y - 1, x - 1, H, W, 0.0f);
  const float own = static_mask[i] > 0.5f ? z[i] : kNegInit;
  mx[i] = fmaxf(own, s > 0.5f ? 0.0f : kNegInit);
}

__global__ void mx_scatter_kernel(const float* __restrict__ z_mov,
                                  const int2* __restrict__ positions,
                                  const float* __restrict__ valid,
                                  const float2* __restrict__ disp,
                                  float* __restrict__ mx, int P, int H,
                                  int W) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P || !(valid[p] > 0.5f)) return;
  const Corners c = corners_of(positions[p], disp[p]);
  const float zm = z_mov[p];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = c.x0 + (k & 1);
    const int cy = c.y0 + (k >> 1);
    if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
      atomic_max_f32(&mx[cy * W + cx], zm * c.w[k]);
    }
  }
}

__global__ void zmax_dense_kernel(const float* __restrict__ z,
                                  const float* __restrict__ mx,
                                  float* __restrict__ zmax_dense, int H,
                                  int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const int y = i / W;
  const int x = i - y * W;
  const float ninf = -CUDART_INF_F;
  const float m = fmaxf(fmaxf(mx[i], at_or(mx, y, x + 1, H, W, ninf)),
                        fmaxf(at_or(mx, y + 1, x, H, W, ninf),
                              at_or(mx, y + 1, x + 1, H, W, ninf)));
  zmax_dense[i] = fmaxf(z[i], m);
}

__global__ void zmax_mov_kernel(const float* __restrict__ z_mov,
                                const int2* __restrict__ positions,
                                const float2* __restrict__ disp,
                                const float* __restrict__ mx,
                                float* __restrict__ zmax_mov, int P, int H,
                                int W) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const Corners c = corners_of(positions[p], disp[p]);
  float t = z_mov[p];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = c.x0 + (k & 1);
    const int cy = c.y0 + (k >> 1);
    if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
      t = fmaxf(t, mx[cy * W + cx]);
    }
  }
  zmax_mov[p] = t;
}

}  // namespace

// z, static_mask (H, W) f32; z_mov (P,) f32; positions (P, 2) int32 [x, y];
// valid (P,) f32; disp (P, 2) f32; mx (H, W) f32 scratch; writes
// zmax_dense (H, W) and zmax_mov (P,) f32.
extern "C" int maximum_warp_norm_sparse(
    const void* z, const void* static_mask, const void* z_mov,
    const void* positions, const void* valid, const void* disp, void* mx,
    void* zmax_dense, void* zmax_mov, int P, int H, int W, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int cell_blocks = (H * W + kThreads - 1) / kThreads;
  const int row_blocks = (P + kThreads - 1) / kThreads;
  cudaError_t err;
  if (cell_blocks > 0) {
    mx_init_kernel<<<cell_blocks, kThreads, 0, s>>>(
        (const float*)z, (const float*)static_mask, (float*)mx, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (row_blocks > 0) {
    mx_scatter_kernel<<<row_blocks, kThreads, 0, s>>>(
        (const float*)z_mov, (const int2*)positions, (const float*)valid,
        (const float2*)disp, (float*)mx, P, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (cell_blocks > 0) {
    zmax_dense_kernel<<<cell_blocks, kThreads, 0, s>>>(
        (const float*)z, (const float*)mx, (float*)zmax_dense, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (row_blocks > 0) {
    zmax_mov_kernel<<<row_blocks, kThreads, 0, s>>>(
        (const float*)z_mov, (const int2*)positions, (const float2*)disp,
        (const float*)mx, (float*)zmax_mov, P, H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
