// K5 and K6: the maximum-warp norms (the v2 Z-normalisers), sparse and
// dense, as one cooperative launch each.
//
// K6, maximum_warp_norm_splat, replaces slrsfs_tpu/ops/splat.py:
// maximum_warp_norm_splat (:240), i.e. max_splat (:214, _max_splat_single
// :191) followed by inverse_max_gather (:236, _inverse_max_gather_single
// :219), for one channel of the dense rollouts:
//
//   mx[c]   = max(-1000, max of z[s] * w over sources s with an in-grid
//                 bilinear corner on c)                    (max-splat)
//   out[s]  = max(z[s], mx at the in-grid corners of s)    (inverse gather)
//
// K5, maximum_warp_norm_sparse, replaces slrsfs_tpu/ops/splat.py:
// maximum_warp_norm_sparse (:492, with _shift2d :481), the per-frame form of
// the sparse rollouts, where static pixels reduce to fixed stencils and only
// the moving rows scatter:
//
//   mx[c]        = max(mx_init[c], max of z_mov[p] * w over valid moving
//                      rows p with an in-grid corner on c)
//   mx_init[c]   = max(static[c] ? z[c] : -1000,
//                      static at W, N or NW of c ? 0 : -1000)
//   zmax_dense   = max(z, mx, mx_E, mx_S, mx_SE)          (-inf off the grid)
//   zmax_mov[p]  = max(z_mov[p], mx at p's in-grid corners)
//
// A static pixel never moves, so its max-splat is z at its own cell
// (weight 1) and 0 at its E, S and SE cells (weight 0, in-grid). The JAX
// version scatters the moving rows into a separate buffer with a -inf floor
// and then takes the max with mx_init; max is exact and order-free, so
// scattering straight into mx_init gives the same bits. zmax_mov ignores
// valid, as in JAX: padded rows get a value the caller multiplies away.
// -1000 is the reference's max-splat floor (softsplat.py:590); off-grid
// corners, including all four of the Euler OOB sentinel max(H, W) + 1,
// neither write nor are read. Weights are computed in f32 as the JAX
// _corners does; the build disables FMA contraction so they round as
// PyTorch rounds them. The corners, the grid test and the float atomic max
// live in maxwarp_corners.cuh, shared with K6's two halves (maxsplat.cu).
//
// What bounds them on an H100: bytes, and at these sizes the fixed cost of
// a launch. K5 reads z and the static mask (8 B a cell) and the moving rows
// (24 B a row) and writes zmax_dense and zmax_mov: ~1.3 MB at 256^2 with
// P = 32768, ~0.4 us at 3.35 TB/s. K6 reads z and the flow and writes the
// output: 16 B a pixel, ~1 MB at 256^2.
//
// Design: each entry is ONE cudaLaunchCooperativeKernel on the caller's
// stream. The grid is persistent: the SM count times the blocks an SM can
// hold (cudaOccupancyMaxActiveBlocksPerMultiprocessor, computed once per
// device), capped by the work. Grid-stride phases are separated by
// grid.sync(), so any H, W, P and B fit whatever grid is resident:
//   K5: (a) mx_init per cell | (b) scatter of the valid moving rows |
//       (c) zmax_dense per cell and zmax_mov per row;
//   K6: (a) fill mx with -1000 | (b) splat per source pixel |
//       (c) inverse gather per source pixel.
// The float atomic max (maxwarp_corners.cuh) is one instruction and gives
// the bits of fmaxf up to the sign of a zero, which the equality checks
// against the plain versions treat as equal. No fallback: a refused
// launch returns its CUDA error and the wrapper raises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "maxwarp_corners.cuh"

namespace cg = cooperative_groups;

namespace {

using maxwarp::atomic_max_f32;
using maxwarp::Corners;
using maxwarp::corners_of;
using maxwarp::in_grid;
using maxwarp::kNegInit;

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// max of v * w[k] into each in-grid corner of c
__device__ __forceinline__ void splat_max(float* m, const Corners& c, float v,
                                          int H, int W) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = c.x0 + (k & 1);
    const int cy = c.y0 + (k >> 1);
    if (in_grid(cx, cy, H, W)) atomic_max_f32(&m[cy * W + cx], v * c.w[k]);
  }
}

// max of t and mx at each in-grid corner of c; mx was written by atomics in
// an earlier phase of this launch, so it is read through L2
__device__ __forceinline__ float gather_max(const float* m, const Corners& c,
                                            float t, int H, int W) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = c.x0 + (k & 1);
    const int cy = c.y0 + (k >> 1);
    if (in_grid(cx, cy, H, W)) t = fmaxf(t, __ldcg(&m[cy * W + cx]));
  }
  return t;
}

__device__ __forceinline__ float at_or(const float* a, int y, int x, int H,
                                       int W, float fill) {
  return in_grid(x, y, H, W) ? __ldcg(&a[y * W + x]) : fill;
}

__global__ void __launch_bounds__(kThreads)
maxwarp_sparse_kernel(const float* __restrict__ z,
                      const float* __restrict__ static_mask,
                      const float* __restrict__ z_mov,
                      const int2* __restrict__ positions,
                      const float* __restrict__ valid,
                      const float2* __restrict__ disp, float* mx,
                      float* __restrict__ zmax_dense,
                      float* __restrict__ zmax_mov, int P, int H, int W) {
  cg::grid_group grid = cg::this_grid();
  const int HW = H * W;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = first; i < HW; i += stride) {  // (a) the static stencils
    const int y = i / W;
    const int x = i - y * W;
    // the JAX sum of the three shifted masks, in its order
    const float s = (at_or(static_mask, y, x - 1, H, W, 0.0f) +
                     at_or(static_mask, y - 1, x, H, W, 0.0f)) +
                    at_or(static_mask, y - 1, x - 1, H, W, 0.0f);
    const float own = static_mask[i] > 0.5f ? z[i] : kNegInit;
    mx[i] = fmaxf(own, s > 0.5f ? 0.0f : kNegInit);
  }
  grid.sync();
  for (int p = first; p < P; p += stride) {  // (b) the valid moving rows
    if (!(valid[p] > 0.5f)) continue;
    const int2 src = positions[p];
    splat_max(mx, corners_of(src.x, src.y, disp[p]), z_mov[p], H, W);
  }
  grid.sync();
  const float ninf = -CUDART_INF_F;
  for (int i = first; i < HW; i += stride) {  // (c) every cell ...
    const int y = i / W;
    const int x = i - y * W;
    const float m = fmaxf(fmaxf(__ldcg(&mx[i]), at_or(mx, y, x + 1, H, W, ninf)),
                          fmaxf(at_or(mx, y + 1, x, H, W, ninf),
                                at_or(mx, y + 1, x + 1, H, W, ninf)));
    zmax_dense[i] = fmaxf(z[i], m);
  }
  for (int p = first; p < P; p += stride) {  // ... and every moving row
    const int2 src = positions[p];
    zmax_mov[p] = gather_max(mx, corners_of(src.x, src.y, disp[p]), z_mov[p],
                             H, W);
  }
}

__global__ void __launch_bounds__(kThreads)
maxwarp_splat_kernel(const float* __restrict__ z,
                     const float2* __restrict__ flow, float* mx,
                     float* __restrict__ out, int B, int H, int W) {
  cg::grid_group grid = cg::this_grid();
  const int HW = H * W;
  const long long n = (long long)B * HW;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = first; i < n; i += stride) mx[i] = kNegInit;  // (a)
  grid.sync();
  for (long long i = first; i < n; i += stride) {  // (b) max-splat
    const int b = (int)(i / HW);
    const int r = (int)(i - (long long)b * HW);
    const int y = r / W;
    splat_max(mx + (size_t)b * HW, corners_of(r - y * W, y, flow[i]), z[i], H,
              W);
  }
  grid.sync();
  for (long long i = first; i < n; i += stride) {  // (c) inverse gather
    const int b = (int)(i / HW);
    const int r = (int)(i - (long long)b * HW);
    const int y = r / W;
    out[i] = gather_max(mx + (size_t)b * HW, corners_of(r - y * W, y, flow[i]),
                        z[i], H, W);
  }
}

// blocks of kThreads that the whole card holds at once for `kernel`,
// computed once per device
cudaError_t resident_blocks(const void* kernel, int* cache, int* blocks) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    cache[dev] = sms * per_sm;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// one cooperative launch of `kernel` over `work` items on stream s
cudaError_t launch(const void* kernel, int* cache, long long work,
                   void** args, cudaStream_t s) {
  int blocks;
  cudaError_t err = resident_blocks(kernel, cache, &blocks);
  if (err != cudaSuccess) return err;
  const long long need = (work + kThreads - 1) / kThreads;
  const int grid = (int)(need < blocks ? need : blocks);
  return cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, 0, s);
}

int sparse_blocks[kMaxDevices];
int splat_blocks[kMaxDevices];

}  // namespace

// z, static_mask (H, W) f32; z_mov (P,) f32; positions (P, 2) int32 [x, y];
// valid (P,) f32; disp (P, 2) f32; mx (H, W) f32 scratch; writes
// zmax_dense (H, W) and zmax_mov (P,) f32.
extern "C" int maximum_warp_norm_sparse(
    const void* z, const void* static_mask, const void* z_mov,
    const void* positions, const void* valid, const void* disp, void* mx,
    void* zmax_dense, void* zmax_mov, int P, int H, int W, void* stream) {
  const long long work = (long long)H * W > P ? (long long)H * W : P;
  if (work == 0) return 0;
  const float* z_ = (const float*)z;
  const float* static_ = (const float*)static_mask;
  const float* z_mov_ = (const float*)z_mov;
  const int2* positions_ = (const int2*)positions;
  const float* valid_ = (const float*)valid;
  const float2* disp_ = (const float2*)disp;
  float* mx_ = (float*)mx;
  float* zmax_dense_ = (float*)zmax_dense;
  float* zmax_mov_ = (float*)zmax_mov;
  void* args[] = {&z_,   &static_,     &z_mov_,    &positions_, &valid_, &disp_,
                  &mx_,  &zmax_dense_, &zmax_mov_, &P,          &H,      &W};
  return (int)launch((const void*)maxwarp_sparse_kernel, sparse_blocks, work,
                     args, (cudaStream_t)stream);
}

// z (B, H, W, 1) f32, flow (B, H, W, 2) f32, mx (B, H, W) f32 scratch;
// writes out (B, H, W, 1) f32.
extern "C" int maximum_warp_norm_splat(const void* z, const void* flow,
                                       void* mx, void* out, int B, int H,
                                       int W, void* stream) {
  const long long work = (long long)B * H * W;
  if (work == 0) return 0;
  const float* z_ = (const float*)z;
  const float2* flow_ = (const float2*)flow;
  float* mx_ = (float*)mx;
  float* out_ = (float*)out;
  void* args[] = {&z_, &flow_, &mx_, &out_, &B, &H, &W};
  return (int)launch((const void*)maxwarp_splat_kernel, splat_blocks, work,
                     args, (cudaStream_t)stream);
}
