// The bilinear corners and the float atomic max shared by the dense and
// sparse maximum-warp norms (K5, K6: maxwarp.cu) and by the max-splat pair
// (K6a max_splat, K6b inverse_max_gather: maxsplat.cu), so that the two
// sources cannot drift apart.
//
// corners_of computes a source's four target corners (NW, NE, SW, SE) and
// their weights in f32, operation for operation as slrsfs_tpu/ops/splat.py:
// _corners (:33) does; both sources are built with -fmad=false, so the
// weights, and each value times its weight, round as PyTorch and XLA round
// them. in_grid is the validity test: an off-grid corner, including all
// four of the Euler out-of-bounds sentinel max(H, W) + 1, neither writes
// nor is read. -1000 is the reference's max-splat floor (softsplat.py:590).

#pragma once

#include <cuda_runtime.h>

namespace maxwarp {

constexpr float kNegInit = -1000.0f;

// One instruction: atomicMax on the int bits of a value whose sign bit is
// clear, atomicMin on the unsigned bits of one whose sign bit is set (both
// orders agree with the float order across signs). It gives the bits of
// fmaxf up to the sign of a zero.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// corners (NW, NE, SW, SE) of a source at (x, y) moved by d
struct Corners {
  int x0, y0;
  float w[4];
};

__device__ __forceinline__ Corners corners_of(int x, int y, float2 d) {
  const float ox = (float)x + d.x;
  const float oy = (float)y + d.y;
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

__device__ __forceinline__ bool in_grid(int x, int y, int H, int W) {
  return x >= 0 && x < W && y >= 0 && y < H;
}

}  // namespace maxwarp
