// K1: compact dual Euler integration of a constant motion field.
//
// Replaces slrsfs_tpu/ops/euler.py:euler_integrate_compact_dual (:145), the
// lax.scan that advects P moving pixels through max(n_fwd, n_bwd) steps for
// +M and -M together. Each step gathers M at the half-to-even rounded
// destination, adds it, marks the trajectory invalid for good once it
// leaves the frame, pins invalid trajectories to their source and reports
// their displacement as max(H, W) + 1.
//
// What bounds it on an H100: bytes. Each trajectory writes one float2 per
// step ((n_fwd + n_bwd + 2) * P * 8 bytes, ~32 MB at P = 32768, N = 60)
// and does a handful of flops per step; the 512 KB motion field is read
// through the read-only path and stays in L2.
//
// Design: one thread per trajectory (2P threads; the first P integrate +M,
// the rest -M). Destination and the sticky invalid flag live in registers
// for the whole loop, so the scan's carry never touches device memory.
// Consecutive threads hold consecutive pixels, so every per-step store is
// one coalesced float2 row. The arithmetic is the scan's, operation for
// operation (rintf is round-half-to-even like jnp.round; the -M half
// negates the gathered vector, which is exact), and the build disables FMA
// contraction, so the output matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

__global__ void euler_compact_dual_kernel(const float2* __restrict__ motion,
                                          const int2* __restrict__ positions,
                                          float2* __restrict__ disp_f,
                                          float2* __restrict__ disp_b,
                                          int P, int H, int W, int n_fwd,
                                          int n_bwd) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= 2 * P) return;
  const bool fwd = r < P;
  const int p = fwd ? r : r - P;
  const int n = fwd ? n_fwd : n_bwd;
  float2* out = fwd ? disp_f : disp_b;

  const int2 src = positions[p];
  const float cx = (float)src.x;
  const float cy = (float)src.y;
  const float oob = (float)((H > W ? H : W) + 1);
  const float xmax = (float)(W - 1);
  const float ymax = (float)(H - 1);

  float dx = cx, dy = cy;
  bool invalid = false;
  out[p] = make_float2(0.0f, 0.0f);
  for (int s = 0; s < n; ++s) {
    int ix = (int)rintf(dx);
    int iy = (int)rintf(dy);
    ix = ix < 0 ? 0 : (ix > W - 1 ? W - 1 : ix);
    iy = iy < 0 ? 0 : (iy > H - 1 ? H - 1 : iy);
    float2 m = __ldg(&motion[iy * W + ix]);
    if (!fwd) {
      m.x = -m.x;
      m.y = -m.y;
    }
    dx = dx + m.x;
    dy = dy + m.y;
    invalid = invalid || (dx > xmax) || (dx < 0.0f) || (dy > ymax) ||
              (dy < 0.0f);
    if (invalid) {
      dx = cx;
      dy = cy;
    }
    out[(size_t)(s + 1) * P + p] =
        invalid ? make_float2(oob, oob) : make_float2(dx - cx, dy - cy);
  }
}

// motion (H, W, 2) f32, positions (P, 2) int32 [x, y]; writes
// disp_f (n_fwd + 1, P, 2) and disp_b (n_bwd + 1, P, 2) f32, entry 0 zero.
extern "C" int euler_compact_dual(const void* motion, const void* positions,
                                  void* disp_f, void* disp_b, int P, int H,
                                  int W, int n_fwd, int n_bwd, void* stream) {
  const int threads = 256;
  const int blocks = (2 * P + threads - 1) / threads;
  if (blocks > 0) {
    euler_compact_dual_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)motion, (const int2*)positions, (float2*)disp_f,
        (float2*)disp_b, P, H, W, n_fwd, n_bwd);
  }
  return (int)cudaGetLastError();
}
