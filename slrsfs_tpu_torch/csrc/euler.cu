// K1 and K4: Euler integration of a constant motion field.
//
// K1 (entry euler_compact_dual) replaces
// slrsfs_tpu/ops/euler.py:euler_integrate_compact_dual (:145), the lax.scan
// that advects P moving pixels through max(n_fwd, n_bwd) steps for +M and -M
// together. K4 (entry euler_all) replaces the dense and single-direction
// forms of the same scan: euler_integrate_all (:34) with euler_integrate
// (:88), euler_integrate_compact (:99) and euler_integrate_all_dual (:199).
// Each step gathers M at the half-to-even rounded destination, adds it,
// marks the trajectory invalid for good once it leaves the frame, pins
// invalid trajectories to their source and reports their displacement as
// max(H, W) + 1; the single-direction forms also report visibility
// (!invalid as f32, entry 0 all ones).
//
// What bounds it on an H100: bytes. Each trajectory writes one float2 (and
// with visibility one float) per step and does a handful of flops per step:
// (n_fwd + n_bwd + 2) * R * 8 bytes, ~32 MB for K1 at P = 32768, N = 60, and
// 63.4 MB for the dense dual form at 256^2 with (59, 60) steps. The 512 KB
// motion field is read through the read-only path and stays in L2, so in
// practice the dependent gather of every step (one L2 round trip) sets the
// time: the kernel is latency-bound.
//
// Design: one kernel, one thread per trajectory, with options: rows are the
// dense grid (positions == NULL, row r is pixel (r % W, r / W)) or given
// positions; one direction (+M, disp_b == NULL) or both (rows [R, 2R)
// integrate -M); every step's displacement or only the last (last_only);
// visibility or not (vis_f == NULL). Destination and the sticky invalid
// flag live in registers for the whole loop, so the scan's carry never
// touches device memory. Consecutive threads hold consecutive rows, so every
// per-step store is one coalesced row. The arithmetic is the scan's,
// operation for operation (rintf is round-half-to-even like jnp.round; the
// -M half negates the gathered vector, which is exact), and the build
// disables FMA contraction, so the output matches the plain PyTorch
// versions bit for bit. n_steps = 0 writes entry 0 only.

#include <cuda_runtime.h>

__global__ void euler_all_kernel(const float2* __restrict__ motion,
                                 const int2* __restrict__ positions,
                                 float2* __restrict__ disp_f,
                                 float2* __restrict__ disp_b,
                                 float* __restrict__ vis_f,
                                 float* __restrict__ vis_b, int R, int H,
                                 int W, int n_fwd, int n_bwd, int last_only) {
  const int n_rows = disp_b != nullptr ? 2 * R : R;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const bool fwd = r < R;
  const int p = fwd ? r : r - R;
  const int n = fwd ? n_fwd : n_bwd;
  float2* out = fwd ? disp_f : disp_b;
  float* vis = fwd ? vis_f : vis_b;

  int sx, sy;
  if (positions != nullptr) {
    const int2 src = positions[p];
    sx = src.x;
    sy = src.y;
  } else {
    sx = p % W;
    sy = p / W;
  }
  const float cx = (float)sx;
  const float cy = (float)sy;
  const float oob = (float)((H > W ? H : W) + 1);
  const float xmax = (float)(W - 1);
  const float ymax = (float)(H - 1);

  float dx = cx, dy = cy;
  bool invalid = false;
  float2 d = make_float2(0.0f, 0.0f);
  if (!last_only || n == 0) {
    out[p] = d;
    if (vis != nullptr) vis[p] = 1.0f;
  }
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
    d = invalid ? make_float2(oob, oob) : make_float2(dx - cx, dy - cy);
    if (!last_only) {
      out[(size_t)(s + 1) * R + p] = d;
      if (vis != nullptr) vis[(size_t)(s + 1) * R + p] = invalid ? 0.0f : 1.0f;
    }
  }
  if (last_only && n > 0) {
    out[p] = d;
    if (vis != nullptr) vis[p] = invalid ? 0.0f : 1.0f;
  }
}

static cudaError_t launch(const void* motion, const void* positions,
                          void* disp_f, void* disp_b, void* vis_f, void* vis_b,
                          int R, int H, int W, int n_fwd, int n_bwd,
                          int last_only, void* stream) {
  const int threads = 256;
  const int n_rows = disp_b != nullptr ? 2 * R : R;
  const int blocks = (n_rows + threads - 1) / threads;
  if (blocks > 0) {
    euler_all_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float2*)motion, (const int2*)positions, (float2*)disp_f,
        (float2*)disp_b, (float*)vis_f, (float*)vis_b, R, H, W, n_fwd, n_bwd,
        last_only);
  }
  return cudaGetLastError();
}

// K1. motion (H, W, 2) f32, positions (P, 2) int32 [x, y]; writes
// disp_f (n_fwd + 1, P, 2) and disp_b (n_bwd + 1, P, 2) f32, entry 0 zero.
extern "C" int euler_compact_dual(const void* motion, const void* positions,
                                  void* disp_f, void* disp_b, int P, int H,
                                  int W, int n_fwd, int n_bwd, void* stream) {
  return (int)launch(motion, positions, disp_f, disp_b, nullptr, nullptr, P, H,
                     W, n_fwd, n_bwd, 0, stream);
}

// K4. motion (H, W, 2) f32; positions (R, 2) int32 [x, y], or NULL for the
// dense grid (R = H * W, row-major). disp_f (E, R, 2) f32 with E = n_fwd + 1,
// or E = 1 with last_only (the displacement after n_fwd steps); disp_b
// likewise for -M and n_bwd, or NULL for one direction. vis_f / vis_b
// (E, R) f32 when not NULL.
extern "C" int euler_all(const void* motion, const void* positions,
                         void* disp_f, void* disp_b, void* vis_f, void* vis_b,
                         int R, int H, int W, int n_fwd, int n_bwd,
                         int last_only, void* stream) {
  return (int)launch(motion, positions, disp_f, disp_b, vis_f, vis_b, R, H, W,
                     n_fwd, n_bwd, last_only, stream);
}
