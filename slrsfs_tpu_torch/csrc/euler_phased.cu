// K7: phase-switched Euler integration of the training pass.
//
// Replaces slrsfs_tpu/ops/euler.py:euler_integrate_phased (:249) and
// euler_integrate_phased_compact (:308), the lax.scan (vmapped over the
// batch) that advects each sample's trajectories forward for t_f steps,
// latches the displacement, restarts from the source grid, advects
// backward for t_p steps and latches again. Step k (1-based) gathers M at
// the half-to-even rounded destination with sign +1 while k <= t_f and -1
// after; a trajectory that leaves the frame is invalid until the restart,
// is pinned to its source and reports a displacement of max(H, W) + 1.
// out_f latches at k == t_f, out_p at k == t_f + t_p only when t_p > 0
// (t_f = 0 or t_p = 0 leaves that output at zero).
//
// What bounds it on an H100: latency, not bytes. Each trajectory runs up to
// T = 60 dependent gathers (round, load, add, compare); the bytes are one
// float2 of motion per source pixel and two float2 outputs (~25 MB at
// B = 16, 256^2, a 7.5 us byte bound). The 512 KB motion field of a sample
// stays in L2, so each step costs one L2 round trip per warp.
//
// Design: one thread per (sample, trajectory) over B * R rows, R = H * W
// (dense) or the padded moving-set size P (compact). The destination, the
// sticky invalid flag and both latched outputs live in registers for the
// whole loop; the loop ends at the last step that latches anything, which
// changes no output. Dense mode stores both outputs per pixel (coalesced
// float2 rows). Compact mode scatter-ADDS out * valid onto the zeroed grid
// at the row's source pixel: padded rows point at (0, 0), and a plain store
// would clobber the result of a moving pixel at (0, 0), whereas their
// zero addends leave it exact. The arithmetic is the scan's, operation for
// operation (rintf is half-to-even like jnp.round; the backward phase
// negates the gathered vector, which equals multiplying by -1), and the
// build disables FMA contraction, so the result matches the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

__global__ void euler_phased_kernel(const float2* __restrict__ motion,
                                    const int2* __restrict__ positions,
                                    const float* __restrict__ valid,
                                    const int* __restrict__ t_fwd,
                                    const int* __restrict__ t_bwd,
                                    float2* __restrict__ out_f,
                                    float2* __restrict__ out_p, int B, int R,
                                    int H, int W, int n_steps) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)B * R) return;
  const int b = (int)(r / R);
  const int p = (int)(r - (long long)b * R);
  const bool compact = positions != nullptr;
  int sx, sy;
  if (compact) {
    const int2 s = positions[r];
    sx = s.x;
    sy = s.y;
  } else {
    sx = p % W;
    sy = p / W;
  }
  const float cx = (float)sx;
  const float cy = (float)sy;
  const float oob = (float)((H > W ? H : W) + 1);
  const float xmax = (float)(W - 1);
  const float ymax = (float)(H - 1);
  const float2* __restrict__ m_b = motion + (size_t)b * H * W;
  const int tf = t_fwd[b];
  const int tp = t_bwd[b];
  int k_end = tp > 0 ? tf + tp : tf;
  if (k_end > n_steps) k_end = n_steps;

  float dx = cx, dy = cy;
  bool invalid = false;
  float2 of = make_float2(0.0f, 0.0f);
  float2 op = make_float2(0.0f, 0.0f);
  for (int k = 1; k <= k_end; ++k) {
    if (k == tf + 1) {  // phase switch: restart from the source, now -M
      dx = cx;
      dy = cy;
      invalid = false;
    }
    int ix = (int)rintf(dx);
    int iy = (int)rintf(dy);
    ix = ix < 0 ? 0 : (ix > W - 1 ? W - 1 : ix);
    iy = iy < 0 ? 0 : (iy > H - 1 ? H - 1 : iy);
    float2 m = __ldg(&m_b[iy * W + ix]);
    if (k > tf) {
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
    const float2 disp =
        invalid ? make_float2(oob, oob) : make_float2(dx - cx, dy - cy);
    if (k == tf) of = disp;
    if (tp > 0 && k == tf + tp) op = disp;
  }

  if (compact) {
    const float v = valid[r];
    const size_t cell = (size_t)b * H * W + (size_t)sy * W + sx;
    float* f = reinterpret_cast<float*>(out_f + cell);
    float* q = reinterpret_cast<float*>(out_p + cell);
    atomicAdd(f, of.x * v);
    atomicAdd(f + 1, of.y * v);
    atomicAdd(q, op.x * v);
    atomicAdd(q + 1, op.y * v);
  } else {
    out_f[r] = of;
    out_p[r] = op;
  }
}

// motion (B, H, W, 2) f32; t_fwd, t_bwd (B,) int32 with t_fwd + t_bwd <=
// n_steps. Dense (positions == NULL, R = H * W): writes out_f, out_p
// (B, H, W, 2). Compact (positions (B, R, 2) int32 [x, y], valid (B, R)
// f32): adds out * valid into out_f, out_p, which the caller zeroes.
extern "C" int euler_phased(const void* motion, const void* positions,
                            const void* valid, const void* t_fwd,
                            const void* t_bwd, void* out_f, void* out_p,
                            int B, int R, int H, int W, int n_steps,
                            void* stream) {
  const int threads = 256;
  const long long rows = (long long)B * R;
  const long long blocks = (rows + threads - 1) / threads;
  if (blocks > 0) {
    euler_phased_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        (const float2*)motion, (const int2*)positions, (const float*)valid,
        (const int*)t_fwd, (const int*)t_bwd, (float2*)out_f,
        (float2*)out_p, B, R, H, W, n_steps);
  }
  return (int)cudaGetLastError();
}
