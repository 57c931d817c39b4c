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
// What bounds it on an H100: the SM's issue. Each trajectory runs up to
// T = 60 dependent steps of ~20 lane-instructions (round, clamp, index,
// gather, add, compare) at 33.5e12 lane-instructions a second, fewer where
// it leaves the frame or rests (below). A round and a float-to-int
// conversion issue at a quarter of that rate, so the rounding is two adds.
// The bytes are one float2 of motion per source pixel and two float2
// outputs (~25 MB at B = 16, 256^2, a 7.5 us byte bound); a sample's
// 512 KB motion field stays in L2.
//
// Design: a thread carries kPerThread neighbouring trajectories of one
// sample (rows kPerThread * q + j), whose gathers of one step are issued
// together and whose motion is alike, so that they tend to stop together.
// The scan is split at the phase switch into two loops, with no test of
// k left in a step: the forward loop runs t_f steps of +M, the backward
// loop restarts from the source and runs t_p steps of -M. A loop runs only
// when its latch happens (t_f <= n_steps; t_p > 0 and t_f + t_p <=
// n_steps); a phase that latches nothing changes no output.
//
// Leaving a phase early is exact, so a trajectory stops gathering at its
// first step that leaves the frame, and the thread's loop ends when all
// of its trajectories have stopped: the scan pins an invalid trajectory to
// its source and keeps it invalid until the restart (the flag is sticky),
// so every later step of the phase, its latch included, reports
// (max(H, W) + 1) whatever the motion it would gather; the restart sets
// the destination and the flag from the source alone, so nothing of the
// forward phase reaches the backward one. A source in the grid whose own
// motion is zero (either sign) does not gather at all: every step of
// either phase gathers that zero at the same cell and leaves the
// destination as it is (d + 0 == d, as no destination is -0: it starts at
// a source >= +0 and +0 + -0 is +0), so its displacement is +0; these are
// the static pixels that the compact form leaves out. The loops' step
// counts thus follow the data; chip_smoke.py:k7_gathers counts them for
// the kernel's bound.

// Outputs: dense mode stores both per pixel (coalesced float2 rows).
// Compact mode stores 0 + out * valid at the row's source pixel of the
// zeroed grid, for rows with valid != 0, and skips the padded rows
// (valid 0, at (0, 0)), which are not integrated at all. This equals the
// plain version's scatter-add (0 + the rows' addends in any order)
// because cli/train.py:attach_moving_sets lists each moving pixel once
// (rows with valid != 0 have distinct positions: the wrapper's contract)
// and a padded row's addend out * 0 is +-0, which leaves any cell as it
// is (no cell holds -0: a cell is +0 or 0 + x, and 0 + -0 is +0). Motion
// holding NaN breaks the last step (NaN * 0 is NaN); training motion is
// finite.
//
// The arithmetic is the scan's, operation for operation (the rounding is
// half-to-even like jnp.round; the backward phase negates the gathered
// vector, which equals multiplying by -1), and the build disables FMA
// contraction, so the result matches the plain PyTorch version bit for bit.

#include <cuda_runtime.h>

constexpr int kPerThread = 2;
constexpr int kThreads = 256;

// (int)rintf(x) for |x| < 2^22: adding 1.5 * 2^23 leaves the integer in the
// low bits of the sum, rounded to nearest even as rintf and jnp.round
// round it; two full-rate adds instead of a round and a conversion, which
// run at a quarter of the rate. Destinations lie in the grid or at a
// source, and the wrapper keeps both below 2^22.
__device__ __forceinline__ int round_even(float x) {
  return __float_as_int(x + 12582912.0f) - 0x4B400000;
}

// One phase of `steps` steps (sign -1 when kNeg) for the thread's
// trajectories from their sources (cx, cy); has[j]: row j exists. Returns
// each row's latched displacement in (ox, oy).
template <bool kNeg>
__device__ __forceinline__ void phase(const float2* __restrict__ m_b, const float* cx,
                                      const float* cy, const bool* has, const bool* rest,
                                      int steps, int H, int W, float oob, float* ox, float* oy) {
  const float xmax = (float)(W - 1);
  const float ymax = (float)(H - 1);
  float dx[kPerThread], dy[kPerThread];
  bool valid[kPerThread], moving[kPerThread];  // in the frame; still changing
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    dx[j] = cx[j];
    dy[j] = cy[j];
    valid[j] = has[j];
    moving[j] = has[j] && !rest[j];
  }
  for (int k = 0; k < steps; ++k) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) any = any || moving[j];
    if (!any) break;
    // branch-free: a trajectory that stopped gathers at its last cell (in
    // the grid once clamped) and keeps its state
    float2 m[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int ix = min(max(round_even(dx[j]), 0), W - 1);
      const int iy = min(max(round_even(dy[j]), 0), H - 1);
      m[j] = __ldg(&m_b[iy * W + ix]);
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (kNeg) {
        m[j].x = -m[j].x;
        m[j].y = -m[j].y;
      }
      const float nx = dx[j] + m[j].x;
      const float ny = dy[j] + m[j].y;
      const bool inside = !((nx > xmax) || (nx < 0.0f) || (ny > ymax) || (ny < 0.0f));
      dx[j] = moving[j] ? nx : dx[j];
      dy[j] = moving[j] ? ny : dy[j];
      valid[j] = moving[j] ? inside : valid[j];
      moving[j] = moving[j] && inside;
    }
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    ox[j] = valid[j] ? dx[j] - cx[j] : oob;
    oy[j] = valid[j] ? dy[j] - cy[j] : oob;
  }
}

// A phase's outputs: dense rows store the latched displacement, or 0 when
// the phase latched nothing; compact rows with valid != 0 store
// 0 + out * valid when it latched, and leave the zeroed grid otherwise.
__device__ __forceinline__ void store(float2* __restrict__ out, bool latched, bool compact,
                                      const bool* has, const size_t* at, const float* v,
                                      const float* ox, const float* oy) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (!has[j]) continue;
    if (!compact)
      out[at[j]] = latched ? make_float2(ox[j], oy[j]) : make_float2(0.0f, 0.0f);
    else if (latched && v[j] != 0.0f)
      out[at[j]] = make_float2(0.0f + ox[j] * v[j], 0.0f + oy[j] * v[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
    euler_phased_kernel(const float2* __restrict__ motion, const int2* __restrict__ positions,
                        const float* __restrict__ valid, const int* __restrict__ t_fwd,
                        const int* __restrict__ t_bwd, float2* __restrict__ out_f,
                        float2* __restrict__ out_p, int B, int R, int Q, int H, int W,
                        int n_steps) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * Q) return;
  const int b = (int)(t / Q);
  const int q = (int)(t - (long long)b * Q);
  const bool compact = positions != nullptr;
  const size_t row0 = (size_t)b * R;
  const size_t cell0 = (size_t)b * H * W;
  float cx[kPerThread], cy[kPerThread], v[kPerThread];
  bool has[kPerThread];
  size_t at[kPerThread];  // the output element of each row
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int p = q * kPerThread + j;
    has[j] = p < R;
    int sx = 0, sy = 0;
    v[j] = 0.0f;
    if (has[j] && compact) {
      const int2 s = positions[row0 + p];
      sx = s.x;
      sy = s.y;
      v[j] = valid[row0 + p];
      has[j] = v[j] != 0.0f;  // a padded row stores nothing: not run
    } else if (has[j]) {
      sx = p % W;
      sy = p / W;
    }
    cx[j] = (float)sx;
    cy[j] = (float)sy;
    at[j] = compact ? cell0 + (size_t)sy * W + sx : row0 + p;
  }
  const float oob = (float)((H > W ? H : W) + 1);
  const float2* __restrict__ m_b = motion + cell0;
  const int tf = t_fwd[b];
  const int tp = t_bwd[b];
  // a source in the grid whose motion is zero never moves (both phases)
  bool rest[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const bool in = cx[j] >= 0.0f && cx[j] <= (float)(W - 1) && cy[j] >= 0.0f &&
                    cy[j] <= (float)(H - 1);
    const float2 m0 = in ? __ldg(&m_b[(int)cy[j] * W + (int)cx[j]]) : make_float2(1.0f, 1.0f);
    rest[j] = m0.x == 0.0f && m0.y == 0.0f;
  }
  float ox[kPerThread] = {}, oy[kPerThread] = {};
  // the forward phase: steps 1 .. tf; the backward phase: steps k0+1 ..
  // tf+tp (k0 = max(tf, 0)); each only when it latches
  const bool fwd = tf >= 1 && tf <= n_steps;
  if (fwd) phase<false>(m_b, cx, cy, has, rest, tf, H, W, oob, ox, oy);
  store(out_f, fwd, compact, has, at, v, ox, oy);
  const int k0 = tf > 0 ? tf : 0;
  const bool bwd = tp > 0 && tf + tp >= 1 && tf + tp <= n_steps;
  if (bwd) phase<true>(m_b, cx, cy, has, rest, tf + tp - k0, H, W, oob, ox, oy);
  store(out_p, bwd, compact, has, at, v, ox, oy);
}

// motion (B, H, W, 2) f32; t_fwd, t_bwd (B,) int32 with t_fwd + t_bwd <=
// n_steps; H, W below 2^22. Dense (positions == NULL, R = H * W): writes
// out_f, out_p (B, H, W, 2). Compact (positions (B, R, 2) int32 [x, y],
// valid (B, R) f32, the rows with valid != 0 of a sample at distinct
// positions): stores 0 + out * valid into out_f, out_p, which the caller
// zeroes.
extern "C" int euler_phased(const void* motion, const void* positions,
                            const void* valid, const void* t_fwd,
                            const void* t_bwd, void* out_f, void* out_p,
                            int B, int R, int H, int W, int n_steps,
                            void* stream) {
  if (H >= (1 << 22) || W >= (1 << 22)) return (int)cudaErrorInvalidValue;
  const int Q = (R + kPerThread - 1) / kPerThread;
  const long long threads = (long long)B * Q;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0) {
    euler_phased_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float2*)motion, (const int2*)positions, (const float*)valid,
        (const int*)t_fwd, (const int*)t_bwd, (float2*)out_f, (float2*)out_p, B, R, Q, H, W,
        n_steps);
  }
  return (int)cudaGetLastError();
}
