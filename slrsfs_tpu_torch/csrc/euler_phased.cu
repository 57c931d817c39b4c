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

// ---- euler_phased_bwd: the motion's gradient ------------------------------
//
// Replaces the VJP that XLA derives from euler_integrate_phased (:249; the
// jnp.take at :284 is the gather it transposes). round carries no
// gradient, so each step's destination d_k = d_{k-1} + sign_k * M[i_k]
// passes the cotangent of the latched displacement straight back: for a
// row whose latched output is valid, every step k of that phase up to the
// latch adds sign_k * cot[row] into grad[i_k], where i_k is the step's
// rounded, clamped position (+1 and cot_f in the forward phase, -1 and
// cot_p in the backward one). A row whose latched output is the sentinel
// max(H, W) + 1 left the frame and stayed invalid to the latch, so its
// phase adds nothing; no valid displacement is that large, so the saved
// outputs (out_f, out_p) say which rows to skip. A phase that latched
// nothing (t_f = 0 for out_f, t_p = 0 for out_p) adds nothing either. A
// valid row never left the frame, so it walks every step of its phase.
//
// The walk re-runs the forward's step arithmetic (round_even, clamp,
// gather, add; the build has -fmad=false as the forward's has), so every
// rounded index equals the forward's. A static source (its own motion
// zero) reads M[src] at every step too, so its gradient is not zero:
// grad[src] gets steps * sign * cot.
//
// What bounds it on an H100: the walk's chain of dependent gathers, as in
// the forward, and the adds. The first design added each step into grad
// with its own red.global.add.v2.f32: ~57 M on the joint step's motion at
// ~93 G a second (0.61 ms), its lanes' cells scattered over L2. Half of a
// row's steps there stay on the previous step's cell, and nearly all land
// within a few tens of pixels of the source (ops/euler.py:
// phased_bwd_window_counts counts both).
//
// Design: a block owns a kBwdTile x kBwdTile tile of one sample's sources
// and sums the gradient in a window of shared memory, the tile dilated by
// kBwdMargin on each side. A thread carries kBwdRows rows of one tile
// column, whose gathers of a step are issued together. A row keeps the sum
// of sign * cot added at its current cell in registers (a run) and adds
// the run to that cell when the cell changes and at the end: into the
// window, or, for a cell outside it, into grad with red.global.add.v2.f32.
// A static source is one run of steps * sign * cot a phase; both phases
// share the runs (the backward phase restarts at the source, where the
// forward's first run began). After the walk the block adds each non-zero
// window cell in the frame into grad with one red.global.add.v2.f32:
// windows of neighbouring tiles overlap, so it is a reduction, never a
// store; skipping a zero cell is exact (grad holds +0 or a sum, and adding
// +-0 leaves it).
//
// The window sums in fixed point. The card has no shared-memory f32 add:
// atomicAdd(float *) there is a compare-and-swap loop (ATOMS.CAST.SPIN),
// and where trajectories converge the lanes of a warp retry on one cell
// (0.44 ms on the joint step's motion; a 64-bit compare-and-swap loop over
// the float2 1.41 ms; this form 0.18: tools/k7_bwd_probe.py); an int32 add
// is native (ATOMS.ADD). Each component of a cell is two int32 sums,
// coarse and fine, in separate planes (lanes on neighbouring cells hit
// neighbouring banks). A run's value v is scaled by s1 = 2^(30 - e), where
// 2^e exceeds the block's bound S = rows * (n_f + n_p) * max |cot| on the
// sum of its runs' |values|, so no coarse sum leaves int32; coarse =
// rint(v * s1) and fine = rint((v * s1 - coarse) * fk), the residual
// (exact in f32, at most 1/2) scaled by fk = 2^(31 - er), 2^er above the
// block's most runs, rows * (n_f + n_p + 1), so no fine sum leaves int32
// either. Integer sums are exact in any order; a cell's value is
// (coarse + fine / fk) / s1, to 2^(er - 62) of S a run (2^-46 at T = 60).
// A block whose bound is not finite (a cotangent NaN or Inf) or below
// ~2^-100 adds every run into grad as a window miss. Sums into grad are
// f32 in an order that changes from launch to launch; the result is held
// against the plain version's autograd within a bound.
// ops/euler.py:phased_bwd_window_counts repeats the tiling, window and
// run rule on the host.

constexpr int kBwdTile = 32;
constexpr int kBwdMargin = 16;
constexpr int kBwdWin = kBwdTile + 2 * kBwdMargin;  // the window's side
constexpr int kBwdCells = kBwdWin * kBwdWin;
constexpr int kBwdThreads = 512;
constexpr int kBwdBlocksPerSm = 3;  // 3 x 64 KB of the SM's 227 KB, 40 registers
constexpr int kBwdRowStep = kBwdThreads / kBwdTile;  // tile rows between a thread's rows
constexpr int kBwdRows = kBwdTile / kBwdRowStep;     // rows a thread
constexpr int kBwdSmem = 4 * kBwdCells * (int)sizeof(int);  // coarse x, y; fine x, y
static_assert(kBwdThreads % kBwdTile == 0 && kBwdTile % kBwdRowStep == 0, "tiling");
static_assert(kBwdCells % 4 == 0, "the window is zeroed in int4s");

__device__ __forceinline__ void red_add_f32x2(float2* addr, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(addr), "f"(x), "f"(y)
               : "memory");
}

// A block's sums: the window's four planes, its scales, its slice of grad.
struct BwdSums {
  int* win;
  float2* g_b;
  float s1, fk;
};

// A run's value (x, y) into its key: a window cell (key >= 0) or ~(the
// cell's index in grad).
__device__ __forceinline__ void add_run(const BwdSums& a, int key, float x, float y) {
  if (key < 0) {
    red_add_f32x2(&a.g_b[~key], x, y);
    return;
  }
  const float vx = x * a.s1, vy = y * a.s1;
  const int cx = __float2int_rn(vx), cy = __float2int_rn(vy);
  atomicAdd(&a.win[key], cx);
  atomicAdd(&a.win[key + kBwdCells], cy);
  atomicAdd(&a.win[key + 2 * kBwdCells], __float2int_rn((vx - (float)cx) * a.fk));
  atomicAdd(&a.win[key + 3 * kBwdCells], __float2int_rn((vy - (float)cy) * a.fk));
}

// One phase's walk for the thread's rows with on[j] set (valid and not
// static), from their sources (cx, cy): `steps` steps of sign -1 when
// kNeg, each adding sign * (gx, gy) to the row's run at the step's cell;
// key[j] is the run's cell (add_run), sx, sy its sum. `exact` is false
// when the block adds every run into grad.
template <bool kNeg>
__device__ __forceinline__ void phase_bwd(const float2* __restrict__ m_b, const BwdSums& a,
                                          const float* cx, const float* cy, const bool* on,
                                          const float* gx, const float* gy, int steps, int H,
                                          int W, int wx0, int wy0, bool exact, int* key, float* sx,
                                          float* sy) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j) any = any || on[j];
  if (!any) return;
  const float s = kNeg ? -1.0f : 1.0f;
  float dx[kBwdRows], dy[kBwdRows], ax[kBwdRows], ay[kBwdRows];
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j) {
    dx[j] = cx[j];
    dy[j] = cy[j];
    ax[j] = s * gx[j];
    ay[j] = s * gy[j];
  }
  for (int k = 0; k < steps; ++k) {
    int at[kBwdRows];
    float2 m[kBwdRows];
#pragma unroll
    for (int j = 0; j < kBwdRows; ++j) {
      const int ix = min(max(round_even(dx[j]), 0), W - 1);
      const int iy = min(max(round_even(dy[j]), 0), H - 1);
      const unsigned lx = (unsigned)(ix - wx0);
      const unsigned ly = (unsigned)(iy - wy0);
      const int cell = iy * W + ix;
      at[j] = exact && lx < (unsigned)kBwdWin && ly < (unsigned)kBwdWin
                  ? (int)(ly * kBwdWin + lx) : ~cell;
      m[j] = on[j] ? __ldg(&m_b[cell]) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kBwdRows; ++j) {
      if (on[j] && at[j] != key[j]) {
        add_run(a, key[j], sx[j], sy[j]);
        key[j] = at[j];
        sx[j] = 0.0f;
        sy[j] = 0.0f;
      }
      if (on[j]) {
        sx[j] += ax[j];
        sy[j] += ay[j];
      }
      if (kNeg) {
        m[j].x = -m[j].x;
        m[j].y = -m[j].y;
      }
      dx[j] = dx[j] + m[j].x;
      dy[j] = dy[j] + m[j].y;
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads, kBwdBlocksPerSm)
    euler_phased_bwd_kernel(const float2* __restrict__ motion, const int* __restrict__ t_fwd,
                            const int* __restrict__ t_bwd, const float2* __restrict__ out_f,
                            const float2* __restrict__ out_p, const float2* __restrict__ cot_f,
                            const float2* __restrict__ cot_p, float2* __restrict__ grad, int H,
                            int W, int n_steps, int tiles_x, int tiles) {
  extern __shared__ int4 smem[];
  __shared__ unsigned most;  // the bits of the block's largest |cot|
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int tx0 = (tile % tiles_x) * kBwdTile;
  const int ty0 = (tile / tiles_x) * kBwdTile;
  const int wx0 = tx0 - kBwdMargin;
  const int wy0 = ty0 - kBwdMargin;
  if (threadIdx.x == 0) most = 0;
  for (int i = threadIdx.x; i < kBwdCells; i += kBwdThreads) smem[i] = make_int4(0, 0, 0, 0);

  const size_t cell0 = (size_t)b * H * W;
  const float2* __restrict__ m_b = motion + cell0;
  const float oob = (float)((H > W ? H : W) + 1);
  const int tf = t_fwd[b];
  const int tp = t_bwd[b];
  // the forward phase: steps 1 .. tf; the backward phase: k0+1 .. tf+tp
  const int k0 = tf > 0 ? tf : 0;
  const int n_f = tf;
  const int n_p = tf + tp - k0;
  const bool fwd = cot_f != nullptr && tf >= 1 && tf <= n_steps;
  const bool bwd = cot_p != nullptr && tp > 0 && tf + tp >= 1 && tf + tp <= n_steps;

  const int lx = threadIdx.x % kBwdTile;
  float cx[kBwdRows], cy[kBwdRows], fx[kBwdRows], fy[kBwdRows], px[kBwdRows], py[kBwdRows];
  float sx[kBwdRows], sy[kBwdRows];
  int key[kBwdRows];
  bool on_f[kBwdRows], on_p[kBwdRows];
  float big = 0.0f;
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j) {
    const int ly = threadIdx.x / kBwdTile + j * kBwdRowStep;
    const int x = tx0 + lx;
    const int y = ty0 + ly;
    const bool has = x < W && y < H;
    const int p = has ? y * W + x : 0;
    const float2 m0 = has ? __ldg(&m_b[p]) : make_float2(0.0f, 0.0f);
    const bool rest = m0.x == 0.0f && m0.y == 0.0f;
    const bool vf = has && fwd && __ldg(&out_f[cell0 + p]).x != oob;
    const bool vp = has && bwd && __ldg(&out_p[cell0 + p]).x != oob;
    const float2 cf = vf ? __ldg(&cot_f[cell0 + p]) : make_float2(0.0f, 0.0f);
    const float2 cp = vp ? __ldg(&cot_p[cell0 + p]) : make_float2(0.0f, 0.0f);
    // NaN or Inf makes the block's bound infinite (fmaxf drops a NaN, a
    // sum keeps it)
    const float c = fmaxf(fmaxf(fabsf(cf.x), fabsf(cf.y)), fmaxf(fabsf(cp.x), fabsf(cp.y)));
    const float t = fabsf(cf.x) + fabsf(cf.y) + fabsf(cp.x) + fabsf(cp.y);
    big = t <= 3.4e38f ? fmaxf(big, c) : __int_as_float(0x7f800000);
    cx[j] = (float)x;
    cy[j] = (float)y;
    fx[j] = cf.x;
    fy[j] = cf.y;
    px[j] = cp.x;
    py[j] = cp.y;
    on_f[j] = vf && !rest;
    on_p[j] = vp && !rest;
    // every run starts at the source, the cell of each phase's first step;
    // a static source's steps are one run
    key[j] = (ly + kBwdMargin) * kBwdWin + lx + kBwdMargin;
    sx[j] = 0.0f;
    sy[j] = 0.0f;
    if (rest && vf) {
      const float k = (float)n_f;
      sx[j] += k * cf.x;
      sy[j] += k * cf.y;
    }
    if (rest && vp) {
      const float k = -(float)n_p;
      sx[j] += k * cp.x;
      sy[j] += k * cp.y;
    }
  }
  __syncthreads();  // the window is zero
  atomicMax(&most, __float_as_uint(big));
  __syncthreads();
  // fixed point unless the bound is not finite or below ~2^-100 (the
  // scale would leave f32): then every run goes to grad
  const int n = n_f + n_p;
  const float bound = (float)(kBwdTile * kBwdTile) * (float)n * __uint_as_float(most);
  const bool exact = bound == 0.0f || (bound >= 1.0e-30f && bound <= 3.4e38f);
  int e = 0, er = 0;
  frexpf(bound, &e);
  frexpf((float)(kBwdTile * kBwdTile) * (float)(n + 1), &er);
  const BwdSums a = {reinterpret_cast<int*>(smem), grad + cell0,
                     exact && bound > 0.0f ? ldexpf(1.0f, 30 - e) : 1.0f, ldexpf(1.0f, 31 - er)};
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j)
    if (!exact) key[j] = ~((ty0 + threadIdx.x / kBwdTile + j * kBwdRowStep) * W + tx0 + lx);
  phase_bwd<false>(m_b, a, cx, cy, on_f, fx, fy, n_f, H, W, wx0, wy0, exact, key, sx, sy);
  phase_bwd<true>(m_b, a, cx, cy, on_p, px, py, n_p, H, W, wx0, wy0, exact, key, sx, sy);
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j)
    if (sx[j] != 0.0f || sy[j] != 0.0f) add_run(a, key[j], sx[j], sy[j]);
  __syncthreads();
  // the flush: each non-zero window cell in the frame, in row order
  const float inv = 1.0f / a.s1;
  const float inv_k = 1.0f / a.fk;
  for (int i = threadIdx.x; i < kBwdCells; i += kBwdThreads) {
    const int gx = wx0 + i % kBwdWin;
    const int gy = wy0 + i / kBwdWin;
    const int* w = a.win;
    const float vx = ((float)w[i] + (float)w[i + 2 * kBwdCells] * inv_k) * inv;
    const float vy = ((float)w[i + kBwdCells] + (float)w[i + 3 * kBwdCells] * inv_k) * inv;
    if ((vx != 0.0f || vy != 0.0f) && gx >= 0 && gx < W && gy >= 0 && gy < H)
      red_add_f32x2(&a.g_b[gy * W + gx], vx, vy);
  }
}

// The window's geometry, for ops/euler.py:phased_bwd_window_counts.
extern "C" int euler_phased_bwd_tile() { return kBwdTile; }
extern "C" int euler_phased_bwd_margin() { return kBwdMargin; }

// Dense form only. motion (B, H, W, 2) f32; t_fwd, t_bwd (B,) int32 as the
// forward took them; out_f, out_p (B, H, W, 2) the forward's outputs;
// cot_f, cot_p (B, H, W, 2) their cotangents (NULL: zero); grad
// (B, H, W, 2) f32, zeroed by the caller, += the motion's gradient.
extern "C" int euler_phased_bwd(const void* motion, const void* t_fwd, const void* t_bwd,
                                const void* out_f, const void* out_p, const void* cot_f,
                                const void* cot_p, void* grad, int B, int H, int W,
                                int n_steps, void* stream) {
  if (H >= (1 << 22) || W >= (1 << 22)) return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kBwdTile - 1) / kBwdTile;
  const int tiles_y = (H + kBwdTile - 1) / kBwdTile;
  const long long blocks = (long long)B * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (blocks == 0 || (cot_f == nullptr && cot_p == nullptr)) return (int)cudaGetLastError();
  // the window's shared memory, above the 48 KB a block gets unasked: set
  // once a device
  static int dev_seen = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != dev_seen) {
    err = cudaFuncSetAttribute(euler_phased_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmem);
    if (err != cudaSuccess) return (int)err;
    dev_seen = dev;
  }
  euler_phased_bwd_kernel<<<(unsigned)blocks, kBwdThreads, kBwdSmem, (cudaStream_t)stream>>>(
      (const float2*)motion, (const int*)t_fwd, (const int*)t_bwd, (const float2*)out_f,
      (const float2*)out_p, (const float2*)cot_f, (const float2*)cot_p, (float2*)grad, H, W,
      n_steps, tiles_x, tiles_x * tiles_y);
  return (int)cudaGetLastError();
}
