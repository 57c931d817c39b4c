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
// What bounds it on an H100: the chain of dependent gathers, and the
// stores beside it. Every step's gather waits for the one before it (the
// destination is made from the motion gathered last), and most steps move
// a trajectory to lines its SM has not read, so a step is an L2 round trip:
// on an NVIDIA H100 80GB HBM3 at 700 W, tools/chase_probe.py's chain of 60
// dependent float2 gathers alone takes 12.2 us (~204 ns a step; on a still
// field, where each gather hits L1, 3.8 us) at K1's 65,536 trajectories,
// which is K1's latency bound; its
// bytes bound is 9.7 us ((n_fwd + n_bwd + 2) * R * 8 bytes, ~32 MB at
// P = 32768, N = 60; 63.4 MB and 19.1 us for the dense dual form at 256^2).
// The stores alone run at 3.3 TB/s, but beside the chain they slow its
// gathers (chain and stores together: 15-18 us in the probe).
//
// Design: one kernel, one row a thread, with options: rows are the dense
// grid (positions == NULL, row r is pixel (r % W, r / W)) or given
// positions; one direction (+M, disp_b == NULL) or both (the -M half in
// disp_b, its threads from a whole warp on, so that a warp holds one
// direction); every step's displacement or only the last (last_only);
// visibility or not (vis_f == NULL). Destination and the sticky invalid
// flag live in registers. Each step:
// * the rounding is an add of 1.5 * 2^23 (round_even): two full-rate adds
//   where rintf and a conversion to int run at a quarter of the rate;
// * the next step's gather is issued as soon as the destination is known,
//   before the step's entries are stored; the first step's gather, at the
//   source itself, before entry 0;
// * the entries go out as streaming stores (st.global.cs): consecutive
//   threads hold consecutive rows, so a step's store is one coalesced row.
// The launch is one even wave: a block an SM, as few whole warps as cover
// the rows, and no shared memory, all of it left to L1.
//
// Measured and not kept (PERF.md, section 6): two rows a thread with 16-byte
// stores (the chain lengthens); leaving the step loop once a row is
// invalid or static, per thread (a lane that stops stores its tail apart
// from its warp: up to 3x slower) or per warp (no faster: the chain of
// the rows still moving sets the time); a rest test; prefetching the cell
// a row would reach in a few steps into L1 (2-8x slower).
//
// The arithmetic is the scan's, operation for operation (the -M half
// negates the gathered vector, which is exact), and the build disables FMA
// contraction, so the output matches the plain PyTorch versions bit for
// bit. n_steps = 0 writes entry 0 only. NaN motion is out of scope: the
// rounding sends it to the last column where rintf sends it to the first.

#include <algorithm>
#include <climits>

#include <cuda_runtime.h>

constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;

// round-half-to-even of x as an int, exact for |x| < 2^22 and, once clamped
// to [0, n) with n <= 2^22, equal to the clamped rintf for any finite x:
// adding 1.5 * 2^23 leaves the integer in the low bits of the sum.
__device__ __forceinline__ int round_even(float x) {
  return __float_as_int(x + 12582912.0f) - 0x4B400000;
}

struct Args {
  const float2* motion;
  const int2* positions;  // NULL: the dense grid
  float2* disp_f;
  float2* disp_b;  // NULL: +M only
  float* vis_f;    // NULL: no visibility
  float* vis_b;
  int R, H, W, n_fwd, n_bwd, last_only;
  int Q;  // threads of one direction: R rounded up to whole warps
};

// Entry e of row p (and its visibility), by streaming stores.
__device__ __forceinline__ void store_entry(float2* __restrict__ out, float* __restrict__ vis,
                                            size_t e, int R, int p, float2 d, bool valid) {
  __stcs(out + e * (size_t)R + p, d);
  if (vis != nullptr) __stcs(vis + e * (size_t)R + p, valid ? 1.0f : 0.0f);
}

// Row p of R for n steps of +M (of -M when kNeg).
template <bool kNeg>
__device__ __forceinline__ void run(const Args& a, int p, int n, float2* __restrict__ out,
                                    float* __restrict__ vis) {
  const int R = a.R, H = a.H, W = a.W;
  if (p >= R) return;
  const float2* __restrict__ motion = a.motion;
  const float oob = (float)((H > W ? H : W) + 1);
  const float xmax = (float)(W - 1);
  const float ymax = (float)(H - 1);

  int sx, sy;
  if (a.positions != nullptr) {
    const int2 src = a.positions[p];
    sx = src.x;
    sy = src.y;
  } else {
    sx = p % W;
    sy = p / W;
  }
  const float cx = (float)sx, cy = (float)sy;
  float dx = cx, dy = cy;
  bool valid = true;
  float2 d = make_float2(0.0f, 0.0f);
  // step 1 gathers at the source itself: round(cx) == sx, clamped
  float2 m = make_float2(0.0f, 0.0f);
  if (n > 0) m = __ldg(&motion[min(max(sy, 0), H - 1) * W + min(max(sx, 0), W - 1)]);
  for (int s = 0; s < n; ++s) {
    if (kNeg) {
      m.x = -m.x;
      m.y = -m.y;
    }
    const float nx = dx + m.x;
    const float ny = dy + m.y;
    const bool inside = !((nx > xmax) || (nx < 0.0f) || (ny > ymax) || (ny < 0.0f));
    valid = valid && inside;
    dx = valid ? nx : cx;
    dy = valid ? ny : cy;
    d = valid ? make_float2(nx - cx, ny - cy) : make_float2(oob, oob);
    if (s + 1 < n) {  // the next step's gather, before this step's stores
      const int ix = min(max(round_even(dx), 0), W - 1);
      const int iy = min(max(round_even(dy), 0), H - 1);
      m = __ldg(&motion[iy * W + ix]);
    }
    if (!a.last_only) store_entry(out, vis, (size_t)s + 1, R, p, d, valid);
  }
  if (!a.last_only || n == 0) store_entry(out, vis, 0, R, p, make_float2(0.0f, 0.0f), true);
  if (a.last_only && n > 0) store_entry(out, vis, 0, R, p, d, valid);
}

// Threads [0, Q) integrate +M, [Q, 2Q) -M.
__global__ void __launch_bounds__(kMaxThreads) euler_all_kernel(const Args a) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool dual = a.disp_b != nullptr;
  if (t >= (dual ? 2LL : 1LL) * a.Q) return;
  if (t < a.Q)
    run<false>(a, (int)t, a.n_fwd, a.disp_f, a.vis_f);
  else
    run<true>(a, (int)(t - a.Q), a.n_bwd, a.disp_b, a.vis_b);
}

static cudaError_t launch(const void* motion, const void* positions, void* disp_f,
                          void* disp_b, void* vis_f, void* vis_b, int R, int H, int W,
                          int n_fwd, int n_bwd, int last_only, void* stream) {
  if (H >= (1 << 22) || W >= (1 << 22) || R > INT_MAX - kWarp) return cudaErrorInvalidValue;
  const int Q = (R + kWarp - 1) / kWarp * kWarp;
  const Args a = {(const float2*)motion, (const int2*)positions, (float2*)disp_f,
                  (float2*)disp_b, (float*)vis_f, (float*)vis_b, R, H, W, n_fwd, n_bwd,
                  last_only, Q};
  const long long n_threads = (disp_b != nullptr ? 2LL : 1LL) * Q;
  if (n_threads == 0) return cudaGetLastError();
  static int dev_seen = -1, sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(euler_all_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (err != cudaSuccess) return err;
    dev_seen = dev;
  }
  // one even wave: a block an SM, as few whole warps as cover the rows
  const long long per_sm = (n_threads + sms - 1) / sms;
  const int threads = (int)std::min<long long>((per_sm + kWarp - 1) / kWarp * kWarp,
                                               kMaxThreads);
  const long long blocks = (n_threads + threads - 1) / threads;
  euler_all_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// K1. motion (H, W, 2) f32, positions (P, 2) int32 [x, y]; writes
// disp_f (n_fwd + 1, P, 2) and disp_b (n_bwd + 1, P, 2) f32, entry 0 zero.
// H, W below 2^22 (else cudaErrorInvalidValue).
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
// (E, R) f32 when not NULL. H, W below 2^22.
extern "C" int euler_all(const void* motion, const void* positions,
                         void* disp_f, void* disp_b, void* vis_f, void* vis_b,
                         int R, int H, int W, int n_fwd, int n_bwd,
                         int last_only, void* stream) {
  return (int)launch(motion, positions, disp_f, disp_b, vis_f, vis_b, R, H, W,
                     n_fwd, n_bwd, last_only, stream);
}
