// Probe of the accumulation forms of K7's backward on the H100, for
// slrsfs_tpu_torch/tools/k7_bwd_probe.py: csrc/euler_phased.cu's block
// rule (a block's tile of sources, runs of steps on one cell kept in
// registers, a shared-memory window of the gradient, misses and the flush
// added with red.global.add.v2.f32), built once for each form of the
// window's add, chosen by -DACC:
//
//   0  no add (the walk alone: the runs fold into a register)
//   1  int32 fixed point, coarse only (native ATOMS.ADD; too coarse)
//   2  int32 fixed point, coarse and fine (the kernel's form)
//   3  two atomicAdd(float *) (ATOMS.CAST.SPIN, a compare-and-swap loop)
//   4  one 64-bit atomicCAS loop over the float2
//   5  no window and no runs: each step's red.global.add.v2.f32 (the
//      first design's adds in this layout)
//
// and -DMATCH=1 (ACC 2): the lanes of a warp that add to one cell summed
// with __match_any_sync and __reduce_add_sync first. -DTILE, -DMARGIN,
// -DROWS_STEP (tile rows between a thread's rows) and -DLB (blocks an SM
// for __launch_bounds__) set the geometry. Not on any path.

#include <cuda_runtime.h>

#ifndef ACC
#define ACC 2
#endif
#ifndef MATCH
#define MATCH 0
#endif
#ifndef TILE
#define TILE 32
#endif
#ifndef MARGIN
#define MARGIN 16
#endif
#ifndef ROWS_STEP
#define ROWS_STEP 16
#endif
#ifndef LB
#define LB 1
#endif

// (int)rintf(x) for |x| < 2^22: adding 1.5 * 2^23 leaves the integer in the
// low bits of the sum, rounded to nearest even as rintf and jnp.round
// round it; two full-rate adds instead of a round and a conversion, which
// run at a quarter of the rate. Destinations lie in the grid or at a
// source, and the wrapper keeps both below 2^22.
__device__ __forceinline__ int round_even(float x) {
  return __float_as_int(x + 12582912.0f) - 0x4B400000;
}

constexpr int kT = TILE;
constexpr int kM = MARGIN;
constexpr int kWin = kT + 2 * kM;
constexpr int kCells = kWin * kWin;
constexpr int kThr = kT * ROWS_STEP;
constexpr int kRowStep = ROWS_STEP;
constexpr int kRows = kT / kRowStep;
constexpr bool kWindow = ACC >= 1 && ACC <= 4;
constexpr int kPlanes = ACC == 2 ? 4 : 2;
constexpr int kSmem = kWindow ? kCells * kPlanes * 4 : 16;

__device__ __forceinline__ void red2(float2* a, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(a), "f"(x), "f"(y) : "memory");
}

__device__ __forceinline__ void cas2(float2* c, float x, float y) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(c);
  unsigned long long old = *p, seen;
  do {
    seen = old;
    float2 v = *reinterpret_cast<const float2*>(&seen);
    v.x += x;
    v.y += y;
    old = atomicCAS(p, seen, *reinterpret_cast<const unsigned long long*>(&v));
  } while (old != seen);
}

struct Sums { int* win; float2* g_b; float s1, fk, sink; };

// a run into its key: >= 0 a window cell, < 0 ~(its cell in grad)
__device__ __forceinline__ void add_run(Sums& a, int key, float x, float y) {
  if (ACC == 0) {
    a.sink += x + y + (float)key;
    return;
  }
  if (key < 0) {
    red2(&a.g_b[~key], x, y);
    return;
  }
  if (ACC == 3) {
    float* w = reinterpret_cast<float*>(a.win);
    atomicAdd(&w[key], x);
    atomicAdd(&w[key + kCells], y);
    return;
  }
  if (ACC == 4) {
    cas2(reinterpret_cast<float2*>(a.win) + key, x, y);
    return;
  }
  const float vx = x * a.s1, vy = y * a.s1;
  unsigned cx = (unsigned)__float2int_rn(vx), cy = (unsigned)__float2int_rn(vy);
  unsigned fx = (unsigned)__float2int_rn((vx - (float)(int)cx) * a.fk);
  unsigned fy = (unsigned)__float2int_rn((vy - (float)(int)cy) * a.fk);
  if (MATCH) {
    const unsigned g = __match_any_sync(__activemask(), key);
    cx = __reduce_add_sync(g, cx);
    cy = __reduce_add_sync(g, cy);
    fx = __reduce_add_sync(g, fx);
    fy = __reduce_add_sync(g, fy);
    if ((int)(threadIdx.x & 31) != __ffs(g) - 1) return;
  }
  atomicAdd(&a.win[key], (int)cx);
  atomicAdd(&a.win[key + kCells], (int)cy);
  if (ACC == 2) {
    atomicAdd(&a.win[key + 2 * kCells], (int)fx);
    atomicAdd(&a.win[key + 3 * kCells], (int)fy);
  }
}

template <bool kNeg>
__device__ __forceinline__ void walk(const float2* __restrict__ m_b, Sums& a, const float* cx,
                                     const float* cy, const bool* on, const float* gx,
                                     const float* gy, int steps, int H, int W, int wx0, int wy0,
                                     int* key, float* sx, float* sy) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < kRows; ++j) any = any || on[j];
  if (!any) return;
  const float s = kNeg ? -1.0f : 1.0f;
  float dx[kRows], dy[kRows], ax[kRows], ay[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    dx[j] = cx[j];
    dy[j] = cy[j];
    ax[j] = s * gx[j];
    ay[j] = s * gy[j];
  }
  for (int k = 0; k < steps; ++k) {
    int at[kRows];
    float2 m[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int ix = min(max(round_even(dx[j]), 0), W - 1);
      const int iy = min(max(round_even(dy[j]), 0), H - 1);
      const unsigned lx = (unsigned)(ix - wx0), ly = (unsigned)(iy - wy0);
      const int cell = iy * W + ix;
      at[j] = kWindow && lx < (unsigned)kWin && ly < (unsigned)kWin ? (int)(ly * kWin + lx)
                                                                     : ~cell;
      m[j] = on[j] ? __ldg(&m_b[cell]) : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (ACC == 5) {
        if (on[j]) add_run(a, at[j], ax[j], ay[j]);
      } else {
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

__global__ void __launch_bounds__(kThr, LB)
    probe_kernel(const float2* __restrict__ motion, const int* __restrict__ t_fwd,
                 const int* __restrict__ t_bwd, const float2* __restrict__ out_f,
                 const float2* __restrict__ out_p, const float2* __restrict__ cot_f,
                 const float2* __restrict__ cot_p, float2* __restrict__ grad, int H, int W,
                 int n_steps, int tiles_x, int tiles) {
  extern __shared__ int4 smem[];
  __shared__ unsigned most;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int tx0 = (tile % tiles_x) * kT, ty0 = (tile / tiles_x) * kT;
  const int wx0 = tx0 - kM, wy0 = ty0 - kM;
  if (threadIdx.x == 0) most = 0;
  for (int i = threadIdx.x; i < kSmem / 16; i += kThr) smem[i] = make_int4(0, 0, 0, 0);
  const size_t cell0 = (size_t)b * H * W;
  const float2* __restrict__ m_b = motion + cell0;
  const float oob = (float)((H > W ? H : W) + 1);
  const int tf = t_fwd[b], tp = t_bwd[b];
  const int k0 = tf > 0 ? tf : 0;
  const int n_f = tf, n_p = tf + tp - k0;
  const bool fwd = tf >= 1 && tf <= n_steps;
  const bool bwd = tp > 0 && tf + tp >= 1 && tf + tp <= n_steps;
  const int lx = threadIdx.x % kT;
  float cx[kRows], cy[kRows], fx[kRows], fy[kRows], px[kRows], py[kRows], sx[kRows], sy[kRows];
  int key[kRows];
  bool on_f[kRows], on_p[kRows];
  float big = 0.0f;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int ly = threadIdx.x / kT + j * kRowStep;
    const int x = tx0 + lx, y = ty0 + ly;
    const bool has = x < W && y < H;
    const int p = has ? y * W + x : 0;
    const float2 m0 = has ? __ldg(&m_b[p]) : make_float2(0.0f, 0.0f);
    const bool rest = m0.x == 0.0f && m0.y == 0.0f;
    const bool vf = has && fwd && __ldg(&out_f[cell0 + p]).x != oob;
    const bool vp = has && bwd && __ldg(&out_p[cell0 + p]).x != oob;
    const float2 cf = vf ? __ldg(&cot_f[cell0 + p]) : make_float2(0.0f, 0.0f);
    const float2 cp = vp ? __ldg(&cot_p[cell0 + p]) : make_float2(0.0f, 0.0f);
    big = fmaxf(big, fmaxf(fmaxf(fabsf(cf.x), fabsf(cf.y)), fmaxf(fabsf(cp.x), fabsf(cp.y))));
    cx[j] = (float)x;
    cy[j] = (float)y;
    fx[j] = cf.x;
    fy[j] = cf.y;
    px[j] = cp.x;
    py[j] = cp.y;
    on_f[j] = vf && !rest;
    on_p[j] = vp && !rest;
    key[j] = kWindow ? (ly + kM) * kWin + lx + kM : ~p;
    sx[j] = 0.0f;
    sy[j] = 0.0f;
    if (rest && vf) {
      sx[j] += (float)n_f * cf.x;
      sy[j] += (float)n_f * cf.y;
    }
    if (rest && vp) {
      sx[j] += -(float)n_p * cp.x;
      sy[j] += -(float)n_p * cp.y;
    }
  }
  __syncthreads();
  atomicMax(&most, __float_as_uint(big));
  __syncthreads();
  const int n = n_f + n_p;
  const float bound = (float)(kT * kT) * (float)n * __uint_as_float(most);
  int e = 0, er = 0;
  frexpf(bound, &e);
  frexpf((float)(kT * kT) * (float)(n + 1), &er);
  Sums a = {reinterpret_cast<int*>(smem), grad + cell0,
            bound > 0.0f ? ldexpf(1.0f, 30 - e) : 1.0f, ldexpf(1.0f, 31 - er), 0.0f};
  walk<false>(m_b, a, cx, cy, on_f, fx, fy, n_f, H, W, wx0, wy0, key, sx, sy);
  walk<true>(m_b, a, cx, cy, on_p, px, py, n_p, H, W, wx0, wy0, key, sx, sy);
#pragma unroll
  for (int j = 0; j < kRows; ++j)
    if (sx[j] != 0.0f || sy[j] != 0.0f) add_run(a, key[j], sx[j], sy[j]);
  if (ACC == 0 && a.sink == -1.2345e-30f) a.g_b[0].x = 1.0f;  // keeps the walk
  if (!kWindow) return;
  __syncthreads();
  const float inv = 1.0f / a.s1, inv_k = 1.0f / a.fk;
  for (int i = threadIdx.x; i < kCells; i += kThr) {
    const int gx = wx0 + i % kWin, gy = wy0 + i / kWin;
    const int* w = a.win;
    float vx, vy;
    if (ACC == 3) {
      vx = __int_as_float(w[i]);
      vy = __int_as_float(w[i + kCells]);
    } else if (ACC == 4) {
      vx = __int_as_float(w[2 * i]);
      vy = __int_as_float(w[2 * i + 1]);
    } else {
      vx = ((float)w[i] + (ACC == 2 ? (float)w[i + 2 * kCells] * inv_k : 0.0f)) * inv;
      vy = ((float)w[i + kCells] + (ACC == 2 ? (float)w[i + 3 * kCells] * inv_k : 0.0f)) * inv;
    }
    if ((vx != 0.0f || vy != 0.0f) && gx >= 0 && gx < W && gy >= 0 && gy < H)
      red2(&a.g_b[gy * W + gx], vx, vy);
  }
}

// As csrc/euler_phased.cu:euler_phased_bwd (both cotangents given).
extern "C" int k7_bwd_probe(const void* motion, const void* t_fwd, const void* t_bwd,
                            const void* out_f, const void* out_p, const void* cot_f,
                            const void* cot_p, void* grad, int B, int H, int W, int n_steps,
                            void* stream) {
  const int tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;
  const long long blocks = (long long)B * tiles_x * tiles_y;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<<<(unsigned)blocks, kThr, kSmem, (cudaStream_t)stream>>>(
      (const float2*)motion, (const int*)t_fwd, (const int*)t_bwd, (const float2*)out_f,
      (const float2*)out_p, (const float2*)cot_f, (const float2*)cot_p, (float2*)grad, H, W,
      n_steps, tiles_x, tiles_x * tiles_y);
  return (int)cudaGetLastError();
}
