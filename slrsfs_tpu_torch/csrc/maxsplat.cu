// K6a and K6b: the two halves of the dense maximum-warp norm as entries of
// their own, for any number of channels.
//
// K6a, max_splat, replaces slrsfs_tpu/ops/splat.py:max_splat (:214,
// _max_splat_single :191): for inp (B, H, W, C) and flow (B, H, W, 2),
//
//   out[b, c, k] = max(-1000, max of inp[b, s, k] * w over the sources s
//                         with an in-grid bilinear corner on cell c)
//
// K6b, inverse_max_gather, replaces slrsfs_tpu/ops/splat.py:
// inverse_max_gather (:236, _inverse_max_gather_single :219), a pure gather:
//
//   out[b, s, k] = max(init[b, s, k], maxmap[b, c, k] at the in-grid
//                      corners c of source s)
//
// Run in turn, they are K6 (maxwarp.cu: maximum_warp_norm_splat), which
// does both in one cooperative launch for one channel; the port's
// maximum_warp_norm_splat routes C > 1 to this pair (its one caller,
// models/baseline.py:z_normalize, passes C = 1). The corners, the grid
// test and the float atomic max come from maxwarp_corners.cuh, shared with
// K6: weights in f32 in _corners's order, with FMA contraction off, so that
// inp * w has the JAX bits; the atomic max gives fmaxf's bits up to the
// sign of a zero, which the checks against the plain versions treat as
// equal. fmaxf drops a NaN where torch.maximum keeps it: the inputs are
// finite, and no NaN parity is claimed.
//
// What bounds them on an H100. Bytes: K6a reads inp and the flow and
// writes out, 8C + 8 bytes a pixel; K6b reads maxmap, the flow and init and
// writes out, 12C + 8 bytes a pixel: ~0.8 and ~1.3 MB at (1, 256, 256, 1),
// 0.3 and 0.4 us at 3.35 TB/s. Below the bytes, three other floors. A
// launch costs its fixed time however little it does (an empty kernel's,
// which tools/maxsplat_probe.py times): at 256^2 it exceeds the bytes
// bound, and K6a has two launches (the -1000 fill and the scatter). A
// float atomic max into device memory is a read-modify-write at L2; one a
// corner is 4 B H W C of them (2.36 M at 768^2, C = 1), and those set the
// time of a scatter that issues one a corner. And a design that merges
// corners before they reach L2 pays in instructions a tile: the box, the
// window and its flush cost a few hundred warp instructions, which must be
// spread over many pixels or they, not the atomics, set the time.
//
// K6a design: two kernels. The fill stores -1000 with 16-byte stores and
// lets the scatter start at once as its programmatic dependent (sm_90:
// griddepcontrol.launch_dependents in the fill, the scatter launched with
// cudaLaunchAttributeProgrammaticStreamSerialization), so the scatter's
// loads and corners overlap the fill and its launch, and it waits
// (griddepcontrol.wait) only before its first reduction into out.
// At one channel the scatter is a window max-scatter over 8 x 16 tiles of
// one sample's source pixels, a warp a tile, four pixels a lane (two rows
// of 16 lanes, a lane's rows two apart), so that the tile's fixed work is
// spread over 128 pixels:
//  * P1: each pixel's four corners and weights once (corners_of, in_grid);
//    warp reductions give the tile's bounding box and coordinate sums of
//    its in-grid corners.
//  * P2: a window of at most kCells cells over them by
//    splat_window.cuh:place_window, the rule of K2's, K8's and K3's
//    scatters, so ops/splat.py:dense_window_misses counts K6a's misses on
//    the host (max_splat_tile_rows, _tile_cols, _window_cells report the
//    geometry).
//  * P3: each corner in the window takes its max of inp * w in its window
//    cell in shared memory: the float's bits mapped to an int of the same
//    order (max_key), so that the max is one native shared-memory integer
//    max; a corner outside the window is reduced into out alone. Then each
//    window cell that a corner reached is reduced into out once with
//    atomic_max_f32 (RED.MAX / RED.MIN on the float's bits) and emptied.
//    PTX has no f32 max reduction (ptxas refuses red.global.max.f32 and
//    .v4.f32: .max takes integers, f16 and bf16 only), so the flush stays
//    scalar. Max is exact and order-free, so taking it first in shared
//    memory changes no bit: the result is the per-corner atomics' result.
//  Corners off the grid, all four of the Euler sentinel max(H, W) + 1
//  included, are in no cell; cells that nothing reaches keep -1000.
// Above one channel the scatter is a thread a (pixel, channel) and one
// atomic max a corner in the grid. A window design there (a block of 8
// warps a tile, a 32-channel chunk a cell) was timed at (1, 256, 256, 65)
// and lost to it by ~3 % (PERF.md §6), and no caller of the port sends
// C > 1, so the simpler kernel stays.
//
// K6b design: one launch, no atomics. A warp takes a run of consecutive
// pixels: their corners are computed once for all C channels (a lane a
// pixel) and the flow is read once. At one channel the run is 32 pixels,
// and a lane issues its four gathers and its init load before its maxes.
// Above, the run is about 256 floats' worth of pixels (many short warps in
// flight), the corners go to shared memory and the lanes go over the run's
// contiguous floats: each load of init, of a corner's run of maxmap and
// each store of out covers 128 contiguous bytes a warp. (16-byte loads per
// lane over each pixel's run, as splat_window.cuh's P3 addresses a run,
// were slower here: a corner's run starts at another phase than its
// pixel's whenever C is not a multiple of 4, so most of them fell back to
// scalar loads.) It indexes pixels with int.
//
// Limits, each refused with cudaErrorInvalidValue (the wrapper raises): at
// one channel K6a takes B <= 65535 and ceil(H / 8) <= 65535; K6b takes
// B H W <= INT_MAX - 31.
//
// Each entry returns the launch's error or cudaGetLastError(); no
// fallback: the wrapper raises.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "maxwarp_corners.cuh"
#include "splat_window.cuh"  // place_window, isqrt

namespace {

using maxwarp::atomic_max_f32;
using maxwarp::Corners;
using maxwarp::corners_of;
using maxwarp::in_grid;
using maxwarp::kNegInit;

// K6a at one channel: the tile of source pixels (a warp's, kRows a lane:
// the lanes are two rows of kTileX pixels, a lane's rows two apart) and the
// cells of its window. K6b: the warps of a block.
constexpr int kTileY = 8;
constexpr int kTileX = 16;
constexpr int kRows = kTileY / 2;
constexpr int kCells = 256;
constexpr int kWarps1 = 4;  // K6a's warps a block at one channel, a tile each
constexpr int kGatherWarps = 8;
constexpr int kThreads = 256;  // the fill's, and K6a's above one channel
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kMaxGridYZ = 65535;

int blocks_for(long long n, int per_block) {
  const long long need = (n + per_block - 1) / per_block;
  return (int)(need < kMaxBlocks ? need : kMaxBlocks);
}

// A float's bits as an int whose order is the float order (NaN aside):
// the window's max is one native shared-memory integer max (ATOMS.MAX).
__device__ __forceinline__ int max_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}
// no corner reached the window cell: -inf's key
constexpr int kEmpty = (int)(0xff800000u ^ 0x7fffffffu);

// ---- K6a --------------------------------------------------------------

// out[0, n) = -1000; out 16-byte aligned when `quads`: 16-byte stores, then
// the tail. The scatter kernel, launched as its programmatic dependent,
// starts at once: its loads and corners overlap the fill, and it waits for
// the fill's stores (griddepcontrol.wait) before its own.
__global__ void __launch_bounds__(kThreads)
max_splat_fill_kernel(float* __restrict__ out, long long n, bool quads) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nq = quads ? n >> 2 : 0;
  const float4 q = make_float4(kNegInit, kNegInit, kNegInit, kNegInit);
  for (long long i = first; i < nq; i += stride) reinterpret_cast<float4*>(out)[i] = q;
  for (long long i = 4 * nq + first; i < n; i += stride) out[i] = kNegInit;
}

struct SplatArgs {
  const float* inp;
  const float2* flow;
  float* out;
  int H, W;
};

// Each of c's corners k (bit k of `in`: in the grid) gets its cell of
// window w, -1 outside the window, -2 off the grid.
__device__ __forceinline__ void window_slots(const Corners& c, unsigned in,
                                             const splat_window::Window& w, int slot[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dx = c.x0 + (k & 1) - w.ox, dy = c.y0 + (k >> 1) - w.oy;
    slot[k] = !(in >> k & 1u)                                     ? -2
              : dx >= 0 && dx < w.lw && dy >= 0 && dy < w.rows ? dy * w.lw + dx
                                                                : -1;
  }
}

// One channel: the window max-scatter of one tile (tile column tx, tile
// row ty, sample b) by one warp into out (filled with -1000 before); `win`
// is the warp's kCells ints of shared memory, all kEmpty, and left so.
__device__ __forceinline__ void max_splat_tile(const SplatArgs& a, int* win, int tx, int ty,
                                               int b) {
  const int lane = threadIdx.x & 31;
  const int H = a.H, W = a.W;
  const int x0 = tx * kTileX, y0 = ty * kTileY;
  if (x0 >= W) return;  // the same for every lane
  // ---- P1: corners and weights once, the values loaded beside the flow;
  // the box, coordinate sums and count of the tile's in-grid corners
  const int x = x0 + lane % kTileX;
  Corners c[kRows];
  float v[kRows];
  unsigned in[kRows];
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN, sx = 0, sy = 0, n = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y0 + lane / kTileX + 2 * j;
    const bool live = y < H && x < W;
    const long long pix = ((long long)b * H + y) * W + x;
    c[j] = Corners{0, 0, {0.0f, 0.0f, 0.0f, 0.0f}};
    v[j] = 0.0f;
    if (live) {
      const float2 d = __ldg(&a.flow[pix]);
      v[j] = __ldg(&a.inp[pix]);
      c[j] = corners_of(x, y, d);
    }
    in[j] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int cx = c[j].x0 + (k & 1), cy = c[j].y0 + (k >> 1);
      if (!live || !in_grid(cx, cy, H, W)) continue;
      in[j] |= 1u << k;
      bx0 = min(bx0, cx);
      bx1 = max(bx1, cx);
      by0 = min(by0, cy);
      by1 = max(by1, cy);
      sx += cx;
      sy += cy;
      ++n;
    }
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (n == 0) return;  // the same for every lane
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  by1 = __reduce_max_sync(0xffffffffu, by1);
  sx = __reduce_add_sync(0xffffffffu, sx);
  sy = __reduce_add_sync(0xffffffffu, sy);

  // ---- P2: the window (splat_window.cuh's rule); each corner's cell
  const splat_window::Window w = splat_window::place_window(
      bx0, bx1, by0, by1, sx, sy, n, kCells, splat_window::isqrt(kCells));
  int slot[kRows][4];
#pragma unroll
  for (int j = 0; j < kRows; ++j) window_slots(c[j], in[j], w, slot[j]);

  // ---- P3: each corner's max into its window cell, or, outside the
  // window, into out alone; then each reached cell into out once. The
  // fill before this kernel must be done (a no-op where it was launched
  // without a programmatic dependency).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float* grid = a.out + (size_t)b * H * W;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float m = v[j] * c[j].w[k];
      if (slot[j][k] >= 0) {
        atomicMax(&win[slot[j][k]], max_key(m));
      } else if (slot[j][k] == -1) {
        atomic_max_f32(&grid[(long long)(c[j].y0 + (k >> 1)) * W + c[j].x0 + (k & 1)], m);
      }
    }
  }
  __syncwarp();
  // lanes over the window's cells; cell i is (wy, wx), i advancing by 32 =
  // q lw + rem
  const int q = 32 / w.lw, rem = 32 - q * w.lw;
  int wy = lane / w.lw, wx = lane - wy * w.lw;
  for (int i = lane; i < w.lw * w.rows; i += 32) {
    const int key = win[i];
    if (key != kEmpty) {  // reached
      win[i] = kEmpty;
      atomic_max_f32(&grid[(long long)(w.oy + wy) * W + w.ox + wx], key_value(key));
    }
    wy += q;
    wx += rem;
    if (wx >= w.lw) {
      wx -= w.lw;
      ++wy;
    }
  }
  __syncwarp();
}

// One channel: kWarps1 warps a block, a tile a warp; grid (tile columns /
// kWarps1, tile rows, samples). (Walking samples and tile rows past the
// grid's 65535 made the scatter ~10 % slower at 768^2, PERF.md §6.)
__global__ void __launch_bounds__(kWarps1 * 32) max_splat_window_kernel(SplatArgs a) {
  __shared__ int win_all[kWarps1][kCells];
  int* win = win_all[threadIdx.x >> 5];
  for (int i = threadIdx.x & 31; i < kCells; i += 32) win[i] = kEmpty;
  __syncwarp();
  max_splat_tile(a, win, blockIdx.x * kWarps1 + (threadIdx.x >> 5), blockIdx.y, blockIdx.z);
}

// Above one channel: a thread a (pixel, channel), one atomic max into out
// a corner in the grid.
__global__ void __launch_bounds__(kThreads)
max_splat_kernel(const float* __restrict__ inp, const float2* __restrict__ flow,
                 float* __restrict__ out, long long n, int H, int W, int C) {
  const long long HW = (long long)H * W;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const long long p = i / C;
    const int k = (int)(i - p * C);
    const long long base = p / HW * HW;  // the sample's first pixel
    const int r = (int)(p - base);
    const int y = r / W;
    const Corners c = corners_of(r - y * W, y, flow[p]);
    const float v = inp[i];
    asm volatile("griddepcontrol.wait;" ::: "memory");  // the fill is done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cx = c.x0 + (j & 1), cy = c.y0 + (j >> 1);
      if (in_grid(cx, cy, H, W))
        atomic_max_f32(&out[(base + (long long)cy * W + cx) * C + k], v * c.w[j]);
    }
  }
}

// ---- K6b --------------------------------------------------------------

// A warp takes `ppw` consecutive pixels of the (B, H, W) grid (one a lane
// for the corners) and the ppw C contiguous floats of their runs.
__global__ void __launch_bounds__(kGatherWarps * 32)
inverse_max_gather_run_kernel(const float* __restrict__ maxmap, const float2* __restrict__ flow,
                              const float* __restrict__ init, float* __restrict__ out, int n_px,
                              int H, int W, int C, int ppw) {
  __shared__ int4 corner_all[kGatherWarps][32];  // the corners' pixels, -1 off the grid
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int4* corner = corner_all[warp];
  const int HW = H * W;
  const int n_warps = (n_px + ppw - 1) / ppw;
  for (int g = blockIdx.x * kGatherWarps + warp; g < n_warps; g += gridDim.x * kGatherWarps) {
    const int p = g * ppw + lane;
    const bool live = lane < ppw && p < n_px;
    int off[4] = {-1, -1, -1, -1};
    float v = 0.0f;
    if (live) {
      const float2 d = __ldg(&flow[p]);
      if (C == 1) v = __ldg(&init[p]);
      const int b = p / HW;
      const int r = p - b * HW;
      const int y = r / W;
      const Corners c = corners_of(r - y * W, y, d);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int cx = c.x0 + (k & 1), cy = c.y0 + (k >> 1);
        if (in_grid(cx, cy, H, W)) off[k] = b * HW + cy * W + cx;
      }
    }
    if (C == 1) {  // a lane's four gathers issued before its maxes
      if (live) {
        float m[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) m[k] = off[k] >= 0 ? __ldg(&maxmap[off[k]]) : 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (off[k] >= 0) v = fmaxf(v, m[k]);
        out[p] = v;
      }
      continue;
    }
    corner[lane] = make_int4(off[0], off[1], off[2], off[3]);
    __syncwarp();
    // lanes over the warp's contiguous floats: element e is channel ch of
    // pixel i; e advances by 32 = q C + rem
    const long long base = (long long)g * ppw * C;
    const int n_el = min(n_px - g * ppw, ppw) * C;
    const int q = 32 / C, rem = 32 - q * C;
    int i = lane / C, ch = lane - i * C;
    for (int e = lane; e < n_el; e += 32) {
      const int4 o = corner[i];
      float t = __ldg(&init[base + e]);
      if (o.x >= 0) t = fmaxf(t, __ldg(&maxmap[(long long)o.x * C + ch]));
      if (o.y >= 0) t = fmaxf(t, __ldg(&maxmap[(long long)o.y * C + ch]));
      if (o.z >= 0) t = fmaxf(t, __ldg(&maxmap[(long long)o.z * C + ch]));
      if (o.w >= 0) t = fmaxf(t, __ldg(&maxmap[(long long)o.w * C + ch]));
      out[base + e] = t;
      i += q;
      ch += rem;
      if (ch >= C) {
        ch -= C;
        ++i;
      }
    }
    __syncwarp();
  }
}

// pixels a warp of K6b takes: 32 at one channel; above, about 256 floats'
// worth, so that a warp's loop is short and many warps are in flight
int gather_ppw(int C) {
  if (C == 1) return 32;
  const int ppw = 256 / C;
  return ppw < 1 ? 1 : ppw > 32 ? 32 : ppw;
}

}  // namespace

// inp (B, H, W, C) f32, flow (B, H, W, 2) f32; writes out (B, H, W, C) f32
// (filled with -1000 first). At one channel B and the rows of tiles,
// ceil(H / 8), are at most 65535 (the launch grid's y and z).
extern "C" int max_splat(const void* inp, const void* flow, void* out, int B, int H, int W,
                         int C, void* stream) {
  const long long n = (long long)B * H * W * C;
  if (n == 0) return 0;
  const int tiles_y = (H + kTileY - 1) / kTileY, tiles_x = (W + kTileX - 1) / kTileX;
  if (C == 1 && (tiles_y > kMaxGridYZ || B > kMaxGridYZ)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool quads = ((uintptr_t)out & 15) == 0;
  max_splat_fill_kernel<<<blocks_for(quads ? (n + 3) / 4 : n, kThreads), kThreads, 0, s>>>(
      (float*)out, n, quads);
  // the scatter as the fill's programmatic dependent (sm_90)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (C == 1) {
    cfg.gridDim = dim3((tiles_x + kWarps1 - 1) / kWarps1, tiles_y, B);
    cfg.blockDim = dim3(kWarps1 * 32);
    const SplatArgs a = {(const float*)inp, (const float2*)flow, (float*)out, H, W};
    err = cudaLaunchKernelEx(&cfg, max_splat_window_kernel, a);
  } else {
    cfg.gridDim = dim3(blocks_for(n, kThreads));
    cfg.blockDim = dim3(kThreads);
    err = cudaLaunchKernelEx(&cfg, max_splat_kernel, (const float*)inp, (const float2*)flow,
                             (float*)out, n, H, W, C);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// maxmap, init (B, H, W, C) f32, flow (B, H, W, 2) f32; writes out
// (B, H, W, C) f32. B H W at most INT_MAX - 31.
extern "C" int inverse_max_gather(const void* maxmap, const void* flow, const void* init,
                                  void* out, int B, int H, int W, int C, void* stream) {
  const long long n_px = (long long)B * H * W;
  if (n_px * C == 0) return 0;
  if (n_px > INT_MAX - 31) return (int)cudaErrorInvalidValue;
  const int ppw = gather_ppw(C);
  inverse_max_gather_run_kernel<<<blocks_for((n_px + ppw - 1) / ppw, kGatherWarps),
                                  kGatherWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)maxmap, (const float2*)flow, (const float*)init, (float*)out, (int)n_px, H, W,
      C, ppw);
  return (int)cudaGetLastError();
}

// K6a's geometry at one channel, for the host's count of window misses
// (ops/splat.py:dense_window_misses): the tile's rows and columns and the
// window's cells. They launch nothing.
extern "C" int max_splat_tile_rows(void) { return kTileY; }
extern "C" int max_splat_tile_cols(void) { return kTileX; }
extern "C" int max_splat_window_cells(int) { return kCells; }
