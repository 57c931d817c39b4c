// K3: the dense summation splat and its gather VJP (training path).
//
// Replaces slrsfs_tpu/ops/splat.py:softsplat_sum (:139), a jax.custom_vjp
// whose forward is _splat_sum_single (:79) and whose backward is
// _splat_grad_single (:111) with _corner_weight_grads (:61), vmapped over
// the batch. Every source pixel (y, x) of sample b moves to
// (x + flow.x, y + flow.y); its C channels split bilinearly over the four
// integer neighbours (NW, NE, SW, SE) of the target; corners outside the
// grid are dropped, so cells that receive nothing stay exactly 0 (the
// decoder's hole mask is x != 0). Weights are computed in f32 from the
// flow, operation for operation as _corners does (the build disables FMA
// contraction).
//
// What bounds it on an H100: bytes. The forward reads inp and flow and
// writes out (2 * B*H*W*C*4 + B*H*W*8 bytes, ~554 MB at B = 16, 256^2,
// C = 65); the backward reads inp, flow and g and writes grad_inp and
// grad_flow (~835 MB). Both do a few flops per byte.
//
// Forward design: splat_window::scatter (splat_window.cuh), the output
// zeroed by the wrapper. A warp owns a unit, a kTileY x kTileX tile of one
// sample's pixels. Lane i computes pixel i's four corners and weights once
// (operation for operation as _corners; the build disables FMA
// contraction). A window of at most 256 cells is placed over the tile's
// corners; shared memory holds only its map from cell to entry (one int a
// cell). The corners that meet in one window cell form one entry, and a
// corner outside the window is an entry of its own. Each entry's weighted
// rows are summed in registers, lanes over (entry, 16-byte quad or scalar
// end of the cell's run of C floats), and every entry, a miss too, is
// reduced into its cell once: red.global.add.v4.f32 over the run's aligned
// middle, atomicAdd at its two ends. The tile's rows are read from device
// memory, or staged in shared memory by cp.async when inp exceeds the
// card's L2 (the training batch). Cells that receive nothing stay exactly
// 0. The order of the adds varies, so the result matches the plain version
// to ~1e-7 relative, with the same empty cells (where signed contributions
// cancel, a single element can round to exactly 0 in one order of the
// adds and not in another).
//
// Backward design: the gather dual of the forward's window. A warp owns a
// kBwdTileY x kBwdTileX tile of one sample's pixels, one pixel a lane, and
// computes each pixel's taps once. The tile's inp rows (kBwdTileX pixels
// of one image row are one contiguous run of floats) are staged in shared
// memory by 16-byte cp.async; grad_inp is written over them and leaves by
// 16-byte stores, grad_flow as one float2 a lane. A window is placed over
// the tile's in-grid corners by splat_window::place_window.
//  * When the window holds every corner (smooth flow), its g rows are
//    staged (one run of floats per window row) and the lanes go over
//    pixels: each lane walks its pixel's C channels, four at a time, reads
//    inp and the four corners' g from shared memory (C odd: the lanes of
//    an image row hit consecutive banks, and runs start 8 banks apart),
//    and sums grad_inp and its four inner products in registers. No
//    shuffles.
//  * Otherwise the tile goes in rounds of up to 16 pixels: each lane stages
//    whole corner rows of the round's pixels, then the lanes go over
//    (pixel, part of its channels) and the parts' inner products meet by
//    shuffles.
// Every read of g and inp is thus asynchronous and in flight at once,
// and the arithmetic reads shared memory only. grad_inp adds g * w over
// the corners in the order NW, NE, SW, SE, as the plain version does (bit
// for bit); the inner products are summed in another order, within 1e-5
// of each output's max. An out-of-grid corner reads 0.

#include <cuda_runtime.h>

#include "splat_window.cuh"

// The tile of a unit of splat_window::scatter.
constexpr int kTileY = 4;
constexpr int kTileX = 4;

// The pixels of inp (B, H, W, C) as units of splat_window::scatter: unit
// (b * tiles_y + ty) * tiles_x + tx is tile (ty, tx) of sample b.
struct DenseSource {
  static constexpr int kItems = kTileY * kTileX;
  static constexpr bool kScaled = false;  // the weights multiply inp itself
  const float* inp;
  const float2* flow;
  float* out;
  int B, H, W, C, tiles_y, tiles_x;

  __device__ int units() const { return B * tiles_y * tiles_x; }
  __device__ float scale(int) const { return 1.0f; }
  __device__ int items(int) const { return kTileY * kTileX; }
  __device__ bool item(int unit, int i, splat_window::Item& it) const {
    const int per_sample = tiles_y * tiles_x;
    const int b = unit / per_sample;
    const int tile = unit - b * per_sample;
    const int ty = tile / tiles_x;
    const int y = ty * kTileY + i / kTileX;
    const int x = (tile - ty * tiles_x) * kTileX + i % kTileX;
    if (y >= H || x >= W) return false;
    const size_t pix = ((size_t)b * H + y) * W + x;
    const float2 f = __ldg(&flow[pix]);
    it.row = inp + pix * C;
    it.ox = (float)x + f.x;
    it.oy = (float)y + f.y;
    return true;
  }
  __device__ float* grid(int unit) const {
    return out + (size_t)(unit / (tiles_y * tiles_x)) * H * W * C;
  }
};

// kStage: the rows staged in shared memory (inp larger than L2: the
// training batch) or read from L2 (the dense render's one frame end).
template <bool kStage>
__global__ void __launch_bounds__(splat_window::kGroups * 32)
    splat_dense_fwd_kernel(DenseSource src) {
  splat_window::scatter<kStage>(src, src.H, src.W, src.C);
}

template <bool kStage>
static cudaError_t dense_fwd(const DenseSource& src, long long units, cudaStream_t s) {
  unsigned blocks = 0;
  size_t smem = 0;
  cudaError_t err = splat_window::launch_shape<DenseSource::kItems, kStage>(
      splat_dense_fwd_kernel<kStage>, src.C, units, &blocks, &smem);
  if (err != cudaSuccess) return err;
  splat_dense_fwd_kernel<kStage><<<blocks, splat_window::kGroups * 32, smem, s>>>(src);
  return cudaGetLastError();
}

// inp (B, H, W, C) f32, flow (B, H, W, 2) f32; adds the splat into out
// (B, H, W, C) f32, which the caller zeroes.
extern "C" int splat_dense_fwd(const void* inp, const void* flow, void* out,
                               int B, int H, int W, int C, void* stream) {
  const DenseSource src = {(const float*)inp, (const float2*)flow, (float*)out, B, H, W, C,
                           (H + kTileY - 1) / kTileY, (W + kTileX - 1) / kTileX};
  const long long units = (long long)B * src.tiles_y * src.tiles_x;
  if (units == 0 || C == 0) return (int)cudaGetLastError();
  if (H >= 32768 || W >= 32768) return (int)cudaErrorInvalidValue;
  bool stage = false;
  cudaError_t err = splat_window::stage_rows((size_t)B * H * W * C * sizeof(float), &stage);
  if (err == cudaSuccess)
    err = stage ? dense_fwd<true>(src, units, (cudaStream_t)stream)
                : dense_fwd<false>(src, units, (cudaStream_t)stream);
  return (int)err;
}

// The forward's geometry, for the host's count of window misses
// (ops/splat.py:dense_window_misses): the tile's rows and columns and the
// window's cells. They launch nothing.
extern "C" int splat_dense_tile_rows(void) { return kTileY; }
extern "C" int splat_dense_tile_cols(void) { return kTileX; }
extern "C" int splat_dense_window_cells(void) { return splat_window::kMapCells; }

// ---- backward -----------------------------------------------------------

// The backward's tile (one pixel a lane; a block is one warp), the most
// cells a window holds, and the floats of shared memory a warp aims at: its
// staged inp rows and its pool (the window's g rows, or a round's corner
// rows) fill them; a wide C shrinks the window, to none, and the rounds.
// Eight such warps fit an SM.
constexpr int kBwdTileY = 4;
constexpr int kBwdTileX = 8;
constexpr int kBwdMaxCells = 64;
constexpr int kBwdWarpFloats = 6912;
// The floats a window row may add beyond its data when padded: its phase
// (<= 3), the multiple of 4 and the bank offset; rows padded at most.
constexpr int kRowPad = 37;
constexpr int kPaddedRows = 8;

// Floats of shared memory for a run of n floats staged at any phase: a
// multiple of 4, padded so that the next run starts 8 banks further on.
__host__ __device__ inline int run_stride(int n) {
  const int s = (n + 6) & ~3;
  return s + ((8 - s) & 31);
}

// Floats of one staged corner row of C channels, at any phase.
__host__ __device__ inline int row_stride(int C) { return (C + 6) & ~3; }

__host__ __device__ inline int bwd_tile_floats(int C) {
  return kBwdTileY * run_stride(kBwdTileX * C);
}

__host__ __device__ inline int bwd_budget(int C) { return kBwdWarpFloats - bwd_tile_floats(C); }

// Window cells of a warp for C channels: rows of at most kPaddedRows runs
// take run_stride, taller windows (lw * C + 3) rounded to 4 floats.
__host__ __device__ inline int bwd_window_cells(int C) {
  const int spare = bwd_budget(C) - kPaddedRows * kRowPad;
  const int cells = spare > 0 ? spare / (C + 6) : 0;
  return cells < kBwdMaxCells ? cells : kBwdMaxCells;
}

// Pixels of one round of a tile with a miss: 16, or fewer where their 4
// corner rows each exceed the budget (at least 1).
__host__ __device__ inline int bwd_round_pixels(int C) {
  int p = 16;
  while (p > 1 && 4 * p * row_stride(C) > bwd_budget(C)) p >>= 1;
  return p;
}

__host__ __device__ inline int bwd_pool_floats(int C) {
  const int cap = bwd_window_cells(C);
  const int win = cap > 0 ? cap * (C + 6) + kPaddedRows * kRowPad : 0;
  const int rows = 4 * bwd_round_pixels(C) * row_stride(C);
  return win > rows ? win : rows;
}

__host__ __device__ inline int bwd_warp_floats(int C) {
  return (bwd_tile_floats(C) + bwd_pool_floats(C) + 3) & ~3;
}

__device__ __forceinline__ int phase_of(const float* p) { return (int)(((uintptr_t)p >> 2) & 3); }

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The pieces of a run of n floats whose first float has phase ph: `head`
// scalars, `quads` 16-byte quads, then scalars; piece i starts at float
// piece_at(i) of the run.
struct Pieces {
  int head, quads, count;
  __device__ Pieces(int ph, int n) {
    head = splat_window::imin((4 - ph) & 3, n);
    quads = (n - head) >> 2;
    count = n - 3 * quads;
  }
  __device__ bool quad(int i) const { return i >= head && i < head + quads; }
  __device__ int at(int i) const {
    return quad(i) ? head + 4 * (i - head) : (i < head ? i : i + 3 * quads);
  }
};

// Copies src[0, n) into dst[ph, ph + n), ph = src's phase (its float offset
// modulo 16 bytes), dst 16-byte aligned: the pieces first, first + step,
// ... (the lanes of a warp share a run with (lane, 32); a lane copies a
// row of its own with (0, 1)).
__device__ __forceinline__ void stage_run(float* dst, const float* src, int n, int first,
                                          int step) {
  const int ph = phase_of(src);
  const Pieces pc(ph, n);
  for (int i = first; i < pc.count; i += step) {
    const int j = pc.at(i);
    if (pc.quad(i))
      copy16_async(dst + ph + j, src + j);
    else
      splat_window::copy4_async(dst + ph + j, src + j);
  }
}

// Stores src[ph, ph + n) (shared, staged by stage_run at phase ph) to
// dst[0, n): 16-byte stores where dst has the same phase, else scalars.
__device__ __forceinline__ void store_run(float* dst, const float* src, int ph, int n,
                                          int lane) {
  if (phase_of(dst) != ph) {
    for (int j = lane; j < n; j += 32) dst[j] = src[ph + j];
    return;
  }
  const Pieces pc(ph, n);
  for (int i = lane; i < pc.count; i += 32) {
    const int j = pc.at(i);
    if (pc.quad(i))
      *reinterpret_cast<float4*>(dst + j) = *reinterpret_cast<const float4*>(src + ph + j);
    else
      dst[j] = src[ph + j];
  }
}

// One pixel's channels [c0, c1) from shared memory: row holds its inp and
// receives grad_inp = sum_k g_k * w_k (k in the order NW, NE, SW, SE; g_k
// read from gk[k] where hv[k], else 0); inner[k] += sum_c inp * g_k. Four
// channels a step, their loads first.
__device__ __forceinline__ void gather_pixel(float* row, const float* const* gk, const bool* hv,
                                             const float* w, int c0, int c1, float* inner) {
  int c = c0;
  for (; c + 4 <= c1; c += 4) {
    float x[4], g[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = row[c + u];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int u = 0; u < 4; ++u) g[k][u] = hv[k] ? gk[k][c + u] : 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc = acc + g[k][u] * w[k];
        inner[k] = inner[k] + x[u] * g[k][u];
      }
      row[c + u] = acc;
    }
  }
  for (; c < c1; ++c) {
    const float x = row[c];
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float g = hv[k] ? gk[k][c] : 0.0f;
      acc = acc + g * w[k];
      inner[k] = inner[k] + x * g;
    }
    row[c] = acc;
  }
}

struct BwdArgs {
  const float* inp;
  const float2* flow;
  const float* g;
  float* grad_inp;
  float2* grad_flow;
  int B, H, W, C, tiles_y, tiles_x, cap, round_pixels;
};

__global__ void __launch_bounds__(32) splat_dense_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float buf[];  // the tile's rows, then g rows
  const int lane = threadIdx.x;
  const int per_sample = a.tiles_y * a.tiles_x;
  const long long unit = blockIdx.x;
  const int H = a.H, W = a.W, C = a.C;
  float* pool = buf + bwd_tile_floats(C);
  const int b = (int)(unit / per_sample);
  const int tile = (int)(unit - (long long)b * per_sample);
  const int y0 = (tile / a.tiles_x) * kBwdTileY;
  const int x0 = (tile % a.tiles_x) * kBwdTileX;
  const int ny = splat_window::imin(kBwdTileY, H - y0);
  const int nx = splat_window::imin(kBwdTileX, W - x0);
  const int py = lane / kBwdTileX, px = lane % kBwdTileX;
  const bool live = py < ny && px < nx;
  const size_t sample = (size_t)b * H * W;
  const float* g_b = a.g + sample * C;
  const int tstride = run_stride(kBwdTileX * C);

  // the tile's inp rows into shared memory
  for (int r = 0; r < ny; ++r)
    stage_run(buf + r * tstride, a.inp + (sample + (size_t)(y0 + r) * W + x0) * C, nx * C, lane,
              32);

  // taps, operation for operation as _corners and _corner_weight_grads
  float w[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dwdx[4] = {0.0f, 0.0f, 0.0f, 0.0f},
        dwdy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cx[4] = {0, 0, 0, 0}, cy[4] = {0, 0, 0, 0};
  int cell[4] = {-1, -1, -1, -1};  // in the grid: the corner's cell of the sample
  if (live) {
    const float2 f = __ldg(&a.flow[sample + (size_t)(y0 + py) * W + x0 + px]);
    const float ox = (float)(x0 + px) + f.x;
    const float oy = (float)(y0 + py) + f.y;
    const float x0f = floorf(ox);
    const float y0f = floorf(oy);
    const float dx = ox - x0f;
    const float dy = oy - y0f;
    const int ix = (int)x0f, iy = (int)y0f;
    w[0] = (1.0f - dx) * (1.0f - dy);
    w[1] = dx * (1.0f - dy);
    w[2] = (1.0f - dx) * dy;
    w[3] = dx * dy;
    dwdx[0] = -(1.0f - dy);
    dwdx[1] = 1.0f - dy;
    dwdx[2] = -dy;
    dwdx[3] = dy;
    dwdy[0] = -(1.0f - dx);
    dwdy[1] = -dx;
    dwdy[2] = 1.0f - dx;
    dwdy[3] = dx;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cx[k] = ix + (k & 1);
      cy[k] = iy + (k >> 1);
      if (cx[k] >= 0 && cx[k] < W && cy[k] >= 0 && cy[k] < H) cell[k] = cy[k] * W + cx[k];
    }
  }

  // the window over the in-grid corners, as the forward places it
  int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN, sx = 0, sy = 0, n = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cell[k] >= 0) {
      bx0 = min(bx0, cx[k]);
      bx1 = max(bx1, cx[k]);
      by0 = min(by0, cy[k]);
      by1 = max(by1, cy[k]);
      sx += cx[k];
      sy += cy[k];
      ++n;
    }
  }
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  by1 = __reduce_max_sync(0xffffffffu, by1);
  sx = __reduce_add_sync(0xffffffffu, sx);
  sy = __reduce_add_sync(0xffffffffu, sy);
  n = __reduce_add_sync(0xffffffffu, n);
  splat_window::Window wd = {0, 0, 0, 0};
  if (n > 0 && a.cap > 0)
    wd = splat_window::place_window(bx0, bx1, by0, by1, sx, sy, n, a.cap,
                                    splat_window::isqrt(a.cap));
  int hits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int u = cx[k] - wd.ox, v = cy[k] - wd.oy;
    hits += cell[k] >= 0 && u >= 0 && u < wd.lw && v >= 0 && v < wd.rows;
  }
  hits = __reduce_add_sync(0xffffffffu, hits);

  float inner[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (hits == n) {
    // every corner in the window: stage it, lanes over pixels
    const int wstride = wd.rows <= kPaddedRows ? run_stride(wd.lw * C) : (wd.lw * C + 6) & ~3;
    const float* g_win = g_b + ((size_t)wd.oy * W + wd.ox) * C;  // the window's origin
    for (int r = 0; r < wd.rows; ++r)
      stage_run(pool + r * wstride, g_win + (size_t)r * W * C, wd.lw * C, lane, 32);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    if (live) {
      const float* gk[4];
      bool hv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = cx[k] - wd.ox, v = cy[k] - wd.oy;
        hv[k] = cell[k] >= 0;
        gk[k] = pool + (hv[k] ? v * wstride + phase_of(g_win + (size_t)v * W * C) + u * C : 0);
      }
      const int ph = phase_of(a.inp + (sample + (size_t)(y0 + py) * W + x0) * C);
      gather_pixel(buf + py * tstride + ph + px * C, gk, hv, w, 0, C, inner);
    }
  } else {
    // a corner outside the window: rounds of P pixels, each pixel's corner
    // rows staged one by one, lanes over (pixel, part of its channels)
    asm volatile("cp.async.wait_all;" ::: "memory");
    const int P = a.round_pixels;
    const int parts = 32 / P;
    const int rs = row_stride(C);
    const int p = lane % P, q = lane / P;
    const int span = (C + parts - 1) / parts;
    const int c0 = splat_window::imin(q * span, C), c1 = splat_window::imin(c0 + span, C);
    for (int r = 0; r < parts; ++r) {
      __syncwarp();  // the pool is free
      for (int base = 0; base < 4 * P; base += 32) {  // row idx: corner idx / P of pixel idx % P
        const int idx = base + lane, k = idx / P;
        int cl[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) cl[j] = __shfl_sync(0xffffffffu, cell[j], r * P + idx % P);
        const int c = k == 0 ? cl[0] : k == 1 ? cl[1] : k == 2 ? cl[2] : cl[3];
        if (idx < 4 * P && c >= 0) stage_run(pool + idx * rs, g_b + (size_t)c * C, C, 0, 1);
      }
      asm volatile("cp.async.wait_all;" ::: "memory");
      __syncwarp();
      const int i = r * P + p;  // the lane's pixel this round
      float wi[4], part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const float* gk[4];
      bool hv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wi[k] = __shfl_sync(0xffffffffu, w[k], i);
        const int c = __shfl_sync(0xffffffffu, cell[k], i);
        hv[k] = c >= 0;
        gk[k] = pool + (p + P * k) * rs + (hv[k] ? phase_of(g_b + (size_t)c * C) : 0);
      }
      const int iy = i / kBwdTileX, ix = i % kBwdTileX;
      if (iy < ny && ix < nx) {
        const int ph = phase_of(a.inp + (sample + (size_t)(y0 + iy) * W + x0) * C);
        gather_pixel(buf + iy * tstride + ph + ix * C, gk, hv, wi, c0, c1, part);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        for (int off = P; off < 32; off <<= 1)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
        if (q == r) inner[k] = part[k];  // lane r * P + p owns pixel i
      }
    }
  }
  if (live) {
    float gx = 0.0f, gy = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gx = gx + inner[k] * dwdx[k];
      gy = gy + inner[k] * dwdy[k];
    }
    a.grad_flow[sample + (size_t)(y0 + py) * W + x0 + px] = make_float2(gx, gy);
  }
  __syncwarp();
  for (int r = 0; r < ny; ++r) {
    const size_t at = (sample + (size_t)(y0 + r) * W + x0) * C;
    store_run(a.grad_inp + at, buf + r * tstride, phase_of(a.inp + at), nx * C, lane);
  }
}

// inp, flow as above, g (B, H, W, C) f32 the output's cotangent; writes
// grad_inp (B, H, W, C) and grad_flow (B, H, W, 2), both f32. A C whose
// staged tile rows do not fit a block's shared memory is refused
// (cudaErrorInvalidValue; C above ~1700).
extern "C" int splat_dense_bwd(const void* inp, const void* flow,
                               const void* g, void* grad_inp, void* grad_flow,
                               int B, int H, int W, int C, void* stream) {
  const int tiles_y = (H + kBwdTileY - 1) / kBwdTileY;
  const int tiles_x = (W + kBwdTileX - 1) / kBwdTileX;
  const long long units = (long long)B * tiles_y * tiles_x;
  if (units == 0 || C == 0) return (int)cudaGetLastError();
  if (H >= 32768 || W >= 32768 || units > INT_MAX) return (int)cudaErrorInvalidValue;
  const BwdArgs args = {(const float*)inp, (const float2*)flow, (const float*)g,
                        (float*)grad_inp, (float2*)grad_flow, B, H, W, C, tiles_y, tiles_x,
                        bwd_window_cells(C), bwd_round_pixels(C)};
  const size_t smem = (size_t)bwd_warp_floats(C) * sizeof(float);
  static int dev_seen = -1, c_seen = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != dev_seen || C != c_seen) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)most) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(splat_dense_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dev_seen = dev;
    c_seen = C;
  }
  splat_dense_bwd_kernel<<<(unsigned)units, 32, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// The backward's geometry, for the host's count of window misses
// (ops/splat.py:dense_window_misses, dense_window_units): the tile's rows
// and columns and the window's cells for C channels. They launch nothing.
extern "C" int splat_dense_bwd_tile_rows(void) { return kBwdTileY; }
extern "C" int splat_dense_bwd_tile_cols(void) { return kBwdTileX; }
extern "C" int splat_dense_bwd_window_cells(int C) { return bwd_window_cells(C); }
