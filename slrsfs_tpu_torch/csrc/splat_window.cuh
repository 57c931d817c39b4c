// The tile-and-window splat scatter shared by K2 and K8 (csrc/splat.cu,
// packed rows, f32) and K3's forward (csrc/splat_dense.cu, dense pixels, f32
// rows or, in its bf16 mode, bf16 rows and a bf16 grid).
//
// An f32 splat adds, for every source item (a packed row or a pixel), its
// C channels times each bilinear weight into the four integer neighbours
// of its target; corners off the grid are dropped. Done as one f32
// reduction per (item, channel, corner) into device memory (14.1 M of
// them a frame in K2 at 256^2), the card's L2 spends its
// time on the reductions. Neighbouring items land on neighbouring cells,
// so the corners of a unit of items that meet in one cell are summed
// first, and each such cell is then reduced into device memory once, 16
// bytes at a time:
//
//  * A warp owns a unit of up to Src::kItems <= 32 items (K2: a run of
//    consecutive packed rows of one end; K3: a 2-D tile of one sample).
//    The warps are persistent and walk over the units; a block's warps
//    share nothing.
//  * (P1) Lane i computes item i's four corners and weights once, in f32,
//    operation for operation as the JAX _corners does (the build keeps
//    -fmad=false), into shared memory; warp reductions give the bounding
//    box and the coordinate sums of the unit's in-grid corners. Where the
//    rows stream from HBM (kStage), they are copied into shared memory
//    meanwhile (cp.async), so each is read from device memory once.
//  * (P2) The window, a rectangle of at most kMapCells cells, is placed by
//    place_window: the bounding box when it fits, else a box about
//    isqrt(kMapCells) on a side, widened where the bounding box is narrow,
//    centred on the mean corner and clamped into the bounding box. The
//    window is a map from cell to entry: the corners in one window cell
//    form one entry, each corner outside the window (divergent flow, a
//    box larger than the window) an entry of its own. A count per cell,
//    a warp scan over the entries and a pass over the corners list each
//    entry's corners.
//  * (P3) Each entry is flushed once: its cell's C channels are one
//    contiguous run in the NHWC grid; the lanes take (entry, op) pairs, an
//    op a quad of the run's 16-byte aligned middle or a scalar at its two
//    ends, sum the entry's corners' (row * scale) * weight in registers
//    and reduce the quad with one red.global.add.v4.f32 (sm_90) or the
//    scalar with atomicAdd: a touched cell costs C / 4 reductions instead
//    of C per corner. Corners off the grid (the OOB sentinel
//    max(H, W) + 1 puts all four there) are in no entry, and cells that no
//    corner reaches receive nothing, so they keep their value exactly (the
//    decoders' hole mask is x != 0).
//
// The sums agree with the plain version to rounding: an entry sums its
// corners in the order they were counted, then lands on the grid in one
// more add. place_window is repeated on the host by
// slrsfs_tpu_torch/ops/splat.py:place_windows, which counts the corners
// that miss their window from the displacements alone.
//
// bf16 rows and grid (a source whose `Elem` is __nv_bfloat16; K3's bf16
// mode): the same units, window and entries, the rows read from device
// memory. An entry's sum is taken in f32 registers (the weights f32, each
// row element widened exactly, fused multiply-adds), then rounded once to
// bf16 and added into its cell with bf16 reductions (rounded to nearest
// even), one red.global.add.noftz.v4.bf16x2 for each 16-byte line that the
// cell's run of C bf16 touches: an odd C starts every other run 2 bytes
// into a word, so a line's elements outside the run (the neighbouring
// cells') receive +0, which leaves them as they are (a cell is never -0:
// it starts at +0, and an add rounds an exact zero sum to +0). A line
// that would reach outside the grid's tensor is added element by element.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "splat_quarters.cuh"  // bf16, pack_bf16x2

namespace splat_window {

// The window's cells (its map from cell to entry is one int each) and the
// warps of a block. Whether a unit's rows are staged in shared memory is
// the kernel's template parameter kStage: staged (cp.async), each row is
// read from device memory once, which pays where the rows stream from HBM;
// read in P3 from device memory (through L1), a warp needs less shared
// memory and more warps fit an SM, which pays where the rows sit in L2.
constexpr int kMapCells = 256;
constexpr int kGroups = 4;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int isqrt(int n) {
  int s = 0;
  while ((s + 1) * (s + 1) <= n) ++s;
  return s;
}

struct Window {
  int ox, oy, lw, rows;  // origin and shape; lw * rows <= cap
};

// The window of a unit whose n > 0 in-grid corners have the bounding box
// [bx0, bx1] x [by0, by1] and coordinate sums sx, sy (all >= 0), for
// cap >= 1 cells and side = isqrt(cap).
__host__ __device__ inline Window place_window(int bx0, int bx1, int by0, int by1,
                                               int sx, int sy, int n, int cap, int side) {
  Window w;
  const int bw = bx1 - bx0 + 1, bh = by1 - by0 + 1;
  w.lw = imin(bw, side);
  w.rows = imin(bh, cap / w.lw);
  w.lw = imin(bw, cap / w.rows);
  w.ox = bw <= w.lw ? bx0 : imin(imax(sx / n - w.lw / 2, bx0), bx1 - w.lw + 1);
  w.oy = bh <= w.rows ? by0 : imin(imax(sy / n - w.rows / 2, by0), by1 - w.rows + 1);
  return w;
}

// One source item: its channels `row` (C elements) and its target position.
template <class T>
struct ItemOf {
  const T* row;
  float ox, oy;
};
using Item = ItemOf<float>;

// A source's element type: Src::Elem where it names one, else float.
template <class S, class = void>
struct ElemOf {
  using type = float;
};
template <class S>
struct ElemOf<S, std::void_t<typename S::Elem>> {
  using type = typename S::Elem;
};

// Shared memory of one warp for units of kItems items, 16-byte aligned
// pieces: the items' rows (kItems x C floats); the window's count per cell
// (entry index after the scan); per entry its cell, its window cell (-1: a
// miss) and {first corner, end, cell, the cell's float offset modulo 4};
// the corners listed by entry, each {its item's row offset, its weight};
// per corner its cell (-1: off the grid), its (x, y) in 16 bits each, its
// window cell (-1: a miss, -2: off the grid), its rank in its cell (a
// miss: its entry) and its weight; per item its row in device memory.
template <int kItems, bool kStage, class T = float>
struct WarpSmem {
  static constexpr int kCorners = 4 * kItems;
  T* rows;
  int* count;
  int* entry_cell;
  int* entry_slot;
  int4* entry;
  int2* contrib;
  int* cell;
  int* xy;
  int* slot;
  int* rank;
  float* wgt;
  const T** row;
  int* n_entries;

  __host__ __device__ static size_t rows_bytes(int C) {
    return kStage ? align16((size_t)kItems * C * sizeof(T)) : 0;
  }

  __host__ __device__ static size_t bytes(int C) {
    return rows_bytes(C) + align16(kMapCells * 4) + 7 * align16(kCorners * 4) +
           align16(kCorners * 16) + align16(kCorners * 8) + align16(kItems * sizeof(void*)) + 16;
  }

  __device__ WarpSmem(unsigned char* p, int C) {
    rows = (T*)p;            p += rows_bytes(C);
    count = (int*)p;         p += align16(kMapCells * 4);
    entry_cell = (int*)p;    p += align16(kCorners * 4);
    entry_slot = (int*)p;    p += align16(kCorners * 4);
    entry = (int4*)p;        p += align16(kCorners * 16);
    contrib = (int2*)p;      p += align16(kCorners * 8);
    cell = (int*)p;          p += align16(kCorners * 4);
    xy = (int*)p;            p += align16(kCorners * 4);
    slot = (int*)p;          p += align16(kCorners * 4);
    rank = (int*)p;          p += align16(kCorners * 4);
    wgt = (float*)p;         p += align16(kCorners * 4);
    row = (const T**)p;      p += align16(kItems * sizeof(void*));
    n_entries = (int*)p;
  }
};

template <int kItems, bool kStage, class T = float>
__host__ __device__ inline size_t block_bytes(int C) {
  return kGroups * WarpSmem<kItems, kStage, T>::bytes(C);
}

__device__ __forceinline__ void red4(float* a, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

// 4 bytes from device to shared memory, asynchronously (sm_80).
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// ---- bf16 lines ------------------------------------------------------------

// line[0, 8) += acc rounded to bf16, line 16-byte aligned: one reduction,
// every element its own bf16 add.
__device__ __forceinline__ void red_line_bf16(bf16* line, const float* acc) {
  asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};" ::"l"(line),
               "r"(pack_bf16x2(acc[0], acc[1])), "r"(pack_bf16x2(acc[2], acc[3])),
               "r"(pack_bf16x2(acc[4], acc[5])), "r"(pack_bf16x2(acc[6], acc[7]))
               : "memory");
}

// One element: *dst += x rounded to bf16 (sm_90).
__device__ __forceinline__ void red_one_bf16(bf16* dst, float x) {
  asm volatile("red.global.add.noftz.bf16 [%0], %1;" ::"l"(dst),
               "h"(__bfloat16_as_ushort(__float2bfloat16_rn(x)))
               : "memory");
}

// The grid a source writes to: `Src` provides
//   static constexpr int kItems;        items of a unit, at most (<= 32)
//   static constexpr bool kScaled;      rows are scaled before the weights
//   float scale(int unit) const;        the unit's scale (when kScaled)
//   int units() const;                  the work units
//   int items(int unit) const;          items of the unit (<= kItems)
//   bool item(int unit, int i, ItemOf<Elem>&) const;  false: the item adds nothing
//   Elem* grid(int unit) const;         the (H, W, C) grid of the unit
//   using Elem = __nv_bfloat16;         optional: bf16 rows and grid, which
//   const Elem* grid_lo() const;        then also give the bounds of the
//   const Elem* grid_hi() const;        grids' tensor (kStage false)
// H and W are below 32768 (a corner's (x, y) packs into 32 bits).
template <bool kStage, class Src>
__device__ void scatter(const Src& src, int H, int W, int C) {
  using T = typename ElemOf<Src>::type;
  constexpr bool kF32 = std::is_same<T, float>::value;
  static_assert(kF32 || (std::is_same<T, bf16>::value && !Src::kScaled && !kStage),
                "f32 rows, or unscaled bf16 rows read from device memory");
  constexpr int kItems = Src::kItems;
  static_assert(kItems >= 1 && kItems <= 32, "a unit's items are one per lane");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  WarpSmem<kItems, kStage, T> s(smem + warp * WarpSmem<kItems, kStage, T>::bytes(C), C);
  const int side = isqrt(kMapCells);
  // ops of a run of C elements at its worst phase (bf16: the lines it touches)
  int max_ops = (C + 14) >> 3;
  if (kF32) {
    max_ops = 1;
    for (int d = 0; d < 4; ++d) {
      const int head = imin((4 - d) & 3, C), quads = (C - head) >> 2;
      max_ops = imax(max_ops, head + quads + (C - head - 4 * quads));
    }
  }

  for (int i = lane; i < kMapCells; i += 32) s.count[i] = 0;
  if (lane == 0) *s.n_entries = 0;
  __syncwarp();

  const int n_units = src.units();
  for (int unit = blockIdx.x * kGroups + warp; unit < n_units; unit += gridDim.x * kGroups) {
    T* __restrict__ grid = src.grid(unit);
    const int n_items = src.items(unit);
    // ---- P1: corners, weights, the unit's bounding box; the rows copied
    int bx0 = INT_MAX, bx1 = INT_MIN, by0 = INT_MAX, by1 = INT_MIN, sx = 0, sy = 0, n = 0;
    if (lane < n_items) {
      bool any = false;  // the item has a corner in the grid
      ItemOf<T> it = {nullptr, 0.0f, 0.0f};
      const bool live = src.item(unit, lane, it);
      const float x0f = floorf(it.ox);
      const float y0f = floorf(it.oy);
      const float dx = it.ox - x0f;
      const float dy = it.oy - y0f;
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const int cxs[4] = {x0, x0 + 1, x0, x0 + 1};
      const int cys[4] = {y0, y0, y0 + 1, y0 + 1};
      const float ws[4] = {(1.0f - dx) * (1.0f - dy), dx * (1.0f - dy), (1.0f - dx) * dy,
                           dx * dy};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = live && cxs[k] >= 0 && cxs[k] < W && cys[k] >= 0 && cys[k] < H;
        s.cell[4 * lane + k] = in ? cys[k] * W + cxs[k] : -1;
        s.xy[4 * lane + k] = in ? (cys[k] << 16) | cxs[k] : 0;
        s.wgt[4 * lane + k] = ws[k];
        if (in) {
          bx0 = min(bx0, cxs[k]);
          bx1 = max(bx1, cxs[k]);
          by0 = min(by0, cys[k]);
          by1 = max(by1, cys[k]);
          sx += cxs[k];
          sy += cys[k];
          ++n;
          any = true;
        }
      }
      s.row[lane] = any ? it.row : nullptr;
    }
    __syncwarp();
    if constexpr (kStage) {
      for (int i = 0; i < n_items; ++i) {
        const T* r = s.row[i];
        if (r != nullptr)
          for (int c = lane; c < C; c += 32) copy4_async(s.rows + i * C + c, r + c);
      }
    }
    bx0 = __reduce_min_sync(0xffffffffu, bx0);
    bx1 = __reduce_max_sync(0xffffffffu, bx1);
    by0 = __reduce_min_sync(0xffffffffu, by0);
    by1 = __reduce_max_sync(0xffffffffu, by1);
    sx = __reduce_add_sync(0xffffffffu, sx);
    sy = __reduce_add_sync(0xffffffffu, sy);
    n = __reduce_add_sync(0xffffffffu, n);

    // ---- P2: the window; count the corners per cell, scan, list them
    Window win = {0, 0, 0, 0};
    if (n > 0) win = place_window(bx0, bx1, by0, by1, sx, sy, n, kMapCells, side);
    if (lane < n_items) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * lane + k;
        const int cell = s.cell[c];
        int slot = -2, rank = 0;
        if (cell >= 0) {
          const int cx = (s.xy[c] & 0xffff) - win.ox;
          const int cy = (s.xy[c] >> 16) - win.oy;
          if (cx >= 0 && cx < win.lw && cy >= 0 && cy < win.rows) {
            slot = cy * win.lw + cx;
            rank = atomicAdd(&s.count[slot], 1);
            if (rank == 0) {
              const int j = atomicAdd(s.n_entries, 1);
              s.entry_cell[j] = cell;
              s.entry_slot[j] = slot;
            }
          } else {
            slot = -1;
            rank = atomicAdd(s.n_entries, 1);  // a miss: its own entry
            s.entry_cell[rank] = cell;
            s.entry_slot[rank] = -1;
          }
        }
        s.slot[c] = slot;
        s.rank[c] = rank;
      }
    }
    __syncwarp();
    const int n_ent = *s.n_entries;
    // exclusive scan of the entries' corner counts, 4 entries a lane
    int cnt[4], sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * lane + q;
      cnt[q] = j < n_ent ? (s.entry_slot[j] >= 0 ? s.count[s.entry_slot[j]] : 1) : 0;
      sum += cnt[q];
    }
    int pre = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, pre, d);
      if (lane >= d) pre += y;
    }
    pre -= sum;
    __syncwarp();
    // the grid's phase in elements of a 16-byte line
    const unsigned line = kF32 ? 3u : 7u;
    const uintptr_t grid_phase = ((uintptr_t)grid / sizeof(T)) & line;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * lane + q;
      if (j < n_ent) {
        const int cell = s.entry_cell[j];
        s.entry[j] = make_int4(pre, pre + cnt[q], cell,
                               (int)((grid_phase + (unsigned)cell * (unsigned)C) & line));
        if (s.entry_slot[j] >= 0) s.count[s.entry_slot[j]] = j;  // now the entry
      }
      pre += cnt[q];
    }
    __syncwarp();
    if (lane < n_items) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * lane + k;
        const int slot = s.slot[c];
        if (slot == -2) continue;
        const int pos = slot >= 0 ? s.entry[s.count[slot]].x + s.rank[c]
                                  : s.entry[s.rank[c]].x;
        s.contrib[pos] = make_int2(kStage ? lane * C : lane, __float_as_int(s.wgt[c]));
      }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // the window's counts back to 0
      const int j = 4 * lane + q;
      if (j < n_ent && s.entry_slot[j] >= 0) s.count[s.entry_slot[j]] = 0;
    }
    if (kStage) asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();

    // ---- P3: each entry's sums, reduced into its cell once; lanes over
    // (entry, op), an op a 16-byte quad of the run's aligned middle or a
    // scalar at its two ends (bf16: a 16-byte line of the run)
    int j = lane / max_ops, o = lane - (lane / max_ops) * max_ops;
    if constexpr (kF32) {
      const float sc = Src::kScaled ? src.scale(unit) : 1.0f;
      for (; j < n_ent;) {
        const int4 e = s.entry[j];  // {first corner, end, cell, phase}
        const int head = imin((4 - e.w) & 3, C);
        const int quads = (C - head) >> 2;
        if (o < head + quads + (C - head - 4 * quads)) {
          const bool quad = o >= head && o < head + quads;
          const int c = quad ? head + 4 * (o - head) : (o < head ? o : o + 3 * quads);
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          for (int p = e.x; p < e.y; ++p) {
            const int2 ct = s.contrib[p];  // {row offset or item, weight}
            const float w = __int_as_float(ct.y);
            const float* r = kStage ? s.rows + ct.x + c : s.row[ct.x] + c;
            if (Src::kScaled) {
              acc.x = acc.x + (r[0] * sc) * w;
              if (quad) {
                acc.y = acc.y + (r[1] * sc) * w;
                acc.z = acc.z + (r[2] * sc) * w;
                acc.w = acc.w + (r[3] * sc) * w;
              }
            } else {
              acc.x = acc.x + r[0] * w;
              if (quad) {
                acc.y = acc.y + r[1] * w;
                acc.z = acc.z + r[2] * w;
                acc.w = acc.w + r[3] * w;
              }
            }
          }
          float* dst = grid + (size_t)e.z * C + c;
          if (quad) {
            red4(dst, acc);
          } else {
            atomicAdd(dst, acc.x);
          }
        }
        for (o += 32; o >= max_ops; o -= max_ops) ++j;
      }
    } else {
      // op o of an entry: the o-th 16-byte line of its cell's run, the
      // run's elements [8 o - phase, 8 o - phase + 8)
      const T* lo = src.grid_lo();
      const T* hi = src.grid_hi();
      for (; j < n_ent;) {
        const int4 e = s.entry[j];  // {first corner, end, cell, phase}
        if (o < (e.w + C + 7) >> 3) {
          const int c0 = 8 * o - e.w;
          float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
          for (int p = e.x; p < e.y; ++p) {
            const int2 ct = s.contrib[p];  // {item, weight}
            const float w = __int_as_float(ct.y);
            const T* r = s.row[ct.x];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (c0 + u >= 0 && c0 + u < C)
                acc[u] = __fmaf_rn(__bfloat162float(r[c0 + u]), w, acc[u]);
          }
          T* line = grid + (size_t)e.z * C + c0;
          if (line >= lo && line + 8 <= hi) {
            red_line_bf16(line, acc);
          } else {
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (c0 + u >= 0 && c0 + u < C) red_one_bf16(line + u, acc[u]);
          }
        }
        for (o += 32; o >= max_ops; o -= max_ops) ++j;
      }
    }
    __syncwarp();
    if (lane == 0) *s.n_entries = 0;
    __syncwarp();
  }
}

// Sets the kernel's dynamic shared memory limit and returns the grid of
// persistent blocks for `n_units` units of kItems items (rows staged or
// not): at most the blocks the card holds at once. The card's shape is
// queried once per (kernel, device, C).
template <int kItems, bool kStage, class T = float, class Kernel>
inline cudaError_t launch_shape(Kernel kernel, int C, long long n_units, unsigned* blocks,
                                size_t* smem) {
  static const void* kernel_seen = nullptr;
  static int dev_seen = -1, c_seen = -1, most = 0;
  *smem = block_bytes<kItems, kStage, T>(C);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((const void*)kernel != kernel_seen || dev != dev_seen || C != c_seen) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)*smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGroups * 32, *smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    kernel_seen = (const void*)kernel;
    dev_seen = dev;
    c_seen = C;
    most = sms * per_sm;
  }
  const long long need = (n_units + kGroups - 1) / kGroups;
  *blocks = (unsigned)(need < most ? need : most);
  return cudaSuccess;
}

// Whether rows of `bytes` in all should be staged: when they do not fit in
// the card's L2.
inline cudaError_t stage_rows(size_t bytes, bool* stage) {
  static int dev_seen = -1, l2 = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != dev_seen) {
    err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    if (err != cudaSuccess) return err;
    dev_seen = dev;
  }
  *stage = bytes > (size_t)l2;
  return cudaSuccess;
}

}  // namespace splat_window
