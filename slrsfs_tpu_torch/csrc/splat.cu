// K2 and K8: sparse bilinear splats of packed rows onto a dense grid.
//
// K2 (entries splat_dual_normalize, splat_dual_normalize_slr) replaces
// slrsfs_tpu/ops/splat.py:softsplat_sum_at_quad_dual (:390, rows built by
// _quad_rows :344, combined by _quad_combine :380) together with the
// per-frame epilogue of slrsfs_tpu/engine/rollout.py:577-581:
//
//   g = splat(u_mov * w_a, disp_a) + splat(u_mov * w_b, disp_b) + u_static
//   out = g[..., :C] / max(g[..., C], 1e-8)      (in the compute dtype)
//
// where splat() moves each source pixel to position + disp and splits it
// over the four integer neighbours with bilinear weights, dropping corners
// outside the grid. The SLR entry runs the same splat with the epilogue of
// slrsfs_tpu/models/slr.py:slr_unpack_splatted (:228, the use_alpha0 layout
// [fs*e^Z (C-1), af*e^C, e^C, e^Z], C1 = C + 2):
//
//   out = [g[..., :C-1] / max(g[..., C+1], 1e-8), g[..., C-1] / max(g[..., C], 1e-8)]
//
// K8 (entry splat_sum_at) replaces the single-ended raw splats
// softsplat_sum_at (:255), softsplat_sum_at_paired (:296) and
// softsplat_sum_at_quad (:418), and the raw two-ended
// softsplat_sum_at_quad_dual (:390): the same scatter with no u_static and
// no normalisation. The paired and quad forms are TPU row layouts of one
// sum; here they are one kernel.
//
// Accumulation dtype. f32, or bf16 for the render's --dtype bfloat16-fast
// (JAX rollout.py:523-529), which reads bf16 rows and sums in bf16 as the
// JAX scatter does: the row is scaled by the end's weight and rounded to
// bf16 ((u * w_a).astype(u.dtype), :407), the corner weights are computed in
// f32 and the weighted row is rounded into bf16 (:369-373), and every add
// of the sum rounds to bf16. In bf16 a sum rounds at every add, so its
// grouping matters: the JAX quad layout sums each corner (NW, NE, SW, SE)
// of all rows in its own bf16 buffer and adds the four and then u_static in
// bf16 (_quad_combine; + u_static at rollout.py:579). The bf16 mode keeps
// that grouping: four bf16 quarter accumulators per cell, combined in the
// epilogue in the same order. (One bf16 accumulator per cell, seeded with
// u_static, put the normalised field four times further from the f32 sums
// than the plain version at 256^2 on an H100.)
//
// What bounds it on an H100: bytes. Per frame K2 reads the moving rows
// (P x 65 f32), their positions and two displacement fields, the static
// identity (H x W x 65) and writes the normalised field (H x W x 64); about
// 43 MB at 256^2 with P = 32768 in f32 (the rows and u_static at half the
// bytes in bf16), against ~10^7 flops. K8 reads the rows and displacements
// and writes (H, W, C). The accumulator (17 MB at 256^2 in f32, 38 MB of
// bf16 quarters) stays in the 50 MB L2 between the passes.
//
// Design, on the caller's stream. f32:
//  (a) K2 copies u_static into the accumulator (cudaMemcpyAsync), K8
//      scatters into its zeroed output;
//  (b) scatter: splat_window::scatter (splat_window.cuh), a unit one end's
//      run of kRun consecutive rows. A warp computes each row's corners and
//      weights once, in f32 from position + disp exactly as _quad_rows
//      does, gathers the corners that meet in a cell, sums their weighted
//      rows (each end's rows scaled by its weight first) in registers and
//      reduces each such cell into the accumulator once, with 16-byte
//      red.global.add.v4.f32 over its aligned middle. Rows with valid == 0
//      (padding) are skipped where a valid array is given. The OOB
//      sentinel max(H, W) + 1 puts all four corners off the grid. The rows
//      (8.5 MB at 256^2) are read from L2, not staged;
//  (c) epilogue, one thread per output element: K2 divides by the clamped
//      weight channel(s) in f32 and stores f32 or bf16 (round to nearest
//      even) into the decode chunk's slot, which is NHWC in memory.
//      Zeroing the accumulator and adding u_static here instead of (a)
//      moves the same 68 MB a frame and took 4-5 us longer on an H100
//      80GB HBM3 at 700 W (a 5 us memset and an epilogue of 26-27 us,
//      against the copy's 11.6 and this one's 16.4).
// bf16: the quarters are (H * W, 4, C1p), C1p = C1 rounded up to a
// multiple of 8, so that 8 channels of a quarter are one aligned 16 bytes:
//  (a) the quarters are zeroed (cudaMemsetAsync);
//  (b) scatter: a block holds whole rows, C1p / 8 threads per (end, row),
//      8 channels each. The row's four corners and weights are computed
//      once, by one thread, into shared memory; each thread then adds its
//      8 weighted channels into each in-grid corner's quarter with ONE
//      red.global.add.noftz.v4.bf16x2 (sm_90): every element of it is its
//      own bf16 add, rounded to nearest even, as a scalar bf16 atomicAdd
//      is. At 256^2, P = 32768, C1 = 65 on an H100 the scatter takes 19 us
//      a frame this way, 60 us with four red.global.add.noftz.bf16x2 per 8
//      channels and 179 us with one scalar bf16 atomicAdd per channel. The
//      pad channels receive +0 and are never read;
//  (c) epilogue, one block per run of pixels: the four quarters are read
//      with 16-byte loads, u_static's run (contiguous, not 16-byte aligned
//      per pixel) is staged through shared memory with 16-byte loads, the
//      sums NW + NE + SW + SE + u_static (each add rounded to bf16, in that
//      order) land in shared memory, and the outputs are written by
//      consecutive threads: K2 the quotients, K8 the sums.
// Cells no moving tap reaches keep u_static (K8: zero) exactly, so the
// decoder's x != 0 hole mask is unchanged. Atomic summation order differs
// from the deterministic XLA scatter, so results agree to rounding, not
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_quarters.cuh"
#include "splat_window.cuh"

static const int kThreads = 256;

static unsigned n_blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// ---- f32 accumulation: the tile-and-window scatter -------------------

// Packed rows per unit of splat_window::scatter (one end's run of
// consecutive rows; prepare_scene_sparse packs the moving pixels in raster
// order, so a run lands on neighbouring cells when the flow is smooth).
constexpr int kRun = 8;

// Both ends' rows as units of splat_window::scatter: unit r < runs is run r
// of end a, unit runs + r run r of end b; disp_b == NULL splats one end,
// valid == NULL every row.
struct RowsSource {
  static constexpr int kItems = kRun;
  static constexpr bool kScaled = true;  // each end's rows times its weight
  const float* u;
  const int2* positions;
  const float* valid;
  const float2* disp_a;
  const float2* disp_b;
  float w_a, w_b;
  float* acc;
  int P, C1, runs;

  __device__ int units() const { return (disp_b != nullptr ? 2 : 1) * runs; }
  __device__ float scale(int unit) const { return unit < runs ? w_a : w_b; }
  __device__ int items(int unit) const {
    const int r = unit < runs ? unit : unit - runs;
    return min(kRun, P - r * kRun);
  }
  __device__ bool item(int unit, int i, splat_window::Item& it) const {
    const bool end_a = unit < runs;
    const int p = (end_a ? unit : unit - runs) * kRun + i;
    const float keep = valid != nullptr ? valid[p] : 1.0f;
    const int2 src = positions[p];
    const float2 d = end_a ? disp_a[p] : disp_b[p];
    it.row = u + (size_t)p * C1;
    it.ox = (float)src.x + d.x;
    it.oy = (float)src.y + d.y;
    return keep != 0.0f;
  }
  __device__ float* grid(int) const { return acc; }
};

// The moving rows (P x C1 f32, 8.5 MB at the render's P = 32768) sit in
// L2, so P3 reads them there instead of staging them.
__global__ void __launch_bounds__(splat_window::kGroups * 32)
    rows_scatter_kernel(RowsSource src, int H, int W) {
  splat_window::scatter<false>(src, H, W, src.C1);
}

// acc (H * W, C1) += both ends' splats of rows u (P, C1).
static cudaError_t scatter_f32(const void* u, const void* positions,
                               const void* valid, const void* disp_a,
                               const void* disp_b, float w_a, float w_b,
                               void* acc, int P, int C1, int H, int W,
                               cudaStream_t s) {
  const int runs = (P + kRun - 1) / kRun;
  const long long units = (disp_b != nullptr ? 2LL : 1LL) * runs;
  if (units == 0 || C1 == 0 || H * W == 0) return cudaGetLastError();
  if (H >= 32768 || W >= 32768) return cudaErrorInvalidValue;
  unsigned blocks = 0;
  size_t smem = 0;
  cudaError_t err = splat_window::launch_shape<RowsSource::kItems, false>(
      rows_scatter_kernel, C1, units, &blocks, &smem);
  if (err != cudaSuccess) return err;
  const RowsSource src = {(const float*)u,      (const int2*)positions, (const float*)valid,
                          (const float2*)disp_a, (const float2*)disp_b,  w_a,
                          w_b,                  (float*)acc,            P,
                          C1,                   runs};
  rows_scatter_kernel<<<blocks, splat_window::kGroups * 32, smem, s>>>(
      src, H, W);
  return cudaGetLastError();
}

// K2's f32 epilogue: out = g[:C] / max(g[C], eps) (kSlr: the features
// over g[C + 1], the fluid alpha over g[C]), C = C1 - 1 (kSlr: C1 - 2).
template <typename T, bool kSlr>
__global__ void splat_normalize_kernel(const float* __restrict__ acc,
                                       T* __restrict__ out, int HW, int C1) {
  const int C = C1 - (kSlr ? 2 : 1);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)HW * C) return;
  const size_t pix = (size_t)(i / C);
  const int c = (int)(i - (long long)pix * C);
  const int den_ch = kSlr ? (c < C - 1 ? C + 1 : C) : C;
  const float num = acc[pix * C1 + c];
  const float den = acc[pix * C1 + den_ch];
  out[i] = from_f32<T>(num / fmaxf(den, 1e-8f));
}

// ---- bf16 accumulation in four quarters ---------------------------------

// acc (H * W, 4, C1p) bf16 += both ends' splats of rows u (P, C1) bf16,
// corner k of a row into quarter k of its cell. blockDim.x / n rows per
// block, n = C1p / 8 threads per row. disp_b == NULL splats one end;
// valid == NULL splats every row.
__global__ void splat_scatter_quarters_kernel(
    const bf16* __restrict__ u, const int2* __restrict__ positions,
    const float* __restrict__ valid, const float2* __restrict__ disp_a,
    const float2* __restrict__ disp_b, float w_a, float w_b,
    bf16* __restrict__ acc, int P, int C1, int H, int W) {
  __shared__ int s_p[kThreads];  // source row, -1: none or padding
  __shared__ float s_scale[kThreads];
  __shared__ int s_cell[kThreads][4];  // -1: corner off the grid
  __shared__ float s_w[kThreads][4];
  const int C1p = quarter_stride(C1);
  const int n = C1p >> 3;
  const int rows = blockDim.x / n;
  const long long row0 = (long long)blockIdx.x * rows;
  const long long total = (disp_b != nullptr ? 2LL : 1LL) * P;

  if (threadIdx.x < rows) {
    const long long row = row0 + threadIdx.x;
    int p = -1;
    if (row < total) {
      const bool end_a = row < P;
      p = (int)(end_a ? row : row - P);
      if (valid != nullptr && valid[p] == 0.0f) p = -1;
      if (p >= 0) {
        const int2 src = positions[p];
        const float2 d = end_a ? disp_a[p] : disp_b[p];
        const float ox = (float)src.x + d.x;
        const float oy = (float)src.y + d.y;
        const float x0f = floorf(ox);
        const float y0f = floorf(oy);
        const float dx = ox - x0f;
        const float dy = oy - y0f;
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const int cxs[4] = {x0, x0 + 1, x0, x0 + 1};
        const int cys[4] = {y0, y0, y0 + 1, y0 + 1};
        const float ws[4] = {(1.0f - dx) * (1.0f - dy), dx * (1.0f - dy),
                             (1.0f - dx) * dy, dx * dy};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = cxs[k] >= 0 && cxs[k] < W && cys[k] >= 0 && cys[k] < H;
          s_cell[threadIdx.x][k] = in ? cys[k] * W + cxs[k] : -1;
          s_w[threadIdx.x][k] = ws[k];
        }
        s_scale[threadIdx.x] = end_a ? w_a : w_b;
      }
    }
    s_p[threadIdx.x] = p;
  }
  __syncthreads();

  const int r = threadIdx.x / n;
  const int j = threadIdx.x - r * n;
  if (r >= rows || s_p[r] < 0) return;
  // channels 8j..8j+7 of the row, scaled by its end's weight and rounded
  // to bf16; the pad channels are 0
  const bf16* ur = u + (size_t)s_p[r] * C1 + 8 * j;
  const float scale = s_scale[r];
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = 8 * j + e < C1
               ? __bfloat162float(__float2bfloat16_rn(__bfloat162float(ur[e]) * scale))
               : 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cell = s_cell[r][k];
    if (cell < 0) continue;
    const float w = s_w[r][k];
    uint32_t packed[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) packed[m] = pack_bf16x2(v[2 * m] * w, v[2 * m + 1] * w);
    red_add_bf16x8(acc + ((size_t)cell * 4 + k) * C1p + 8 * j, packed);
  }
}

// (a), (b) and (c) of the bf16 mode: quarters zeroed, both ends scattered,
// the epilogue kMode into out.
template <typename T, int kMode>
static cudaError_t bf16_quarters(const void* u, const void* positions,
                                 const void* valid, const void* disp_a,
                                 const void* disp_b, float w_a, float w_b,
                                 const void* u_static, void* quarters,
                                 void* out, int P, int C1, int H, int W,
                                 cudaStream_t s) {
  const int C1p = quarter_stride(C1);
  const int n = C1p >> 3;
  if (n > kThreads) return cudaErrorInvalidValue;
  const int per_block = kThreads / n;  // rows of the scatter, pixels of (c)
  cudaError_t err =
      cudaMemsetAsync(quarters, 0, (size_t)H * W * 4 * C1p * sizeof(bf16), s);
  if (err != cudaSuccess) return err;
  const long long rows = (disp_b != nullptr ? 2LL : 1LL) * P;
  if (rows > 0) {
    splat_scatter_quarters_kernel<<<(unsigned)((rows + per_block - 1) / per_block),
                                    per_block * n, 0, s>>>(
        (const bf16*)u, (const int2*)positions, (const float*)valid,
        (const float2*)disp_a, (const float2*)disp_b, w_a, w_b, (bf16*)quarters,
        P, C1, H, W);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int HW = H * W;
  if (HW > 0) {
    const size_t smem = (size_t)per_block * (C1p + C1 + 8) * sizeof(bf16);
    quarters_epilogue_kernel<T, kMode>
        <<<(unsigned)((HW + per_block - 1) / per_block), per_block * n, smem, s>>>(
            (const bf16*)quarters, (const bf16*)u_static, (T*)out, HW, C1);
  }
  return cudaGetLastError();
}

// ---- entry points -------------------------------------------------------

// K2: accumulator f32 (acc_bf16 == 0: u_static copied in, scatter,
// epilogue) or the bf16 quarters, output type T.
template <typename T, bool kSlr>
static cudaError_t dual_normalize(const void* u_mov, const void* positions,
                                  const void* valid, const void* disp_a,
                                  const void* disp_b, float w_a, float w_b,
                                  const void* u_static, void* acc, void* out,
                                  int P, int C1, int H, int W, int acc_bf16,
                                  cudaStream_t s) {
  if (acc_bf16)
    return bf16_quarters<T, kSlr ? kNormalizeSlr : kNormalize>(
        u_mov, positions, valid, disp_a, disp_b, w_a, w_b, u_static, acc, out,
        P, C1, H, W, s);
  cudaError_t err = cudaMemcpyAsync(acc, u_static, (size_t)H * W * C1 * sizeof(float),
                                    cudaMemcpyDeviceToDevice, s);
  if (err == cudaSuccess)
    err = scatter_f32(u_mov, positions, valid, disp_a, disp_b, w_a, w_b, acc, P,
                      C1, H, W, s);
  if (err != cudaSuccess) return err;
  const long long n_out = (long long)H * W * (C1 - (kSlr ? 2 : 1));
  if (n_out > 0) {
    splat_normalize_kernel<T, kSlr><<<n_blocks(n_out), kThreads, 0, s>>>(
        (const float*)acc, (T*)out, H * W, C1);
  }
  return cudaGetLastError();
}

template <bool kSlr>
static int dual_normalize_any(const void* u_mov, const void* positions,
                              const void* valid, const void* disp_a,
                              const void* disp_b, float w_a, float w_b,
                              const void* u_static, void* acc, void* out,
                              int P, int C1, int H, int W, int out_bf16,
                              int acc_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(out_bf16
                   ? dual_normalize<bf16, kSlr>(u_mov, positions, valid, disp_a,
                                                disp_b, w_a, w_b, u_static, acc,
                                                out, P, C1, H, W, acc_bf16, s)
                   : dual_normalize<float, kSlr>(u_mov, positions, valid,
                                                 disp_a, disp_b, w_a, w_b,
                                                 u_static, acc, out, P, C1, H,
                                                 W, acc_bf16, s));
}

// u_mov (P, C1), positions (P, 2) int32 [x, y], valid (P,) f32,
// disp_a / disp_b (P, 2) f32, u_static (H, W, C1): u_mov and u_static f32
// with acc (H, W, C1) f32 scratch (acc_bf16 == 0), or bf16 with acc
// (H, W, 4, C1p) bf16 scratch, 16-byte aligned, C1p = C1 rounded up to a
// multiple of 8 (acc_bf16 == 1; C1 <= 2048); out (H, W, C1 - 1) f32
// (out_bf16 == 0) or bf16 (out_bf16 == 1).
extern "C" int splat_dual_normalize(const void* u_mov, const void* positions,
                                    const void* valid, const void* disp_a,
                                    const void* disp_b, float w_a, float w_b,
                                    const void* u_static, void* acc,
                                    void* out, int P, int C1, int H, int W,
                                    int out_bf16, int acc_bf16, void* stream) {
  return dual_normalize_any<false>(u_mov, positions, valid, disp_a, disp_b,
                                   w_a, w_b, u_static, acc, out, P, C1, H, W,
                                   out_bf16, acc_bf16, stream);
}

// As splat_dual_normalize, over the SLR layout; out (H, W, C1 - 2).
extern "C" int splat_dual_normalize_slr(
    const void* u_mov, const void* positions, const void* valid,
    const void* disp_a, const void* disp_b, float w_a, float w_b,
    const void* u_static, void* acc, void* out, int P, int C1, int H, int W,
    int out_bf16, int acc_bf16, void* stream) {
  return dual_normalize_any<true>(u_mov, positions, valid, disp_a, disp_b, w_a,
                                  w_b, u_static, acc, out, P, C1, H, W,
                                  out_bf16, acc_bf16, stream);
}

// K8. u (P, C) f32 (acc_bf16 == 0) or bf16 (acc_bf16 == 1), positions
// (P, 2) int32 [x, y], disp_a / disp_b (P, 2) f32 (disp_b NULL: one end);
// writes splat(u * w_a, disp_a) [+ splat(u * w_b, disp_b)] to out (H, W, C)
// of u's type. f32 adds into out, which the caller zeroes; bf16 sums in the
// scratch quarters (H, W, 4, Cp) bf16 (as K2's, Cp = C rounded up to a
// multiple of 8) and writes out from them.
extern "C" int splat_sum_at(const void* u, const void* positions,
                            const void* disp_a, const void* disp_b, float w_a,
                            float w_b, void* out, void* quarters, int P, int C,
                            int H, int W, int acc_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!acc_bf16)
    return (int)scatter_f32(u, positions, nullptr, disp_a, disp_b, w_a, w_b, out,
                            P, C, H, W, s);
  return (int)bf16_quarters<bf16, kSum>(u, positions, nullptr, disp_a, disp_b, w_a,
                                        w_b, nullptr, quarters, out, P, C, H, W, s);
}

// The f32 scatter's geometry, for the host's count of window misses
// (ops/splat.py:rows_window_misses): the rows of a run and the window's
// cells. They launch nothing.
extern "C" int splat_rows_run(void) { return kRun; }
extern "C" int splat_rows_window_cells(void) { return splat_window::kMapCells; }
