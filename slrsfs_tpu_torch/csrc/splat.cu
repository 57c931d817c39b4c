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
// f32 and the weighted row is rounded into bf16 (:369-373), and the sums
// are bf16 atomicAdds. In bf16 a sum rounds at every add, so its grouping
// matters: the JAX quad layout sums each corner (NW, NE, SW, SE) of all rows
// in its own bf16 buffer and adds the four and then u_static in bf16
// (_quad_combine; + u_static at rollout.py:579). The bf16 mode keeps that
// grouping: four bf16 quarter accumulators per cell, combined in the
// epilogue in the same order. (One bf16 accumulator per cell, seeded with
// u_static, put the normalised field four times further from the f32 sums
// than the plain version at 256^2 on an H100.)
//
// What bounds it on an H100: bytes. Per frame K2 reads the moving rows
// (P x 65 f32), their positions and two displacement fields, the static
// identity (H x W x 65) and writes the normalised field (H x W x 64); about
// 43 MB at 256^2 with P = 32768 in f32 (the rows and u_static at half the
// bytes in bf16), against ~10^7 flops. K8 reads the rows and displacements
// and writes (H, W, C). The accumulator (17 MB at 256^2 in f32, 34 MB of
// bf16 quarters) stays in the 50 MB L2 between the passes.
//
// Design, on the caller's stream:
//  (a) f32: K2 copies u_static into the accumulator (cudaMemcpyAsync), K8
//      scatters into its zeroed output; bf16: the quarters are zeroed
//      (cudaMemsetAsync);
//  (b) scatter: one thread per (end, row, channel). Consecutive threads hold
//      consecutive channels of one row, so the weight math is shared by a
//      warp's lanes and the four atomicAdds of a warp land on consecutive
//      addresses. Weights are computed in f32 from position + disp exactly
//      as _quad_rows does; rows with valid == 0 (padding) are skipped where
//      a valid array is given. The OOB sentinel max(H, W) + 1 puts all four
//      corners off the grid;
//  (c) epilogue, one thread per output element: bf16 combines the quarters
//      (and K2 adds u_static); K2 divides by the clamped weight channel(s)
//      in f32 and stores f32 or bf16 (round to nearest even) into the
//      decode chunk's slot, which is NHWC in memory.
// Cells no moving tap reaches keep u_static (K8: zero) exactly, so the
// decoder's x != 0 hole mask is unchanged. Atomic summation order differs
// from the deterministic XLA scatter, so results agree to rounding, not
// bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// acc += both ends' splats of rows u (P, C1) of type T, summed in T.
// kQuarters: acc is (H * W, 4, C1), corner k of a row adds into quarter k
// of its cell; else acc is (H * W, C1). disp_b == NULL splats one end;
// valid == NULL splats every row.
template <typename T, bool kQuarters>
__global__ void splat_scatter_kernel(const T* __restrict__ u,
                                     const int2* __restrict__ positions,
                                     const float* __restrict__ valid,
                                     const float2* __restrict__ disp_a,
                                     const float2* __restrict__ disp_b,
                                     float w_a, float w_b, T* __restrict__ acc,
                                     int P, int C1, int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (disp_b != nullptr ? 2LL : 1LL) * P * C1;
  if (i >= total) return;
  const int row = (int)(i / C1);
  const int c = (int)(i - (long long)row * C1);
  const bool end_a = row < P;
  const int p = end_a ? row : row - P;
  if (valid != nullptr && valid[p] == 0.0f) return;

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
  // the row scaled by its end's weight, in T (exact for f32 when w = 1)
  const float v =
      to_f32<T>(from_f32<T>(to_f32<T>(u[(size_t)p * C1 + c]) * (end_a ? w_a : w_b)));

  const int cxs[4] = {x0, x0 + 1, x0, x0 + 1};
  const int cys[4] = {y0, y0, y0 + 1, y0 + 1};
  const float ws[4] = {(1.0f - dx) * (1.0f - dy), dx * (1.0f - dy),
                       (1.0f - dx) * dy, dx * dy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = cxs[k];
    const int cy = cys[k];
    if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
      const size_t cell = (size_t)cy * W + cx;
      const size_t at = kQuarters ? (cell * 4 + k) * C1 + c : cell * C1 + c;
      atomicAdd(&acc[at], from_f32<T>(v * ws[k]));
    }
  }
}

// Channel ch of cell pix: from the f32 accumulator, or the bf16 quarters
// combined as _quad_combine does (NW + NE + SW + SE, each add rounded to
// bf16) plus u_static (u_static == NULL: none).
__device__ __forceinline__ float cell_sum(const float* acc, const bf16* quarters,
                                          const bf16* u_static, size_t pix,
                                          int ch, int C1) {
  if (quarters == nullptr) return acc[pix * C1 + ch];
  const bf16* q = quarters + pix * 4 * C1 + ch;
  bf16 s = __hadd(__hadd(__hadd(q[0], q[C1]), q[2 * C1]), q[3 * C1]);
  if (u_static != nullptr) s = __hadd(s, u_static[pix * C1 + ch]);
  return __bfloat162float(s);
}

// K2's epilogue: out = g[:C] / max(g[C], eps) (kSlr: the features over
// g[C + 1], the fluid alpha over g[C]), C = C1 - 1 (kSlr: C1 - 2).
template <typename T, bool kSlr>
__global__ void splat_normalize_kernel(const float* __restrict__ acc,
                                       const bf16* __restrict__ quarters,
                                       const bf16* __restrict__ u_static,
                                       T* __restrict__ out, int HW, int C1) {
  const int C = C1 - (kSlr ? 2 : 1);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)HW * C) return;
  const size_t pix = (size_t)(i / C);
  const int c = (int)(i - (long long)pix * C);
  const int den_ch = kSlr ? (c < C - 1 ? C + 1 : C) : C;
  const float num = cell_sum(acc, quarters, u_static, pix, c, C1);
  const float den = cell_sum(acc, quarters, u_static, pix, den_ch, C1);
  out[i] = from_f32<T>(num / fmaxf(den, 1e-8f));
}

// K8's bf16 epilogue: out = the combined quarters.
__global__ void splat_combine_kernel(const bf16* __restrict__ quarters,
                                     bf16* __restrict__ out, int HW, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)HW * C) return;
  const size_t pix = (size_t)(i / C);
  const int c = (int)(i - (long long)pix * C);
  out[i] = __float2bfloat16_rn(cell_sum(nullptr, quarters, nullptr, pix, c, C));
}

static const int kThreads = 256;

static unsigned n_blocks(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

template <typename T, bool kQuarters>
static cudaError_t scatter(const void* u, const void* positions,
                           const void* valid, const void* disp_a,
                           const void* disp_b, float w_a, float w_b, void* acc,
                           int P, int C1, int H, int W, cudaStream_t s) {
  const long long n = (disp_b != nullptr ? 2LL : 1LL) * P * C1;
  if (n > 0) {
    splat_scatter_kernel<T, kQuarters><<<n_blocks(n), kThreads, 0, s>>>(
        (const T*)u, (const int2*)positions, (const float*)valid,
        (const float2*)disp_a, (const float2*)disp_b, w_a, w_b, (T*)acc, P, C1,
        H, W);
  }
  return cudaGetLastError();
}

// K2's steps (a), (b) and (c): accumulator f32 (acc_bf16 == 0) or bf16
// quarters, output type T.
template <typename T, bool kSlr>
static cudaError_t dual_normalize(const void* u_mov, const void* positions,
                                  const void* valid, const void* disp_a,
                                  const void* disp_b, float w_a, float w_b,
                                  const void* u_static, void* acc, void* out,
                                  int P, int C1, int H, int W, int acc_bf16,
                                  cudaStream_t s) {
  const size_t cells = (size_t)H * W * C1;
  cudaError_t err;
  if (acc_bf16) {
    err = cudaMemsetAsync(acc, 0, 4 * cells * sizeof(bf16), s);
    if (err == cudaSuccess)
      err = scatter<bf16, true>(u_mov, positions, valid, disp_a, disp_b, w_a,
                                w_b, acc, P, C1, H, W, s);
  } else {
    err = cudaMemcpyAsync(acc, u_static, cells * sizeof(float),
                          cudaMemcpyDeviceToDevice, s);
    if (err == cudaSuccess)
      err = scatter<float, false>(u_mov, positions, valid, disp_a, disp_b, w_a,
                                  w_b, acc, P, C1, H, W, s);
  }
  if (err != cudaSuccess) return err;
  const long long n_out = (long long)H * W * (C1 - (kSlr ? 2 : 1));
  if (n_out > 0) {
    splat_normalize_kernel<T, kSlr><<<n_blocks(n_out), kThreads, 0, s>>>(
        acc_bf16 ? nullptr : (const float*)acc,
        acc_bf16 ? (const bf16*)acc : nullptr,
        acc_bf16 ? (const bf16*)u_static : nullptr, (T*)out, H * W, C1);
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
// (H, W, 4, C1) bf16 scratch (acc_bf16 == 1); out (H, W, C1 - 1) f32
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
// scratch quarters (H, W, 4, C) bf16 and writes out from them.
extern "C" int splat_sum_at(const void* u, const void* positions,
                            const void* disp_a, const void* disp_b, float w_a,
                            float w_b, void* out, void* quarters, int P, int C,
                            int H, int W, int acc_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!acc_bf16)
    return (int)scatter<float, false>(u, positions, nullptr, disp_a, disp_b,
                                      w_a, w_b, out, P, C, H, W, s);
  cudaError_t err =
      cudaMemsetAsync(quarters, 0, (size_t)H * W * 4 * C * sizeof(bf16), s);
  if (err == cudaSuccess)
    err = scatter<bf16, true>(u, positions, nullptr, disp_a, disp_b, w_a, w_b,
                              quarters, P, C, H, W, s);
  if (err != cudaSuccess) return (int)err;
  const long long n_out = (long long)H * W * C;
  if (n_out > 0)
    splat_combine_kernel<<<n_blocks(n_out), kThreads, 0, s>>>(
        (const bf16*)quarters, (bf16*)out, H * W, C);
  return (int)cudaGetLastError();
}
