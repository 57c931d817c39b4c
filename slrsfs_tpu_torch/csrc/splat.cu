// K2: dual-ended sparse bilinear splat with the softmax-splat normalisation.
//
// Replaces slrsfs_tpu/ops/splat.py:softsplat_sum_at_quad_dual (:390, rows
// built by _quad_rows :344, combined by _quad_combine :380) together with
// the per-frame epilogue of slrsfs_tpu/engine/rollout.py:577-581:
//
//   g = u_static + splat(u_mov * w_a, disp_a) + splat(u_mov * w_b, disp_b)
//   out = g[..., :C] / max(g[..., C], 1e-8)      (in the compute dtype)
//
// where splat() moves each source pixel to position + disp and splits it
// over the four integer neighbours with bilinear weights, dropping corners
// outside the grid.
//
// A second entry, splat_dual_normalize_slr, runs the same splat with the
// SLR epilogue of slrsfs_tpu/models/slr.py:slr_unpack_splatted (:228, the
// use_alpha0 layout [fs*e^Z (C-1), af*e^C, e^C, e^Z], C1 = C + 2):
//
//   out = [g[..., :C-1] / max(g[..., C+1], 1e-8), g[..., C-1] / max(g[..., C], 1e-8)]
//
// i.e. the warped features over the Z normaliser and the warped fluid alpha
// over the blending-weight normaliser, 65 channels at full width, written
// into the decode chunk's slot that both SLR decoders read.
//
// What bounds it on an H100: bytes. Per frame it reads the moving rows
// (P x 65 f32), their positions and two displacement fields, the static
// identity (H x W x 65 f32) and writes the normalised field (H x W x 64);
// about 43 MB at 256^2 with P = 32768, against ~10^7 flops. The f32
// accumulator (17 MB at 256^2) stays in the 50 MB L2 between the passes.
//
// Design, three steps on the caller's stream:
//  (a) copy u_static into the f32 accumulator (cudaMemcpyAsync);
//  (b) scatter: one thread per (end, row, channel). Consecutive threads hold
//      consecutive channels of one row, so the weight math is shared by a
//      warp's lanes and the four atomicAdds of a warp land on consecutive
//      addresses. Weights are computed in f32 from position + disp exactly
//      as _quad_rows does; rows with valid == 0 (padding) are skipped.
//      The OOB sentinel max(H, W) + 1 puts all four corners off the grid.
//  (c) epilogue: one thread per output element divides by the clamped
//      weight channel and stores f32 or bf16 (round to nearest even) into
//      the decode chunk's slot, which is NHWC in memory.
// The SLR epilogue is step (c) with a second divisor per pixel.
// Cells no moving tap reaches keep u_static exactly, so the decoder's
// x != 0 hole mask is unchanged. Atomic summation order differs from the
// deterministic XLA scatter, so results agree to float rounding, not bits.
// The quad packing of the TPU version is a scatter-row trick and is not
// reproduced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__global__ void splat_dual_scatter_kernel(
    const float* __restrict__ u_mov, const int2* __restrict__ positions,
    const float* __restrict__ valid, const float2* __restrict__ disp_a,
    const float2* __restrict__ disp_b, float w_a, float w_b,
    float* __restrict__ acc, int P, int C1, int H, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = 2LL * P * C1;
  if (i >= total) return;
  const int row = (int)(i / C1);
  const int c = (int)(i - (long long)row * C1);
  const bool end_a = row < P;
  const int p = end_a ? row : row - P;
  if (valid[p] == 0.0f) return;

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
  const float v = u_mov[(size_t)p * C1 + c] * (end_a ? w_a : w_b);

  const int cxs[4] = {x0, x0 + 1, x0, x0 + 1};
  const int cys[4] = {y0, y0, y0 + 1, y0 + 1};
  const float ws[4] = {(1.0f - dx) * (1.0f - dy), dx * (1.0f - dy),
                       (1.0f - dx) * dy, dx * dy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cx = cxs[k];
    const int cy = cys[k];
    if (cx >= 0 && cx < W && cy >= 0 && cy < H) {
      atomicAdd(&acc[((size_t)cy * W + cx) * C1 + c], v * ws[k]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void splat_normalize_kernel(const float* __restrict__ acc,
                                       T* __restrict__ out, int HW, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)HW * C) return;
  const int pix = (int)(i / C);
  const int c = (int)(i - (long long)pix * C);
  const float* g = acc + (size_t)pix * (C + 1);
  out[i] = from_f32<T>(g[c] / fmaxf(g[C], 1e-8f));
}

// SLR epilogue: acc rows are [fs (C-1), af, e^C, e^Z] (C + 2 channels).
template <typename T>
__global__ void splat_normalize_slr_kernel(const float* __restrict__ acc,
                                           T* __restrict__ out, int HW,
                                           int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)HW * C) return;
  const int pix = (int)(i / C);
  const int c = (int)(i - (long long)pix * C);
  const float* g = acc + (size_t)pix * (C + 2);
  const float den = c < C - 1 ? g[C + 1] : g[C];
  out[i] = from_f32<T>(g[c] / fmaxf(den, 1e-8f));
}

static const int kThreads = 256;

// steps (a) and (b): acc = u_static + both ends' splats
static cudaError_t splat_accumulate(const void* u_mov, const void* positions,
                                    const void* valid, const void* disp_a,
                                    const void* disp_b, float w_a, float w_b,
                                    const void* u_static, void* acc, int P,
                                    int C1, int H, int W, cudaStream_t s) {
  const size_t acc_bytes = (size_t)H * W * C1 * sizeof(float);
  cudaError_t err =
      cudaMemcpyAsync(acc, u_static, acc_bytes, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  const long long n_scatter = 2LL * P * C1;
  if (n_scatter > 0) {
    const unsigned blocks = (unsigned)((n_scatter + kThreads - 1) / kThreads);
    splat_dual_scatter_kernel<<<blocks, kThreads, 0, s>>>(
        (const float*)u_mov, (const int2*)positions, (const float*)valid,
        (const float2*)disp_a, (const float2*)disp_b, w_a, w_b, (float*)acc,
        P, C1, H, W);
    err = cudaGetLastError();
  }
  return err;
}

// u_mov (P, C1) f32, positions (P, 2) int32 [x, y], valid (P,) f32,
// disp_a / disp_b (P, 2) f32, u_static (H, W, C1) f32, acc (H, W, C1) f32
// scratch, out (H, W, C1 - 1) f32 (out_bf16 == 0) or bf16 (out_bf16 == 1).
extern "C" int splat_dual_normalize(const void* u_mov, const void* positions,
                                    const void* valid, const void* disp_a,
                                    const void* disp_b, float w_a, float w_b,
                                    const void* u_static, void* acc,
                                    void* out, int P, int C1, int H, int W,
                                    int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = splat_accumulate(u_mov, positions, valid, disp_a, disp_b,
                                     w_a, w_b, u_static, acc, P, C1, H, W, s);
  if (err != cudaSuccess) return (int)err;
  const int C = C1 - 1;
  const long long n_out = (long long)H * W * C;
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  if (out_bf16) {
    splat_normalize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const float*)acc, (__nv_bfloat16*)out, H * W, C);
  } else {
    splat_normalize_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)acc, (float*)out, H * W, C);
  }
  return (int)cudaGetLastError();
}

// As splat_dual_normalize, over the SLR layout; out (H, W, C1 - 2).
extern "C" int splat_dual_normalize_slr(
    const void* u_mov, const void* positions, const void* valid,
    const void* disp_a, const void* disp_b, float w_a, float w_b,
    const void* u_static, void* acc, void* out, int P, int C1, int H, int W,
    int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = splat_accumulate(u_mov, positions, valid, disp_a, disp_b,
                                     w_a, w_b, u_static, acc, P, C1, H, W, s);
  if (err != cudaSuccess) return (int)err;
  const int C = C1 - 2;
  const long long n_out = (long long)H * W * C;
  const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
  if (out_bf16) {
    splat_normalize_slr_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        (const float*)acc, (__nv_bfloat16*)out, H * W, C);
  } else {
    splat_normalize_slr_kernel<float><<<blocks, kThreads, 0, s>>>(
        (const float*)acc, (float*)out, H * W, C);
  }
  return (int)cudaGetLastError();
}
