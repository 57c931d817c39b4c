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
// Forward design: one thread per (sample, pixel, channel), channels
// fastest, so a warp reads consecutive channels of one pixel and its four
// atomicAdds land on consecutive addresses of each target cell. The sum is
// f32 atomicAdd into an output the wrapper zeroes; the order of the adds
// varies, so the result matches the plain version to ~1e-7 relative, with
// the same empty cells (where signed contributions cancel, a single element
// can round to exactly 0 in one order of the adds and not in another).
//
// Backward design: one warp per (sample, pixel), lanes over channels, no
// atomics. For each corner the warp gathers g at the clipped target
// (zeroed when the corner is out of the grid): grad_inp[c] accumulates
// g * w over the corners in order, and the per-corner inner product
// sum_c inp[c] * g[c] is reduced across the warp with shuffles; lane 0
// then writes grad_flow = sum_k inner_k * (dw_k/dx, dw_k/dy), all in f32.

#include <cuda_runtime.h>

struct Taps {
  int lin[4];      // clipped flat target index
  bool inside[4];  // corner lies in the grid
  float w[4];      // bilinear weight
  float dwdx[4];
  float dwdy[4];
};

__device__ __forceinline__ Taps taps_of(int x, int y, float2 f, int H,
                                        int W) {
  const float ox = (float)x + f.x;
  const float oy = (float)y + f.y;
  const float x0f = floorf(ox);
  const float y0f = floorf(oy);
  const float dx = ox - x0f;
  const float dy = oy - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  Taps t;
  const int cx[4] = {x0, x0 + 1, x0, x0 + 1};
  const int cy[4] = {y0, y0, y0 + 1, y0 + 1};
  t.w[0] = (1.0f - dx) * (1.0f - dy);
  t.w[1] = dx * (1.0f - dy);
  t.w[2] = (1.0f - dx) * dy;
  t.w[3] = dx * dy;
  t.dwdx[0] = -(1.0f - dy);
  t.dwdx[1] = 1.0f - dy;
  t.dwdx[2] = -dy;
  t.dwdx[3] = dy;
  t.dwdy[0] = -(1.0f - dx);
  t.dwdy[1] = -dx;
  t.dwdy[2] = 1.0f - dx;
  t.dwdy[3] = dx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.inside[k] = cx[k] >= 0 && cx[k] < W && cy[k] >= 0 && cy[k] < H;
    const int xc = cx[k] < 0 ? 0 : (cx[k] > W - 1 ? W - 1 : cx[k]);
    const int yc = cy[k] < 0 ? 0 : (cy[k] > H - 1 ? H - 1 : cy[k]);
    t.lin[k] = yc * W + xc;
  }
  return t;
}

__global__ void splat_dense_fwd_kernel(const float* __restrict__ inp,
                                       const float2* __restrict__ flow,
                                       float* __restrict__ out, int B, int H,
                                       int W, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long HW = (long long)H * W;
  if (i >= (long long)B * HW * C) return;
  const long long pix = i / C;  // b * HW + y * W + x
  const int c = (int)(i - pix * C);
  const int b = (int)(pix / HW);
  const int yx = (int)(pix - (long long)b * HW);
  const Taps t = taps_of(yx % W, yx / W, __ldg(&flow[pix]), H, W);
  const float v = __ldg(&inp[i]);
  float* __restrict__ out_b = out + (size_t)b * HW * C;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (t.inside[k]) atomicAdd(&out_b[(size_t)t.lin[k] * C + c], v * t.w[k]);
  }
}

__global__ void splat_dense_bwd_kernel(const float* __restrict__ inp,
                                       const float2* __restrict__ flow,
                                       const float* __restrict__ g,
                                       float* __restrict__ grad_inp,
                                       float2* __restrict__ grad_flow, int B,
                                       int H, int W, int C) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long HW = (long long)H * W;
  if (warp >= (long long)B * HW) return;  // whole warps exit together
  const int b = (int)(warp / HW);
  const int yx = (int)(warp - (long long)b * HW);
  const Taps t = taps_of(yx % W, yx / W, __ldg(&flow[warp]), H, W);
  const float* __restrict__ g_b = g + (size_t)b * HW * C;
  const float* __restrict__ inp_p = inp + (size_t)warp * C;
  float* __restrict__ gi_p = grad_inp + (size_t)warp * C;
  float inner[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int c = lane; c < C; c += 32) {
    const float x = __ldg(&inp_p[c]);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float gk =
          t.inside[k] ? __ldg(&g_b[(size_t)t.lin[k] * C + c]) : 0.0f;
      acc = acc + gk * t.w[k];
      inner[k] = inner[k] + x * gk;
    }
    gi_p[c] = acc;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      inner[k] += __shfl_xor_sync(0xffffffffu, inner[k], off);
  }
  if (lane == 0) {
    float gx = 0.0f, gy = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gx = gx + inner[k] * t.dwdx[k];
      gy = gy + inner[k] * t.dwdy[k];
    }
    grad_flow[warp] = make_float2(gx, gy);
  }
}

// inp (B, H, W, C) f32, flow (B, H, W, 2) f32; adds the splat into out
// (B, H, W, C) f32, which the caller zeroes.
extern "C" int splat_dense_fwd(const void* inp, const void* flow, void* out,
                               int B, int H, int W, int C, void* stream) {
  const int threads = 256;
  const long long n = (long long)B * H * W * C;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    splat_dense_fwd_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)inp, (const float2*)flow, (float*)out, B, H, W, C);
  }
  return (int)cudaGetLastError();
}

// inp, flow as above, g (B, H, W, C) f32 the output's cotangent; writes
// grad_inp (B, H, W, C) and grad_flow (B, H, W, 2), both f32.
extern "C" int splat_dense_bwd(const void* inp, const void* flow,
                               const void* g, void* grad_inp, void* grad_flow,
                               int B, int H, int W, int C, void* stream) {
  const int threads = 256;  // 8 pixels per block
  const long long n = (long long)B * H * W * 32;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    splat_dense_bwd_kernel<<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const float*)inp, (const float2*)flow, (const float*)g,
        (float*)grad_inp, (float2*)grad_flow, B, H, W, C);
  }
  return (int)cudaGetLastError();
}
