// The bf16 quarters shared by K2/K8's bf16 mode (csrc/splat.cu) and K3's
// bf16 mode (csrc/splat_dense.cu): a bf16 sum in the JAX quad layout's
// grouping. Each cell holds four bf16 accumulators, one per corner (NW,
// NE, SW, SE), of C1p = C1 rounded up to a multiple of 8 channels, so that
// 8 channels of a quarter are one aligned 16 bytes and one
// red.global.add.noftz.v4.bf16x2 adds them, every element its own bf16
// add rounded to nearest even. The epilogue combines NW + NE + SW + SE
// (+ u_static), each add rounded to bf16, in that order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

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

// Channel stride of the bf16 quarters: C1 rounded up to a multiple of 8
// (ops/splat.py:_scratch_numel allocates (H * W, 4, this)).
__host__ __device__ __forceinline__ int quarter_stride(int C1) {
  return (C1 + 7) & ~7;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// 8 bf16 at the 16-byte aligned addr += v, each element its own bf16 add.
__device__ __forceinline__ void red_add_bf16x8(bf16* addr, const uint32_t v[4]) {
  asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};" ::"l"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// Copies the m bf16 at src to shared memory, element e to dst[off + e]
// with off = src's element offset in its 16-byte line (returned), so that
// both sides of the 16-byte copies in between are aligned. dst holds
// m + 7 elements.
__device__ __forceinline__ int load_run(const bf16* __restrict__ src,
                                        bf16* dst, int m) {
  const int off = (int)(((uintptr_t)src >> 1) & 7);
  const int head = min(m, (8 - off) & 7);
  const int n_vec = (m - head) >> 3;
  const uint4* s4 = (const uint4*)(src + head);
  uint4* d4 = (uint4*)(dst + off + head);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) d4[i] = s4[i];
  for (int e = threadIdx.x; e < head; e += blockDim.x) dst[off + e] = src[e];
  for (int e = head + 8 * n_vec + threadIdx.x; e < m; e += blockDim.x)
    dst[off + e] = src[e];
  return off;
}

__device__ __forceinline__ void unpack8(uint4 q, bf16 x[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    x[2 * m] = __ushort_as_bfloat16((unsigned short)(w[m] & 0xffff));
    x[2 * m + 1] = __ushort_as_bfloat16((unsigned short)(w[m] >> 16));
  }
}

enum Epilogue { kSum, kNormalize, kNormalizeSlr };

// The bf16 quarters' epilogue over blockDim.x / n pixels per block
// (n = C1p / 8 threads per pixel): g = NW + NE + SW + SE (+ u_static when
// not NULL), each add rounded to bf16; kSum: out (H * W, C1) = g in bf16;
// kNormalize(Slr): out (H * W, C) = g's quotients as in
// splat_normalize_kernel, in T. Dynamic shared memory: the block's g
// (pixels x C1p) and u_static's run (pixels x C1 + 8).
template <typename T, int kMode>
__global__ void quarters_epilogue_kernel(const bf16* __restrict__ quarters,
                                         const bf16* __restrict__ u_static,
                                         T* __restrict__ out, int HW, int C1) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C1p = quarter_stride(C1);
  const int n = C1p >> 3;
  const int n_pix = blockDim.x / n;
  const int pix0 = blockIdx.x * n_pix;
  const int pix_here = min(n_pix, HW - pix0);
  bf16* g = (bf16*)smem;
  bf16* us = g + n_pix * C1p;
  const int us_off = u_static != nullptr
                         ? load_run(u_static + (size_t)pix0 * C1, us, pix_here * C1)
                         : 0;
  __syncthreads();

  const int r = threadIdx.x / n;
  const int j = threadIdx.x - r * n;
  if (r < pix_here) {
    const uint4* q = (const uint4*)(quarters + (size_t)(pix0 + r) * 4 * C1p) + j;
    bf16 nw[8], ne[8], sw[8], se[8], s[8];
    unpack8(q[0], nw);
    unpack8(q[n], ne);
    unpack8(q[2 * n], sw);
    unpack8(q[3 * n], se);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s[e] = __hadd(__hadd(__hadd(nw[e], ne[e]), sw[e]), se[e]);
      if (u_static != nullptr && 8 * j + e < C1)
        s[e] = __hadd(s[e], us[us_off + r * C1 + 8 * j + e]);
    }
    uint4 packed;
    packed.x = (uint32_t)__bfloat16_as_ushort(s[0]) | ((uint32_t)__bfloat16_as_ushort(s[1]) << 16);
    packed.y = (uint32_t)__bfloat16_as_ushort(s[2]) | ((uint32_t)__bfloat16_as_ushort(s[3]) << 16);
    packed.z = (uint32_t)__bfloat16_as_ushort(s[4]) | ((uint32_t)__bfloat16_as_ushort(s[5]) << 16);
    packed.w = (uint32_t)__bfloat16_as_ushort(s[6]) | ((uint32_t)__bfloat16_as_ushort(s[7]) << 16);
    *(uint4*)(g + r * C1p + 8 * j) = packed;
  }
  __syncthreads();

  const int C = C1 - (kMode == kNormalizeSlr ? 2 : kMode == kNormalize ? 1 : 0);
  for (int i = threadIdx.x; i < pix_here * C; i += blockDim.x) {
    const int pr = i / C;
    const int c = i - pr * C;
    const bf16* gp = g + pr * C1p;
    if (kMode == kSum) {
      out[(size_t)pix0 * C + i] = from_f32<T>(__bfloat162float(gp[c]));
    } else {
      const int den_ch = kMode == kNormalizeSlr ? (c < C - 1 ? C + 1 : C) : C;
      out[(size_t)pix0 * C + i] = from_f32<T>(
          __bfloat162float(gp[c]) / fmaxf(__bfloat162float(gp[den_ch]), 1e-8f));
    }
  }
}
