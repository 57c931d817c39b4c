// K9: fused bf16 conv3x3 -> ReLU -> conv3x3.
//
// Replaces tools/pallas_conv_prototype.py:fused (:118, pl.pallas_call :122,
// body kernel :68), the repository's only Pallas kernel:
//
//   h   = bf16(relu(conv3x3(x, waa)))  inside the image, exactly 0 outside
//   out = bf16(conv3x3(h, wab))
//
// x (B, H, W, C) bf16 NHWC, waa (3, 3, C, F) and wab (3, 3, F, F) bf16
// HWIO, out (B, H, W, F) bf16; both convolutions SAME with zero padding and
// f32 accumulation. The halo of h outside the image is zero, not the conv
// of zero-padded x there (the Pallas kernel's row and column masks,
// :101-112).
//
// What bounds it on an H100: operations. At the prototype's shape (B = 60,
// 256 x 480, C = F = 128) the two convolutions are 4.35 TFLOP of bf16
// products, 4.40 ms at the 989 TFLOP/s tensor-core peak, against 3.8 GB of
// x and out, 1.13 ms at 3.35 TB/s; h never leaves the SM.
//
// Design, one block of 8 warps per (image, TH x TW output tile):
//  (1) stage the x slab of the tile and its 2-pixel halo,
//      (TH + 4) x (TW + 4) x C, into shared memory (zeros outside the
//      image), rows padded by 8 bf16 so ldmatrix reads hit distinct banks;
//  (2) conv1 as an implicit GEMM over the (TH + 2) x (TW + 2) pixels of the
//      h tile: for each of the 9 taps, the tap's C x F weights are copied
//      into shared memory and the warps run mma.sync m16n8k16 bf16 -> f32,
//      A rows gathered per lane by ldmatrix from the shifted slab pixels,
//      B read by ldmatrix.trans from the HWIO tap;
//  (3) ReLU, zero outside the image, round to bf16 and write h over the
//      slab in shared memory;
//  (4) conv2 the same way over the TH x TW output pixels from h, stored
//      straight to out as bf16, the ragged edge of the image masked.
// Each warp holds a quarter of the rows (16-row tiles) and half of F in
// registers; each tap sums into fresh accumulators that are then added in
// f32 (see conv_taps). The halo recompute costs (TH + 2)(TW + 2) / (TH TW)
// of conv1 (1.41 at 8 x 16), and each block reads the 2 x 295 KB of
// weights from L2. Weights are staged one tap at a time with no double buffering; wgmma
// and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 of padding per shared-memory row
constexpr int kMaxNt = 8;  // n8 tiles per warp: F / 16 <= 8

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy one tap's (K, F) HWIO weights into shared memory rows of F + kPad.
__device__ __forceinline__ void stage_tap(const bf16* __restrict__ w, int K,
                                          int F, bf16* ws) {
  const int chunks_per_row = F / 8;
  for (int i = threadIdx.x; i < K * chunks_per_row; i += kThreads) {
    const int k = i / chunks_per_row;
    const int c8 = i - k * chunks_per_row;
    *reinterpret_cast<uint4*>(ws + k * (F + kPad) + c8 * 8) =
        __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * F + c8 * 8));
  }
}

// acc = conv3x3(src, w) over M output pixels of a grid OUT_W wide, whose
// tap (ky, kx) reads source pixel (y + ky) * (OUT_W + 2) + x + kx of src
// (rows of K + kPad bf16). The warp owns 16-row tiles warp_m + 4 i and the
// n8 tiles of its half of F. Each tap sums into fresh tensor-core
// accumulators that are then added to acc in f32, a chain of K / 16 mma
// steps instead of 9 K / 16: the tensor cores accumulate with truncation,
// and over one long chain the drift flipped the bf16 rounding of h often
// enough that more than 0.1 % of the outputs (random inputs, C = F = 128)
// ended more than one bf16 ulp from the f32 plain chain. chip_smoke.py
// prints the shares of the kernel, the plain chain and cuDNN against a
// float64 chain.
template <int MT, int OUT_W>
__device__ __forceinline__ void conv_taps(const bf16* src, int K,
                                          const bf16* __restrict__ w, int F,
                                          bf16* ws, int M,
                                          float (&acc)[MT][kMaxNt][4]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp >> 1;
  const int nt = F / 16;
  const int n_base = (warp & 1) * (F / 2);
  const int m_tiles = (M + 15) / 16;
  constexpr int SRC_W = OUT_W + 2;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
    __syncthreads();  // every warp is done with the previous tap
    stage_tap(w + (size_t)tap * K * F, K, F, ws);
    __syncthreads();

    const bf16* a_row[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      int m = (warp_m + 4 * i) * 16 + (lane & 15);
      m = m < M ? m : M - 1;  // rows past M compute garbage, never stored
      const int y = m / OUT_W;
      const int x = m - y * OUT_W;
      a_row[i] = src + ((y + ky) * SRC_W + x + kx) * (K + kPad) +
                 (lane >> 4) * 8;
    }
    const bf16* b_row = ws + (lane & 15) * (F + kPad) + n_base + (lane >> 4) * 8;

    float part[MT][kMaxNt][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kMaxNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (warp_m + 4 * i < m_tiles) ldmatrix_x4(a[i], a_row[i] + k0);
#pragma unroll
      for (int j = 0; j < kMaxNt; j += 2) {
        if (j < nt) {
          uint32_t b[4];  // n8 tiles j and j + 1
          ldmatrix_x4_trans(b, b_row + k0 * (F + kPad) + j * 8);
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (warp_m + 4 * i < m_tiles) {  // warp-uniform
              mma_bf16(part[i][j], a[i], b[0], b[1]);
              mma_bf16(part[i][j + 1], a[i], b[2], b[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < kMaxNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
}

template <int TH, int TW, int MT1, int MT2>
__global__ void __launch_bounds__(kThreads)
    fused_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ waa,
                      const bf16* __restrict__ wab, bf16* __restrict__ out,
                      int H, int W, int C, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* slab = reinterpret_cast<bf16*>(smem_raw);  // x slab, then h
  constexpr int SW = TW + 4, HTW = TW + 2;
  const int slab_elems = (TH + 4) * SW * (C + kPad);
  const int h_elems = (TH + 2) * HTW * (F + kPad);
  bf16* ws = slab + (slab_elems > h_elems ? slab_elems : h_elems);

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp >> 1;
  const int nt = F / 16;
  const int n_base = (warp & 1) * (F / 2);

  // (1) the x slab with its 2-pixel halo, zeros outside the image
  const int cpp = C / 8;
  for (int i = threadIdx.x; i < (TH + 4) * SW * cpp; i += kThreads) {
    const int pix = i / cpp;
    const int c8 = i - pix * cpp;
    const int gy = oy0 - 2 + pix / SW;
    const int gx = ox0 - 2 + pix % SW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + gy) * W + gx) * C + c8 * 8));
    *reinterpret_cast<uint4*>(slab + pix * (C + kPad) + c8 * 8) = v;
  }

  // (2) conv1 over the (TH + 2) x (TW + 2) h tile
  {
    constexpr int M = (TH + 2) * HTW;
    float acc[MT1][kMaxNt][4];
    conv_taps<MT1, HTW>(slab, C, waa, F, ws, M, acc);
    __syncthreads();  // h overwrites the slab
    // (3) h = bf16(relu(acc)) inside the image, 0 outside
#pragma unroll
    for (int i = 0; i < MT1; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (warp_m + 4 * i) * 16 + (lane >> 2) + half * 8;
        if (m >= M) continue;
        const int hy = m / HTW;
        const int hx = m - hy * HTW;
        const int gy = oy0 - 1 + hy;
        const int gx = ox0 - 1 + hx;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < kMaxNt; ++j) {
          if (j < nt) {
            const float v0 = inside ? fmaxf(acc[i][j][2 * half], 0.0f) : 0.0f;
            const float v1 =
                inside ? fmaxf(acc[i][j][2 * half + 1], 0.0f) : 0.0f;
            *reinterpret_cast<__nv_bfloat162*>(
                slab + m * (F + kPad) + n_base + j * 8 + (lane & 3) * 2) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }

  // (4) conv2 over the TH x TW output tile, stored to out
  {
    constexpr int M = TH * TW;
    float acc[MT2][kMaxNt][4];
    conv_taps<MT2, TW>(slab, F, wab, F, ws, M, acc);
#pragma unroll
    for (int i = 0; i < MT2; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (warp_m + 4 * i) * 16 + (lane >> 2) + half * 8;
        if (m >= M) continue;
        const int gy = oy0 + m / TW;
        const int gx = ox0 + m % TW;
        if (gy >= H || gx >= W) continue;
        bf16* o = out + (((size_t)b * H + gy) * W + gx) * F + n_base +
                  (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < kMaxNt; ++j)
          if (j < nt)
            *reinterpret_cast<__nv_bfloat162*>(o + j * 8) =
                __floats2bfloat162_rn(acc[i][j][2 * half],
                                      acc[i][j][2 * half + 1]);
      }
    }
  }
}

constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int TH, int TW>
cudaError_t launch(const void* x, const void* waa, const void* wab, void* out,
                   int B, int H, int W, int C, int F, cudaStream_t s) {
  // 16-row tiles of each conv spread over the 4 warp rows
  constexpr int MT1 = ceil_div(ceil_div((TH + 2) * (TW + 2), 16), 4);
  constexpr int MT2 = ceil_div(ceil_div(TH * TW, 16), 4);
  auto kernel = fused_conv_kernel<TH, TW, MT1, MT2>;
  const size_t slab = (size_t)(TH + 4) * (TW + 4) * (C + kPad);
  const size_t h = (size_t)(TH + 2) * (TW + 2) * (F + kPad);
  const size_t ws = (size_t)(C > F ? C : F) * (F + kPad);
  const size_t smem = ((slab > h ? slab : h) + ws) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(W, TW), ceil_div(H, TH), B);
  if (B > 0 && H > 0 && W > 0)
    kernel<<<grid, kThreads, smem, s>>>(
        (const bf16*)x, (const bf16*)waa, (const bf16*)wab, (bf16*)out, H, W,
        C, F);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C), waa (3, 3, C, F), wab (3, 3, F, F), out (B, H, W, F), all
// bf16, contiguous and 16-byte aligned; C a multiple of 16, F a multiple
// of 32 up to 128. tile picks (TH, TW): 0 = 8 x 8, 1 = 8 x 16, 2 = 16 x 8.
extern "C" int fused_conv3x3_relu_conv3x3(const void* x, const void* waa,
                                          const void* wab, void* out, int B,
                                          int H, int W, int C, int F, int tile,
                                          void* stream) {
  if (C <= 0 || C % 16 != 0 || F <= 0 || F % 32 != 0 || F > 16 * kMaxNt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 0:
      return (int)launch<8, 8>(x, waa, wab, out, B, H, W, C, F, s);
    case 1:
      return (int)launch<8, 16>(x, waa, wab, out, B, H, W, C, F, s);
    case 2:
      return (int)launch<16, 8>(x, waa, wab, out, B, H, W, C, F, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
