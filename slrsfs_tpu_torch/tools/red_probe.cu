// Probe of the f32 global reduction forms on the H100, for
// slrsfs_tpu_torch/tools/red_probe.py: K2's two-ended scatter of packed
// rows (the parent design of csrc/splat.cu, one thread per row, end and
// group of channels) issued with one form of reduction per group:
//
//   form 0  scalar  red.global.add.f32        1 channel a group
//   form 1  vector  red.global.add.v2.f32     2 channels (8 bytes)
//   form 2  vector  red.global.add.v4.f32     4 channels (16 bytes, sm_90)
//
// into an accumulator (H * W, stride) with stride >= C1; the vector forms
// need stride to be a multiple of their width (the pad channels receive
// +0). The same taps in the same bytes (but the pad) with 1x, 1/2x or 1/4x
// the reductions: whether the scatter's time follows their count or their
// bytes. Below it, two access patterns of K7's backward. Not on any path.

#include <cuda_runtime.h>

__device__ __forceinline__ void red1(float* a, float x) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(a), "f"(x) : "memory");
}
__device__ __forceinline__ void red2(float* a, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(a), "f"(x), "f"(y)
               : "memory");
}
__device__ __forceinline__ void red4(float* a, float x, float y, float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a), "f"(x),
               "f"(y), "f"(z), "f"(w)
               : "memory");
}

template <int kVec>
__global__ void probe_kernel(const float* __restrict__ u, const int2* __restrict__ positions,
                             const float* __restrict__ valid, const float2* __restrict__ disp_a,
                             const float2* __restrict__ disp_b, float w_a, float w_b,
                             float* __restrict__ acc, int P, int C1, int stride, int H,
                             int W) {
  const int groups = (C1 + kVec - 1) / kVec;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2LL * P * groups) return;
  const int row = (int)(i / groups);
  const int c0 = (int)(i - (long long)row * groups) * kVec;
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
  const float s = end_a ? w_a : w_b;
  float v[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    v[e] = c0 + e < C1 ? u[(size_t)p * C1 + c0 + e] * s : 0.0f;
  const int cxs[4] = {x0, x0 + 1, x0, x0 + 1};
  const int cys[4] = {y0, y0, y0 + 1, y0 + 1};
  const float ws[4] = {(1.0f - dx) * (1.0f - dy), dx * (1.0f - dy), (1.0f - dx) * dy,
                       dx * dy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (cxs[k] < 0 || cxs[k] >= W || cys[k] < 0 || cys[k] >= H) continue;
    float* a = acc + ((size_t)cys[k] * W + cxs[k]) * stride + c0;
    if (kVec == 1) red1(a, v[0] * ws[k]);
    if (kVec == 2) red2(a, v[0] * ws[k], v[1 % kVec] * ws[k]);
    if (kVec == 4)
      red4(a, v[0] * ws[k], v[1 % kVec] * ws[k], v[2 % kVec] * ws[k], v[3 % kVec] * ws[k]);
  }
}

// u (P, C1), positions (P, 2) int32, valid (P,), disp_a / disp_b (P, 2)
// f32; acc (H * W, stride) f32, 16-byte aligned; form 0, 1 or 2 as above.
extern "C" int red_probe(const void* u, const void* positions, const void* valid,
                         const void* disp_a, const void* disp_b, float w_a, float w_b,
                         void* acc, int P, int C1, int stride, int H, int W, int form,
                         void* stream) {
  const int vec = form == 0 ? 1 : form == 1 ? 2 : 4;
  if (stride < C1 || stride % vec) return (int)cudaErrorInvalidValue;
  const long long n = 2LL * P * ((C1 + vec - 1) / vec);
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  const float* uu = (const float*)u;
  const int2* pp = (const int2*)positions;
  const float* vv = (const float*)valid;
  const float2* da = (const float2*)disp_a;
  const float2* db = (const float2*)disp_b;
  float* aa = (float*)acc;
  if (vec == 1) probe_kernel<1><<<blocks, 256, 0, s>>>(uu, pp, vv, da, db, w_a, w_b, aa, P, C1, stride, H, W);
  if (vec == 2) probe_kernel<2><<<blocks, 256, 0, s>>>(uu, pp, vv, da, db, w_a, w_b, aa, P, C1, stride, H, W);
  if (vec == 4) probe_kernel<4><<<blocks, 256, 0, s>>>(uu, pp, vv, da, db, w_a, w_b, aa, P, C1, stride, H, W);
  return (int)cudaGetLastError();
}

// ---- the access patterns of K7's backward (csrc/euler_phased.cu) ----------
//
// (a) repeat_probe: n threads, each issuing `steps` red.global.add.v2.f32
//     of (1, 1) either to its own cell every time (same = 1: the first
//     backward design's steps that stay on a cell, queued at one address)
//     or to a new cell a step (same = 0: cell t + k * 4099 mod n, lanes on
//     neighbouring cells). acc holds n float2 cells, zeroed by the caller.
// (b) shared_probe: blocks of 256 threads, each with a window of `win`
//     float2 cells in dynamic shared memory (72 KB at win 9216), each
//     thread adding (1, 1) `steps` times into the window with the add the
//     backward kernel would use (form 0: two atomicAdd(float *), form 1: a
//     64-bit atomicCAS loop over the float2), `share` neighbouring lanes on
//     one cell; the window is then added into acc (win cells a block).

__device__ __forceinline__ void red2v(float2* a, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(a), "f"(x), "f"(y) : "memory");
}

__global__ void repeat_probe_kernel(float2* __restrict__ acc, int n, int steps, int same) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  for (int k = 0; k < steps; ++k) {
    const int c = same ? t : (int)(((long long)t + (long long)k * 4099) % n);
    red2v(&acc[c], 1.0f, 1.0f);
  }
}

__device__ __forceinline__ void cas_add2(float2* a, float x, float y) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(a);
  unsigned long long old = *p, seen;
  do {
    seen = old;
    float2 v = *reinterpret_cast<float2*>(&seen);
    v.x += x;
    v.y += y;
    old = atomicCAS(p, seen, *reinterpret_cast<unsigned long long*>(&v));
  } while (old != seen);
}

template <int kForm>
__global__ void shared_probe_kernel(float2* __restrict__ acc, int win, int steps, int share) {
  extern __shared__ float2 w[];
  for (int i = threadIdx.x; i < win; i += blockDim.x) w[i] = make_float2(0.0f, 0.0f);
  __syncthreads();
  const int base = threadIdx.x / share;
  for (int k = 0; k < steps; ++k) {
    float2* c = &w[(base + k * 37) % win];
    if (kForm == 0) {
      atomicAdd(&c->x, 1.0f);
      atomicAdd(&c->y, 1.0f);
    } else {
      cas_add2(c, 1.0f, 1.0f);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    const float2 v = w[i];
    if (v.x != 0.0f || v.y != 0.0f) red2v(&acc[i], v.x, v.y);
  }
}

// pattern 0: (a) with `same`; pattern 1: (b) with form `arg` and `share`
// lanes a cell over `blocks` blocks. acc: n (a) or win (b) float2 cells.
extern "C" int red_pattern_probe(void* acc, int pattern, int n, int steps, int arg, int share,
                                 int blocks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float2* a = (float2*)acc;
  if (pattern == 0) {
    if (n > 0) repeat_probe_kernel<<<(n + 255) / 256, 256, 0, s>>>(a, n, steps, arg);
    return (int)cudaGetLastError();
  }
  if (share < 1 || n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const int smem = n * (int)sizeof(float2);
  auto kernel = arg == 0 ? shared_probe_kernel<0> : shared_probe_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, 256, smem, s>>>(a, n, steps, share);
  return (int)cudaGetLastError();
}
