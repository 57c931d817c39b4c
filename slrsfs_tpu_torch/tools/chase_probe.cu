// Probe of the dependent-gather chain that K1 and K4 (csrc/euler.cu) run,
// for slrsfs_tpu_torch/tools/chase_probe.py: each thread makes `steps`
// gathers of a float2 from a field of H * W float2 (512 KB at 256^2), each
// gather's cell read from the value gathered before it, as each Euler step
// gathers the motion at a destination made from the motion gathered
// before. Cell c's float2 holds, as int bits, the cell one step of +M
// leads to (.x) and the cell one step of -M leads to (.y): the rounded
// destination of c + M and c - M, clamped to the frame. Threads [0, n/2)
// follow .x, [n/2, n) follow .y, from their start cells. With `store`,
// each step also stores its float2 (8 bytes, coalesced rows of n as K1's
// entries); without, only the last. The time is that of the chain alone:
// a load, the address made from it, the next load. Not on any path.

#include <cuda_runtime.h>

template <int kDir, bool kStore>
__device__ __forceinline__ void chase(const float2* __restrict__ field, int i,
                                      float2* __restrict__ out, int t, int n, int steps) {
  float2 v = make_float2(0.0f, 0.0f);
  for (int s = 0; s < steps; ++s) {
    v = __ldg(&field[i]);
    i = __float_as_int(kDir == 0 ? v.x : v.y);
    if (kStore) out[(size_t)s * n + t] = v;
  }
  if (!kStore) out[t] = v;
}

// The stores alone, K1's pattern: thread t stores `steps` entries of 8
// bytes at out[s * n + t] (kWide: 16 bytes, two rows, at out[s * 2n + 2t]).
template <bool kWide>
__global__ void store_kernel(float2* __restrict__ out, int n, int steps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const float2 v = make_float2((float)t, 1.0f);
  for (int s = 0; s < steps; ++s) {
    if (kWide)
      reinterpret_cast<float4*>(out + (size_t)s * 2 * n)[t] = make_float4(v.x, v.y, v.x, v.y);
    else
      out[(size_t)s * n + t] = v;
  }
}

template <bool kStore>
__global__ void chase_kernel(const float2* __restrict__ field, const int* __restrict__ start,
                             float2* __restrict__ out, int n, int steps) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  if (t < n / 2)
    chase<0, kStore>(field, start[t], out, t, n, steps);
  else
    chase<1, kStore>(field, start[t], out, t, n, steps);
}

// field (H * W) float2, start (n,) int32 cells, out (steps, n) float2 with
// store 1, else (n,) float2. store 2: the stores alone into (steps, n)
// float2; store 3: 16-byte stores alone into (steps, 2n) float2. n even;
// 256 threads a block.
extern "C" int chase_probe(const void* field, const void* start, void* out, int n,
                           int steps, int store, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (blocks > 0) {
    if (store >= 2) {
      if (store == 3)
        store_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>((float2*)out, n, steps);
      else
        store_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>((float2*)out, n, steps);
    } else if (store)
      chase_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          (const float2*)field, (const int*)start, (float2*)out, n, steps);
    else
      chase_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
          (const float2*)field, (const int*)start, (float2*)out, n, steps);
  }
  return (int)cudaGetLastError();
}
