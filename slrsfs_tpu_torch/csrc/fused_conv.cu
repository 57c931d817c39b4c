// K9: fused bf16 conv3x3 -> ReLU -> conv3x3.
//
// Replaces tools/pallas_conv_prototype.py:fused (:118, pl.pallas_call :122,
// body kernel :68), the repository's only Pallas kernel:
//
//   h   = bf16(relu(conv3x3(x, waa)))  inside the image, exactly 0 outside
//   out = bf16(conv3x3(h, wab))
//
// x (B, H, W, C) bf16 NHWC, out (B, H, W, F) bf16; both convolutions SAME
// with zero padding and f32 accumulation. The halo of h outside the image is
// zero, not the conv of zero-padded x there (the Pallas kernel's row and
// column masks, :101-112). The weights arrive packed by the wrapper
// (ops/fused_conv.py:pack_weights): 18 tap images, the 9 of waa then the 9
// of wab, each the (K, F) matrix of one tap padded to (Kp, kNp) in the
// K-major 128-byte-swizzled layout that wgmma reads its B operand in.
//
// What bounds it on an H100: operations. At the prototype's shape (B = 60,
// 256 x 480, C = F = 128) the two convolutions are 4.35 TFLOP of bf16
// products, 4.40 ms at the 989 TFLOP/s tensor-core peak, against 3.8 GB of
// x and out, 1.13 ms at 3.35 TB/s; h never leaves the SM. Each block also
// streams all 18 tap images (576 KiB at C = F = 128) from L2.
//
// Design, one block per (image, TH x TW = 8 x 16 output tile): two consumer
// warpgroups, each computing one n64 half of the kNp = 128 packed output
// channels, and one producer warpgroup.
//  (1) the producer's first thread initialises a ring of kStages tap
//      slots, each with a full and an empty mbarrier, and keeps bulk
//      copies (cp.async.bulk, one per tap image) in flight ahead of the
//      consumers: conv1's 9 taps stream straight into conv2's 9;
//  (2) meanwhile the block stages the x slab of the tile and its 2-pixel
//      halo, (TH + 4) x (TW + 4) x C, into shared memory (zeros outside the
//      image), rows padded by 8 bf16 so ldmatrix reads hit distinct banks;
//      __syncthreads (slab loaded, barriers initialised). Then the
//      producer gives registers up (setmaxnreg) and the consumers take them;
//  (3) conv1 as an implicit GEMM over the (TH + 2) x (TW + 2) pixels of h,
//      in m64 row tiles: per tap the consumers wait for the slot's full
//      barrier and run wgmma.mma_async m64n64k16 bf16 -> f32, A from
//      registers (each warp's 16 rows gathered by ldmatrix from the shifted
//      slab pixels, mma.sync's m16k16 fragment), B from the slot through a
//      128-byte-swizzle descriptor; then they release the slot on its empty
//      barrier;
//  (4) ReLU, zero outside the image, round to bf16 into the h buffer; a
//      named barrier of the consumers (h written);
//  (5) conv2 the same way over the TH x TW output pixels from h, stored
//      straight to out as bf16, the ragged edge of the image masked.
// No barrier of the whole block is left in the tap loop. Each tap sums into
// fresh accumulators that are then added in f32 (see conv_taps). Rows of a
// last m64 tile past the tile's pixels and the packed channels past F are
// computed and never stored. The slab's and h's channels are rounded up to
// whole 64-channel swizzle rows (zeros past C and F) so that no wgmma is
// conditional: a branch around one makes ptxas inject warpgroup.arrive
// fences (its C7519 report), which serialise the wgmmas.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kConsumerThreads = 256;  // two warpgroups
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 128;  // + the producer warpgroup
constexpr int kStages = 3;                        // tap slots in the ring
constexpr int kPad = 8;     // bf16 of padding per slab and h row
constexpr int kNp = 128;    // output channels of a packed tap image
constexpr int kAtomK = 64;  // input channels per 128-byte swizzled row
constexpr int kTaps = 9;
// the output tile: conv1 then runs on 3 m64 row tiles (the 10 x 18 = 180
// pixels of h), conv2 on 2, 1.25x the useful rows; 8 x 8 issues 1.5x
constexpr int TH = 8, TW = 16;
// registers per thread after setmaxnreg; the block launches at 168 (65536 /
// 384 rounded down to 8), and 128 x (168 - 40) = 256 x (232 - 168)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Tap image i of the weight stream into its ring slot, completing on the
// slot's full barrier.
__device__ __forceinline__ void issue_tap(int i, const unsigned char* wpk,
                                          unsigned char* ring,
                                          uint32_t slot_bytes,
                                          uint32_t img1_bytes,
                                          uint32_t img2_bytes, uint64_t* full) {
  const int slot = i % kStages;
  const uint32_t bytes = i < kTaps ? img1_bytes : img2_bytes;
  const unsigned char* src =
      wpk + (i < kTaps ? (size_t)i * img1_bytes
                       : (size_t)kTaps * img1_bytes +
                             (size_t)(i - kTaps) * img2_bytes);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(full + slot)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(ring + slot * slot_bytes)),
      "l"(src), "r"(bytes), "r"(smem_addr(full + slot))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand
// at shared address addr: rows of 128 bytes, 8-row groups 1024 bytes apart
// (stride byte offset), the swizzle's period 1024 bytes (the slots are
// aligned to it, so base offset 0).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across the
// asynchronous wgmma that owns these registers.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[e])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[s][e])::"memory");
}

// d (+)= A (m64 x k16, registers) x B (k16 x n64, descriptor); scale_d 0
// starts a fresh sum.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// acc = conv3x3(src, taps tap0 .. tap0 + 8 of the stream) over M output
// pixels of a grid OUT_W wide, whose tap (ky, kx) reads source pixel
// (y + ky) * (OUT_W + 2) + x + kx of src (rows of NC * kAtomK + kPad bf16,
// zeros past the conv's input channels, as the tap images have zero rows
// there: no k step is ever skipped, so every wgmma is unconditional), for
// the warpgroup's n64 half of the channels. Row tile i is rows 64 i .. 64 i
// + 63; this warp holds rows 16 w .. 16 w + 15 of each.
//
// Each tap sums into fresh accumulators (scale-d 0 on its first wgmma) that
// are then added to acc in f32, a chain of K / 16 steps instead of 9 K /
// 16 (K input channels): the tensor cores accumulate with truncation, and
// over one long chain the drift flipped the bf16 rounding of h often enough
// that more than 0.1 % of the outputs (random inputs, C = F = 128) ended
// more than one bf16 ulp from the f32 plain chain. chip_smoke.py prints
// the shares of the kernel, the plain chain and cuDNN against a float64
// chain.
//
// Pipelining within the warpgroup: a tap's row tiles are MT chains of NC
// commit groups of 4 k16 steps (one 64-channel swizzle row each). Group g
// takes its A fragments in a[g % 2] and its sum in part[i % 2]; after
// committing group g the warpgroup waits until at most one group is in
// flight, so group g - 1 is done: its A registers are free, and when g
// starts a chain, chain i - 1's partial is complete and is added to acc.
template <int MT, int OUT_W, int NC>
__device__ __forceinline__ void conv_taps(const bf16* src,
                                          const unsigned char* ring,
                                          uint32_t slot_bytes, uint64_t* full,
                                          uint64_t* empty, int tap0, int M,
                                          float (&acc)[MT][32]) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;        // warp in the warpgroup
  const int half = threadIdx.x >> 7;           // the warpgroup's n64 half
  constexpr int SRC_W = OUT_W + 2;
  constexpr int ROW = NC * kAtomK + kPad;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[i][e] = 0.0f;

  uint32_t a[2][4][4];
  float part[2][32];
  for (int tap = 0; tap < kTaps; ++tap) {
    const int ky = tap / 3;
    const int kx = tap - ky * 3;
    const int t = tap0 + tap;
    const int slot = t % kStages;
    uint32_t a_row[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      int m = i * 64 + w * 16 + (lane & 15);
      m = m < M ? m : M - 1;  // rows past M compute garbage, never stored
      const int y = m / OUT_W;
      const int x = m - y * OUT_W;
      a_row[i] = smem_addr(src + ((y + ky) * SRC_W + x + kx) * ROW +
                           (lane >> 4) * 8);
    }
    const uint32_t b_base =
        smem_addr(ring + slot * slot_bytes) + half * 64 * 128;
    mbar_wait(full + slot, (t / kStages) & 1);

#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int g = i * NC + c;  // compile-time after unrolling
        uint32_t(&ag)[4][4] = a[g & 1];
        uint64_t desc[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          ldmatrix_x4(ag[s], a_row[i] + (c * kAtomK + s * 16) * 2);
          desc[s] = sw128_desc(b_base + c * kNp * 128 + s * 32);
        }
        // every register the wgmmas read is written before the fence
        fence_regs(part[i & 1]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          wgmma_m64n64k16(part[i & 1], ag[s], desc[s], (c | s) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (g > 0) fence_regs(a[(g - 1) & 1]);
        if (c == 0 && i > 0) {
          fence_regs(part[(i - 1) & 1]);
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[i - 1][e] += part[(i - 1) & 1][e];
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(a[(MT * NC - 1) & 1]);
    fence_regs(part[(MT - 1) & 1]);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[MT - 1][e] += part[(MT - 1) & 1][e];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with it
  }
}

template <int NC1, int NC2>
__global__ void __launch_bounds__(kThreads, 1)
    fused_conv_kernel(const bf16* __restrict__ x,
                      const unsigned char* __restrict__ wpk,
                      bf16* __restrict__ out, int H, int W, int C, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SW = TW + 4, HTW = TW + 2;
  constexpr int M1 = (TH + 2) * HTW, M2 = TH * TW;
  constexpr int MT1 = ceil_div(M1, 64), MT2 = ceil_div(M2, 64);
  constexpr uint32_t img1_bytes = NC1 * kAtomK * kNp * 2;
  constexpr uint32_t img2_bytes = NC2 * kAtomK * kNp * 2;
  constexpr uint32_t slot_bytes = img1_bytes > img2_bytes ? img1_bytes
                                                          : img2_bytes;
  // the ring first, 1024-byte aligned (the swizzle's period), then the
  // slab, h and the barriers
  unsigned char* ring =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* slab = reinterpret_cast<bf16*>(ring + kStages * slot_bytes);
  constexpr int ROW1 = NC1 * kAtomK + kPad, ROW2 = NC2 * kAtomK + kPad;
  bf16* hbuf = slab + (TH + 4) * SW * ROW1;
  uint64_t* full = reinterpret_cast<uint64_t*>(hbuf + (TH + 2) * HTW * ROW2);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const int lane = threadIdx.x & 31;
  constexpr int kStream = 2 * kTaps;

  // (1) the ring's barriers and its first kStages copies
  if (threadIdx.x == kConsumerThreads) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < kStages; ++i)
      issue_tap(i, wpk, ring, slot_bytes, img1_bytes, img2_bytes, full);
  }

  // (2) the x slab with its 2-pixel halo, zeros outside the image and
  // past C
  constexpr int cpp = NC1 * kAtomK / 8;
  for (int i = threadIdx.x; i < (TH + 4) * SW * cpp; i += kThreads) {
    const int pix = i / cpp;
    const int c8 = i - pix * cpp;
    const int gy = oy0 - 2 + pix / SW;
    const int gx = ox0 - 2 + pix % SW;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c8 * 8 < C)
      v = __ldg(reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + gy) * W + gx) * C + c8 * 8));
    *reinterpret_cast<uint4*>(slab + pix * ROW1 + c8 * 8) = v;
  }
  __syncthreads();  // slab loaded, barriers initialised

  if (threadIdx.x >= kConsumerThreads) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumerThreads) {  // the rest of the stream
      for (int i = kStages; i < kStream; ++i) {
        const int slot = i % kStages;
        mbar_wait(empty + slot, ((i / kStages) - 1) & 1);
        issue_tap(i, wpk, ring, slot_bytes, img1_bytes, img2_bytes, full);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = (threadIdx.x >> 5) & 3;
    const int n_base = (threadIdx.x >> 7) * 64 + (lane & 3) * 2;

    // (3) conv1 over the (TH + 2) x (TW + 2) h tile
    {
      float acc1[MT1][32];
      conv_taps<MT1, HTW, NC1>(slab, ring, slot_bytes, full, empty, 0, M1,
                               acc1);
      // (4) h = bf16(relu(acc)) inside the image, 0 outside; the channels
      // from F to the row's end are 0 too (zero weights there)
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = i * 64 + w * 16 + (lane >> 2) + r * 8;
          if (m >= M1) continue;
          const int hy = m / HTW;
          const int hx = m - hy * HTW;
          const int gy = oy0 - 1 + hy;
          const int gx = ox0 - 1 + hx;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n_base + j * 8;
            if (n < NC2 * kAtomK) {
              const float v0 = inside ? fmaxf(acc1[i][4 * j + 2 * r], 0.0f)
                                      : 0.0f;
              const float v1 =
                  inside ? fmaxf(acc1[i][4 * j + 2 * r + 1], 0.0f) : 0.0f;
              *reinterpret_cast<__nv_bfloat162*>(hbuf + m * ROW2 + n) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads)
                 : "memory");  // h written

    // (5) conv2 over the TH x TW output tile, stored to out
    {
      float acc2[MT2][32];
      conv_taps<MT2, TW, NC2>(hbuf, ring, slot_bytes, full, empty, kTaps, M2,
                              acc2);
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = i * 64 + w * 16 + (lane >> 2) + r * 8;
          if (m >= M2) continue;
          const int gy = oy0 + m / TW;
          const int gx = ox0 + m % TW;
          if (gy >= H || gx >= W) continue;
          bf16* o = out + (((size_t)b * H + gy) * W + gx) * F;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n_base + j * 8;
            if (n < F)
              *reinterpret_cast<__nv_bfloat162*>(o + n) =
                  __floats2bfloat162_rn(acc2[i][4 * j + 2 * r],
                                        acc2[i][4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
}

// Dynamic shared memory of a block, as the kernel lays it out: 1024 bytes
// to align the ring, the ring of kStages tap slots, the x slab and h (their
// channels rounded up to whole swizzle rows), a full and an empty mbarrier
// per slot.
int smem_bytes(int nc1, int nc2) {
  const int ring = kStages * (nc1 > nc2 ? nc1 : nc2) * kAtomK * kNp * 2;
  const int slab = (TH + 4) * (TW + 4) * (nc1 * kAtomK + kPad) * 2;
  const int h = (TH + 2) * (TW + 2) * (nc2 * kAtomK + kPad) * 2;
  return 1024 + ring + slab + h + 2 * kStages * 8;
}

template <int NC1, int NC2>
cudaError_t launch(const void* x, const void* wpk, void* out, int B, int H,
                   int W, int C, int F, cudaStream_t s) {
  auto kernel = fused_conv_kernel<NC1, NC2>;
  const int smem = smem_bytes(NC1, NC2);
  // fails when the block does not fit the card's shared memory
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(W, TW), ceil_div(H, TH), B);
  if (B > 0 && H > 0 && W > 0)
    kernel<<<grid, kThreads, smem, s>>>((const bf16*)x,
                                        (const unsigned char*)wpk, (bf16*)out,
                                        H, W, C, F);
  return cudaGetLastError();
}

bool takes(int C, int F) {
  return C > 0 && C % 16 == 0 && C <= kNp && F > 0 && F % 32 == 0 && F <= kNp;
}

}  // namespace

// x (B, H, W, C), out (B, H, W, F) bf16, contiguous and 16-byte aligned;
// wpk the packed weights of ops/fused_conv.py:pack_weights; C a multiple of
// 16 and F a multiple of 32, both up to 128.
extern "C" int fused_conv3x3_relu_conv3x3(const void* x, const void* wpk,
                                          void* out, int B, int H, int W,
                                          int C, int F, void* stream) {
  if (!takes(C, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nc1 = ceil_div(C, kAtomK), nc2 = ceil_div(F, kAtomK);
  if (nc1 == 1 && nc2 == 1)
    return (int)launch<1, 1>(x, wpk, out, B, H, W, C, F, s);
  if (nc1 == 1) return (int)launch<1, 2>(x, wpk, out, B, H, W, C, F, s);
  if (nc2 == 1) return (int)launch<2, 1>(x, wpk, out, B, H, W, C, F, s);
  return (int)launch<2, 2>(x, wpk, out, B, H, W, C, F, s);
}

// Bytes of dynamic shared memory a block takes for C input and F output
// channels; -1 for channels the kernel does not take. Launches nothing.
extern "C" int fused_conv_smem_bytes(int C, int F) {
  return takes(C, F) ? smem_bytes(ceil_div(C, kAtomK), ceil_div(F, kAtomK))
                     : -1;
}
