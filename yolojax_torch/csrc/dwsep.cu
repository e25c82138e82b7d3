// Fused depthwise-separable block (dw 3x3 + bias + leaky -> pw 1x1 + bias +
// leaky), hand-written for Hopper (sm_90a) and bound through a plain C
// interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/dwsep.py::dwsep_pallas (body
// _dwsep_kernel), with the same contract on folded params:
//   x (B, H, W, C) NHWC, dw taps (3, 3, C), bd (C,) f32,
//   pw weights (C, Cout), bp (Cout,) f32
//   -> leaky(pw(leaky(dw(x) + bd)) + bp), (B, Ho, Wo, Cout), stride 1 or 2,
//   symmetric padding 1.
// The bf16 entry point reads the pw weights as (Cout, C), the folded 1x1
// conv's own OIHW layout, which the engine stores once.
//
// What bounds it on this card.  The pointwise product, (pixels x C) @
// (C x Cout), is 2 * C * Cout flops per output pixel: 45 GFLOP for
// MobileNet-416's (128, 26, 26, 512) -> 512 pair, ~46 us at the tensor
// cores' 989 TFLOP/s in bf16, against 177 MB of activations in and out,
// ~53 us at 3.35 TB/s.  Both bounds are close, so the product has to run on
// the tensor cores, as the TPU kernel ran it on the MXU, and the depthwise
// intermediate must not reach device memory.
//
// Design, bf16 (the main path).  One CTA of four warpgroups per tile of M
// output pixels over the flattened (b, oy, ox) index, so tiles cross image
// boundaries and no image leaves a ragged tail; each pixel still reads only
// its own image's 3x3 neighbourhood.
//   1. The CTA computes the depthwise block of its M pixels once, for all C
//      channels, straight into shared memory as wgmma's A operand: bf16,
//      K-major, 128-byte swizzle, in atoms of 64 channels.  M = 128 when
//      C <= 512 (C = 512: 128 KB), M = 64 when C <= 1024 (C = 1024: 128 KB).
//      Nothing is recomputed per output-channel tile (the CUDA-core design
//      did it Cout / 128 times).  Lanes take neighbouring channels of one
//      pixel and keep their taps in registers; a tap row's 3 loads issue
//      together, and 16 warps per SM hide their latency.
//   2. It then walks its output-channel tiles of 128, streaming the (Cout,
//      C) weights through a ring of 5 shared-memory stages of 128 x 64 with
//      cp.async (3 stages in flight), and each warpgroup runs
//      wgmma.m64nNk16 (bf16 x bf16 -> f32 in registers): at M = 128 each
//      warpgroup owns 64 rows and 64 columns, at M = 64 each owns 32
//      columns.  One wgmma group stays in flight while the next issues.
//   3. The epilogue works from the accumulator registers: round to bf16,
//      + bp and leaky in f32, round again; each warpgroup stages its tile in
//      a free ring stage and stores it in 16-byte runs along the output
//      rows, masked past the last pixel and past Cout.
// When few pixel tiles exist (batch 8: 43 tiles of 128 at 26x26) the grid
// also splits the output-channel tiles across CTAs, up to one CTA per SM;
// each split recomputes its depthwise block.  The grid is (pixel tiles,
// splits), so the batch has no 65535 limit.  Channels past C are zeros in
// both A and B.  C % 8 != 0 or a misaligned pointer takes element loads
// in place of 16-byte ones.  cp.async, not TMA: a tensor map would have to
// be encoded on the host through the driver API on every call.
//
// Design, f32 (the parity dtype).  The CUDA-core loop of the first port:
// one CTA of 256 threads per (image, 64 pixels, 128 output channels), C in
// chunks of 32, each thread a 4 x 8 tile of f32 FMAs.  TF32 tensor cores
// would round the operands to 10 bits and break the f32 check at 1e-4.
//
// Numerics.  The depthwise sum from 0, taps dy outer and dx inner, each a
// product then an add (__fmul_rn / __fadd_rn); rounded to the compute dtype,
// + bd and leaky in f32, rounded again: the A operand is exactly the tensor
// the unfused pair feeds its 1x1 conv.  The pointwise sum in f32 (the
// tensor cores' order in bf16, channels in order as FMAs in f32), rounded
// to the compute dtype, + bp and leaky in f32, rounded again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ unsigned pack2(unsigned short lo, unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

__device__ __forceinline__ float leaky(float z) { return z >= 0.0f ? z : 0.1f * z; }

__device__ __forceinline__ float bf16_to_f32(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ unsigned short f32_to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));  // round to nearest even
}

// ---------------------------------------------------------------------------
// bf16: depthwise into shared memory, pointwise on wgmma

constexpr int kThreads = 512;           // four warpgroups
constexpr int kBN = 128;                // output channels per tile
constexpr int kBK = 64;                 // channels per 128-byte swizzle atom
constexpr int kStages = 5;              // weight ring
constexpr int kPrefetch = 3;            // weight stages in flight; at most kStages - 2
constexpr int kStageBytes = kBN * kBK * 2;
constexpr int kMaxABytes = 128 * 1024;  // the depthwise block: M * C * 2 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `j` of row `r` in a K-major tile of 64-channel
// rows under the 128-byte swizzle (the chunk index XOR the row mod 8); the
// tile starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swizzled(int r, int j) {
  return static_cast<uint32_t>(r * 128 + ((j ^ (r & 7)) << 4));
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// keep the compiler from moving accumulator accesses across wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16, K-major in shared memory) x B (64 x 16, K-major): m64n64k16
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d += A (64 x 16, K-major in shared memory) x B (32 x 16, K-major): m64n32k16
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// 8 consecutive bf16 values at p[0..7], zeros past `valid`; one 16-byte
// load when `vec`.
__device__ __forceinline__ uint4 load8(const unsigned short* p, int valid, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  unsigned short v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = i < valid ? p[i] : 0;
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
}

__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One weight stage: rows n0..n0+127 of the (Cout, C) weights, channels
// k0..k0+63, swizzled; zeros past Cout and C.
__device__ __forceinline__ void load_weights(uint32_t stage, unsigned char* stage_ptr,
                                             const unsigned short* __restrict__ wt, int n0,
                                             int k0, int c, int cout, bool vec) {
  for (int e = threadIdx.x; e < kBN * (kBK / 8); e += kThreads) {
    const int r = e / (kBK / 8), j = e % (kBK / 8);
    const int n = n0 + r, k = k0 + j * 8;
    const bool in = n < cout && k < c;
    const unsigned short* src = wt + (in ? static_cast<long long>(n) * c + k : 0);
    if (vec) {
      cp_async16(stage + swizzled(r, j), src, in ? 16 : 0);
    } else {
      *reinterpret_cast<uint4*>(stage_ptr + swizzled(r, j)) =
          load8(src, in ? c - k : 0, false);
    }
  }
}

// Where 16-byte chunk `jn` of row `r` of a staged output tile of kWgN
// columns lies: rows of 128 bytes XOR the chunk with r mod 8, rows of 64 bytes
// with (r / 2) mod 4, so that the 8 rows one accumulator store touches land
// in 8 different bank groups.
template <int kWgN>
__device__ __forceinline__ int out_chunk(int r, int jn) {
  return kWgN == 64 ? jn ^ (r & 7) : jn ^ ((r >> 1) & 3);
}

template <int kM>
__global__ void __launch_bounds__(kThreads, 1)
dwsep_wgmma_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ taps,
                   const float* __restrict__ bd, const unsigned short* __restrict__ wt,
                   const float* __restrict__ bp, unsigned short* __restrict__ out, int h, int w,
                   int c, int ho, int wo, int cout, int stride, long long pixels,
                   int tiles_per_split, bool vec) {
  constexpr int kWgN = kM == 128 ? 64 : 32;   // columns per warpgroup
  constexpr int kAcc = kWgN / 2;              // f32 accumulators per thread
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  __shared__ long long row_base[kM];          // b * h * w of the row's image
  __shared__ int row_iy[kM], row_ix[kM];      // top-left tap; row_iy INT_MIN past the end

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * kM;
  const int cpad = (c + kBK - 1) / kBK * kBK;
  const int kblocks = cpad / kBK;
  const int ntiles = (cout + kBN - 1) / kBN;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tiles = min(tiles_per_split, ntiles - tile0);
  const int steps = tiles * kblocks;

  // 1024-byte aligned regions: the depthwise block (A), then the weight ring (B)
  const uint32_t raw = smem_addr(dyn_smem);
  unsigned char* a_ptr = dyn_smem + ((1024 - (raw & 1023)) & 1023);
  unsigned char* b_ptr = a_ptr + kM * cpad * 2;
  const uint32_t a_base = smem_addr(a_ptr), b_base = smem_addr(b_ptr);

  // the first weight stages load while the depthwise block is computed
#pragma unroll
  for (int s = 0; s < kPrefetch; ++s) {
    if (s < steps) {
      load_weights(b_base + s * kStageBytes, b_ptr + s * kStageBytes, wt,
                   (tile0 + s / kblocks) * kBN, (s % kblocks) * kBK, c, cout, vec);
    }
    cp_async_commit();
  }

  const int npix = ho * wo;
  for (int m = tid; m < kM; m += kThreads) {
    const long long p = m0 + m;
    if (p < pixels) {
      const long long img = p / npix;
      const int rem = static_cast<int>(p - img * npix);
      row_base[m] = img * h * w;
      row_iy[m] = (rem / wo) * stride - 1;
      row_ix[m] = (rem % wo) * stride - 1;
    } else {
      row_base[m] = 0;
      row_iy[m] = INT_MIN;
      row_ix[m] = 0;
    }
  }
  __syncthreads();

  // 1. depthwise: lanes on neighbouring 8-channel chunks of one pixel, warps
  //    on pixels.  A thread keeps its chunk's 9 taps in registers; per tap
  //    row it issues the 3 loads (clamped into the image, so all are in
  //    bounds) before it adds them, a tap outside the image as a zero.
  const int chunks = cpad / 8;
  for (int j = lane; j < chunks; j += 32) {
    const int c0 = j * 8;
    const bool live = c0 < c;
    uint4 tap[9];
    float bias[8];
#pragma unroll
    for (int t = 0; t < 9; ++t) tap[t] = live ? load8(taps + t * c + c0, c - c0, vec) : uint4{};
#pragma unroll
    for (int v = 0; v < 8; ++v) bias[v] = c0 + v < c ? bd[c0 + v] : 0.0f;
    unsigned char* a_chunk = a_ptr + (c0 / kBK) * (kM * 128);
    for (int m = tid / 32; m < kM; m += kThreads / 32) {
      uint4 packed = make_uint4(0, 0, 0, 0);
      const int iy0 = row_iy[m];
      if (live && iy0 != INT_MIN) {
        const int ix0 = row_ix[m];
        const long long base = row_base[m];
        float s[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) s[v] = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int iy = iy0 + dy;
          const long long row = base + static_cast<long long>(min(max(iy, 0), h - 1)) * w;
          uint4 xr[3];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int cx = min(max(ix0 + dx, 0), w - 1);
            xr[dx] = load8(x + (row + cx) * c + c0, c - c0, vec);
          }
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            // the padding: a zero tap adds +-0, which leaves the sum as it is
            if (iy < 0 || iy >= h || ix0 + dx < 0 || ix0 + dx >= w) xr[dx] = uint4{};
            float xv[8], tv[8];
            unpack8(xr[dx], xv);
            unpack8(tap[dy * 3 + dx], tv);
#pragma unroll
            for (int v = 0; v < 8; ++v) s[v] = __fadd_rn(s[v], __fmul_rn(xv[v], tv[v]));
          }
        }
        unsigned short r[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          r[v] = c0 + v < c
                     ? f32_to_bf16(leaky(__fadd_rn(bf16_to_f32(f32_to_bf16(s[v])), bias[v])))
                     : 0;
        }
        packed = make_uint4(pack2(r[0], r[1]), pack2(r[2], r[3]), pack2(r[4], r[5]),
                            pack2(r[6], r[7]));
      }
      *reinterpret_cast<uint4*>(a_chunk + swizzled(m, j % 8)) = packed;
    }
  }

  // 2. pointwise: each tile walks its 64-channel blocks through the weight
  //    ring, one wgmma group in flight while the next issues
  const int a_row = kM == 128 ? wg / 2 * 64 : 0;         // this warpgroup's rows of A
  const int b_row = kM == 128 ? wg % 2 * 64 : wg * 32;   // and of the weight tile
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  int step = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    for (int kb = 0; kb < kblocks; ++kb, ++step) {
      cp_async_wait<kPrefetch - 1>();  // this step's stage has landed (this thread's part)
      fence_async_shared();
      __syncthreads();  // ... everyone's part, and the stage read kStages - kPrefetch steps ago is free
      const int next = step + kPrefetch;
      if (next < steps) {
        const int s = next % kStages;
        load_weights(b_base + s * kStageBytes, b_ptr + s * kStageBytes, wt,
                     (tile0 + next / kblocks) * kBN, (next % kblocks) * kBK, c, cout, vec);
      }
      cp_async_commit();

      const uint32_t a_tile = a_base + kb * (kM * 128) + a_row * 128;
      const uint32_t b_tile = b_base + (step % kStages) * kStageBytes + b_row * 128;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        wgmma_bf16(acc, desc(a_tile + k * 32), desc(b_tile + k * 32), (kb > 0 || k > 0) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<kStages - kPrefetch - 1>();
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // 3. epilogue of the tile, from the accumulators: each warpgroup rounds,
    //    adds bp and applies leaky, writes its bf16 tile into a ring stage
    //    that no load is filling (the stages of the tile's last two steps),
    //    then stores it in 16-byte runs along the output rows.
    //    The staged rows use the 128-byte swizzle, so the accumulator
    //    layout's column writes do not collide in banks.
    const int n_base = (tile0 + tile) * kBN + b_row;
    const int last = step - 1;
    __syncthreads();  // every warpgroup's wgmma is done with these stages
    constexpr int kRowBytes = kWgN * 2;
    unsigned char* stage_out = b_ptr + ((last + wg / 2 * (kStages - 1)) % kStages) * kStageBytes +
                               wg % 2 * 64 * kRowBytes;
#pragma unroll
    for (int jn = 0; jn < kWgN / 8; ++jn) {
      const int n = n_base + jn * 8 + (lane % 4) * 2;
      const float b0 = n < cout ? bp[n] : 0.0f, b1 = n + 1 < cout ? bp[n + 1] : 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + lane / 4 + half * 8;
        const unsigned short z0 =
            f32_to_bf16(leaky(__fadd_rn(bf16_to_f32(f32_to_bf16(acc[jn * 4 + half * 2])), b0)));
        const unsigned short z1 = f32_to_bf16(
            leaky(__fadd_rn(bf16_to_f32(f32_to_bf16(acc[jn * 4 + half * 2 + 1])), b1)));
        *reinterpret_cast<unsigned*>(stage_out + r * kRowBytes + (out_chunk<kWgN>(r, jn) << 4) +
                                     (lane % 4) * 4) = pack2(z0, z1);
      }
    }
    fence_acc(acc);
    __syncthreads();
    const bool vec_out = cout % 8 == 0;
    constexpr int kRunsPerRow = kWgN / 8;
#pragma unroll 4
    for (int e = tid % 128; e < 64 * kRunsPerRow; e += 128) {
      const int r = e / kRunsPerRow, jn = e % kRunsPerRow;
      const long long p = m0 + a_row + r;
      const int n = n_base + jn * 8;
      if (p >= pixels || n >= cout) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(stage_out + r * kRowBytes +
                                                      (out_chunk<kWgN>(r, jn) << 4));
      unsigned short* o = out + p * cout + n;
      if (vec_out) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (n + i < cout) o[i] = static_cast<unsigned short>(words[i / 2] >> (16 * (i % 2)));
        }
      }
    }
    fence_acc(acc);
  }
  cp_async_wait<0>();
}

struct DeviceInfo {
  int sms = 0;
  bool configured = false;
};

int launch_bf16(const void* x, const void* taps, const float* bd, const void* wt,
                const float* bp, void* out, int b, int h, int w, int c, int cout, int stride,
                cudaStream_t stream) {
  static DeviceInfo devices[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceInfo& info = devices[dev];
  constexpr int kMaxSmem = kMaxABytes + kStages * kStageBytes + 1024;
  if (!info.configured) {
    err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dwsep_wgmma_kernel<128>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(dwsep_wgmma_kernel<64>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    info.configured = true;
  }
  const int cpad = (c + kBK - 1) / kBK * kBK;
  const int m = cpad * 128 * 2 <= kMaxABytes ? 128 : 64;
  if (cpad * m * 2 > kMaxABytes) return static_cast<int>(cudaErrorInvalidValue);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const long long pixels = static_cast<long long>(b) * ho * wo;
  const long long mtiles = (pixels + m - 1) / m;
  if (mtiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // split the output-channel tiles across CTAs while pixel tiles leave SMs idle
  const int ntiles = (cout + kBN - 1) / kBN;
  const long long fill = info.sms / mtiles;
  const int splits = static_cast<int>(fill < 1 ? 1 : (fill > ntiles ? ntiles : fill));
  const int per_split = (ntiles + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned>(mtiles), (ntiles + per_split - 1) / per_split);
  const size_t smem = static_cast<size_t>(m) * cpad * 2 + kStages * kStageBytes + 1024;
  const bool vec = c % 8 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(taps) |
       reinterpret_cast<uintptr_t>(wt)) % 16 == 0;
  using U = unsigned short;
  if (m == 128) {
    dwsep_wgmma_kernel<128><<<grid, kThreads, smem, stream>>>(
        static_cast<const U*>(x), static_cast<const U*>(taps), bd, static_cast<const U*>(wt), bp,
        static_cast<U*>(out), h, w, c, ho, wo, cout, stride, pixels, per_split, vec);
  } else {
    dwsep_wgmma_kernel<64><<<grid, kThreads, smem, stream>>>(
        static_cast<const U*>(x), static_cast<const U*>(taps), bd, static_cast<const U*>(wt), bp,
        static_cast<U*>(out), h, w, c, ho, wo, cout, stride, pixels, per_split, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core loop

constexpr int kThreads32 = 256;
constexpr int kBM32 = 64;        // output pixels per CTA
constexpr int kBN32 = 128;       // output channels per CTA
constexpr int kBK32 = 32;        // input channels per chunk
constexpr int kApad = kBM32 + 4;  // row pitch of the dw tile: spreads its column writes over banks
constexpr int kTM = 4;           // pixels per thread
constexpr int kTN = 8;           // output channels per thread, as two runs of 4

__global__ void __launch_bounds__(kThreads32)
dwsep_f32_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                 const float* __restrict__ bd, const float* __restrict__ wp,
                 const float* __restrict__ bp, float* __restrict__ out, int h, int w, int c,
                 int ho, int wo, int cout, int stride) {
  __shared__ __align__(16) float a_s[kBK32][kApad];  // dw result, channel-major
  __shared__ __align__(16) float b_s[kBK32][kBN32];  // pw weights of the chunk

  const int npix = ho * wo;
  const int m0 = blockIdx.x * kBM32;
  const int n0 = blockIdx.y * kBN32;
  const long long img = blockIdx.z;
  const float* xb = x + img * h * w * c;
  const int tx = threadIdx.x % 16;  // output channels n0 + tx*4 + {0..3} and + 64
  const int ty = threadIdx.x / 16;  // pixels m0 + ty*4 + {0..3}

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < c; k0 += kBK32) {
    // depthwise 3x3 of the chunk: neighbouring threads on neighbouring channels
    for (int e = threadIdx.x; e < kBM32 * kBK32; e += kThreads32) {
      const int kk = e % kBK32, m = e / kBK32;
      const int k = k0 + kk, pix = m0 + m;
      float v = 0.0f;
      if (k < c && pix < npix) {
        const int oy = pix / wo, ox = pix % wo;
        float s = 0.0f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int iy = oy * stride - 1 + dy;
          if (iy < 0 || iy >= h) continue;
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int ix = ox * stride - 1 + dx;
            if (ix < 0 || ix >= w) continue;
            s = s + xb[(static_cast<long long>(iy) * w + ix) * c + k] * taps[(dy * 3 + dx) * c + k];
          }
        }
        v = leaky(s + bd[k]);
      }
      a_s[kk][m] = v;
    }
    // pointwise weights of the chunk; zeros past C or Cout add nothing
    for (int e = threadIdx.x; e < kBK32 * kBN32; e += kThreads32) {
      const int nn = e % kBN32, kk = e / kBN32;
      const int k = k0 + kk, n = n0 + nn;
      b_s[kk][nn] = (k < c && n < cout) ? wp[static_cast<long long>(k) * cout + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK32; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * kTM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[kk][kBN32 / 2 + tx * 4]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: + bp, leaky; four contiguous channels per run
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int pix = m0 + ty * kTM + i;
    if (pix >= npix) continue;
    float* o = out + (img * npix + pix) * cout;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : kBN32 / 2 + tx * 4 + j - 4);
      if (n < cout) o[n] = leaky(acc[i][j] + bp[n]);
    }
  }
}

}  // namespace

// Launch on `stream` without synchronising; each returns cudaGetLastError().
// The caller checks shapes, dtypes and contiguity.
//
// bf16: x (B, H, W, C), taps (3, 3, C), wt (Cout, C) in bf16; C <= 1024.
extern "C" int yolo_dwsep_bf16(const void* x, const void* taps, const float* bd, const void* wt,
                               const float* bp, void* out, int b, int h, int w, int c, int cout,
                               int stride, void* stream) {
  return launch_bf16(x, taps, bd, wt, bp, out, b, h, w, c, cout, stride,
                     static_cast<cudaStream_t>(stream));
}

// f32: x (B, H, W, C), taps (3, 3, C), wp (C, Cout) in f32; b <= 65535.
extern "C" int yolo_dwsep_f32(const float* x, const float* taps, const float* bd,
                              const float* wp, const float* bp, float* out, int b, int h, int w,
                              int c, int cout, int stride, void* stream) {
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const dim3 grid((ho * wo + kBM32 - 1) / kBM32, (cout + kBN32 - 1) / kBN32, b);
  dwsep_f32_kernel<<<grid, kThreads32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, taps, bd, wp, bp, out, h, w, c, ho, wo, cout, stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
