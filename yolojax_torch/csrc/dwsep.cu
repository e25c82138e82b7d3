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
//
// Design.  The pointwise conv is a product (pixels x C) @ (C x Cout) per
// image, computed here on the CUDA cores.  One CTA of 256 threads per
// (image, tile of 64 output pixels, tile of 128 output channels).  The CTA
// walks C in chunks of 32 channels; for each chunk it computes the depthwise
// result of its 64 pixels into shared memory (rounded, + bd, leaky,
// rounded: exactly what the pointwise conv reads in the unfused pair),
// stages the chunk's (32 x 128) pointwise weights beside it, and every
// thread adds the chunk's products into a 4 x 8 tile of f32 sums held in
// registers.  Shared memory: (32 x 68 + 32 x 128) floats = 25 KB, under the
// 48 KB a block gets without opting in.  The depthwise intermediate never
// reaches device memory; the price is that each channel tile of the output
// recomputes it (Cout / 128 = 4 or 8 times at 416, 9 FMAs per element).
//
// What bounds it on this card: the f32 multiply-adds of the pointwise
// product on the CUDA cores (67 TFLOP/s peak), far below the tensor cores'
// bf16 rate.  wgmma, TMA and tensor cores are the next step for this kernel.
// The TPU kernel fed whole images to the MXU because its grid ran in order
// on one core; here thousands of CTAs share the card's 132 SMs.
//
// Numerics follow _dwsep_kernel: the depthwise sum from 0, taps dy outer and
// dx inner, each a product and an add (built with --fmad=false); the
// pointwise sum in f32 over channels in order, as fused multiply-adds
// (__fmaf_rn: a bf16 product is exact in f32, so only the f32 case rounds
// differently from a product and an add); the sum rounded to the compute
// dtype, + bp and leaky in f32, rounded again.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;        // output pixels per CTA
constexpr int kBN = 128;       // output channels per CTA
constexpr int kBK = 32;        // input channels per chunk
constexpr int kApad = kBM + 4;  // row pitch of the dw tile: spreads its column writes over banks
constexpr int kTM = 4;         // pixels per thread
constexpr int kTN = 8;         // output channels per thread, as two runs of 4

struct F32 {
  using Storage = float;
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
};

struct BF16 {
  using Storage = unsigned short;  // raw bf16 bits
  static __device__ __forceinline__ float to_f32(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ unsigned short from_f32(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));  // round to nearest even
  }
};

__device__ __forceinline__ float leaky(float z) { return z >= 0.0f ? z : 0.1f * z; }

// D's round trip: the value a tensor of the compute dtype holds
template <class D>
__device__ __forceinline__ float rounded(float v) { return D::to_f32(D::from_f32(v)); }

template <class D>
__global__ void __launch_bounds__(kThreads)
dwsep_kernel(const typename D::Storage* __restrict__ x,
             const typename D::Storage* __restrict__ taps, const float* __restrict__ bd,
             const typename D::Storage* __restrict__ wp, const float* __restrict__ bp,
             typename D::Storage* __restrict__ out, int h, int w, int c, int ho, int wo,
             int cout, int stride) {
  __shared__ __align__(16) float a_s[kBK][kApad];  // dw result, channel-major
  __shared__ __align__(16) float b_s[kBK][kBN];    // pw weights of the chunk

  const int npix = ho * wo;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long img = blockIdx.z;
  const typename D::Storage* xb = x + img * h * w * c;
  const int tx = threadIdx.x % 16;  // output channels n0 + tx*4 + {0..3} and + 64
  const int ty = threadIdx.x / 16;  // pixels m0 + ty*4 + {0..3}

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < c; k0 += kBK) {
    // depthwise 3x3 of the chunk: neighbouring threads on neighbouring channels
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int kk = e % kBK, m = e / kBK;
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
            s = s + D::to_f32(xb[(static_cast<long long>(iy) * w + ix) * c + k]) *
                        D::to_f32(taps[(dy * 3 + dx) * c + k]);
          }
        }
        v = rounded<D>(leaky(rounded<D>(s) + bd[k]));
      }
      a_s[kk][m] = v;
    }
    // pointwise weights of the chunk; zeros past C or Cout add nothing
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int nn = e % kBN, kk = e / kBN;
      const int k = k0 + kk, n = n0 + nn;
      b_s[kk][nn] = (k < c && n < cout) ? D::to_f32(wp[static_cast<long long>(k) * cout + n])
                                        : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][ty * kTM]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[kk][kBN / 2 + tx * 4]);
      const float av[kTM] = {a.x, a.y, a.z, a.w};
      const float bv[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: round, + bp, leaky, round; four contiguous channels per run
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int pix = m0 + ty * kTM + i;
    if (pix >= npix) continue;
    typename D::Storage* o = out + (img * npix + pix) * cout;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : kBN / 2 + tx * 4 + j - 4);
      if (n < cout) o[n] = D::from_f32(leaky(rounded<D>(acc[i][j]) + bp[n]));
    }
  }
}

template <class D>
int launch(const void* x, const void* taps, const float* bd, const void* wp, const float* bp,
           void* out, int b, int h, int w, int c, int cout, int stride, cudaStream_t stream) {
  using S = typename D::Storage;
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const dim3 grid((ho * wo + kBM - 1) / kBM, (cout + kBN - 1) / kBN, b);
  dwsep_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(taps), bd, static_cast<const S*>(wp), bp,
      static_cast<S*>(out), h, w, c, ho, wo, cout, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x, taps, wp and out hold bf16 when `bf16` is set, f32 otherwise; the
// caller checks shapes, dtypes, contiguity and b <= 65535.
extern "C" int yolo_dwsep(const void* x, const void* taps, const float* bd, const void* wp,
                          const float* bp, void* out, int b, int h, int w, int c, int cout,
                          int stride, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, taps, bd, wp, bp, out, b, h, w, c, cout, stride, s)
              : launch<F32>(x, taps, bd, wp, bp, out, b, h, w, c, cout, stride, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
