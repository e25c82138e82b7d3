// Depthwise 3x3 convolution with its folded bias + leaky epilogue, hand-written
// for Hopper (sm_90a) and bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/dwconv.py::dwconv3x3_pallas (body
// _dw_kernel) together with the epilogue the JAX engine runs after it on
// folded params (yolojax/models/engine.py::_post_conv: + b, leaky):
//   x (B, H, W, C) NHWC, taps (3, 3, C), bias (C,) f32
//   -> y (B, Ho, Wo, C), Ho = (H - 1) / stride + 1, symmetric padding 1.
//
// Design.  One thread per (output pixel, 16 bytes of channels): 8 bf16 or 4
// f32 lanes, one vector load per tap, neighbouring threads on neighbouring
// channels of one pixel.  The padding is a bounds check on each tap, not a
// padded copy of the input.  A channel count that is not a multiple of the
// vector width, or a misaligned pointer, takes the one-lane instantiation.
//
// What bounds it on this card: bytes.  9 multiply-adds per output element
// against one read and one write of the activation; the nine taps' rereads
// of neighbouring pixels hit L1/L2.  At (128, 104, 104, 128) bf16 that is
// 0.71 GB of compulsory traffic, ~0.21 ms at 3.35 TB/s.  The TPU kernel DMA'd
// a halo slab per row tile into VMEM; here the caches carry the halo.  The
// epilogue runs in the same thread, so the conv output makes no round trip
// through device memory before its bias and leaky.
//
// Numerics follow _dw_kernel and the plain version op for op: f32 sum from
// 0, taps dy outer and dx inner, each a product and an add (built with
// --fmad=false); the sum is rounded to the compute dtype, then + bias and
// leaky in f32, rounded again.  Skipping a tap in the padding adds exactly
// what the padded zero would.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename S, int kVec>
struct alignas(sizeof(S) * kVec) Pack {
  S v[kVec];
};

__device__ __forceinline__ float leaky(float z) { return z >= 0.0f ? z : 0.1f * z; }

template <class D, int kVec>
__global__ void __launch_bounds__(kThreads)
dwconv3x3_kernel(const typename D::Storage* __restrict__ x,
                 const typename D::Storage* __restrict__ taps, const float* __restrict__ bias,
                 typename D::Storage* __restrict__ y, int h, int w, int c, int ho, int wo,
                 int stride, int act, long long total) {
  using P = Pack<typename D::Storage, kVec>;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int vectors = c / kVec;
  const int c0 = static_cast<int>(idx % vectors) * kVec;
  long long pix = idx / vectors;  // (b, oy, ox) flattened
  const int ox = static_cast<int>(pix % wo);
  pix /= wo;
  const int oy = static_cast<int>(pix % ho);
  const long long b = pix / ho;

  float acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = oy * stride - 1 + dy;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = ox * stride - 1 + dx;
      if (ix < 0 || ix >= w) continue;
      const P xv = *reinterpret_cast<const P*>(x + ((b * h + iy) * w + ix) * c + c0);
      const P wv = *reinterpret_cast<const P*>(taps + (dy * 3 + dx) * c + c0);
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[v] = acc[v] + D::to_f32(xv.v[v]) * D::to_f32(wv.v[v]);
    }
  }
  P out;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    float z = D::to_f32(D::from_f32(acc[v])) + bias[c0 + v];
    if (act) z = leaky(z);
    out.v[v] = D::from_f32(z);
  }
  *reinterpret_cast<P*>(y + ((b * ho + oy) * wo + ox) * c + c0) = out;
}

template <class D>
int launch(const void* x, const void* taps, const float* bias, void* y, int b, int h, int w,
           int c, int stride, int act, cudaStream_t stream) {
  using S = typename D::Storage;
  constexpr int kVec = 16 / sizeof(S);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const bool vector = c % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(taps) |
       reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const long long pixels = static_cast<long long>(b) * ho * wo;
  const long long total = pixels * (vector ? c / kVec : c);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (vector) {
    dwconv3x3_kernel<D, kVec><<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(x), static_cast<const S*>(taps), bias, static_cast<S*>(y), h, w,
        c, ho, wo, stride, act, total);
  } else {
    dwconv3x3_kernel<D, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(x), static_cast<const S*>(taps), bias, static_cast<S*>(y), h, w,
        c, ho, wo, stride, act, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x, taps and y hold bf16 when `bf16` is set, f32 otherwise; the caller
// checks shapes, dtypes and contiguity.
extern "C" int yolo_dwconv3x3(const void* x, const void* taps, const float* bias, void* y, int b,
                              int h, int w, int c, int stride, int act, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, taps, bias, y, b, h, w, c, stride, act, s)
              : launch<F32>(x, taps, bias, y, b, h, w, c, stride, act, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
