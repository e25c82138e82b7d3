// The bias + leaky epilogue of a folded conv over NHWC in one pass,
// hand-written for Hopper (sm_90a) and bound through a plain C interface
// (ctypes).
//
// Replaces models/blocks.py::bias_leaky where the engine runs it on its own:
// the epilogue of a conv whose output no pool, reorg or depthwise kernel
// takes (the folded-params case of the JAX engine's
// yolojax/models/engine.py::_post_conv, which XLA fuses into the conv):
//   x (B, H, W, C) raw conv output, f32 or bf16; bias (C,) f32
//   -> y (B, H, W, C) in x's type, each element epilogue.cuh's
//   f32 (x + bias), leaky when act, rounded to x's type.
// The plain version runs that as six torch ops, each a full pass over the
// activation in device memory (widen, add, multiply, compare, select,
// narrow); here the raw output is read once and the result written once.
//
// Design.  A block is bdx x bdy threads: x over the 16-byte units of one
// pixel's channels (8 bf16 or 4 f32 lanes), y over pixels.  With a pixel's
// units at most kThreads, bdx is all of them and bdy as many pixels as fill
// kThreads, so a block's rows are one contiguous run of memory and a warp
// reads 512 contiguous bytes; with more (C over 2048 bf16 or 1024 f32), the
// grid's y cuts a pixel's units into rows of kThreads.  Each thread keeps one
// unit of channels, so it loads its bias (__ldg, float4) once, then takes
// kIlp pixels bdy apart: kIlp independent 16-byte loads in flight before the
// math, the epilogue in f32 registers, kIlp plain stores (the next conv
// reads the output at once, from L2 where it fits).  The grid's x counts
// pixel blocks and every offset is 64 bit, so no batch wraps (c1 at B=128 is
// 709 M elements).  A channel count that is not a multiple of the unit, or a
// misaligned pointer, takes the one-lane instantiation.
//
// Padded x.  Where x's pixels lie `stride` values apart, stride a multiple of
// 8 above c (the first c channels of a conv the engine ran at a padded width:
// YOLO9000's 28 269-wide head in a 28 272-wide output), y is still dense, so
// an odd c puts y's pixels at every alignment.  There a thread takes one
// 16-byte pack of y, flat: kVec values that start at channel c0 of pixel p
// (a block's x over the packs that start in one pixel, its y over pixels;
// no division).  Where the pack lies in its pixel, x's values sit at the same
// shift s = c0 % kVec in one or two aligned 16-byte packs of x's row, and the
// bias at c0 % 4 in two or three aligned float4s; s is the same for every
// thread of a pixel, so each picks its window with constant register
// indices after one uniform branch.  The one or two packs that run past a
// pixel's channels (into the next pixel, or within 4 values of the bias's
// end) and the last pack of y take their values one at a time, as every
// pack does where x, y or the bias is not 16-byte aligned.
//
// What bounds it on this card: bytes, the raw output read once and the
// result written once: c1's (128, 416, 416, 32) bf16 moves 2.84 GB, 0.85 ms
// at 3.35 TB/s; YOLO9000's head (128, 17, 17, 28 269) 4.18 GB, 1.25 ms.
//
// Numerics: epilogue.cuh's scalar epilogue per element (built with
// --fmad=false, no fast-math), so the bits are bias_leaky's, NaN, signed
// zeros, infinities and subnormals included.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 2;   // pixels a thread takes: loads in flight before the math

template <class D, int kVec, bool kAct>
__global__ void __launch_bounds__(kThreads)
yolo_bias_leaky_nhwc(const typename D::Storage* __restrict__ x, const float* __restrict__ bias,
                     typename D::Storage* __restrict__ y, long long pixels, int units) {
  using P = Pack<typename D::Storage, kVec>;
  const int u = blockIdx.y * blockDim.x + threadIdx.x;   // unit within a pixel
  if (u >= units) return;
  float b[kVec];
  if constexpr (kVec == 1) {
    b[0] = __ldg(bias + u);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; v += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(bias + u * kVec + v));
      b[v] = q.x;
      b[v + 1] = q.y;
      b[v + 2] = q.z;
      b[v + 3] = q.w;
    }
  }
  const long long first =
      static_cast<long long>(blockIdx.x) * (blockDim.y * kIlp) + threadIdx.y;
  const long long step = blockDim.y;
  const P* __restrict__ xp = reinterpret_cast<const P*>(x);
  P* __restrict__ yp = reinterpret_cast<P*>(y);
  P packs[kIlp];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    const long long pix = first + j * step;
    if (pix < pixels) packs[j] = xp[pix * units + u];
  }
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    const long long pix = first + j * step;
    if (pix < pixels) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) packs[j].v[v] = epilogue<D>(packs[j].v[v], b[v], kAct);
      yp[pix * units + u] = packs[j];
    }
  }
}

template <class D, int kVec>
int launch_vec(const void* x, const float* bias, void* y, long long pixels, int c, int act,
               cudaStream_t stream) {
  using S = typename D::Storage;
  const int units = c / kVec;
  const int bdx = units < kThreads ? units : kThreads;
  const int bdy = kThreads / bdx;
  const dim3 block(bdx, bdy);
  const long long per_block = static_cast<long long>(bdy) * kIlp;
  const dim3 grid(static_cast<unsigned>((pixels + per_block - 1) / per_block),
                  (units + bdx - 1) / bdx);
  const auto* xs = static_cast<const S*>(x);
  auto* ys = static_cast<S*>(y);
  if (act) {
    yolo_bias_leaky_nhwc<D, kVec, true><<<grid, block, 0, stream>>>(xs, bias, ys, pixels, units);
  } else {
    yolo_bias_leaky_nhwc<D, kVec, false><<<grid, block, 0, stream>>>(xs, bias, ys, pixels, units);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[k] = in[S + k] for k < N where s == S: a chain of uniform branches, each
// with constant indices, so both arrays stay in registers
template <int N, int S = 0, typename T, int M>
__device__ __forceinline__ void window(const T (&in)[M], int s, T (&out)[N]) {
  if constexpr (S + N <= M) {
    if (s == S) {
#pragma unroll
      for (int k = 0; k < N; ++k) out[k] = in[S + k];
      return;
    }
    window<N, S + 1>(in, s, out);
  }
}

// The padded case (see the top): x's pixels `stride` values apart, y dense.
// kAligned: x, y and bias are 16-byte aligned; else every pack takes its
// values one at a time.
template <class D, bool kAct, bool kAligned>
__global__ void __launch_bounds__(kThreads)
yolo_bias_leaky_padded(const typename D::Storage* __restrict__ x, const float* __restrict__ bias,
                       typename D::Storage* __restrict__ y, long long pixels, int c,
                       long long stride) {
  using S = typename D::Storage;
  constexpr int kVec = 16 / sizeof(S);
  using P = Pack<S, kVec>;
  const long long p =
      (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * blockDim.y + threadIdx.y;
  if (p >= pixels) return;
  const long long first = p * c;                      // y's offset of pixel p
  const long long f =                                  // this thread's pack of y
      ((first + kVec - 1) / kVec + blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const int c0 = static_cast<int>(f - first);
  if (c0 >= c) return;                                 // the pack starts in the next pixel
  P out;
  if (kAligned && c0 + kVec + 4 <= c) {
    const int s = c0 % kVec, sb = c0 % 4;
    const P* src = reinterpret_cast<const P*>(x + p * stride + (c0 - s));
    S v[2 * kVec];
    const P lo = src[0];
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = lo.v[k];
    if (s) {
      const P hi = src[1];
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[kVec + k] = hi.v[k];
    }
    float bb[kVec + 4];
    const float4* bsrc = reinterpret_cast<const float4*>(bias + (c0 - sb));
#pragma unroll
    for (int q = 0; q < kVec / 4 + 1; ++q) {
      if (q < kVec / 4 || sb) {
        const float4 b4 = __ldg(bsrc + q);
        bb[4 * q] = b4.x;
        bb[4 * q + 1] = b4.y;
        bb[4 * q + 2] = b4.z;
        bb[4 * q + 3] = b4.w;
      }
    }
    S xs[kVec];
    float bs[kVec];
    window(v, s, xs);
    window(bb, sb, bs);
#pragma unroll
    for (int k = 0; k < kVec; ++k) out.v[k] = epilogue<D>(xs[k], bs[k], kAct);
    reinterpret_cast<P*>(y)[f / kVec] = out;
    return;
  }
  const long long total = pixels * c;
  const bool whole = kAligned && f + kVec <= total;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (f + k >= total) break;
    long long q = p;
    int ck = c0 + k;
    while (ck >= c) {                                  // the values past pixel p's channels
      ck -= c;
      ++q;
    }
    out.v[k] = epilogue<D>(x[q * stride + ck], __ldg(bias + ck), kAct);
    if (!whole) y[f + k] = out.v[k];
  }
  if (whole) reinterpret_cast<P*>(y)[f / kVec] = out;
}

template <class D, bool kAligned>
int launch_padded(const void* x, const float* bias, void* y, long long pixels, int c,
                  long long stride, int act, cudaStream_t stream) {
  using S = typename D::Storage;
  constexpr int kVec = 16 / sizeof(S);
  const int packs = (c + kVec - 1) / kVec;             // the most packs that start in a pixel
  const int warps = (packs + 31) / 32;
  const int bdx = warps * 32 < kThreads ? warps * 32 : kThreads;
  const int bdy = kThreads / bdx;
  const dim3 block(bdx, bdy);
  // the grid's x over a pixel's packs, then its y and z over pixel blocks, so
  // the blocks in flight walk a few rows of x and y in order (with the pixel
  // blocks first, YOLO9000's head took 8 % longer on an H100)
  const long long rows = (pixels + bdy - 1) / bdy;
  const unsigned gy = static_cast<unsigned>(rows < 65535 ? rows : 65535);
  const dim3 grid((packs + bdx - 1) / bdx, gy, static_cast<unsigned>((rows + gy - 1) / gy));
  const auto* xs = static_cast<const S*>(x);
  auto* ys = static_cast<S*>(y);
  if (act) {
    yolo_bias_leaky_padded<D, true, kAligned><<<grid, block, 0, stream>>>(xs, bias, ys, pixels,
                                                                          c, stride);
  } else {
    yolo_bias_leaky_padded<D, false, kAligned><<<grid, block, 0, stream>>>(xs, bias, ys, pixels,
                                                                           c, stride);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int launch(const void* x, const float* bias, void* y, long long pixels, int c, long long stride,
           int act, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(typename D::Storage);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  if (stride != c) {
    return aligned ? launch_padded<D, true>(x, bias, y, pixels, c, stride, act, stream)
                   : launch_padded<D, false>(x, bias, y, pixels, c, stride, act, stream);
  }
  const bool vector = c % kVec == 0 && aligned;
  return vector ? launch_vec<D, kVec>(x, bias, y, pixels, c, act, stream)
                : launch_vec<D, 1>(x, bias, y, pixels, c, act, stream);
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x holds `pixels` (B * H * W) pixels `stride` values apart, the first c of
// each read (stride == c: dense; else a multiple of 8 above c), y `pixels` *
// c values, bf16 when `bf16` is set, f32 otherwise; bias (c,) f32.  The
// caller checks shapes (pixels under 2^31, so the grid's x fits), dtypes and
// layouts.
extern "C" int yolo_bias_leaky(const void* x, const float* bias, void* y, long long pixels, int c,
                               long long stride, int act, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, bias, y, pixels, c, stride, act, s)
              : launch<F32>(x, bias, y, pixels, c, stride, act, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
