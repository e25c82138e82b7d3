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
// What bounds it on this card: bytes, the raw output read once and the
// result written once: c1's (128, 416, 416, 32) bf16 moves 2.84 GB, 0.85 ms
// at 3.35 TB/s.
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

template <class D>
int launch(const void* x, const float* bias, void* y, long long pixels, int c, int act,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(typename D::Storage);
  const bool vector = c % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  return vector ? launch_vec<D, kVec>(x, bias, y, pixels, c, act, stream)
                : launch_vec<D, 1>(x, bias, y, pixels, c, act, stream);
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x and y hold `pixels` (B * H * W) * c values, bf16 when `bf16` is set, f32
// otherwise; bias (c,) f32.  The caller checks shapes (pixels under 2^31, so
// the grid's x fits), dtypes and contiguity.
extern "C" int yolo_bias_leaky(const void* x, const float* bias, void* y, long long pixels, int c,
                               int act, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, bias, y, pixels, c, act, s)
              : launch<F32>(x, bias, y, pixels, c, act, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
