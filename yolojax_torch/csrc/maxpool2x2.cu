// 2x2 stride-2 max pool over NHWC, optionally with the bias + leaky epilogue
// of the conv before it, hand-written for Hopper (sm_90a) and bound through a
// plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/pool.py::maxpool2x2_pallas (body
// _pool_kernel) and, in the fused mode, the epilogue the JAX engine runs on
// the folded conv's output before it (yolojax/models/engine.py::_post_conv):
//   x (B, H, W, C), H and W even, f32 or bf16 -> y (B, H/2, W/2, C);
//   with bias (C,) f32, x is the raw conv output and each element first
//   becomes epilogue.cuh's bias + leaky, rounded to x's type; with full, that
//   whole (B, H, W, C) epilogue output is written too.
// Without bias it is exactly the TPU kernel's contract.
//
// Design.  The grid's x is the output row (b, oy), so the input's top row is
// 2 * row and no thread divides a 64-bit index; its y cuts the row's
// Wo * C / kVec units into blocks of 256 threads.  Each thread takes one unit
// of one output pixel: 16 bytes of channels (8 bf16 or 4 f32 lanes), its four
// taps four 16-byte loads, neighbouring threads on neighbouring channels of
// one pixel, so a warp reads whole runs of a row.  All index arithmetic is 32
// bit, one division per thread (unit -> pixel, channel).  The fused mode runs
// the epilogue on the four taps in registers, writes them to the
// full-resolution output with streaming stores when asked (it is read only
// at the passthrough, much later), and pools them; the pooled output is
// stored plainly, since the next conv reads it at once (from L2 at small
// batches).  So the raw conv output is read once, and the f32 epilogue's
// five or six passes over it (blocks.py::bias_leaky) and the pool's own read
// of the epilogue output are gone.  A channel count that is not a multiple
// of the unit, or a misaligned pointer, takes the one-lane instantiation.
// The TPU kernel streamed row-pair blocks through VMEM and split the W pairs
// by a reshape; here each thread loads its pairs itself.
//
// What bounds it on this card: bytes, the raw input read once, the pooled
// output (a quarter of it) written, and the full output when asked: c13's
// (128, 26, 26, 512) bf16 on Darknet-416 reads 88.6 MB and writes 22.2 MB
// (+ 88.6 MB), ~33 us (~60 us) at 3.35 TB/s.
//
// Numerics: the output is one of the four (epilogue) taps, its bits copied,
// chosen as PyTorch's max_pool2d chooses it -- from -inf, taps in row-major
// order, a tap replaces the running max when it is greater or NaN (so the
// last NaN wins, payload and sign kept) -- so it is bit-identical to the
// plain version, signed zeros and NaN included.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;

template <class D, int kVec, bool kBias, bool kFull>
__global__ void __launch_bounds__(kThreads)
maxpool2x2_kernel(const typename D::Storage* __restrict__ x, const float* __restrict__ bias,
                  typename D::Storage* __restrict__ y, typename D::Storage* __restrict__ full,
                  int w, int c, int wo, int units, int act) {
  using S = typename D::Storage;
  using P = Pack<S, kVec>;
  const int e = blockIdx.y * kThreads + threadIdx.x;   // unit within the output row
  if (e >= wo * units) return;
  const int ox = e / units;
  const int c0 = (e - ox * units) * kVec;
  const unsigned row = blockIdx.x;                     // b * Ho + oy
  const size_t row_elems = static_cast<size_t>(w) * c;
  // input rows 2*row and 2*row + 1 (b * H + 2 * oy), columns 2*ox and 2*ox + 1
  const size_t top = 2 * row * row_elems + static_cast<size_t>(2 * ox * c + c0);
  const size_t at[4] = {top, top + c, top + row_elems, top + row_elems + c};
  P taps[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) taps[t] = *reinterpret_cast<const P*>(x + at[t]);
  if constexpr (kBias) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      epilogue<D, kVec>(taps[t], bias, c0, act);
      if constexpr (kFull) store_streaming(reinterpret_cast<P*>(full + at[t]), taps[t]);
    }
  }
  P out;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    S best = taps[0].v[v];   // kept only if every tap is -inf
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float val = D::to_f32(taps[t].v[v]);
      if (val > m || isnan(val)) {
        m = val;
        best = taps[t].v[v];
      }
    }
    out.v[v] = best;
  }
  const size_t out_at = static_cast<size_t>(row) * wo * c + static_cast<size_t>(ox * c + c0);
  *reinterpret_cast<P*>(y + out_at) = out;
}

template <class D, int kVec>
int launch_vec(const void* x, const float* bias, void* y, void* full, int b, int h, int w, int c,
               int act, cudaStream_t stream) {
  using S = typename D::Storage;
  const int ho = h / 2, wo = w / 2, units = c / kVec;
  const dim3 grid(static_cast<unsigned>(b) * ho, (wo * units + kThreads - 1) / kThreads);
  const auto* xs = static_cast<const S*>(x);
  auto* ys = static_cast<S*>(y);
  auto* fs = static_cast<S*>(full);
  if (!bias) {
    maxpool2x2_kernel<D, kVec, false, false><<<grid, kThreads, 0, stream>>>(
        xs, nullptr, ys, nullptr, w, c, wo, units, act);
  } else if (!full) {
    maxpool2x2_kernel<D, kVec, true, false><<<grid, kThreads, 0, stream>>>(
        xs, bias, ys, nullptr, w, c, wo, units, act);
  } else {
    maxpool2x2_kernel<D, kVec, true, true><<<grid, kThreads, 0, stream>>>(
        xs, bias, ys, fs, w, c, wo, units, act);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int launch(const void* x, const float* bias, void* y, void* full, int b, int h, int w, int c,
           int act, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(typename D::Storage);
  const bool vector = c % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(full) | reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  return vector ? launch_vec<D, kVec>(x, bias, y, full, b, h, w, c, act, stream)
                : launch_vec<D, 1>(x, bias, y, full, b, h, w, c, act, stream);
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x, y and full hold bf16 when `bf16` is set, f32 otherwise.  bias (C,) f32
// or null: null is the plain pool, and full must then be null too; full
// (B, H, W, C) or null.  The caller checks shapes (H and W even, W * C and
// the output row's units under 2^31), dtypes and contiguity.
extern "C" int yolo_maxpool2x2(const void* x, const float* bias, void* y, void* full, int b,
                               int h, int w, int c, int act, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, bias, y, full, b, h, w, c, act, s)
              : launch<F32>(x, bias, y, full, b, h, w, c, act, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
