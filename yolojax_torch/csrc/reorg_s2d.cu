// Space-to-depth reorg (the passthrough's s2d order) over NHWC, optionally
// with the bias + leaky epilogue of the conv before it and the passthrough's
// concat after it, hand-written for Hopper (sm_90a) and bound through a plain
// C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/reorg.py::reorg_pallas (body
// _reorg_kernel) and, when fused, the epilogue before it
// (yolojax/models/engine.py::_post_conv) and the concat after it
// (engine.py:165-166, channels [reorg, top]):
//   x (B, H, W, C), H and W divisible by s, tail (B, H/s, W/s, Ct) or none
//   -> y (B, H/s, W/s, s*s*C + Ct),
//   y[b, i, j, (p*s + q)*C + c] = e(x[b, i*s + p, j*s + q, c]),
//   y[b, i, j, s*s*C + t] = tail[b, i, j, t],
// where e is epilogue.cuh's bias + leaky with a bias (C,) f32 and the
// identity without.  Without bias and tail it is exactly the TPU kernel's
// contract.
//
// Design.  A copy in output order: the grid's x is the output row (b, i),
// its y cuts the row's Wo * U units into blocks of 256 threads, U = the
// units of one output pixel.  A unit is 16 bytes when C and Ct rows are
// whole 16-byte units and every pointer is aligned (c21's C = 64 in bf16 is
// 8 units, Darknet's top Ct = 1024 is 128), one element otherwise.  Writes
// are fully coalesced; each thread reads the matching unit of the source
// row, neighbouring threads neighbouring units of one row of C channels (or
// of tail).  Index arithmetic is 32 bit; a thread divides twice (unit ->
// pixel, offset block), and the input row is the output row times s plus p.
// The epilogue runs in registers on the way through, so the raw conv output
// is read once; the reorg's own output never goes to device memory before
// the concat, and torch.cat's launch and its read of it are gone.  The TPU
// kernel copied s*s strided slabs per output row through VMEM; here the index
// arithmetic is the layout shuffle.
//
// What bounds it on this card: bytes, the inputs read once and the output
// written once.  On Darknet-416 at batch 128 in bf16: c21's raw output 11.1
// MB, top 44.3 MB, the concat 55.4 MB: ~111 MB, ~33 us at 3.35 TB/s.
// Numerics: the copy moves bits; the epilogue is bias_leaky's, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;

// D is the storage type; kVec values of it move as one unit.
template <class D, int kVec, bool kBias>
__global__ void __launch_bounds__(kThreads)
reorg_s2d_kernel(const typename D::Storage* __restrict__ x, const float* __restrict__ bias,
                 const typename D::Storage* __restrict__ tail, typename D::Storage* __restrict__ y,
                 int w, int cu, int tu, int s, int wo, int act) {
  using P = Pack<typename D::Storage, kVec>;
  const int ss_cu = s * s * cu;
  const int units = ss_cu + tu;                          // units of one output pixel
  const int e = blockIdx.y * kThreads + threadIdx.x;     // unit within the output row
  if (e >= wo * units) return;
  const unsigned row = blockIdx.x;                       // b * Ho + i
  const int ox = e / units;
  const int u = e - ox * units;
  const P* xp = reinterpret_cast<const P*>(x);
  P* yp = reinterpret_cast<P*>(y) + static_cast<size_t>(row) * wo * units + e;
  if (u >= ss_cu) {
    *yp = reinterpret_cast<const P*>(tail)[static_cast<size_t>(row) * wo * tu + ox * tu +
                                           (u - ss_cu)];
    return;
  }
  const int pq = u / cu;
  const int cv = u - pq * cu;
  const int p = pq / s, q = pq - p * s;
  // input row b * H + i * s + p = row * s + p; column ox * s + q
  P v = xp[(static_cast<size_t>(row) * s + p) * w * cu + (ox * s + q) * cu + cv];
  if constexpr (kBias) epilogue<D, kVec>(v, bias, cv * kVec, act);
  *yp = v;
}

template <class D, int kVec>
int launch_vec(const void* x, const float* bias, const void* tail, void* y, int b, int h, int w,
               int c, int ct, int s, int act, cudaStream_t stream) {
  using S = typename D::Storage;
  const int ho = h / s, wo = w / s, cu = c / kVec, tu = ct / kVec;
  const dim3 grid(static_cast<unsigned>(b) * ho,
                  (wo * (s * s * cu + tu) + kThreads - 1) / kThreads);
  const auto* xs = static_cast<const S*>(x);
  const auto* ts = static_cast<const S*>(tail);
  auto* ys = static_cast<S*>(y);
  if (bias) {
    reorg_s2d_kernel<D, kVec, true><<<grid, kThreads, 0, stream>>>(xs, bias, ts, ys, w, cu, tu, s,
                                                                   wo, act);
  } else {
    reorg_s2d_kernel<D, kVec, false><<<grid, kThreads, 0, stream>>>(xs, nullptr, ts, ys, w, cu,
                                                                    tu, s, wo, act);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int launch(const void* x, const float* bias, const void* tail, void* y, int b, int h, int w,
           int c, int ct, int s, int act, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(typename D::Storage);
  const bool vector = c % kVec == 0 && ct % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(bias) |
       reinterpret_cast<uintptr_t>(tail) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  return vector ? launch_vec<D, kVec>(x, bias, tail, y, b, h, w, c, ct, s, act, stream)
                : launch_vec<D, 1>(x, bias, tail, y, b, h, w, c, ct, s, act, stream);
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x, tail and y hold bf16 when `bf16` is set, f32 otherwise; bias (C,) f32 or
// null; tail (B, H/s, W/s, ct) or null with ct = 0.  The caller checks shapes
// (H and W divisible by s, a row's elements under 2^31), dtypes and
// contiguity.
extern "C" int yolo_reorg_s2d(const void* x, const float* bias, const void* tail, void* y, int b,
                              int h, int w, int c, int ct, int s, int act, int bf16,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, bias, tail, y, b, h, w, c, ct, s, act, st)
              : launch<F32>(x, bias, tail, y, b, h, w, c, ct, s, act, st);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
