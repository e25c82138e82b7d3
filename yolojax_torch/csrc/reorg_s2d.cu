// Space-to-depth reorg (the passthrough's s2d order) over NHWC, hand-written
// for Hopper (sm_90a) and bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/reorg.py::reorg_pallas (body
// _reorg_kernel), with the same contract:
//   x (B, H, W, C), H and W divisible by s -> y (B, H/s, W/s, s*s*C),
//   y[b, i, j, (p*s + q)*C + c] = x[b, i*s + p, j*s + q, c].
//
// Design.  A pure copy, one thread per unit of the output in output order:
// 16 bytes when a row of C channels is a whole number of 16-byte units and
// both pointers are aligned (C = 64 in bf16 is 8 units), one element
// otherwise.  Writes are fully coalesced; each thread reads the matching unit
// of the source row, and neighbouring threads read neighbouring units of one
// row of C channels.  The TPU kernel copied s*s strided slabs per output row
// through VMEM; here the index arithmetic is the layout shuffle.
//
// What bounds it on this card: bytes, one read and one write of the tensor.
// c21's output on Darknet-416 at batch 128 in bf16 is 11 MB, ~7 us at
// 3.35 TB/s.  Numerics: none -- the output's bits are the input's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// U is the unit copied: uint4 (16 bytes), or one 4- or 2-byte element.
template <typename U>
__global__ void __launch_bounds__(kThreads)
reorg_s2d_kernel(const U* __restrict__ x, U* __restrict__ y, int h, int w, int units, int s,
                 int ho, int wo, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int u = static_cast<int>(idx % units);  // unit within a row of C channels
  long long rest = idx / units;
  const int pq = static_cast<int>(rest % (s * s));  // offset block p*s + q
  rest /= s * s;
  const int ox = static_cast<int>(rest % wo);
  rest /= wo;
  const int oy = static_cast<int>(rest % ho);
  const long long b = rest / ho;
  const int p = pq / s, q = pq - p * s;
  y[idx] = x[((b * h + oy * s + p) * w + ox * s + q) * units + u];
}

template <typename U>
int launch(const void* x, void* y, int b, int h, int w, int units, int s, cudaStream_t stream) {
  const int ho = h / s, wo = w / s;
  const long long total = static_cast<long long>(b) * ho * wo * s * s * units;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  reorg_s2d_kernel<U><<<blocks, kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<U*>(y), h, w, units, s, ho, wo, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// `esize` is the element size in bytes, 2 or 4; the caller checks shapes
// (H and W divisible by s), dtypes and contiguity.
extern "C" int yolo_reorg_s2d(const void* x, void* y, int b, int h, int w, int c, int s,
                              int esize, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_bytes = static_cast<long long>(c) * esize;
  if (row_bytes % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0) {
    return launch<uint4>(x, y, b, h, w, static_cast<int>(row_bytes / 16), s, st);
  }
  return esize == 4 ? launch<unsigned>(x, y, b, h, w, c, s, st)
                    : launch<unsigned short>(x, y, b, h, w, c, s, st);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
