// 2x2 stride-2 max pool over NHWC, hand-written for Hopper (sm_90a) and bound
// through a plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/pool.py::maxpool2x2_pallas (body
// _pool_kernel), with the same contract:
//   x (B, H, W, C), H and W even, f32 or bf16 -> y (B, H/2, W/2, C).
//
// Design.  One thread per (output pixel, 16 bytes of channels): 8 bf16 or 4
// f32 lanes.  The four taps are four 16-byte loads, and neighbouring threads
// take neighbouring channels of one pixel, so a warp reads whole rows of
// channels.  A channel count that is not a multiple of the vector width, or a
// misaligned pointer, takes the one-lane instantiation.  The TPU kernel
// streamed row-pair blocks through VMEM and split the W pairs by a reshape;
// here each thread loads its pairs itself.
//
// What bounds it on this card: bytes.  Every input byte is read once and a
// quarter as many are written: Darknet-416's pool3 at batch 128 in bf16 reads
// 354 MB and writes 89 MB, ~0.13 ms at 3.35 TB/s.
//
// Numerics: the output is one of the four inputs, chosen as PyTorch's
// max_pool2d chooses it -- from -inf, taps in row-major order, a tap replaces
// the running max when it is greater or NaN -- so it is bit-identical to the
// plain version, signed zeros and NaN included.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct F32 {
  using Storage = float;
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float neg_inf() { return -INFINITY; }
};

struct BF16 {
  using Storage = unsigned short;  // raw bf16 bits
  static __device__ __forceinline__ float to_f32(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ unsigned short neg_inf() { return 0xff80u; }
};

template <typename S, int kVec>
struct alignas(sizeof(S) * kVec) Pack {
  S v[kVec];
};

template <class D, int kVec>
__global__ void __launch_bounds__(kThreads)
maxpool2x2_kernel(const typename D::Storage* __restrict__ x, typename D::Storage* __restrict__ y,
                  int w, int c, int ho, int wo, long long total) {
  using S = typename D::Storage;
  using P = Pack<S, kVec>;
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int vectors = c / kVec;
  const int c0 = static_cast<int>(idx % vectors) * kVec;
  long long pix = idx / vectors;  // (b, oy, ox) flattened
  const int ox = static_cast<int>(pix % wo);
  pix /= wo;
  const int oy = static_cast<int>(pix % ho);
  const long long b = pix / ho;

  // the input is (B, 2*ho, w, c): rows 2*oy and 2*oy + 1, columns 2*ox and 2*ox + 1
  const S* top = x + ((b * 2 * ho + 2 * oy) * w + 2 * ox) * c + c0;
  const S* bottom = top + static_cast<long long>(w) * c;
  const P taps[4] = {*reinterpret_cast<const P*>(top), *reinterpret_cast<const P*>(top + c),
                     *reinterpret_cast<const P*>(bottom),
                     *reinterpret_cast<const P*>(bottom + c)};
  P out;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    S best = D::neg_inf();
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
  *reinterpret_cast<P*>(y + ((b * ho + oy) * wo + ox) * c + c0) = out;
}

template <class D>
int launch(const void* x, void* y, int b, int h, int w, int c, cudaStream_t stream) {
  using S = typename D::Storage;
  constexpr int kVec = 16 / sizeof(S);
  const int ho = h / 2, wo = w / 2;
  const bool vector = c % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  const long long total = static_cast<long long>(b) * ho * wo * (vector ? c / kVec : c);
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (vector) {
    maxpool2x2_kernel<D, kVec><<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(x), static_cast<S*>(y), w, c, ho, wo, total);
  } else {
    maxpool2x2_kernel<D, 1><<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(x), static_cast<S*>(y), w, c, ho, wo, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x and y hold bf16 when `bf16` is set, f32 otherwise; the caller checks
// shapes (H and W even), dtypes and contiguity.
extern "C" int yolo_maxpool2x2(const void* x, void* y, int b, int h, int w, int c, int bf16,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, y, b, h, w, c, s) : launch<F32>(x, y, b, h, w, c, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
