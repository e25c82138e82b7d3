// The folded conv block's epilogue, for kernels that take a raw conv output:
// models/blocks.py::bias_leaky, i.e. the folded-params case of the JAX
// engine's yolojax/models/engine.py::_post_conv.  Shared by maxpool2x2.cu and
// reorg_s2d.cu (dwconv3x3.cu keeps its own two-at-a-time copy).
//
// Each element, exactly as the plain version's separate torch ops on the
// card: widen to f32, + b (f32), leaky as z >= 0 ? z : 0.1f * z, round to
// the storage type (bf16 to nearest even, as torch's cast on the card).
// Built with --fmad=false and no fast-math, so nothing is contracted and the
// bits match bias_leaky's, NaN and signed zeros included.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// kVec storage values that move as one load or store (16 bytes at most)
template <typename S, int kVec>
struct alignas(sizeof(S) * kVec) Pack {
  S v[kVec];
};

template <class D>
__device__ __forceinline__ typename D::Storage epilogue(typename D::Storage v, float b, bool act) {
  float z = D::to_f32(v) + b;
  if (act) z = z >= 0.0f ? z : 0.1f * z;
  return D::from_f32(z);
}

// The epilogue on a pack of kVec channels starting at channel c0.  kVec is 1,
// 4 or 8, and bias + c0 is 16-byte aligned when kVec > 1.
template <class D, int kVec>
__device__ __forceinline__ void epilogue(Pack<typename D::Storage, kVec>& p,
                                         const float* __restrict__ bias, int c0, bool act) {
  float b[kVec];
  if constexpr (kVec == 1) {
    b[0] = __ldg(bias + c0);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; v += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(bias + c0 + v));
      b[v] = q.x;
      b[v + 1] = q.y;
      b[v + 2] = q.z;
      b[v + 3] = q.w;
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) p.v[v] = epilogue<D>(p.v[v], b[v], act);
}

// A 16-byte pack stored past L1 and L2's keep-lists (st.global.cs): for an
// output that is read much later; a smaller pack is stored plainly.
template <typename P>
__device__ __forceinline__ void store_streaming(P* dst, const P& p) {
  if constexpr (sizeof(P) == 16) {
    __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(&p));
  } else {
    *dst = p;
  }
}

}  // namespace
