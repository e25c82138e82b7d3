// Block-wide greedy NMS over candidates in shared memory, shared by the fused
// decode+NMS kernel (postprocess_fused.cu) and the batched NMS over decoded
// boxes (nms_select.cu).  Each is the device half of the TPU greedy loop
// yolojax/kernels/nms.py::_nms_loop, run by one CTA of kThreads threads per
// (image, class) row.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The larger score wins; on a tie the lower index wins (jnp.argmax's rule).
__device__ __forceinline__ void keep_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    keep_better(v, i, ov, oi);
  }
}

// Block-wide argmax of s[0, n); every thread returns the same (v, i), with
// i == n when no score beats -inf.  The caller must __syncthreads() before
// the next call and before it writes s.
__device__ void block_argmax(const float* s, int n, float* red_v, int* red_i,
                             float& v, int& i) {
  v = -INFINITY;
  i = n;
  for (int j = threadIdx.x; j < n; j += kThreads) keep_better(v, i, s[j], j);
  warp_argmax(v, i);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  // every warp reduces the partials itself: no broadcast round trip
  v = lane < kWarps ? red_v[lane] : -INFINITY;
  i = lane < kWarps ? red_i[lane] : n;
  warp_argmax(v, i);
}

// Greedy NMS over n candidates in shared memory: corners y0/x0/y1/x1 and
// scores s (consumed: picked and suppressed scores become -inf).  Thread 0
// writes the picks' indices and scores to pick_idx / pick_conf; every thread
// returns their count.  Stops when the best remaining score is not
// > threshold or max_out picks are out; suppresses iou > overlap and the pick
// itself.  red_v / red_i hold kWarps partials each.
__device__ int greedy_nms(const float* y0, const float* x0, const float* y1,
                          const float* x1, float* s, int n, float threshold,
                          float overlap, int max_out, int* pick_idx, float* pick_conf,
                          float* red_v, int* red_i) {
  int k = 0;
  while (k < max_out) {
    float m;
    int i;
    block_argmax(s, n, red_v, red_i, m, i);
    if (!(m > threshold)) break;  // uniform: every thread holds the same m
    const float by0 = y0[i], bx0 = x0[i], by1 = y1[i], bx1 = x1[i];
    const float barea = fmaxf(by1 - by0, 0.0f) * fmaxf(bx1 - bx0, 0.0f);
    if (threadIdx.x == 0) {
      pick_idx[k] = i;
      pick_conf[k] = m;
    }
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float area = fmaxf(y1[j] - y0[j], 0.0f) * fmaxf(x1[j] - x0[j], 0.0f);
      const float iy = fmaxf(fminf(y1[j], by1) - fmaxf(y0[j], by0), 0.0f);
      const float ix = fmaxf(fminf(x1[j], bx1) - fmaxf(x0[j], bx0), 0.0f);
      const float inter = iy * ix;
      const float iou = inter / fmaxf(area + barea - inter, 1e-10f);
      if (iou > overlap || j == i) s[j] = -INFINITY;
    }
    __syncthreads();
    ++k;
  }
  return k;
}

}  // namespace
