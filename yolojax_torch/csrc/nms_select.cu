// Batched greedy NMS over decoded boxes, hand-written for Hopper (sm_90a) and
// bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/nms.py::nms_select_pallas (body
// _nms_kernel, greedy loop _nms_loop), with the same contract:
//   boxes (Gb, N, 4) f32 as [ymin, xmin, ymax, xmax], scores (G, N) f32, and
//   box_row (G,) int32: score row g reads box row box_row[g]
//   -> for each score row up to max_out picks in score order: index, score
//      and count; the slots past the count hold 0.
//
// Design.  One CTA of 256 threads per score row, i.e. per (image, class) on
// the detect path.  A row reads its boxes through box_row, so boxes of shape
// (B, 1, N, 4) broadcast against scores (B, C, N) are never copied per class
// (the TPU wrapper materialises that copy, yolojax/kernels/nms.py:177-178,
// which suited its sequential grid).  The CTA loads the row's four corners
// and scores into shared memory, then greedy_nms.cuh's block_nms: warp 0
// compacts the scores above the threshold (with their indices, N more ints:
// 6*N floats in all, 20 KB at N = 845, 43 KB at N = 1805), and the greedy
// loop runs on that list, by warp 0 alone (no block barrier) or, for a long
// list, by the whole block.
//
// What bounds it on this card: the latency of the pick chain, one pass over
// the compacted list per pick, not bytes -- a row reads 20 bytes per
// candidate once.  The grid runs the rows side by side: B*C = 2560 CTAs at
// B = 128, C = 20.
//
// Numerics: no arithmetic on the scores, which are compared and copied; the
// IoU is ops/iou.py's, max(area + barea - inter, 1e-10) as the denominator,
// built with --fmad=false.  Ties go to the lower index, as jnp.argmax's.
#include <cuda_runtime.h>
#include <stddef.h>

#include "greedy_nms.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
nms_select_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                  const int* __restrict__ box_row, int* __restrict__ out_idx,
                  float* __restrict__ out_conf, int* __restrict__ out_count, int n,
                  float threshold, float overlap, int max_out) {
  extern __shared__ float smem[];
  __shared__ NmsShared sh;
  const int row = blockIdx.x;
  float* y0 = smem;
  float* x0 = y0 + n;
  float* y1 = x0 + n;
  float* x1 = y1 + n;
  float* s = x1 + n;
  int* li = reinterpret_cast<int*>(s + n);

  const float4* b = boxes + static_cast<size_t>(box_row[row]) * n;
  const float* sc = scores + static_cast<size_t>(row) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float4 v = b[j];
    y0[j] = v.x;
    x0[j] = v.y;
    y1[j] = v.z;
    x1[j] = v.w;
    s[j] = sc[j];
  }
  __syncthreads();

  int* oidx = out_idx + static_cast<size_t>(row) * max_out;
  float* oconf = out_conf + static_cast<size_t>(row) * max_out;
  const int count = block_nms(y0, x0, y1, x1, s, li, n, threshold, overlap, max_out, sh,
                              [&](int t, int i, float conf, float, float, float, float) {
                                oidx[t] = i;
                                oconf[t] = conf;
                              });
  if (threadIdx.x >= 32) return;
  for (int t = count + threadIdx.x; t < max_out; t += 32) {
    oidx[t] = 0;
    oconf[t] = 0.0f;
  }
  if (threadIdx.x == 0) out_count[row] = count;
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// boxes must be 16-byte aligned; shared memory is 6*N floats, which the
// caller keeps under 48 KB.
extern "C" int yolo_nms_select(const void* boxes, const float* scores, const int* box_row,
                               int* out_idx, float* out_conf, int* out_count, int rows, int n,
                               float threshold, float overlap, int max_out, void* stream) {
  const size_t smem = 6 * static_cast<size_t>(n) * sizeof(float);
  nms_select_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), scores, box_row, out_idx, out_conf, out_count, n,
      threshold, overlap, max_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
