// Fused YOLOv2 region decode + per-class greedy NMS, hand-written for Hopper
// (sm_90a) and bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/nms.py::postprocess_fused_pallas
// (body _fused_kernel, greedy loop _nms_loop), with the same contract:
//   raw (B, H, W, A*(5+C)) f32 + anchors (A, 2) as (h, w) in grid units
//   -> for each (image, class) up to topk picks: corners, score and count.
//
// Design.  One CTA of 256 threads per (image, class).  The CTA decodes its
// image's N = H*W*A candidates into shared memory -- four corners and this
// class's score, 5 floats each (17 KB at 416, 36 KB at 608) -- and runs the
// greedy loop there, so neither the (B, N, C) confidences nor per-class copies
// of the boxes ever reach device memory.  Each pick is one block-wide argmax
// (warp shuffles, then shared memory) and one pass of IoU suppression; the
// loop is greedy_nms.cuh's, shared with nms_select.cu.
//
// What bounds it on this card: the latency of the serial pick loop (two
// barriers and two shuffle reductions per pick), not bytes -- each CTA reads
// its image's head once (85 KB at 416, mostly from L2, as C CTAs share it).
// The TPU kernel vectorized (image, class) rows over sublanes because its grid
// runs in order on one core; here the grid runs them side by side: B*C = 2560
// CTAs at B=128, C=20 over 132 SMs, several resident per SM.
//
// Numerics follow yolojax/ops/decode.py and the Pallas kernel op for op: f32
// throughout (the wrapper upcasts a bf16 head), sigmoid, exp of the clamped
// size logits, softmax as max, exp(x - max) and a sum added in class order,
// real divisions, expf.  Built without --use_fast_math and with --fmad=false,
// so no multiply and add are contracted into one rounding.  The IoU
// denominator is max(area + barea - inter, 1e-10).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "greedy_nms.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

}  // namespace

__global__ void __launch_bounds__(kThreads)
postprocess_fused_kernel(const float* __restrict__ raw, const float* __restrict__ anchors,
                         float* __restrict__ out_min, float* __restrict__ out_max,
                         float* __restrict__ out_conf, int* __restrict__ out_count,
                         int h, int w, int a, int c, float threshold, float overlap,
                         int topk) {
  extern __shared__ float smem[];
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  const int n = h * w * a, per = 5 + c;
  const int cls = blockIdx.x, img = blockIdx.y;
  float* y0 = smem;
  float* x0 = y0 + n;
  float* y1 = x0 + n;
  float* x1 = y1 + n;
  float* s = x1 + n;
  float* pick_conf = s + n;
  int* pick_idx = reinterpret_cast<int*>(pick_conf + topk);

  // decode: candidate j = (gy*W + gx)*A + anchor, channels [ty,tx,th,tw,to,cls...]
  const float* head = raw + static_cast<size_t>(img) * n * per;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float* r = head + static_cast<size_t>(j) * per;
    const int cell = j / a, anc = j - cell * a;
    const int gy = cell / w, gx = cell - gy * w;
    const float cy = (sigmoid(r[0]) + static_cast<float>(gy)) / static_cast<float>(h);
    const float cx = (sigmoid(r[1]) + static_cast<float>(gx)) / static_cast<float>(w);
    const float sh = anchors[2 * anc] * expf(fminf(fmaxf(r[2], -12.0f), 12.0f))
                     / static_cast<float>(h);
    const float sw = anchors[2 * anc + 1] * expf(fminf(fmaxf(r[3], -12.0f), 12.0f))
                     / static_cast<float>(w);
    const float half_h = sh * 0.5f, half_w = sw * 0.5f;
    y0[j] = cy - half_h;
    y1[j] = cy + half_h;
    x0[j] = cx - half_w;
    x1[j] = cx + half_w;
    const float obj = sigmoid(r[4]);
    float mx = r[5];
    for (int q = 1; q < c; ++q) mx = fmaxf(mx, r[5 + q]);
    float denom = 0.0f;
    for (int q = 0; q < c; ++q) denom += expf(r[5 + q] - mx);
    s[j] = obj * (expf(r[5 + cls] - mx) / denom);
  }
  __syncthreads();

  const int count = greedy_nms(y0, x0, y1, x1, s, n, threshold, overlap, topk,
                               pick_idx, pick_conf, red_v, red_i);

  // the picks in score order; slots past count are written as zeros
  const size_t row = static_cast<size_t>(img) * c + cls;
  float* omin = out_min + row * topk * 2;
  float* omax = out_max + row * topk * 2;
  float* oconf = out_conf + row * topk;
  for (int t = threadIdx.x; t < topk; t += kThreads) {
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f, cf = 0.0f;
    if (t < count) {
      const int i = pick_idx[t];
      v0 = y0[i];
      v1 = x0[i];
      v2 = y1[i];
      v3 = x1[i];
      cf = pick_conf[t];
    }
    omin[2 * t] = v0;
    omin[2 * t + 1] = v1;
    omax[2 * t] = v2;
    omax[2 * t + 1] = v3;
    oconf[t] = cf;
  }
  if (threadIdx.x == 0) out_count[row] = count;
}

// Launch on `stream` without synchronising; returns cudaGetLastError().
// Shared memory: (5*N + 2*topk) floats, which the caller keeps under 48 KB.
extern "C" int yolo_postprocess_fused(const float* raw, const float* anchors,
                                      float* out_min, float* out_max, float* out_conf,
                                      int* out_count, int b, int h, int w, int a, int c,
                                      float threshold, float overlap, int topk,
                                      void* stream) {
  const size_t smem = (5 * static_cast<size_t>(h) * w * a + 2 * static_cast<size_t>(topk))
                      * sizeof(float);
  const dim3 grid(c, b);
  postprocess_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      raw, anchors, out_min, out_max, out_conf, out_count, h, w, a, c, threshold, overlap,
      topk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
