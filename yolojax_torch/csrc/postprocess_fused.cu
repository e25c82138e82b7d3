// Fused YOLOv2 region decode + per-class greedy NMS, hand-written for Hopper
// (sm_90a) and bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/nms.py::postprocess_fused_pallas
// (body _fused_kernel, greedy loop _nms_loop), with the same contract:
//   raw (B, H, W, A*(5+C)) f32 or bf16 + anchors (A, 2) as (h, w) in grid
//   units -> for each (image, class) up to topk picks: corners, score and
//   keep, the slots past the count zero.
//
// Design.  One launch per call, one CTA of 256 threads per (image, group of
// `group` classes); the wrapper sizes the group by shared memory.  The CTA
// decodes each of its image's N = H*W*A candidates once: it stages 256
// candidates' rows of the head at a time into shared memory with coalesced
// loads (in the head's own dtype; the bf16 -> f32 widening is exact), and a
// thread per candidate computes the four corners (kept in shared memory),
// sigmoid(obj), the softmax max and denominator, and the score of every class
// of the group.  Then each warp takes a class of the group at a time:
// greedy_nms.cuh compacts the class's scores above the threshold (ballot +
// prefix count, in index order) and runs the greedy loop on that list, one
// warp and no block barrier per pick.  With a group of one class (a small
// batch, spread over the SMs) the whole block takes the row, and a long
// list runs the block-wide loop.  Each pick's corners, score and keep are
// written as it is taken; the slots past the count are zeroed.
// Shared memory: corners 4*N floats, the group's scores group*N floats
// (compacted in place), and one region that holds first the staged head rows
// (256*(5+C) floats) and then the group's compacted indices (group*N ints).
//
// What bounds it on this card: at the bench density (almost every score
// under the threshold) the decode -- (C+5) expf per candidate, and the head
// read once per group from L2 -- and the launch; the pick chain of a row is
// one pass over its compacted list per pick.  The TPU kernel vectorized
// (image, class) rows over sublanes because its grid runs in order on one
// core; here the groups run side by side over 132 SMs.
//
// Numerics follow yolojax/ops/decode.py and the Pallas kernel op for op: f32
// throughout, sigmoid, exp of the clamped size logits, softmax as max,
// exp(x - max) and a sum added in class order, real divisions, expf.  Built
// without --use_fast_math and with --fmad=false, so no multiply and add are
// contracted into one rounding.  The IoU denominator is
// max(area + barea - inter, 1e-10).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "greedy_nms.cuh"

namespace {

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);   // bf16 bits, exact
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
postprocess_fused_kernel(const T* __restrict__ raw, const float* __restrict__ anchors,
                         float* __restrict__ out_min, float* __restrict__ out_max,
                         float* __restrict__ out_conf, unsigned char* __restrict__ out_keep,
                         int h, int w, int a, int c, int group, float threshold, float overlap,
                         int topk) {
  extern __shared__ float smem[];
  __shared__ NmsShared sh;
  const int n = h * w * a, per = 5 + c;
  const int cls0 = blockIdx.x * group, img = blockIdx.y;
  const int classes = min(group, c - cls0);
  float* y0 = smem;
  float* x0 = y0 + n;
  float* y1 = x0 + n;
  float* x1 = y1 + n;
  float* s = x1 + n;                        // (group, N) scores, then their lists
  float* stage = s + static_cast<size_t>(group) * n;   // staged head rows ...
  int* li = reinterpret_cast<int*>(stage);  // ... then the lists' indices

  // decode: candidate j = (gy*W + gx)*A + anchor, channels [ty,tx,th,tw,to,cls...]
  const T* head = raw + static_cast<size_t>(img) * n * per;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int count = min(kThreads, n - j0);
    __syncthreads();   // the previous rows are read
    const T* src = head + static_cast<size_t>(j0) * per;
    for (int q = threadIdx.x; q < count * per; q += kThreads) stage[q] = widen(src[q]);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= count) continue;
    const int j = j0 + threadIdx.x;
    float* r = stage + threadIdx.x * per;   // this candidate's row, its own
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
    for (int q = 0; q < c; ++q) {   // each exp kept in the staged row for the scores
      const float e = expf(r[5 + q] - mx);
      denom += e;
      r[5 + q] = e;
    }
    for (int k = 0; k < classes; ++k) s[k * n + j] = obj * (r[5 + cls0 + k] / denom);
  }
  __syncthreads();

  // each pick's corners, score and keep as it is taken; zeros past the count
  const auto outputs = [&](int cls) {
    const size_t row = static_cast<size_t>(img) * c + cls;
    float* omin = out_min + row * topk * 2;
    float* omax = out_max + row * topk * 2;
    float* oconf = out_conf + row * topk;
    unsigned char* okeep = out_keep + row * topk;
    return [=](int t, bool kept, float conf, float by0, float bx0, float by1, float bx1) {
      omin[2 * t] = by0;
      omin[2 * t + 1] = bx0;
      omax[2 * t] = by1;
      omax[2 * t + 1] = bx1;
      oconf[t] = conf;
      okeep[t] = kept;
    };
  };
  const int lane = threadIdx.x & 31;
  if (group == 1) {   // one class: the whole block on its row
    const auto out = outputs(cls0);
    const int count = block_nms(
        y0, x0, y1, x1, s, li, n, threshold, overlap, topk, sh,
        [&](int t, int, float conf, float by0, float bx0, float by1, float bx1) {
          out(t, true, conf, by0, bx0, by1, bx1);
        });
    if (threadIdx.x < 32)
      for (int t = count + lane; t < topk; t += 32) out(t, false, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  // one warp per class of the group
  for (int k = threadIdx.x >> 5; k < classes; k += kWarps) {
    const auto out = outputs(cls0 + k);
    const NmsList list = warp_compact(s + k * n, n, threshold, s + k * n, li + k * n);
    const int count = warp_greedy(
        y0, x0, y1, x1, list, threshold, overlap, topk,
        [&](int t, int, float conf, float by0, float bx0, float by1, float bx1) {
          out(t, true, conf, by0, bx0, by1, bx1);
        });
    for (int t = count + lane; t < topk; t += 32) out(t, false, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <typename T>
int launch(const void* raw, const float* anchors, float* out_min, float* out_max,
           float* out_conf, unsigned char* out_keep, int b, int h, int w, int a, int c,
           int group, int smem, float threshold, float overlap, int topk,
           cudaStream_t stream) {
  static unsigned long long configured = 0;   // one bit per device
  auto kernel = postprocess_fused_kernel<T>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(configured >> dev & 1)) {   // opt in to all the shared memory the static part leaves
    int optin = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= 1ULL << dev;
  }
  const dim3 grid((c + group - 1) / group, b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(raw), anchors, out_min,
                                           out_max, out_conf, out_keep, h, w, a, c, group,
                                           threshold, overlap, topk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// raw holds bf16 when `bf16` is set, f32 otherwise.  The caller chooses the
// class group and its shared memory, smem = 4 * (4*N + group*N +
// max(group*N, 256*(5+C))) bytes, within the card's opt-in limit less the
// kernel's static shared memory (under 200 bytes).
extern "C" int yolo_postprocess_fused(const void* raw, const float* anchors, float* out_min,
                                      float* out_max, float* out_conf, unsigned char* out_keep,
                                      int b, int h, int w, int a, int c, int group, int smem,
                                      float threshold, float overlap, int topk, int bf16,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<unsigned short>(raw, anchors, out_min, out_max, out_conf, out_keep, b, h,
                                       w, a, c, group, smem, threshold, overlap, topk, s)
              : launch<float>(raw, anchors, out_min, out_max, out_conf, out_keep, b, h, w, a,
                              c, group, smem, threshold, overlap, topk, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
