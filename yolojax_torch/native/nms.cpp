// Native greedy NMS for the host/CPU detection path (BASELINE config 1:
// "single 416×416 detect on VOC2007 with CPU forward + NMS").
//
// Exact greedy semantics, identical to ops/nms.py::nms_select: repeatedly
// emit the highest remaining score, suppress candidates with IoU > overlap,
// stop when the peak falls below the confidence threshold or max_out boxes
// are emitted.  Boxes are yx corner pairs, any units (IoU is scale-free).
//
// `nms_batch` runs independent problems (e.g. image × class) across OpenMP
// threads.  Built on demand by yolojax_torch/native/__init__.py with
//   g++ -O3 -march=native -fopenmp -shared -fPIC
// and called through ctypes — no build-time Python dependency.  Built with
// -ffp-contract=off as well: g++ contracts `area_a + area_b` into an FMA,
// whose single rounding the plain NMS (separate f32 ops) and the card's
// kernel (--fmad=false) do not make, and an IoU one ulp apart flips a
// suppression at IoU == overlap.
//
// The port's copy of yolojax/native/nms.cpp, with one line changed: the
// score sort breaks ties by index, so equal scores are emitted lowest index
// first, as nms_select's argmax and the fused kernel take them (std::sort
// is not stable; the reference's order among equal scores is arbitrary).
// tests/test_torch_native.py holds the rest to the reference's text.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline float iou(const float* a, const float* b) {
  // a, b: [ymin, xmin, ymax, xmax]
  const float iy = std::min(a[2], b[2]) - std::max(a[0], b[0]);
  const float ix = std::min(a[3], b[3]) - std::max(a[1], b[1]);
  if (iy <= 0.f || ix <= 0.f) return 0.f;
  const float inter = iy * ix;
  const float area_a = std::max(a[2] - a[0], 0.f) * std::max(a[3] - a[1], 0.f);
  const float area_b = std::max(b[2] - b[0], 0.f) * std::max(b[3] - b[1], 0.f);
  const float uni = area_a + area_b - inter;
  return uni > 1e-10f ? inter / uni : 0.f;
}

}  // namespace

extern "C" {

// boxes: (n, 4) row-major [ymin,xmin,ymax,xmax]; scores: (n,), clobbered is
// avoided by an internal copy-free "alive" mask.  Outputs: out_idx/out_conf
// sized max_out; returns the number of boxes emitted.
int32_t nms_greedy(const float* boxes, const float* scores, int32_t n,
                   float threshold, float overlap, int32_t max_out,
                   int32_t* out_idx, float* out_conf) {
  int32_t count = 0;
  // score-descending order once; suppression handled with a flag array
  // (O(n log n + n * emitted), beats the repeated-argmax formulation on CPU)
  int32_t* order = new int32_t[n];
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order, order + n,
            [&](int32_t a, int32_t b) {
              return scores[a] > scores[b] || (scores[a] == scores[b] && a < b);
            });
  bool* dead = new bool[n]();
  for (int32_t r = 0; r < n && count < max_out; ++r) {
    const int32_t i = order[r];
    if (dead[i] || !(scores[i] > threshold)) {
      if (!(scores[i] > threshold)) break;  // sorted: all later are below too
      continue;
    }
    out_idx[count] = i;
    out_conf[count] = scores[i];
    ++count;
    const float* bi = boxes + 4 * i;
    for (int32_t r2 = r + 1; r2 < n; ++r2) {
      const int32_t j = order[r2];
      if (!dead[j] && iou(bi, boxes + 4 * j) > overlap) dead[j] = true;
    }
  }
  delete[] order;
  delete[] dead;
  return count;
}

// g independent problems, parallel over OpenMP threads.
// boxes (g, n, 4), scores (g, n) → out_idx/out_conf (g, max_out),
// out_count (g,).
void nms_batch(const float* boxes, const float* scores, int32_t g, int32_t n,
               float threshold, float overlap, int32_t max_out,
               int32_t* out_idx, float* out_conf, int32_t* out_count) {
#pragma omp parallel for schedule(dynamic)
  for (int32_t k = 0; k < g; ++k) {
    out_count[k] = nms_greedy(boxes + (int64_t)k * n * 4,
                              scores + (int64_t)k * n, n, threshold, overlap,
                              max_out, out_idx + (int64_t)k * max_out,
                              out_conf + (int64_t)k * max_out);
  }
}

}  // extern "C"
