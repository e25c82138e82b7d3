// Greedy NMS by one warp over the candidates above the threshold, shared by
// the fused decode+NMS kernel (postprocess_fused.cu) and the batched NMS over
// decoded boxes (nms_select.cu).  Each is the device half of the TPU greedy
// loop yolojax/kernels/nms.py::_nms_loop for one (image, class) row.
//
// Threshold compaction.  warp_compact keeps, in index order, only the
// candidates whose score is > threshold (ballot + prefix count), with their
// original index.  Greedy over that list gives the same picks as greedy over
// the whole row: the loop stops at the first max that is not > threshold, so
// such a candidate is never picked, and suppressing it changes no later pick.
// Index order keeps ties going to the lower index.  NaN and -inf fail
// > threshold, as they never win keep_better.
//
// The loops.  warp_greedy: one warp per row, no block barrier: each pick
// suppresses the list (IoU > overlap, and the pick itself), compacts the
// survivors in place and finds the next argmax, all in one pass over the
// list (kUnroll entries per lane per trip), then a shuffle reduction.
// block_greedy: where a block holds a single row (nms_select, the fused
// kernel at a small batch) and its list is long -- a saturated row keeps
// most of N -- the block's warps share each pass and meet behind one
// barrier per pick; block_nms picks between the two by the list's length.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    keep_better(v, i, ov, oi);
  }
}

// The row's list: scores ls and original indices li, in index order.
struct NmsList {
  float* ls;
  int* li;
  int m;      // its length
  float best; // the largest score in it (-inf when empty) ...
  int pos;    // ... and its position
};

// Entries a lane takes per trip of a pass: independent loads and IoUs in
// flight, so a long list is not one dependent chain per lane.
constexpr int kUnroll = 4;
constexpr int kTrip = 32 * kUnroll;

// Appends the entries flagged `keep` to the list at m (in lane order within
// each of the kUnroll chunks) and folds them into the running argmax.
__device__ __forceinline__ void append(const bool (&keep)[kUnroll], const float (&sc)[kUnroll],
                                       const int (&j)[kUnroll], float* ls, int* li, int& m,
                                       float& best, int& pos) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1;
  unsigned mask[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) mask[u] = __ballot_sync(kFull, keep[u]);
  __syncwarp();   // every lane has read its entries before any is overwritten
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (keep[u]) {
      const int at = m + __popc(mask[u] & below);
      ls[at] = sc[u];
      li[at] = j[u];
      keep_better(best, pos, sc[u], at);
    }
    m += __popc(mask[u]);
  }
}

// Compacts s[0, n) into (ls, li): the entries > threshold in index order.
// ls may be s itself (each entry moves to a position no later than its
// own, after the warp has read it).  Called by all 32 lanes of a warp;
// every lane returns the same list.
__device__ NmsList warp_compact(const float* s, int n, float threshold, float* ls, int* li) {
  const int lane = threadIdx.x & 31;
  float best = -INFINITY;
  int pos = 0x7fffffff, m = 0;
  for (int e0 = 0; e0 < n; e0 += kTrip) {
    bool keep[kUnroll];
    float sc[kUnroll];
    int j[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      j[u] = e0 + u * 32 + lane;
      sc[u] = j[u] < n ? s[j[u]] : -INFINITY;
      keep[u] = sc[u] > threshold;
    }
    append(keep, sc, j, ls, li, m, best, pos);
  }
  __syncwarp();
  warp_argmax(best, pos);
  return NmsList{ls, li, m, best, pos};
}

// Greedy NMS over a compacted list, by one warp: corners y0/x0/y1/x1 are
// indexed by the original index.  Stops when the best remaining score is not
// > threshold or max_out picks are out; suppresses iou > overlap and the pick
// itself.  For pick k lane 0 calls emit(k, index, score, by0, bx0, by1, bx1).
// Returns the number of picks (the same on every lane).
template <class Emit>
__device__ int warp_greedy(const float* y0, const float* x0, const float* y1, const float* x1,
                           NmsList list, float threshold, float overlap, int max_out,
                           Emit emit) {
  const int lane = threadIdx.x & 31;
  int k = 0;
  while (k < max_out && list.best > threshold) {   // uniform across the warp
    const int i = list.li[list.pos];
    const float by0 = y0[i], bx0 = x0[i], by1 = y1[i], bx1 = x1[i];
    const float barea = fmaxf(by1 - by0, 0.0f) * fmaxf(bx1 - bx0, 0.0f);
    if (lane == 0) emit(k, i, list.best, by0, bx0, by1, bx1);
    if (++k == max_out) break;
    // suppress, compact the survivors and find the next argmax in one pass
    float best = -INFINITY;
    int pos = 0x7fffffff, m = 0;
    for (int e0 = 0; e0 < list.m; e0 += kTrip) {
      bool keep[kUnroll];
      float sc[kUnroll];
      int j[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u * 32 + lane;
        keep[u] = false;
        sc[u] = 0.0f;
        j[u] = 0;
        if (e < list.m) {
          sc[u] = list.ls[e];
          j[u] = list.li[e];
          const int q = j[u];
          const float area = fmaxf(y1[q] - y0[q], 0.0f) * fmaxf(x1[q] - x0[q], 0.0f);
          const float iy = fmaxf(fminf(y1[q], by1) - fmaxf(y0[q], by0), 0.0f);
          const float ix = fmaxf(fminf(x1[q], bx1) - fmaxf(x0[q], bx0), 0.0f);
          const float inter = iy * ix;
          const float iou = inter / fmaxf(area + barea - inter, 1e-10f);
          keep[u] = !(iou > overlap || e == list.pos);
        }
      }
      append(keep, sc, j, list.ls, list.li, m, best, pos);
    }
    __syncwarp();
    warp_argmax(best, pos);
    list.m = m;
    list.best = best;
    list.pos = pos;
  }
  return k;
}

// Shared memory of one block's row: the list's head, and the warps' argmax
// partials, two sets used by turns so one barrier per pick suffices.
struct NmsShared {
  float red_v[2 * kWarps];
  int red_i[2 * kWarps];
  int m, pos;
  float best;
};

// Greedy NMS over a compacted list by the whole block: each thread owns the
// entries e = threadIdx.x (mod kThreads), suppresses them (score -> -inf)
// and keeps the argmax of its survivors; the warps' partials meet in shared
// memory behind one barrier per pick.  Thread 0 calls emit.  Returns the
// number of picks on every thread.
template <class Emit>
__device__ int block_greedy(const float* y0, const float* x0, const float* y1, const float* x1,
                            NmsList list, float threshold, float overlap, int max_out,
                            NmsShared& sh, Emit emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int k = 0, turn = 0;
  while (k < max_out && list.best > threshold) {   // uniform across the block
    const int i = list.li[list.pos];
    const float by0 = y0[i], bx0 = x0[i], by1 = y1[i], bx1 = x1[i];
    const float barea = fmaxf(by1 - by0, 0.0f) * fmaxf(bx1 - bx0, 0.0f);
    if (threadIdx.x == 0) emit(k, i, list.best, by0, bx0, by1, bx1);
    if (++k == max_out) break;
    float best = -INFINITY;
    int pos = 0x7fffffff;
    for (int e = threadIdx.x; e < list.m; e += kThreads) {
      const float sc = list.ls[e];
      if (!(sc > threshold)) continue;   // suppressed before
      const int q = list.li[e];
      const float area = fmaxf(y1[q] - y0[q], 0.0f) * fmaxf(x1[q] - x0[q], 0.0f);
      const float iy = fmaxf(fminf(y1[q], by1) - fmaxf(y0[q], by0), 0.0f);
      const float ix = fmaxf(fminf(x1[q], bx1) - fmaxf(x0[q], bx0), 0.0f);
      const float inter = iy * ix;
      const float iou = inter / fmaxf(area + barea - inter, 1e-10f);
      if (iou > overlap || e == list.pos) {
        list.ls[e] = -INFINITY;
      } else {
        keep_better(best, pos, sc, e);
      }
    }
    warp_argmax(best, pos);
    if (lane == 0) {
      sh.red_v[turn * kWarps + warp] = best;
      sh.red_i[turn * kWarps + warp] = pos;
    }
    __syncthreads();
    best = lane < kWarps ? sh.red_v[turn * kWarps + lane] : -INFINITY;
    pos = lane < kWarps ? sh.red_i[turn * kWarps + lane] : 0x7fffffff;
    warp_argmax(best, pos);
    list.best = best;
    list.pos = pos;
    turn ^= 1;
  }
  return k;
}

// Lists longer than this run the block-wide loop when a block holds one row
// (on an H100, 32 and 128 timed alike on saturated rows, both well ahead
// of a warp alone).
constexpr int kBlockFrom = 32;

// Greedy NMS of one row s[0, n) by the whole block: warp 0 compacts it; a
// list longer than kBlockFrom runs the block-wide loop, a shorter one warp
// 0's loop.  The count is returned on warp 0 (on every thread after
// the block-wide loop); the other warps return -1 after a short list.
template <class Emit>
__device__ int block_nms(const float* y0, const float* x0, const float* y1, const float* x1,
                         float* s, int* li, int n, float threshold, float overlap, int max_out,
                         NmsShared& sh, Emit emit) {
  if (threadIdx.x < 32) {
    const NmsList list = warp_compact(s, n, threshold, s, li);
    if (threadIdx.x == 0) {
      sh.m = list.m;
      sh.best = list.best;
      sh.pos = list.pos;
    }
  }
  __syncthreads();
  const NmsList list{s, li, sh.m, sh.best, sh.pos};
  if (list.m > kBlockFrom)
    return block_greedy(y0, x0, y1, x1, list, threshold, overlap, max_out, sh, emit);
  if (threadIdx.x >= 32) return -1;
  return warp_greedy(y0, x0, y1, x1, list, threshold, overlap, max_out, emit);
}

}  // namespace
