// Depthwise 3x3 convolution with its folded bias + leaky epilogue, hand-written
// for Hopper (sm_90a) and bound through a plain C interface (ctypes).
//
// Replaces the TPU kernel yolojax/kernels/dwconv.py::dwconv3x3_pallas (body
// _dw_kernel) together with the epilogue the JAX engine runs after it on
// folded params (yolojax/models/engine.py::_post_conv: + b, leaky):
//   x (B, H, W, C) NHWC, taps (3, 3, C), bias (C,) f32
//   -> y (B, Ho, Wo, C), Ho = (H - 1) / stride + 1, symmetric padding 1.
//
// Design (the tiled kernel).  A 3-D grid of (channel tile, band of output-row
// tiles, image); a CTA of 128 threads owns 4 channel vectors of 16 bytes (32
// bf16 or 16 f32 channels) and walks its band one tile of R output rows at a
// time (and, for a row too wide for shared memory, in column tiles).  The
// input rows live in a ring of ((R-1)*stride + 3) + R*stride slab rows in
// shared memory, halo included: while a tile is computed, 16-byte cp.async
// stages the R*stride rows the next tile adds, so each input row of a band
// is read from device memory once.  The padding and everything past the
// image are zero-filled by the copy (src-size 0), so no tap has a bounds
// check.  Each thread holds one channel vector's 9 taps in registers (f32,
// loaded once) and computes a run of L outputs along one row, sliding a
// 3-column window: each new output reads only the input columns it adds
// (one for stride 1, two for stride 2) from shared memory.  The lanes of a
// quarter warp sit on two neighbouring rows whose slab rows lie 64 bytes
// apart modulo 128 (the row pitch is padded), so the 16-byte shared loads do
// not conflict.  All index arithmetic is 32 bit within an image and comes
// from blockIdx/threadIdx.  The host chooses (R, S, L) so the ring fits the
// stride's shared memory (Occupancy: two CTAs an SM at stride 1, three at
// stride 2) and the band so the CTAs fill whole waves.  A channel count that
// is not a multiple of the vector width, a misaligned pointer or an image of
// 2^31 elements or more takes the simple one-lane kernel.
//
// What bounds it on this card: bytes.  9 multiply-adds per output element
// against one read and one write of the activation; at (128, 104, 104, 128)
// bf16 that is 0.71 GB of compulsory traffic, ~0.21 ms at 3.35 TB/s; the
// f32 products and adds (18 instructions per output element, no FMA) and
// the bf16 conversions come close to that on the CUDA cores, so compute
// has to overlap the copies.  The TPU kernel DMA'd a halo slab per row tile
// into VMEM.  The epilogue runs in the same thread, so the conv output makes
// no round trip through device memory before its bias and leaky.
//
// Numerics follow _dw_kernel and the plain version op for op: f32 sum from
// 0, taps dy outer and dx inner, each a product and an add (built with
// --fmad=false); the sum is rounded to the compute dtype, then + bias and
// leaky in f32, rounded again.  A zero-filled tap adds acc + 0*w == acc for
// a finite tap, which is what the padded zero of the plain version adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // the simple kernel
constexpr int kTileThreads = 128;   // the tiled kernel: 4 vectors x 32 pixel workers
constexpr int kTileVecs = 4;
constexpr int kWorkers = kTileThreads / kTileVecs;
constexpr int kPixelBytes = kTileVecs * 16;   // one slab pixel: the tile's channels
// CTAs per SM and the shared memory each may take, by stride.  The bf16
// stride-1 kernel needs ~200 registers a thread; under the cap for three
// CTAs (168) it spilled and ran slower on an H100, so stride 1 runs two
// CTAs of up to 110 KB.
template <int kStride>
struct Occupancy {
  static constexpr int kBlocks = kStride == 1 ? 2 : 3;
  static constexpr int kSmem = kStride == 1 ? 110 * 1024 : 72 * 1024;
};

struct F32 {
  using Storage = float;
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  // two values rounded to the storage type and back; two values stored
  static __device__ __forceinline__ void round2(float& a, float& b) {}
  static __device__ __forceinline__ void store2(float* o, float a, float b) {
    o[0] = a;
    o[1] = b;
  }
};

struct BF16 {
  using Storage = unsigned short;  // raw bf16 bits
  static __device__ __forceinline__ float to_f32(unsigned short v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ unsigned short from_f32(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));  // round to nearest even
  }
  // the same roundings, two values per conversion instruction
  static __device__ __forceinline__ unsigned pack2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a low, b high
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ void round2(float& a, float& b) {
    const unsigned u = pack2(a, b);
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ void store2(unsigned short* o, float a, float b) {
    *reinterpret_cast<unsigned*>(o) = pack2(a, b);
  }
};

template <typename S, int kVec>
struct alignas(sizeof(S) * kVec) Pack {
  S v[kVec];
};

__device__ __forceinline__ float leaky(float z) { return z >= 0.0f ? z : 0.1f * z; }

// -- the simple kernel: one thread per output element, bounds-checked taps

template <class D>
__global__ void __launch_bounds__(kThreads)
dwconv3x3_kernel(const typename D::Storage* __restrict__ x,
                 const typename D::Storage* __restrict__ taps, const float* __restrict__ bias,
                 typename D::Storage* __restrict__ y, int h, int w, int c, int ho, int wo,
                 int stride, int act, long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int ch = static_cast<int>(idx % c);
  long long pix = idx / c;  // (b, oy, ox) flattened
  const int ox = static_cast<int>(pix % wo);
  pix /= wo;
  const int oy = static_cast<int>(pix % ho);
  const long long b = pix / ho;

  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = oy * stride - 1 + dy;
    if (iy < 0 || iy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int ix = ox * stride - 1 + dx;
      if (ix < 0 || ix >= w) continue;
      acc = acc + D::to_f32(x[((b * h + iy) * w + ix) * c + ch])
                  * D::to_f32(taps[(dy * 3 + dx) * c + ch]);
    }
  }
  float z = D::to_f32(D::from_f32(acc)) + bias[ch];
  if (act) z = leaky(z);
  y[((b * ho + oy) * wo + ox) * c + ch] = D::from_f32(z);
}

// -- the tiled kernel

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One slab column of the window: rows dy = 0..2 (at row[dy] in the ring) of
// this thread's vector at byte offset `col`, in f32.
template <class D, int kVec>
__device__ __forceinline__ void load_col(float (&out)[3][kVec],
                                         const unsigned char* const (&row)[3], int col) {
  using P = Pack<typename D::Storage, kVec>;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const P pk = *reinterpret_cast<const P*>(row[dy] + col);
#pragma unroll
    for (int v = 0; v < kVec; ++v) out[dy][v] = D::to_f32(pk.v[v]);
  }
}

// One output vector from the window's columns a, b, c (dx = 0, 1, 2): the
// f32 sum in the plain version's order, then the epilogue, one 16-byte store.
template <class D, int kVec>
__device__ __forceinline__ void emit(const float (&a)[3][kVec], const float (&b)[3][kVec],
                                     const float (&c)[3][kVec], const float (&wt)[9][kVec],
                                     const float* __restrict__ bias, int act,
                                     typename D::Storage* out) {
  using P = Pack<typename D::Storage, kVec>;
  float acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      acc[v] = acc[v] + a[dy][v] * wt[dy * 3][v];
      acc[v] = acc[v] + b[dy][v] * wt[dy * 3 + 1][v];
      acc[v] = acc[v] + c[dy][v] * wt[dy * 3 + 2][v];
    }
  }
  // leaky as max(z, 0.1*z): the same value as z >= 0 ? z : 0.1*z, NaN and
  // signed zeros included, in two instructions
  P o;
#pragma unroll
  for (int v = 0; v < kVec; v += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(bias + v));
    const float bv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int u = 0; u < 4; u += 2) {
      float z0 = acc[v + u], z1 = acc[v + u + 1];
      D::round2(z0, z1);
      z0 = z0 + bv[u];
      z1 = z1 + bv[u + 1];
      if (act) {
        z0 = fmaxf(z0, 0.1f * z0);
        z1 = fmaxf(z1, 0.1f * z1);
      }
      D::store2(o.v + v + u, z0, z1);
    }
  }
  *reinterpret_cast<P*>(out) = o;
}

// Stage input rows [iy0, iy0 + count) of the column tile starting at input
// column col0 into ring slots from `slot` on (wrapping at `ring`): 16-byte
// cp.async, zero-filled outside the image.  The caller commits the group.
template <class S>
__device__ __forceinline__ void stage_rows(unsigned char* slab, const S* xi, const S* x, int iy0,
                                           int count, int slot, int ring, int col0, int cols_in,
                                           int pitch, int h, int w, int c, int c0, int v,
                                           int p) {
  for (int i = 0; i < count; ++i, ++slot) {
    if (slot == ring) slot = 0;
    const int iy = iy0 + i;
    const bool row_ok = iy >= 0 && iy < h;
    unsigned char* dst = slab + slot * pitch + v * 16;
    for (int j = p; j < cols_in; j += kWorkers) {
      const int ix = col0 + j;
      const bool ok = row_ok && ix >= 0 && ix < w;
      cp_async16(dst + j * kPixelBytes, ok ? xi + (iy * w + ix) * c + c0 : x, ok);
    }
  }
}

// blockIdx = (channel tile, band of row tiles, first image); the CTA loops
// over images (stride gridDim.z), column tiles of S*L outputs, and the
// `band` row tiles of R = 1 << log_r output rows each.  The slab is a ring of
// `ring` rows = the tile's rows_in plus the R*stride rows the next tile adds,
// which are staged while the current tile is computed.  Worker p of the 32
// holds row p % R and segment p / R; a slab row is `pitch` bytes.
template <class D, int kVec, int kStride>
__global__ void __launch_bounds__(kTileThreads, Occupancy<kStride>::kBlocks)
dwconv3x3_tiled_kernel(const typename D::Storage* __restrict__ x,
                       const typename D::Storage* __restrict__ taps,
                       const float* __restrict__ bias, typename D::Storage* __restrict__ y,
                       int b, int h, int w, int c, int ho, int wo, int act, int log_r, int run,
                       int band, int cols_in, int pitch) {
  using S = typename D::Storage;
  using P = Pack<S, kVec>;
  extern __shared__ __align__(16) unsigned char slab[];
  const int v = threadIdx.x & (kTileVecs - 1), p = threadIdx.x / kTileVecs;
  const int vec = blockIdx.x * kTileVecs + v;
  const bool lane_on = vec < c / kVec;
  const int c0 = lane_on ? vec * kVec : 0;
  const int rows = 1 << log_r;
  const int r = p & (rows - 1), seg = p >> log_r;
  const int step = rows * kStride;                // input rows a row tile adds
  const int rows_in = (rows - 1) * kStride + 3;
  const int ring = rows_in + step;
  const int span = (kWorkers >> log_r) * run;     // output columns per column tile
  const int tile0 = blockIdx.y * band;
  const int tiles = min(band, (ho + rows - 1) / rows - tile0);
  const int first = seg * run;                    // this thread's first output column

  float wt[9][kVec];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const P q = *reinterpret_cast<const P*>(taps + t * c + c0);
#pragma unroll
    for (int u = 0; u < kVec; ++u) wt[t][u] = D::to_f32(q.v[u]);
  }
  const float* bc = bias + c0;

  for (int img = blockIdx.z; img < b; img += gridDim.z) {
    const S* xi = x + static_cast<size_t>(img) * h * w * c;
    S* yi = y + static_cast<size_t>(img) * ho * wo * c;
    for (int ox0 = 0; ox0 < wo; ox0 += span) {
      const int col0 = ox0 * kStride - 1;
      const int n = min(run, wo - ox0 - first);   // outputs of this thread per row
      __syncthreads();   // the previous column tile's readers are done with the ring
      int head = 0;      // the ring slot of the current tile's first input row
      if (lane_on)
        stage_rows(slab, xi, x, tile0 * step - 1, rows_in, 0, ring, col0, cols_in, pitch, h, w,
                   c, c0, v, p);
      cp_async_commit();
      for (int t = 0; t < tiles; ++t) {
        const int iy0 = (tile0 + t) * step - 1;  // the tile's first input row
        if (t + 1 < tiles) {   // stage the rows the next tile adds, then wait for this one
          if (lane_on) {
            const int slot = head + rows_in;
            stage_rows(slab, xi, x, iy0 + rows_in, step, slot < ring ? slot : slot - ring, ring,
                       col0, cols_in, pitch, h, w, c, c0, v, p);
          }
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const int oy = (tile0 + t) * rows + r;
        if (lane_on && oy < ho && n > 0) {
          const unsigned char* row[3];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const int slot = head + r * kStride + dy;
            row[dy] = slab + (slot < ring ? slot : slot - ring) * pitch + v * 16;
          }
          const int col = first * kStride * kPixelBytes;
          S* out = yi + (oy * wo + ox0 + first) * c + c0;
          float A[3][kVec], B[3][kVec], C[3][kVec];
          // three outputs per trip, the window's columns renamed instead of moved
          if (kStride == 1) {
            load_col<D, kVec>(A, row, col);
            load_col<D, kVec>(B, row, col + kPixelBytes);
            for (int u = 0; u < n; u += 3) {
              load_col<D, kVec>(C, row, col + (u + 2) * kPixelBytes);
              emit<D, kVec>(A, B, C, wt, bc, act, out + u * c);
              if (u + 1 >= n) break;
              load_col<D, kVec>(A, row, col + (u + 3) * kPixelBytes);
              emit<D, kVec>(B, C, A, wt, bc, act, out + (u + 1) * c);
              if (u + 2 >= n) break;
              load_col<D, kVec>(B, row, col + (u + 4) * kPixelBytes);
              emit<D, kVec>(C, A, B, wt, bc, act, out + (u + 2) * c);
            }
          } else {
            load_col<D, kVec>(A, row, col);
            for (int u = 0; u < n; u += 3) {
              load_col<D, kVec>(B, row, col + (2 * u + 1) * kPixelBytes);
              load_col<D, kVec>(C, row, col + (2 * u + 2) * kPixelBytes);
              emit<D, kVec>(A, B, C, wt, bc, act, out + u * c);
              if (u + 1 >= n) break;
              load_col<D, kVec>(A, row, col + (2 * u + 3) * kPixelBytes);
              load_col<D, kVec>(B, row, col + (2 * u + 4) * kPixelBytes);
              emit<D, kVec>(C, A, B, wt, bc, act, out + (u + 1) * c);
              if (u + 2 >= n) break;
              load_col<D, kVec>(C, row, col + (2 * u + 5) * kPixelBytes);
              load_col<D, kVec>(A, row, col + (2 * u + 6) * kPixelBytes);
              emit<D, kVec>(B, C, A, wt, bc, act, out + (u + 2) * c);
            }
          }
        }
        __syncthreads();   // the rows the next staging overwrites are read
        head += step;
        if (head >= ring) head -= ring;
      }
    }
  }
}

// The tile of the tiled kernel: R = 1 << log_r rows of S = 32 / R segments of
// `run` outputs, a ring of rows_in + R*stride slab rows.  The fewest segments
// whose ring fits `smem_max`, with R no taller than the output; past 32
// segments the run is cut to fit.
struct Tile {
  int log_r, run, cols_in, pitch, ring;
  int smem() const { return ring * pitch; }
};

Tile choose_tile(int ho, int wo, int stride, int smem_max) {
  auto make = [&](int log_r, int run) {
    Tile t;
    t.log_r = log_r;
    t.run = run;
    const int span = (kWorkers >> log_r) * run;
    t.cols_in = ((span < wo ? span : wo) - 1) * stride + 3;
    // slab rows 64 bytes apart modulo 128 for the two rows of a quarter warp
    t.pitch = t.cols_in * kPixelBytes
              + (stride == 1 ? (t.cols_in % 2 == 0 ? 64 : 0) : 32);
    t.ring = ((1 << log_r) - 1) * stride + 3 + (1 << log_r) * stride;
    return t;
  };
  for (int log_r = 5; log_r > 0; --log_r) {
    if ((1 << log_r) > ho) continue;
    const int segs = kWorkers >> log_r;
    const Tile t = make(log_r, (wo + segs - 1) / segs);
    if (t.smem() <= smem_max) return t;
  }
  Tile t = make(0, (wo + kWorkers - 1) / kWorkers);
  while (t.run > 1 && t.smem() > smem_max) t = make(0, t.run - 1);
  return t;
}

// Row tiles per CTA: the least modelled time, waves of CTAs (`slots` at a
// time) times the tiles each runs plus one for its first full slab.
int choose_band(int row_tiles, long long others, long long slots) {
  int best = row_tiles;
  long long best_cost = -1;
  for (int band = 1; band <= row_tiles; ++band) {
    const long long ctas = others * ((row_tiles + band - 1) / band);
    const long long cost = (ctas + slots - 1) / slots * (band + 1);
    if (best_cost < 0 || cost < best_cost) {
      best = band;
      best_cost = cost;
    }
  }
  return best;
}

template <class D, int kVec, int kStride>
int launch_tiled(const void* x, const void* taps, const float* bias, void* y, int b, int h,
                 int w, int c, int ho, int wo, int act, cudaStream_t stream) {
  using S = typename D::Storage;
  static unsigned long long configured = 0;   // one bit per device
  static int sms[64] = {0};
  auto kernel = dwconv3x3_tiled_kernel<D, kVec, kStride>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(configured >> dev & 1)) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Occupancy<kStride>::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= 1ULL << dev;
  }
  const Tile t = choose_tile(ho, wo, kStride, Occupancy<kStride>::kSmem);
  const int rows = 1 << t.log_r;
  const int row_tiles = (ho + rows - 1) / rows;
  const int ctiles = (c / kVec + kTileVecs - 1) / kTileVecs;
  const int band = choose_band(row_tiles, static_cast<long long>(ctiles) * b,
                               static_cast<long long>(Occupancy<kStride>::kBlocks) * sms[dev]);
  const dim3 grid(ctiles, (row_tiles + band - 1) / band, b < 65535 ? b : 65535);
  kernel<<<grid, kTileThreads, t.smem(), stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(taps), bias, static_cast<S*>(y), b, h, w,
      c, ho, wo, act, t.log_r, t.run, band, t.cols_in, t.pitch);
  return static_cast<int>(cudaGetLastError());
}

template <class D>
int launch(const void* x, const void* taps, const float* bias, void* y, int b, int h, int w,
           int c, int stride, int act, cudaStream_t stream) {
  using S = typename D::Storage;
  constexpr int kVec = 16 / sizeof(S);
  const int ho = (h - 1) / stride + 1, wo = (w - 1) / stride + 1;
  const bool vector = c % kVec == 0 &&
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(taps) |
       reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  const bool tiled = vector && static_cast<long long>(h) * w * c < (1LL << 31) && ho <= 65535;
  if (tiled) {
    return stride == 1
        ? launch_tiled<D, kVec, 1>(x, taps, bias, y, b, h, w, c, ho, wo, act, stream)
        : launch_tiled<D, kVec, 2>(x, taps, bias, y, b, h, w, c, ho, wo, act, stream);
  }
  const long long total = static_cast<long long>(b) * ho * wo * c;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  dwconv3x3_kernel<D><<<blocks, kThreads, 0, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(taps), bias, static_cast<S*>(y), h, w, c,
      ho, wo, stride, act, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` without synchronising; returns cudaGetLastError().
// x, taps and y hold bf16 when `bf16` is set, f32 otherwise; the caller
// checks shapes, dtypes and contiguity.
extern "C" int yolo_dwconv3x3(const void* x, const void* taps, const float* bias, void* y, int b,
                              int h, int w, int c, int stride, int act, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<BF16>(x, taps, bias, y, b, h, w, c, stride, act, s)
              : launch<F32>(x, taps, bias, y, b, h, w, c, stride, act, s);
}

extern "C" const char* yolo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
