// B2: windowed bilinear crop-and-resize of metric-bounded BEV ROIs.
//
// Replaces dodt_tpu/ops/roi_pallas.py::crop_and_resize_window
// (_roi_window_kernel plus the x-contraction einsum after it). The
// Pallas kernel contracts a 64 x 64 window with bilinear hat matrices on
// the MXU; here both contractions are one 4-tap sample per output in a
// single kernel, with the same window semantics:
//   * sample lattice of ops/roi.sample_grid (half-pixel, clamped to the
//     map), computed with round-to-nearest intrinsics so that it agrees
//     bit for bit with the f32 PyTorch twin;
//   * window origin: the y origin clamped to [0, H - win] and then
//     floored to 8 px, the x origin floored to `ax` = 128/gcd(C, 128) px
//     within [0, W - win];
//   * window-relative sample coords clamped to [0, win - 1], so ROIs
//     larger than the window clamp at its edge exactly as the TPU kernel
//     does (roi_pallas.py:107-119);
//   * every tap rounded to bf16 before the blend: the value the twin and
//     the JAX kernel read after casting an f32 map to bf16.
//
// What bounds it on the H100: bytes and latency, not operations. The
// main-path call (2 f32 maps of 350 x 400 x 32, 300 ROIs each, 7 x 7
// crops) taps 11.6 MB of distinct map pixels, mostly L2 hits between
// neighbouring samples, and writes 1.9 MB: a 4 us bound. The design:
//   * the map is read in its own dtype (f32 or bf16), with no cast of
//     the whole map before the call (35.8 MB read, 17.9 MB written, 16 us
//     at the main shape, four times the kernel's own bound);
//   * 16-byte loads: a thread owns one vector of V channels (4 f32 or 8
//     bf16) of one output pixel, so a warp reads whole pixels' channels
//     contiguously, and writes its V bf16 outputs as one 8- or 16-byte
//     store; a scalar instance (V = 1) takes any C;
//   * no barrier and no shared memory: every warp computes the window
//     itself, lane k the sample coords of row and column k, the origin
//     by a warp minimum, and reads a sample's coords from its lane by a
//     shuffle (a 64 x 64 x 32 f32 window is 512 KB, beyond shared
//     memory, and the taps of neighbouring samples hit L2);
//   * one block of 256 threads per ROI: the main path's 600 ROIs give
//     600 blocks, all resident at once on 132 SMs, each thread with two
//     vectors.
//
// Layouts: img (M, H, W, C) f32 or bf16, boxes (M, N, 4) f32 normalised
// [y1, x1, y2, x2], out (M, N, S, S, C) bf16.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_S = 32;          // one sample per lane
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sample_coord(float lo, float hi, int k,
                                              int s, int dim) {
  // ops/roi.sample_grid: t = lo + (hi - lo) * k / (s - 1), or the box
  // centre for s == 1; pixel = clip(t * dim - 0.5, 0, dim - 1).
  float t;
  if (s > 1) {
    const float g = __fdiv_rn((float)k, (float)(s - 1));
    t = __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), g));
  } else {
    t = __fdiv_rn(__fadd_rn(lo, hi), 2.0f);
  }
  const float p = __fsub_rn(__fmul_rn(t, (float)dim), 0.5f);
  return fminf(fmaxf(p, 0.0f), (float)(dim - 1));
}

__device__ __forceinline__ float tap(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float tap(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V channels of one pixel, each rounded to bf16, as f32
template <typename T, int V>
__device__ __forceinline__ void load_taps(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = tap(p[0]);
  } else {
    static_assert(sizeof(T) * V == 16, "one 16-byte load");
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = tap(e[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* o,
                                           const float (&r)[V]) {
  if constexpr (V == 1) {
    o[0] = __float2bfloat16_rn(r[0]);
  } else {
    uint32_t u[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
      u[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    if constexpr (V == 4)
      *reinterpret_cast<uint2*>(o) = make_uint2(u[0], u[1]);
    else
      *reinterpret_cast<uint4*>(o) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
roi_window_kernel(const T* __restrict__ img, const float* __restrict__ boxes,
                  __nv_bfloat16* __restrict__ out, int h, int w, int c,
                  int n, int s, int win, int ax) {
  const int roi = blockIdx.x;
  const int map = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float* bx = boxes + ((long long)map * n + roi) * 4;

  // the window, in every warp: lane k < s samples row k and column k
  // (lanes past s repeat sample 0, which leaves the minimum as it is)
  const int k = lane < s ? lane : 0;
  const float ys = sample_coord(bx[0], bx[2], k, s, h);
  const float xs = sample_coord(bx[1], bx[3], k, s, w);
  float ymin = ys, xmin = xs;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ymin = fminf(ymin, __shfl_xor_sync(FULL, ymin, off));
    xmin = fminf(xmin, __shfl_xor_sync(FULL, xmin, off));
  }
  int oy = min(max((int)floorf(ymin), 0), h - win);
  oy = (oy >> 3) << 3;
  int ox = min(max((int)floorf(xmin), 0), w - win);
  ox = (ox / ax) * ax;
  const float yr_k = fminf(fmaxf(ys - (float)oy, 0.0f), (float)(win - 1));
  const float xr_k = fminf(fmaxf(xs - (float)ox, 0.0f), (float)(win - 1));

  const int cv = c / V;                  // vectors per pixel
  const int total = s * s * cv;
  const T* base = img + ((long long)map * h + oy) * w * c + (long long)ox * c;
  __nv_bfloat16* o = out + ((long long)map * n + roi) * s * s * c;
  // warp-uniform trip count: every lane takes part in the shuffles
#pragma unroll 2
  for (int e0 = threadIdx.x - lane; e0 < total; e0 += THREADS) {
    const int e = e0 + lane;
    const bool live = e < total;
    const int t = live ? e / cv : 0;
    const int i = t / s, j = t % s;
    const float yr = __shfl_sync(FULL, yr_k, i);
    const float xr = __shfl_sync(FULL, xr_k, j);
    if (!live) continue;
    const int ch = (e - t * cv) * V;
    const int iy0 = (int)floorf(yr), ix0 = (int)floorf(xr);
    const float fy = yr - (float)iy0, fx = xr - (float)ix0;
    // the hat weight of tap i0 + 1 is fy, zero when yr == win - 1
    const int iy1 = min(iy0 + 1, win - 1), ix1 = min(ix0 + 1, win - 1);
    const T* r0 = base + (long long)iy0 * w * c + ch;
    const T* r1 = base + (long long)iy1 * w * c + ch;
    float tl[V], tr[V], bl[V], br[V], res[V];
    load_taps<T, V>(r0 + ix0 * c, tl);
    load_taps<T, V>(r0 + ix1 * c, tr);
    load_taps<T, V>(r1 + ix0 * c, bl);
    load_taps<T, V>(r1 + ix1 * c, br);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      // unfused multiply-adds: the same f32 roundings as the twin
      const float top =
          __fadd_rn(tl[q], __fmul_rn(__fsub_rn(tr[q], tl[q]), fx));
      const float bot =
          __fadd_rn(bl[q], __fmul_rn(__fsub_rn(br[q], bl[q]), fx));
      res[q] = __fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy));
    }
    store_bf16<V>(o + (long long)t * c + ch, res);
  }
}

template <typename T, int V>
int launch(const void* img, const void* boxes, void* out, int m, int h,
           int w, int c, int n, int s, int win, int ax, cudaStream_t st) {
  dim3 grid((unsigned)n, (unsigned)m);
  roi_window_kernel<T, V><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(img), static_cast<const float*>(boxes),
      static_cast<__nv_bfloat16*>(out), h, w, c, n, s, win, ax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16 (the map's); vec: channels per load, 1 or the
// 16-byte vector of the dtype (4 f32, 8 bf16), which needs C % vec == 0
// and a 16-byte aligned map.
extern "C" int dodt_roi_window(const void* img, const void* boxes, void* out,
                               int m, int h, int w, int c, int n, int s,
                               int win, int ax, int dtype, int vec,
                               int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > MAX_S || h < win || w < win ||
      (vec > 1 && (c % vec || reinterpret_cast<uintptr_t>(img) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(img, boxes, out, m, h, w, c, n, s, win, ax, st);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(img, boxes, out, m, h, w, c, n, s, win, ax, st);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(img, boxes, out, m, h, w, c, n, s, win,
                                     ax, st);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(img, boxes, out, m, h, w, c, n, s, win,
                                     ax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
