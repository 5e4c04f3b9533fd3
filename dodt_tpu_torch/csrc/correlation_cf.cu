// B4: the raw FlowNet correlation volume, channel-first.
//
// Replaces dodt_tpu/ops/correlation.py::correlation_pallas_cf
// (_corr_kernel_cf):
//   out[b, k, y, x] = (1 / C) * sum_c A[b, y, x, c] *
//                     B[b, y + dy_k, x + dx_k, c]
// over the D x D displacements k = ky * D + kx, dy = (ky - r) * stride2
// - o, dx = (kx - r) * stride2 - o, r = max_disp / stride2, zero padding
// outside the map. The grid's origin o = max_disp - r * stride2 is that
// of the Pallas kernel (B at ky * stride2 - max_disp rows off the
// output's, dodt_tpu/ops/correlation.py:103-105): 0 wherever max_disp %
// stride2 == 0, where it is correlation_xla's centred grid. No model
// calls it; it is the public correlation op.
//
// What bounds it on the H100: writing the volume. At the largest shape
// the port sees (350 x 400 x 32 f32 maps, D = 11) the output is
// 121 x 350 x 400 f32 = 67.8 MB against 2 x 17.9 MB of input (31 us at
// 3.35 TB/s) and 0.54 G multiply-adds (16 us at 67 TFLOP/s), so f32 FMAs
// on the CUDA cores suffice. The first version gave a block one
// displacement row ky (so every tile was read from L2 D times) and read
// two float4s of B from shared memory, 32 bytes apart across lanes, for
// each output and 8 channels. This design, B3's stencil form carried
// over (csrc/correlation.cu):
//   * a block owns a P x 32 output tile and every displacement: warp kx
//     takes displacement column kx, lane x a column, and a thread holds
//     the P x D outputs of its P rows at every row ky (P x D <= 55
//     accumulators);
//   * column strips: the B pixels a thread reads for column kx are one
//     column of the staged tile, P + (D - 1) s2 rows, and each staged
//     float4 (4 channels) feeds every (p, ky) pair it reaches from
//     registers, up to P of them: 15 shared loads for 55 x 4 FMAs at
//     P = 5, D = 11, against 2 x 121 before;
//   * no bank conflicts: the 32 lanes of a warp read 32 consecutive
//     float4s (pixel-major, 4 channels a pixel);
//   * the haloed tile of 4-channel slices, staged once per block by
//     16-byte cp.async straight from the NHWC maps (zero fill outside the
//     map) into a four-stage ring, so slices s + 1 .. s + 3 load while
//     slice s computes, one barrier a slice (two stages where four do not
//     fit, r s2 > about 20); a block reads (P + 2 r s2)(32 + 2 r s2) B
//     pixels and P x 32 A pixels per tile: 2.6x the input from L2 at the
//     main shape, not D times;
//   * each warp stores 32 consecutive floats of one output row: a
//     128-byte segment per (p, ky), streaming (__stcs), so the 67.8 MB
//     volume does not push the inputs out of L2; times 1/C once at the
//     end.
// Instances: D buckets of 5, 11 and 21 with P = 8, 5 and 2 (40-55
// accumulators; of the P x blocks-per-SM tilings probes/b4_tiles.cu times
// at the main shape, P = 5 at one block of 11 warps per SM was the
// fastest with no spills). D = 5 and 11 at stride2 = 1 and 2 have
// instances whose sizes are all constants (D = 21 so spills); any other D
// and stride2 takes its bucket's instance with run-time strip offsets
// (P loads per ky, the rows past D left off), with a four- or a
// two-stage ring.
//
// Layouts: a, b (B, H, W, C) f32 with C % 4 == 0; out (B, D*D, H, W) f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 32;         // output columns per block: one per lane
constexpr int CK = 4;          // channels per staged slice: one float4
constexpr int MAX_D = 21;      // D: max_disp 10 at stride 1
constexpr int MAX_SMEM = 227 * 1024;

__device__ __forceinline__ void cp_async16(float4* dst, const float* src,
                                           bool inside) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = inside ? 16 : 0;    // 0 source bytes: the copy writes zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ float dot4(float acc, const float4 a,
                                      const float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// float4s of one ring stage: the haloed B tile, then the A tile
__host__ __device__ constexpr int stage_len(int p, int d, int s2) {
  return (p + (d - 1) * s2) * (TW + (d - 1) * s2) + p * TW;
}

// P output rows per thread, a ring of STAGES slices. S2 > 0: D = DT and
// stride2 = S2 at compile time (every tile size and guard a constant);
// S2 == 0: any D = d_rt <= DT and stride2 = s2_rt.
template <int DT, int P, int S2, int STAGES, int MINB>
__global__ void __launch_bounds__(32 * DT, MINB)
correlation_cf_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ out,
                      int h, int w, int c, int d_rt, int s2_rt,
                      int origin) {
  constexpr bool EXACT = S2 > 0;
  const int d = EXACT ? DT : d_rt;
  const int s2 = EXACT ? S2 : s2_rt;
  const int span = (d - 1) * s2;       // 2 r s2
  const int reach = span / 2;
  const int bh = P + span;
  const int bw = TW + span;
  const int stage = bh * bw + P * TW;
  extern __shared__ __align__(16) float4 smem4[];

  const int tid = threadIdx.x;
  const int nthreads = 32 * d;
  const int lane = tid & 31;
  const int kx = tid >> 5;             // this warp's displacement column
  const int bi = blockIdx.z;
  const int y0 = blockIdx.y * P;
  const int x0 = blockIdx.x * TW;
  const float* a_img = a + (long long)bi * h * w * c;
  const float* b_img = b + (long long)bi * h * w * c;

  // copies of channel slice s (channels 4 s .. 4 s + 3) into its stage;
  // staged pixel (i, j) of B is the map's (y0 - reach - origin + i,
  // x0 - reach - origin + j)
  auto stage_slice = [&](int s) {
    float4* st = smem4 + (s % STAGES) * stage;
    const int c0 = s * CK;
    for (int e = tid; e < bh * bw; e += nthreads) {
      const int gy = y0 - reach - origin + e / bw;
      const int gx = x0 - reach - origin + e % bw;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      cp_async16(st + e,
                 in ? b_img + ((long long)gy * w + gx) * c + c0 : b_img, in);
    }
    float4* as = st + bh * bw;
    for (int e = tid; e < P * TW; e += nthreads) {
      const int gy = y0 + e / TW;
      const int gx = x0 + e % TW;
      const bool in = gy < h && gx < w;
      cp_async16(as + e,
                 in ? a_img + ((long long)gy * w + gx) * c + c0 : a_img, in);
    }
  };

  float acc[P][DT];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int ky = 0; ky < DT; ++ky) acc[p][ky] = 0.0f;

  // one commit group per slice, empty past the last, so that slice s has
  // landed once at most STAGES - 2 later groups are pending
  const int n_slices = c / CK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_slices) stage_slice(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < n_slices; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    // every thread's copies of slice s are visible, and every thread is
    // done with slice s - 1, whose stage the next copies overwrite
    __syncthreads();
    if (s + STAGES - 1 < n_slices) stage_slice(s + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float4* bs = smem4 + (s % STAGES) * stage;
    const float4* as = bs + bh * bw;
    float4 av[P];
#pragma unroll
    for (int p = 0; p < P; ++p) av[p] = as[p * TW + lane];
    // row j of this column strip is B at displacement (ky, kx) for output
    // row p = j - ky s2
    const float4* col = bs + lane + kx * s2;
    if constexpr (EXACT) {
#pragma unroll
      for (int j = 0; j < P + (DT - 1) * S2; ++j) {
        const float4 v = col[j * bw];
#pragma unroll
        for (int ky = 0; ky < DT; ++ky) {
          const int p = j - ky * S2;
          if (p >= 0 && p < P) acc[p][ky] = dot4(acc[p][ky], av[p], v);
        }
      }
    } else {
#pragma unroll
      for (int ky = 0; ky < DT; ++ky) {
        if (ky < d) {
#pragma unroll
          for (int p = 0; p < P; ++p)
            acc[p][ky] = dot4(acc[p][ky], av[p], col[(p + ky * s2) * bw]);
        }
      }
    }
  }

  const int x = x0 + lane;
  if (x >= w) return;
  const float inv_c = 1.0f / (float)c;
  const long long plane = (long long)h * w;
  // plane ky * d + kx of map bi, column x
  float* o = out + ((long long)bi * d * d + kx) * plane + x;
#pragma unroll
  for (int ky = 0; ky < DT; ++ky) {
    if (ky < d) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int y = y0 + p;
        if (y < h)
          __stcs(o + (long long)ky * d * plane + (long long)y * w,
                 acc[p][ky] * inv_c);
      }
    }
  }
}

template <int DT, int P, int S2, int STAGES, int MINB>
int launch(const float* a, const float* b, float* out, int nb, int h, int w,
           int c, int d, int s2, int origin, cudaStream_t stream) {
  auto kernel = correlation_cf_kernel<DT, P, S2, STAGES, MINB>;
  const int smem = STAGES * stage_len(P, d, s2) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)((w + TW - 1) / TW), (unsigned)((h + P - 1) / P),
            (unsigned)nb);
  kernel<<<grid, 32 * d, smem, stream>>>(a, b, out, h, w, c, d, s2,
                                         origin);
  return static_cast<int>(cudaGetLastError());
}

template <int DT, int P, int MINB>
int dispatch(const float* a, const float* b, float* out, int nb, int h,
             int w, int c, int d, int s2, int origin, int stages,
             cudaStream_t stream) {
  if (stages == 2)       // a halo too wide for four stages
    return launch<DT, P, 0, 2, MINB>(a, b, out, nb, h, w, c, d, s2, origin,
                                     stream);
  // D = 21 as constants spills at 672 threads' 96 registers
  if constexpr (DT < MAX_D) {
    if (d == DT && s2 == 1)
      return launch<DT, P, 1, 4, MINB>(a, b, out, nb, h, w, c, d, s2,
                                       origin, stream);
    if (d == DT && s2 == 2)
      return launch<DT, P, 2, 4, MINB>(a, b, out, nb, h, w, c, d, s2,
                                       origin, stream);
  }
  return launch<DT, P, 0, 4, MINB>(a, b, out, nb, h, w, c, d, s2, origin,
                                   stream);
}

// the tilings of ops/correlation.py (CF_TILINGS, cf_geometry): the D
// bucket and the output rows per thread of each instance, and its ring
bool has_instance(int dmax, int rows, int stages) {
  return ((dmax == 5 && rows == 8) || (dmax == 11 && rows == 5) ||
          (dmax == 21 && rows == 2)) &&
         (stages == 2 || stages == 4);
}

}  // namespace

// dmax, rows and stages: the wrapper's tiling (cf_geometry), checked
// against the instances; d = 2 (max_disp / stride2) + 1 <= dmax. On the
// Pallas kernel's grid: origin max_disp % stride2, which moves only where
// a tile is staged from (the shared memory is the same).
extern "C" int dodt_correlation_cf(const void* a, const void* b, void* out,
                                   int nb, int h, int w, int c,
                                   int max_disp, int stride2, int dmax,
                                   int rows, int stages, int device,
                                   void* stream) {
  cudaSetDevice(device);
  const int d = stride2 > 0 ? 2 * (max_disp / stride2) + 1 : 0;
  if (stride2 < 1 || max_disp < 0 || d > dmax || dmax > MAX_D || c % CK ||
      !has_instance(dmax, rows, stages) ||
      stages * stage_len(rows, d, stride2) * 16 > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fo = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int origin = max_disp % stride2;
  if (dmax == 5)
    return dispatch<5, 8, 2>(fa, fb, fo, nb, h, w, c, d, stride2, origin,
                             stages, st);
  if (dmax == 11)
    return dispatch<11, 5, 1>(fa, fb, fo, nb, h, w, c, d, stride2, origin,
                              stages, st);
  return dispatch<21, 2, 1>(fa, fb, fo, nb, h, w, c, d, stride2, origin,
                            stages, st);
}
