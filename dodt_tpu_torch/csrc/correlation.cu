// B3: FlowNet correlation fused with its 1x1 bottleneck.
//
// Replaces dodt_tpu/ops/correlation.py::corr_bottleneck_pallas
// (_corr_bottleneck_kernel):
//   out[b, k, y, x] = (1 / C) * sum_d w[d, k] * sum_c A[b, y, x, c] *
//                     B[b, y + dy_d, x + dx_d, c]
// over the D x D displacements d = ky * D + kx, dy = (ky - r) * s2 - o,
// dx = (kx - r) * s2 - o (kernel_size 1, zero padding outside the map).
// The grid's origin o = max_disp - r * s2 is that of the Pallas kernel
// and of JAX's blur form, which the model computes; it sits o pixels up
// and left of correlation_xla's centred grid (they differ only where
// max_disp % s2 != 0). The D^2-channel correlation volume is never
// written.
//
// The contraction is linear, so the kernel computes it in the other
// order: for each channel c, the D x D (dilation s2) stencil of B_c with
// the weights w[:, k], times A_c, summed over c:
//   out[k](y, x) = (1 / C) * sum_c A_c(y, x) * (w_k (*) B_c)(y, x).
// That is D^2 + 1 multiply-adds per pixel and channel, the correlation's
// own count, with P accumulators per thread instead of P x D^2.
//
// What bounds it on the H100: f32 FMAs (the main-path call, 350 x 400 x
// 32 f32 maps, D = 11, Cb = 1, does 140k px x 32 x 122 = 0.55 G
// multiply-adds: 16 us at 67 TFLOP/s; its 36 MB of input take 11 us at
// 3.35 TB/s). The first version read two float4s of B from shared memory
// per displacement for 8 FMAs. This design:
//   - register blocking in y: a thread owns P adjacent rows of one
//     column. For each kx it reads the P + 2 r s2 B pixels of its column
//     strip once, as float4s of 4 channels, and adds each to the up to D
//     row accumulators it reaches (the ky taps): 15 loads for 55 x 4 FMAs
//     at P = 5, D = 11;
//   - no bank conflicts: the 32 lanes of a warp own 32 adjacent columns,
//     so every shared load of a warp is 32 consecutive float4s; the
//     weights are warp-uniform (broadcast) loads;
//   - a 32 x (P * warps) output tile (32 x 20 on the main path: 234
//     blocks of 128 threads, 3 resident per SM) with an r s2 halo (r s2
//     + o rows and columns before the tile, r s2 - o after: the origin
//     moves only where the haloed tile is staged from), staged
//     pixel-major with 4 channels a pixel (16-byte cp.async straight from
//     the NHWC maps, zero fill outside the map) into a two-stage ring:
//     channel slice s + 1 loads while slice s computes;
//   - f32 FMAs throughout (TF32 would lose the 1e-4 tolerance); 1/C once
//     at the end.
// (r, s2) with r s2 <= 6 are template instances whose strip offsets are
// constants; any other max_displacement / stride_2 takes the same kernel
// with run-time loops and P loads per tap. Cb > 1 runs one block per
// output channel (grid z), each a full stencil pass.
//
// Layouts: a, b (B, H, W, C) f32 with C % 4 == 0 (the wrapper asks for
// C % 8); w (D*D, Cb) f32 with Cb <= 4; out (B, Cb, H, W) f32.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 4;          // channels per staged slice: one float4
constexpr int TW = 32;         // output columns per block: one per lane
constexpr int MAX_CB = 4;
constexpr int MAX_SMEM = 227 * 1024;
// the main-path tiling (template instances) and the run-time one: of the
// P x warps tilings probes/b3_tiles.cu times at the main-path shape, 5 x 4
// was the fastest on an H100 (PERF.md)
constexpr int P_FIXED = 5, NWY_FIXED = 4;
constexpr int P_RT = 4, NWY_RT = 4;

__device__ __forceinline__ void cp_async16(float4* dst, const float* src,
                                           bool inside) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = inside ? 16 : 0;    // 0 source bytes: the copy writes zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4 v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

// float4s of one ring stage: the haloed B tile, then the A tile
__host__ __device__ constexpr int stage_len(int th, int reach) {
  return (th + 2 * reach) * (TW + 2 * reach) + th * TW;
}

__host__ __device__ constexpr int smem_bytes(int th, int r, int s2) {
  return 2 * stage_len(th, r * s2) * 16 + (2 * r + 1) * (2 * r + 1) * 4;
}

// R >= 0: r = R and s2 = S2 at compile time; R < 0: r_rt and s2_rt.
template <int P, int NWY, int R, int S2>
__global__ void __launch_bounds__(32 * NWY)
corr_bottleneck_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ wts,
                       float* __restrict__ out, int h, int w, int c, int cb,
                       int r_rt, int s2_rt, int origin) {
  constexpr int TH = P * NWY;
  constexpr int THREADS = 32 * NWY;
  constexpr bool FIXED = R >= 0;
  const int r = FIXED ? R : r_rt;
  const int s2 = FIXED ? S2 : s2_rt;
  const int d = 2 * r + 1;
  const int reach = r * s2;
  const int bh = TH + 2 * reach;
  const int bw = TW + 2 * reach;
  const int stage = stage_len(TH, reach);
  extern __shared__ __align__(16) float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4 + 2 * stage);   // [kx][ky]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = (tid >> 5) * P;
  const int bi = blockIdx.z / cb;
  const int k = blockIdx.z % cb;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const float* a_img = a + (long long)bi * h * w * c;
  const float* b_img = b + (long long)bi * h * w * c;

  for (int e = tid; e < d * d; e += THREADS) {
    const int kx = e / d, ky = e % d;
    w_s[e] = wts[(ky * d + kx) * cb + k];
  }

  // copies of channel slice s (channels 4 s .. 4 s + 3) into its stage;
  // staged pixel (i, j) of B is the map's (y0 - reach - origin + i,
  // x0 - reach - origin + j)
  auto stage_slice = [&](int s) {
    float4* st = smem4 + (s & 1) * stage;
    const int c0 = s * CK;
    for (int e = tid; e < bh * bw; e += THREADS) {
      const int gy = y0 - reach - origin + e / bw;
      const int gx = x0 - reach - origin + e % bw;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      cp_async16(st + e,
                 in ? b_img + ((long long)gy * w + gx) * c + c0 : b_img, in);
    }
    float4* as = st + bh * bw;
    for (int e = tid; e < TH * TW; e += THREADS) {
      const int gy = y0 + e / TW;
      const int gx = x0 + e % TW;
      const bool in = gy < h && gx < w;
      cp_async16(as + e,
                 in ? a_img + ((long long)gy * w + gx) * c + c0 : a_img, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float res[P];
#pragma unroll
  for (int p = 0; p < P; ++p) res[p] = 0.0f;

  const int n_slices = c / CK;
  stage_slice(0);
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {
      // the other stage was last read in slice s - 1, which every thread
      // finished before the barrier at the end of that slice
      stage_slice(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float4* bs = smem4 + (s & 1) * stage;
    const float4* as = bs + bh * bw;

    float4 acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll 1
    for (int kx = 0; kx < d; ++kx) {
      const float* wk = w_s + kx * d;
      if constexpr (FIXED) {
        constexpr int D = 2 * R + 1;
        constexpr int BW = TW + 2 * R * S2;
        const float4* col = bs + row0 * BW + lane + kx * S2;
        float wc[D];
#pragma unroll
        for (int ky = 0; ky < D; ++ky) wc[ky] = wk[ky];
        // strip row j holds tap ky of output row p = j - ky * S2
#pragma unroll
        for (int j = 0; j < P + 2 * R * S2; ++j) {
          const float4 v = col[j * BW];
#pragma unroll
          for (int ky = 0; ky < D; ++ky) {
            const int p = j - ky * S2;
            if (p >= 0 && p < P) fma4(acc[p], wc[ky], v);
          }
        }
      } else {
        const float4* col = bs + row0 * bw + lane + kx * s2;
        for (int ky = 0; ky < d; ++ky) {
          const float wv = wk[ky];
          const float4* rows = col + ky * s2 * bw;
#pragma unroll
          for (int p = 0; p < P; ++p) fma4(acc[p], wv, rows[p * bw]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 av = as[(row0 + p) * TW + lane];
      res[p] = fmaf(av.x, acc[p].x,
                    fmaf(av.y, acc[p].y,
                         fmaf(av.z, acc[p].z, fmaf(av.w, acc[p].w, res[p]))));
    }
    __syncthreads();      // every thread is done with this stage
  }

  const int x = x0 + lane;
  if (x >= w) return;
  const float inv_c = 1.0f / (float)c;
  float* o = out + ((long long)bi * cb + k) * h * w + x;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int y = y0 + row0 + p;
    if (y < h) o[(long long)y * w] = res[p] * inv_c;
  }
}

template <int P, int NWY, int R, int S2>
int launch(const float* a, const float* b, const float* wts, float* out,
           int nb, int h, int w, int c, int cb, int r, int s2, int origin,
           cudaStream_t stream) {
  auto kernel = corr_bottleneck_kernel<P, NWY, R, S2>;
  const int smem = smem_bytes(P * NWY, r, s2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // the whole unified L1 as shared memory, so that blocks can share an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((unsigned)((w + TW - 1) / TW),
            (unsigned)((h + P * NWY - 1) / (P * NWY)), (unsigned)(nb * cb));
  kernel<<<grid, 32 * NWY, smem, stream>>>(a, b, wts, out, h, w, c, cb, r,
                                           s2, origin);
  return static_cast<int>(cudaGetLastError());
}

template <int S2, int... Rs>
int dispatch_fixed(int r, const float* a, const float* b, const float* wts,
                   float* out, int nb, int h, int w, int c, int cb,
                   int origin, cudaStream_t stream) {
  int ret = -1;
  ((r == Rs ? (ret = launch<P_FIXED, NWY_FIXED, Rs, S2>(
                   a, b, wts, out, nb, h, w, c, cb, Rs, S2, origin,
                   stream), 0)
            : 0), ...);
  return ret;
}

int fixed_instance(int r, int s2) {
  return (s2 == 1 && r >= 1 && r <= 6) || (s2 == 2 && r >= 1 && r <= 3);
}

}  // namespace

// Shared memory one launch needs, in bytes, and the most it may take.
extern "C" int dodt_corr_bottleneck_smem_bytes(int max_disp, int stride2) {
  const int r = max_disp / stride2;
  const int th = fixed_instance(r, stride2) ? P_FIXED * NWY_FIXED
                                            : P_RT * NWY_RT;
  return smem_bytes(th, r, stride2);
}

extern "C" int dodt_corr_bottleneck_max_smem() { return MAX_SMEM; }

// On the blur's grid, as the Pallas kernel: origin max_disp % stride2
// (see the top of this file).
extern "C" int dodt_corr_bottleneck(const void* a, const void* b,
                                    const void* wts, void* out, int nb,
                                    int h, int w, int c, int max_disp,
                                    int stride2, int cb, int device,
                                    void* stream) {
  cudaSetDevice(device);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  const float* fw = static_cast<const float*>(wts);
  float* fo = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (c % CK || cb < 1 || cb > MAX_CB || stride2 < 1 || max_disp < 0 ||
      dodt_corr_bottleneck_smem_bytes(max_disp, stride2) > MAX_SMEM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = max_disp / stride2;
  const int origin = max_disp % stride2;
  if (stride2 == 1 && fixed_instance(r, 1))
    return dispatch_fixed<1, 1, 2, 3, 4, 5, 6>(r, fa, fb, fw, fo, nb, h, w,
                                               c, cb, origin, st);
  if (stride2 == 2 && fixed_instance(r, 2))
    return dispatch_fixed<2, 1, 2, 3>(r, fa, fb, fw, fo, nb, h, w, c, cb,
                                      origin, st);
  return launch<P_RT, NWY_RT, -1, 0>(fa, fb, fw, fo, nb, h, w, c, cb, r,
                                     stride2, origin, st);
}
