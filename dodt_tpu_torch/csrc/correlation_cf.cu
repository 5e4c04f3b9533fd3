// B4: the raw FlowNet correlation volume, channel-first.
//
// Replaces dodt_tpu/ops/correlation.py::correlation_pallas_cf
// (_corr_kernel_cf):
//   out[b, k, y, x] = (1 / C) * sum_c A[b, y, x, c] *
//                     B[b, y + dy_k, x + dx_k, c]
// over the D x D displacements k = ky * D + kx, dy = (ky - r) * stride2,
// dx = (kx - r) * stride2, r = max_disp / stride2, zero padding outside
// the map. No model calls it; it is the public correlation op.
//
// What bounds it on the H100: writing the volume. At the largest shape
// the port sees (350 x 400 x 32 f32 maps, D = 11) the output is
// 121 x 350 x 400 f32 = 67.8 MB against 2 x 17.9 MB of input and 0.54 G
// multiply-adds, so the design keeps the writes coalesced and the input
// reads on chip:
//   * a block owns an 8 x 32 output tile and ONE displacement row ky, so a
//     thread holds D accumulators (one per kx) and register pressure does
//     not grow with D^2;
//   * a warp spans 32 consecutive x of one output row: each of the D
//     stores per thread is one 128-byte segment of the channel-first
//     volume;
//   * B is staged in 8-channel slices of the tile's rows shifted by dy,
//     with a max_disp column halo (8 x 42 x 8 f32 = 10.8 KB), and every
//     staged value is reused by the D displacements of the row;
//   * the pixel's 8 A values of a slice sit in registers.
// Neighbouring blocks re-read B's rows from L2 (B is 17.9 MB, well inside
// the 50 MB L2), about 4x the input once per call.
//
// Layouts: a, b (B, H, W, C) f32 with C % 8 == 0; out (B, D*D, H, W) f32.
#include <cuda_runtime.h>

namespace {

constexpr int TH = 8;
constexpr int TW = 32;
constexpr int CK = 8;          // channels per staged slice
constexpr int MAX_D = 21;      // displacement row length (max_disp 10 at stride 1)

__global__ void __launch_bounds__(TH * TW)
correlation_cf_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* __restrict__ out,
                      int h, int w, int c, int max_disp, int stride2) {
  extern __shared__ __align__(16) float b_s[];   // [TH][bw][CK]
  const int radius = max_disp / stride2;
  const int d = 2 * radius + 1;
  const int bw = TW + 2 * max_disp;
  const int bi = blockIdx.z / d;
  const int ky = blockIdx.z % d;
  const int dy = (ky - radius) * stride2;

  const int tid = threadIdx.y * TW + threadIdx.x;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int y = y0 + threadIdx.y;
  const int x = x0 + threadIdx.x;
  const bool inside = y < h && x < w;
  const float* a_img = a + (long long)bi * h * w * c;
  const float* b_img = b + (long long)bi * h * w * c;

  float acc[MAX_D];
#pragma unroll
  for (int k = 0; k < MAX_D; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < c; c0 += CK) {
    __syncthreads();
    for (int e = tid; e < TH * bw * (CK / 4); e += TH * TW) {
      const int q = e % (CK / 4);
      const int p = e / (CK / 4);
      const int px = p % bw;
      const int py = p / bw;
      const int gy = y0 + py + dy;
      const int gx = x0 - max_disp + px;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = *reinterpret_cast<const float4*>(
            b_img + ((long long)gy * w + gx) * c + c0 + q * 4);
      *reinterpret_cast<float4*>(&b_s[(py * bw + px) * CK + q * 4]) = v;
    }
    __syncthreads();

    float av[CK];
    if (inside) {
      const float4* ap = reinterpret_cast<const float4*>(
          a_img + ((long long)y * w + x) * c + c0);
      const float4 a0 = ap[0], a1 = ap[1];
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
    } else {
#pragma unroll
      for (int i = 0; i < CK; ++i) av[i] = 0.0f;
    }

    const float* row = &b_s[threadIdx.y * bw * CK];
#pragma unroll
    for (int kx = 0; kx < MAX_D; ++kx) {
      if (kx < d) {
        const int sx = threadIdx.x + max_disp + (kx - radius) * stride2;
        const float4* bp = reinterpret_cast<const float4*>(&row[sx * CK]);
        const float4 b0 = bp[0], b1 = bp[1];
        float s = acc[kx];
        s += av[0] * b0.x;
        s += av[1] * b0.y;
        s += av[2] * b0.z;
        s += av[3] * b0.w;
        s += av[4] * b1.x;
        s += av[5] * b1.y;
        s += av[6] * b1.z;
        s += av[7] * b1.w;
        acc[kx] = s;
      }
    }
  }

  if (inside) {
    const float cf = (float)c;
    float* o = out + (((long long)bi * d * d + (long long)ky * d) * h + y) *
                         w + x;
#pragma unroll
    for (int kx = 0; kx < MAX_D; ++kx)
      if (kx < d) o[(long long)kx * h * w] = acc[kx] / cf;
  }
}

}  // namespace

extern "C" int dodt_correlation_cf_smem_bytes(int max_disp) {
  return (int)sizeof(float) * TH * (TW + 2 * max_disp) * CK;
}

extern "C" int dodt_correlation_cf(const void* a, const void* b, void* out,
                                   int nb, int h, int w, int c,
                                   int max_disp, int stride2, int device,
                                   void* stream) {
  cudaSetDevice(device);
  const int d = 2 * (max_disp / stride2) + 1;
  if (d > MAX_D || c % CK) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)((w + TW - 1) / TW), (unsigned)((h + TH - 1) / TH),
            (unsigned)(nb * d));
  dim3 block(TW, TH);
  correlation_cf_kernel<<<grid, block,
                          dodt_correlation_cf_smem_bytes(max_disp),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), h, w, c, max_disp, stride2);
  return static_cast<int>(cudaGetLastError());
}
