// B4's tilings at the main-path shape, and its dispatch against a naive
// f64 reference on the Pallas kernel's grid on other shapes (the run-time
// instances, D below its bucket's, a two-stage ring, origins 0 and 1).
// Build and run on the card, from the repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o build/b4_tiles probes/b4_tiles.cu && build/b4_tiles
// Prints each check (max abs error against the reference, 1e-5 of the
// range), then the mean time of 50 launches of each P (output rows per
// thread) x ring depth at (1, 350, 400, 32) f32, D = 11 (CUDA events),
// with its registers, local memory (spills) and blocks per SM.
#include "../dodt_tpu_torch/csrc/correlation_cf.cu"
#include <cmath>
#include <cstdio>
#include <vector>

__global__ void naive(const float* a, const float* b, float* out, int nb,
                      int h, int w, int c, int md, int s2) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int bi = blockIdx.z;
  if (x >= w) return;
  int r = md / s2, d = 2 * r + 1, o = md % s2;   // the Pallas kernel's grid
  for (int ky = 0; ky < d; ++ky)
    for (int kx = 0; kx < d; ++kx) {
      int yy = y + (ky - r) * s2 - o, xx = x + (kx - r) * s2 - o;
      double dot = 0;
      if (yy >= 0 && yy < h && xx >= 0 && xx < w)
        for (int ch = 0; ch < c; ++ch)
          dot += (double)a[(((long long)bi * h + y) * w + x) * c + ch] *
                 b[(((long long)bi * h + yy) * w + xx) * c + ch];
      out[(((long long)bi * d * d + ky * d + kx) * h + y) * w + x] =
          (float)(dot / c);
    }
}

static float frand(unsigned& s) {
  s = s * 1664525u + 1013904223u;
  return ((s >> 8) / 16777216.0f) * 2.f - 1.f;
}

// ops/correlation.py cf_geometry: (D bucket, rows) and the ring depth
static void geometry(int md, int s2, int* dmax, int* rows, int* stages) {
  int d = 2 * (md / s2) + 1;
  *dmax = d <= 5 ? 5 : d <= 11 ? 11 : 21;
  *rows = *dmax == 5 ? 8 : *dmax == 11 ? 5 : 2;
  int span = (d - 1) * s2;
  int stage = (*rows + span) * (32 + span) + *rows * 32;
  *stages = 4 * stage * 16 <= MAX_SMEM ? 4 : 2;
}

int check(int nb, int h, int w, int c, int md, int s2) {
  int d = 2 * (md / s2) + 1;
  size_t n = (size_t)nb * h * w * c, no = (size_t)nb * d * d * h * w;
  std::vector<float> ha(n), hb(n);
  unsigned s = 12345 + h * 7 + md;
  for (auto& v : ha) v = frand(s);
  for (auto& v : hb) v = frand(s);
  float *a, *b, *o1, *o2;
  cudaMalloc(&a, n * 4); cudaMalloc(&b, n * 4);
  cudaMalloc(&o1, no * 4); cudaMalloc(&o2, no * 4);
  cudaMemcpy(a, ha.data(), n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(b, hb.data(), n * 4, cudaMemcpyHostToDevice);
  int dmax, rows, stages;
  geometry(md, s2, &dmax, &rows, &stages);
  int rc = dodt_correlation_cf(a, b, o1, nb, h, w, c, md, s2, dmax, rows,
                               stages, 0, 0);
  naive<<<dim3((w + 127) / 128, h, nb), 128>>>(a, b, o2, nb, h, w, c, md, s2);
  cudaDeviceSynchronize();
  std::vector<float> g1(no), g2(no);
  cudaMemcpy(g1.data(), o1, no * 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(g2.data(), o2, no * 4, cudaMemcpyDeviceToHost);
  double e = 0, sc = 0;
  for (size_t i = 0; i < no; ++i) {
    e = fmax(e, fabs(g1[i] - g2[i]));
    sc = fmax(sc, fabs(g2[i]));
  }
  int ok = rc == 0 && e <= 1e-5 * sc;
  printf("check nb %d h %d w %d c %d md %d s2 %d (D %d, bucket %d, rows %d, "
         "%d stages): rc %d err %.3g scale %.3g %s (%s)\n",
         nb, h, w, c, md, s2, d, dmax, rows, stages, rc, e, sc,
         ok ? "OK" : "BAD", cudaGetErrorString(cudaGetLastError()));
  cudaFree(a); cudaFree(b); cudaFree(o1); cudaFree(o2);
  return !ok;
}

template <int DT, int P, int S2, int STAGES, int MINB>
void timeit(const char* tag, const float* a, const float* b, float* o, int h,
            int w, int c, int md, int s2) {
  const int d = 2 * (md / s2) + 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int i = 0; i < 3; ++i)
    launch<DT, P, S2, STAGES, MINB>(a, b, o, 1, h, w, c, d, s2, 0, 0);
  cudaEventRecord(e0);
  for (int i = 0; i < 50; ++i)
    launch<DT, P, S2, STAGES, MINB>(a, b, o, 1, h, w, c, d, s2, 0, 0);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  auto kernel = correlation_cf_kernel<DT, P, S2, STAGES, MINB>;
  cudaFuncAttributes fa;
  cudaFuncGetAttributes(&fa, kernel);
  int nblk = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nblk, kernel, 32 * d, STAGES * stage_len(P, d, s2) * 16);
  printf("%-22s D %2d P %d stages %d minb %d: %.4f ms  regs %d  local %zu B"
         "  blocks/SM %d  (%s)\n", tag, d, P, STAGES, MINB, ms / 50,
         fa.numRegs, fa.localSizeBytes, nblk,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int bad = 0;
  bad += check(1, 350, 400, 32, 5, 1);   // the main path
  bad += check(2, 64, 96, 32, 5, 2);     // D = 5 at stride 2, origin 1
  bad += check(2, 61, 77, 32, 10, 2);    // D = 11 at stride 2
  bad += check(1, 45, 67, 16, 10, 1);    // D = 21
  bad += check(3, 40, 72, 8, 2, 1);      // D = 5, N = 3, C = 8
  bad += check(1, 33, 50, 64, 5, 1);     // C = 64
  bad += check(1, 29, 37, 8, 1, 1);      // D = 3 in the D = 5 bucket
  bad += check(1, 30, 41, 16, 7, 3);     // D = 5 at stride 3: run-time
  bad += check(1, 26, 45, 8, 4, 1);      // D = 9 in the D = 11 bucket
  bad += check(1, 20, 20, 4, 1, 2);      // D = 1, C = 4, origin 1
  bad += check(2, 47, 61, 32, 3, 2);     // D = 3 at stride 2, origin 1
  bad += check(1, 70, 90, 8, 30, 3);     // D = 21, a two-stage ring
  int h = 350, w = 400, c = 32;
  size_t n = (size_t)h * w * c;
  float *a, *b, *o;
  cudaMalloc(&a, n * 4); cudaMalloc(&b, n * 4);
  cudaMalloc(&o, (size_t)121 * h * w * 4);
  cudaMemset(a, 0, n * 4); cudaMemset(b, 0, n * 4);
  timeit<11, 5, 1, 4, 1>("exact (shipped)", a, b, o, h, w, c, 5, 1);
  timeit<11, 4, 1, 4, 2>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 2, 1, 4, 3>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 3, 1, 4, 2>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 3, 1, 4, 3>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 4, 1, 4, 1>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 5, 1, 4, 2>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 6, 1, 4, 1>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 8, 1, 4, 1>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 5, 1, 2, 1>("exact", a, b, o, h, w, c, 5, 1);
  timeit<11, 5, 0, 4, 1>("run-time", a, b, o, h, w, c, 5, 1);
  timeit<11, 5, 1, 4, 1>("exact (shipped)", a, b, o, h, w, c, 5, 1);
  printf("BAD %d\n", bad);
  return bad;
}
