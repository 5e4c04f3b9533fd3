// B3's tilings at the main-path shape, and its dispatch against a naive
// f64 reference on odd shapes (the run-time path and r = 0 included).
// Build and run on the card, from the repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//     -o build/b3_tiles probes/b3_tiles.cu && build/b3_tiles
// Prints each check (max abs error against the reference, 1e-4 of the
// range) and the mean time of 50 launches of each P x warps tiling on
// zero-filled (1, 350, 400, 32) f32 maps, d = 5, Cb = 1 (CUDA events).
#include "../dodt_tpu_torch/csrc/correlation.cu"
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <cmath>

__global__ void naive(const float* a, const float* b, const float* wts, float* out,
                      int nb, int h, int w, int c, int md, int s2, int o,
                      int cb) {
  int x = blockIdx.x * blockDim.x + threadIdx.x;
  int y = blockIdx.y;
  int bi = blockIdx.z;
  if (x >= w) return;
  int r = md / s2, d = 2 * r + 1;
  for (int k = 0; k < cb; ++k) {
    double acc = 0;
    for (int ky = 0; ky < d; ++ky)
      for (int kx = 0; kx < d; ++kx) {
        int yy = y + (ky - r) * s2 - o, xx = x + (kx - r) * s2 - o;
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
        double dot = 0;
        for (int ch = 0; ch < c; ++ch)
          dot += (double)a[(((long long)bi * h + y) * w + x) * c + ch] *
                 b[(((long long)bi * h + yy) * w + xx) * c + ch];
        acc += dot * wts[(ky * d + kx) * cb + k];
      }
    out[(((long long)bi * cb + k) * h + y) * w + x] = (float)(acc / c);
  }
}

static float frand(unsigned& s) { s = s * 1664525u + 1013904223u; return ((s >> 8) / 16777216.0f) * 2.f - 1.f; }

template <int P, int NWY, int R, int S2>
void timeit(const char* tag, const float* a, const float* b, const float* w, float* o,
            int nb, int h, int wd, int c, int cb, int r, int s2) {
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int i = 0; i < 3; ++i) launch<P, NWY, R, S2>(a, b, w, o, nb, h, wd, c, cb, r, s2, 0, 0);
  cudaEventRecord(e0);
  for (int i = 0; i < 50; ++i) launch<P, NWY, R, S2>(a, b, w, o, nb, h, wd, c, cb, r, s2, 0, 0);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  int nblk = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nblk, corr_bottleneck_kernel<P, NWY, R, S2>, 32 * NWY, smem_bytes(P * NWY, r, s2));
  printf("%-28s P %2d NWY %d: %.4f ms  blocks/SM %d  err %s\n", tag, P, NWY, ms / 50, nblk,
         cudaGetErrorString(cudaGetLastError()));
}

int check(int nb, int h, int w, int c, int md, int s2, int cb) {
  int r = md / s2, d = 2 * r + 1, o = md % s2;
  size_t n = (size_t)nb * h * w * c, no = (size_t)nb * cb * h * w;
  std::vector<float> ha(n), hb(n), hw(d * d * cb);
  unsigned s = 12345 + h * 7 + md;
  for (auto& v : ha) v = frand(s);
  for (auto& v : hb) v = frand(s);
  for (auto& v : hw) v = frand(s) / d;
  float *a, *b, *wt, *o1, *o2;
  cudaMalloc(&a, n * 4); cudaMalloc(&b, n * 4); cudaMalloc(&wt, hw.size() * 4);
  cudaMalloc(&o1, no * 4); cudaMalloc(&o2, no * 4);
  cudaMemcpy(a, ha.data(), n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(b, hb.data(), n * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(wt, hw.data(), hw.size() * 4, cudaMemcpyHostToDevice);
  int rc = dodt_corr_bottleneck(a, b, wt, o1, nb, h, w, c, md, s2, cb, 0, 0);
  naive<<<dim3((w + 127) / 128, h, nb), 128>>>(a, b, wt, o2, nb, h, w, c, md, s2, o, cb);
  cudaDeviceSynchronize();
  std::vector<float> g1(no), g2(no);
  cudaMemcpy(g1.data(), o1, no * 4, cudaMemcpyDeviceToHost);
  cudaMemcpy(g2.data(), o2, no * 4, cudaMemcpyDeviceToHost);
  double e = 0, sc = 0;
  for (size_t i = 0; i < no; ++i) { e = fmax(e, fabs(g1[i] - g2[i])); sc = fmax(sc, fabs(g2[i])); }
  int ok = rc == 0 && e <= 1e-4 * sc;
  printf("check nb %d h %d w %d c %d md %d s2 %d origin %d cb %d: rc %d err %.3g scale %.3g %s  (%s)\n",
         nb, h, w, c, md, s2, o, cb, rc, e, sc, ok ? "OK" : "BAD", cudaGetErrorString(cudaGetLastError()));
  cudaFree(a); cudaFree(b); cudaFree(wt); cudaFree(o1); cudaFree(o2);
  return !ok;
}

int main() {
  int bad = 0;
  bad += check(1, 350, 400, 32, 5, 1, 1);
  bad += check(1, 240, 160, 16, 2, 1, 1);
  bad += check(2, 61, 77, 8, 5, 2, 2);
  bad += check(2, 64, 96, 32, 5, 1, 4);
  bad += check(1, 33, 47, 24, 5, 1, 3);
  bad += check(1, 37, 29, 8, 9, 1, 2);    // run-time path
  bad += check(1, 30, 41, 16, 7, 3, 1);   // run-time path, s2 3
  bad += check(1, 20, 20, 8, 1, 2, 1);    // r = 0
  bad += check(1, 37, 29, 8, 3, 2, 1);    // origin 1, r 1
  int h = 350, wd = 400, c = 32;
  size_t n = (size_t)h * wd * c;
  float *a, *b, *w, *o;
  cudaMalloc(&a, n * 4); cudaMalloc(&b, n * 4); cudaMalloc(&w, 121 * 4 * 4);
  cudaMalloc(&o, (size_t)h * wd * 4 * 4);
  cudaMemset(a, 0, n * 4); cudaMemset(b, 0, n * 4); cudaMemset(w, 0, 121 * 16);
  timeit<5, 4, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<4, 4, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<4, 2, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<4, 3, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<6, 2, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<6, 4, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<8, 4, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<8, 2, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<16, 2, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<3, 4, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<2, 4, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<5, 4, 5, 1>("fixed", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<4, 4, -1, 0>("run-time loops", a, b, w, o, 1, h, wd, c, 1, 5, 1);
  timeit<5, 4, 2, 1>("fixed md2 (small cfg)", a, b, w, o, 1, 240, 160, 16, 1, 2, 1);
  printf("BAD %d\n", bad);
  return bad;
}
