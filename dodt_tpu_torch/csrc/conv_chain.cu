// B1: one 3x3 SAME conv + bias + ReLU stage of the tower's conv chain,
// an implicit GEMM on Hopper's warpgroup tensor-core instructions.
//
// Replaces dodt_tpu/ops/conv_chain.py::conv_chain_pallas (_chain_kernel),
// which runs the whole conv4 block (3 convs, 128->256->256->256) as
// shifted matmuls on VMEM-resident row strips. Here each conv of the
// chain is one launch; the inter-conv activations (8800 x 256 bf16 =
// 4.5 MB per BEV conv) go through device memory. Keeping them on chip
// across the chain, as the Pallas strip does, needs the whole haloed
// 256-channel strip in shared memory (227 KB holds about 14 rows of 32
// pixels plus a 1-row halo per conv) and recomputed halos: not done.
//
// What bounds it on the H100: operations. The two towers' conv4 blocks
// are 45.9 GFLOP per keyframe (46 us at 989 TFLOP/s bf16) on ~1.1 KFLOP
// per byte read, far above the ~295 FLOP/byte ridge. The design:
//   - implicit GEMM: M = pixels in raster order, 64 per block (one
//     wgmma m64 tile, one warpgroup of 128 threads), N = output
//     channels, BN = 128 (or the largest of 64, 32, 16, 8 dividing Co),
//     K = 9 taps x Ci in 64-channel slices (the 128-byte rows of the
//     swizzled tiles); each K slice is 4 wgmma.m64nBNk16 steps, bf16
//     operands from shared memory, f32 accumulators in registers;
//   - pipelined loads: a 3-stage ring of shared tiles filled by
//     cp.async (16-byte chunks, written in the 128-byte swizzle the
//     wgmma descriptors name), started 2 K slices ahead of the wgmma that
//     reads them; one barrier per K slice. K runs tap-fastest within a
//     channel slice, so the 9 shifted A tiles of a slice come mostly
//     from L1;
//   - SAME padding exact: a tap outside the image, and channels past Ci
//     of the last slice, are zero-filled by the copy (source size 0);
//   - weights packed once on the host side into the K-major (Co, 9*Ci)
//     layout that wgmma's B operand reads (ops/conv_chain.py caches it);
//   - the grid is (M / 64) x (Co / BN): 138 x 2 = 276 blocks for the BEV
//     map (8800 px) and 212 for the image map (6750 px), three blocks
//     per SM (73 KB of shared memory each), so all 132 SMs have work
//     and every block is resident at once;
//   - epilogue: + bias, ReLU, one rounding to bf16, from the
//     accumulators' registers.
// Measured on an H100 at the main-path shapes, none of these variants was
// faster: two warpgroups sharing one B tile (M = 128 per block, half the
// weight traffic), one wgmma group kept in flight across the barrier
// with 3- and 4-stage rings (4 stages cut residency to 2 blocks per SM
// and left a second wave), BN = 64. The kernel runs at about 0.18 of
// the bf16 bound; what is left to try is TMA copies started by a
// producer warp with mbarriers, in place of the per-slice barrier and
// the 12 cp.async per thread per K slice.
//
// Layouts: x (B, H, W, Ci) bf16, w (Co, 9 * Ci) bf16 with
// w[o, (ky * 3 + kx) * Ci + i] = OIHW[o, i, ky, kx], bias (Co,) f32,
// y (B, H, W, Co) bf16. Ci % 8 == 0 and Co % 8 == 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;            // pixels per block (wgmma M)
constexpr int BK = 64;            // channels per K slice: 128-byte rows
constexpr int STAGES = 3;
constexpr int THREADS = 128;      // one warpgroup
constexpr int A_BYTES = BM * BK * 2;

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // 1024-aligned
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
};

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); the
// leading byte offset is unused for this layout (1 by convention).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(16 >> 4) << 16;
  d |= (uint64_t)(1024 >> 4) << 32;
  d |= 1ull << 62;                  // swizzle 128B
  return d;
}

// 16-byte chunk c (0..7) of row r of a swizzled tile
__device__ __forceinline__ uint32_t swz(uint32_t base, int r, int c) {
  return base + r * 128 + ((c ^ (r & 7)) << 4);
}

// 16-byte copy global -> shared; 0 source bytes write zeros. CA keeps
// the line in L1 (the A tiles: consecutive taps of one channel slice
// re-read shifted pixel rows), otherwise L2 only (the weights).
template <bool CA>
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  if (CA)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst), "l"(src), "r"(n));
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst), "l"(src), "r"(n));
}

template <int BN>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, %4, %5, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, 1, 1, 1, 0, 0;\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db));
  }
};

template <int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_bias_relu_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y,
                         int nb, int h, int wd, int ci, int co) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t smem0 = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem_raw));
  const uint32_t base = (smem0 + 1023) & ~1023u;   // swizzle atoms: 1 KB

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long m_total = (long long)nb * h * wd;
  const int nc = (ci + BK - 1) / BK;        // K slices per tap
  const int n_steps = 9 * nc;
  const long long kdim = 9LL * ci;

  // This thread copies chunk (tid % 8) of A rows tid / 8 + 16 i.
  const int chunk = tid & 7;
  int pb[4], py[4], px[4];
  bool pok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + (tid >> 3) + 16 * i;
    pok[i] = m < m_total;
    const long long mm = pok[i] ? m : 0;
    px[i] = (int)(mm % wd);
    const long long t = mm / wd;
    py[i] = (int)(t % h);
    pb[i] = (int)(t / h);
  }

  auto load_step = [&](int ks) {
    const uint32_t st = base + (ks % STAGES) * Tile<BN>::STAGE_BYTES;
    const int tap = ks % 9;
    const int c0 = (ks / 9) * BK + chunk * 8;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool cok = c0 < ci;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = py[i] + dy, xx = px[i] + dx;
      const bool ok = cok && pok[i] && yy >= 0 && yy < h && xx >= 0 &&
                      xx < wd;
      const __nv_bfloat16* src =
          ok ? x + (((long long)pb[i] * h + yy) * wd + xx) * ci + c0 : x;
      cp_async16<true>(swz(st, (tid >> 3) + 16 * i, chunk), src, ok);
    }
    const uint32_t stb = st + A_BYTES;
#pragma unroll
    for (int i = 0; i < (BN * 8 + THREADS - 1) / THREADS; ++i) {
      const int n = (tid >> 3) + 16 * i;
      if (n < BN) {
        const __nv_bfloat16* src =
            cok ? w + (long long)(n0 + n) * kdim + (long long)tap * ci + c0
                : w;
        cp_async16<false>(swz(stb, n, chunk), src, cok);
      }
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load_step(s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int ks = 0; ks < n_steps; ++ks) {
    // slice ks has landed (its group is the oldest of the STAGES - 1 in
    // flight); make the generic-proxy writes visible to wgmma's async
    // proxy, then wait for every thread's copies
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // the stage of slice ks - 1 is free: every thread waited for its
    // wgmma before the barrier
    if (ks + STAGES - 1 < n_steps) load_step(ks + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const uint32_t st = base + (ks % STAGES) * Tile<BN>::STAGE_BYTES;
    const int c_left = ci - (ks / 9) * BK;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (c_left >= BK) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<BN>::mma(acc, smem_desc(st + kk * 32),
                       smem_desc(st + A_BYTES + kk * 32));
    } else {              // the last slice of a Ci that is not 64-aligned
      for (int kk = 0; kk < (c_left + 15) / 16; ++kk)
        Wgmma<BN>::mma(acc, smem_desc(st + kk * 32),
                       smem_desc(st + A_BYTES + kk * 32));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // Accumulator layout of wgmma m64nBN: warp w holds rows 16 w + lane / 4
  // and + 8; register 4 j + {0, 1} columns 8 j + 2 (lane % 4) + {0, 1}
  // of the first row, 4 j + {2, 3} of the second.
  const int warp = tid >> 5, lane = tid & 31;
  const long long r0 = m0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane & 3) * 2;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long r = r0 + half * 8;
      if (r < m_total) {
        const float v0 = fmaxf(acc[4 * j + 2 * half] + b0, 0.0f);
        const float v1 = fmaxf(acc[4 * j + 2 * half + 1] + b1, 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(&y[r * co + col]) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int BN>
int launch(const void* x, const void* w, const void* bias, void* y, int nb,
           int h, int wd, int ci, int co, cudaStream_t stream) {
  const int smem = Tile<BN>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bias_relu_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // the whole unified L1 as shared memory, so that blocks can share an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_bias_relu_kernel<BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m_total = (long long)nb * h * wd;
  dim3 grid((unsigned)((m_total + BM - 1) / BM), (unsigned)(co / BN));
  conv3x3_bias_relu_kernel<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), nb, h, wd, ci, co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dodt_conv3x3_bias_relu(const void* x, const void* w,
                                      const void* bias, void* y, int nb,
                                      int h, int wd, int ci, int co,
                                      int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ci % 8 || co % 8 || ci <= 0 || co <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (co % 128 == 0) return launch<128>(x, w, bias, y, nb, h, wd, ci, co, st);
  if (co % 64 == 0) return launch<64>(x, w, bias, y, nb, h, wd, ci, co, st);
  if (co % 32 == 0) return launch<32>(x, w, bias, y, nb, h, wd, ci, co, st);
  if (co % 16 == 0) return launch<16>(x, w, bias, y, nb, h, wd, ci, co, st);
  return launch<8>(x, w, bias, y, nb, h, wd, ci, co, st);
}
