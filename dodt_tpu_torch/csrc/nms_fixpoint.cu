// The exact NMS's fixpoint (ops/nms.nms_bev_exact) in one launch.
//
// Replaces no TPU kernel: JAX runs the fixpoint as a lax.while_loop
// inside its jitted program (dodt_tpu/ops/nms.py nms_bev_exact), with
// no host in the loop. Eagerly in PyTorch every pass ended in a host
// sync (torch.equal), so the fixpoint could neither overlap the host nor
// be captured in a CUDA graph. Given the dominance matrix
//   dom[r, i, j]: valid box j outscores box i and overlaps it above the
//                 threshold (ops/nms._dominance),
// it iterates the parallel suppression pass
//   supp'[i] = any_j (dom[r, i, j] & ~supp[j])
// from supp = 0 until a pass changes nothing, and writes supp (R, N).
// The strict score order makes the recursion well-founded, so the
// fixpoint is unique and reached within N passes: the same bits as the
// Python loop, whatever the order of the work inside a pass.
//
// What bounds it on the H100: latency. One block (1024 threads) per
// leading row r, since a pass needs the whole of the previous one; the
// main path's rows are 1 or 2. The design:
//   - dom is read once and packed to 32-bit words, W = ceil(N / 32) a
//     row: a warp reads 32 V contiguous bytes of a row at once (V = 16
//     where N % 16 == 0, 4 where N % 4 == 0, else 1, each lane V bytes),
//     several chunks in flight, and folds each lane's V flags into the
//     chunk's V words with a ballot (V = 1) or shuffles;
//   - the packed words are stored word-major, word k of row i at k N + i,
//     so that the 32 rows of a warp read 32 consecutive words (32 banks,
//     or 128 contiguous bytes); they live in shared memory up to N =
//     1344 (N W 4 bytes: 178 KB at N = 1200, the RPN's eval NMS), beyond
//     that in a global scratch buffer that each pass reads from L2 (2 MB
//     at N = 4096, the train preset's RPN NMS);
//   - a pass: a thread owns a row, ANDs its words with ~supp, and one
//     ballot per warp gives 32 rows' bits, a word of supp'; supp and
//     supp' are a double buffer in shared memory, and one
//     __syncthreads_or per pass both publishes supp' and says whether it
//     changed.
//
// Layouts: dom (R, N, N) bool (one byte, 0 or not), supp (R, N) bool,
// scratch (R, W, N) uint32 where the rows do not fit in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 227 * 1024;

__host__ __device__ inline int words(int n) { return (n + 31) >> 5; }

// shared memory of the launch: the supp double buffer, and the packed
// rows where they fit
__host__ inline long long smem_bytes(int n, bool rows_in_smem) {
  return 4 * (2LL * words(n) + (rows_in_smem ? (long long)n * words(n) : 0));
}

__host__ inline bool rows_fit(int n) {
  return smem_bytes(n, true) <= MAX_SMEM;
}

// four 0/1 flags of the bytes of x (byte 0 in bit 0)
__device__ __forceinline__ unsigned nibble(unsigned x) {
  const unsigned ones = __vcmpne4(x, 0u) & 0x01010101u;
  return (ones * 0x01020408u) >> 24;
}

template <int V>
struct Chunk;          // V bytes a lane: their flags, in V bits

template <>
struct Chunk<1> {
  static constexpr int U = 8;        // chunks a warp has in flight
  uint8_t v;
  __device__ void load(const uint8_t* p) { v = *p; }
  __device__ unsigned flags() const { return v != 0; }
};

template <>
struct Chunk<4> {
  static constexpr int U = 8;
  unsigned v;
  __device__ void load(const uint8_t* p) {
    v = *reinterpret_cast<const unsigned*>(p);
  }
  __device__ unsigned flags() const { return nibble(v); }
};

template <>
struct Chunk<16> {
  static constexpr int U = 4;
  uint4 v;
  __device__ void load(const uint8_t* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ unsigned flags() const {
    return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
           nibble(v.w) << 12;
  }
};

// word k of row i at bits[k * n + i]: bits j = 32 k .. 32 k + 31 of
// dom's row i, 0 beyond N. A chunk is 32 V bytes of a row, V words: lane
// l holds bytes V l .. V l + V - 1, the bits V (l % (32 / V)) .. of word
// l / (32 / V) of the chunk.
template <int V>
__device__ void pack(const uint8_t* __restrict__ d, uint32_t* bits, int n,
                     int w) {
  constexpr int U = Chunk<V>::U;
  constexpr int PER_WORD = 32 / V;              // lanes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_row = (n + 32 * V - 1) / (32 * V);
  const int total = n * per_row;
  for (int base = warp * U; base < total; base += WARPS * U) {
    Chunk<V> c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      const int i = t / per_row;
      const int j = (t - i * per_row) * 32 * V + lane * V;
      if (t < total && j < n)
        c[u].load(d + (long long)i * n + j);
      else
        c[u] = Chunk<V>{};
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u;
      unsigned word;
      if constexpr (V == 1) {
        word = __ballot_sync(FULL, c[u].flags());
      } else {
        word = c[u].flags() << (V * (lane % PER_WORD));
        for (int off = 1; off < PER_WORD; off <<= 1)
          word |= __shfl_xor_sync(FULL, word, off);
      }
      const int i = t / per_row;
      const int k = (t - i * per_row) * V + lane / PER_WORD;
      if (t < total && lane % PER_WORD == 0 && k < w)
        bits[(long long)k * n + i] = word;
    }
  }
}

template <bool kRowsInSmem, int V>
__global__ void __launch_bounds__(THREADS)
nms_fixpoint_kernel(const uint8_t* __restrict__ dom,
                    uint8_t* __restrict__ supp, uint32_t* scratch, int n) {
  extern __shared__ uint32_t smem[];
  const int w = words(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint8_t* d = dom + (long long)blockIdx.x * n * n;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + w;
  // written and read back in this launch: no read-only (nc) loads
  uint32_t* bits = kRowsInSmem ? smem + 2 * w
                               : scratch + (long long)blockIdx.x * n * w;

  pack<V>(d, bits, n, w);
  for (int k = threadIdx.x; k < w; k += THREADS) cur[k] = 0;
  __syncthreads();

  // from supp = 0, the first pass gives any_j dom[i, j], the Python
  // loop's start; the (N + 1)-th pass at the latest changes nothing
  for (int pass = 0; pass <= n; ++pass) {
    int changed = 0;
    for (int base = 0; base < n; base += THREADS) {   // uniform
      const int i = base + threadIdx.x;
      uint32_t acc = 0;
      if (i < n) {
#pragma unroll 8
        for (int k = 0; k < w; ++k)
          acc |= bits[(long long)k * n + i] & ~cur[k];
      }
      const unsigned word = __ballot_sync(FULL, acc != 0);
      const int g = (base >> 5) + warp;
      if (lane == 0 && g < w) {
        nxt[g] = word;
        changed |= word != cur[g];
      }
    }
    changed = __syncthreads_or(changed);
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!changed) break;
  }

  uint8_t* out = supp + (long long)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += THREADS)
    out[i] = (uint8_t)((cur[i >> 5] >> (i & 31)) & 1u);
}

template <bool kRowsInSmem, int V>
int launch(const uint8_t* dom, uint8_t* supp, uint32_t* scratch, int r,
           int n, cudaStream_t stream) {
  auto kernel = nms_fixpoint_kernel<kRowsInSmem, V>;
  const int smem = (int)smem_bytes(n, kRowsInSmem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<r, THREADS, smem, stream>>>(dom, supp, scratch, n);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRowsInSmem>
int dispatch(const uint8_t* dom, uint8_t* supp, uint32_t* scratch, int r,
             int n, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dom);
  if (n % 16 == 0 && a % 16 == 0)
    return launch<kRowsInSmem, 16>(dom, supp, scratch, r, n, stream);
  if (n % 4 == 0 && a % 4 == 0)
    return launch<kRowsInSmem, 4>(dom, supp, scratch, r, n, stream);
  return launch<kRowsInSmem, 1>(dom, supp, scratch, r, n, stream);
}

}  // namespace

// 32-bit words of global scratch one leading row needs: 0 where its
// packed rows fit in shared memory.
extern "C" int dodt_nms_fixpoint_scratch_words(int n) {
  return rows_fit(n) ? 0 : n * words(n);
}

// dom (r, n, n) and supp (r, n) bool; scratch r *
// dodt_nms_fixpoint_scratch_words(n) words, or null where that is 0.
extern "C" int dodt_nms_fixpoint(const void* dom, void* supp, void* scratch,
                                 int r, int n, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r < 1 || n < 1 || (!rows_fit(n) && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* d = static_cast<const uint8_t*>(dom);
  uint8_t* s = static_cast<uint8_t*>(supp);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  if (rows_fit(n)) return dispatch<true>(d, s, sc, r, n, st);
  return dispatch<false>(d, s, sc, r, n, st);
}
