// A dense f32 product on Hopper's tensor cores at f32 accuracy (3xTF32):
//
//   out (M, N) = x (M, K) @ w (K, N),   all f32, rows contiguous.
//
// Replaces no Pallas kernel: the JAX package leaves its products to XLA.  It
// was added for the served SSM members' two projections
// (models/ssm.py::ssm_mixer through kernels/ops.py::dense; at mamba2-1.3b
// in_proj 2048 -> 8512 and out_proj 4096 -> 2048 over 8 or 16 rows of 256
// tokens), which took two thirds of the card's time in cuBLAS's f32 GEMMs on
// the CUDA cores (67 TFLOP/s): one TF32 pass fails the f32 check (PERF.md
// §2).
//
// Bound on this card: operations.  Each product runs three times on the
// tensor cores, 3 x 2MNK / 495 TFLOP/s (TF32 dense): 0.87 ms for in_proj at
// M 4096 against 0.073 ms for its bytes (x, w and out once, 3.35 TB/s).
//
// How the design meets that bound:
// - wgmma (m64n128k8, TF32 in, f32 accumulators): the product runs
//   transposed, out^T = w^T x^T, with w^T as the A operand in registers and
//   x^T as the B operand in shared memory.  TF32 wgmma reads shared operands
//   only K-major; x's rows are K-contiguous, so x^T is K-major as it lies,
//   and w^T, which is not, goes through registers, where each thread
//   gathers its fragment from a row-major tile anyway.  A block owns a
//   128 x 128 tile of out: two warpgroups of 64 of its columns (the
//   wgmma's M), each over its 128 rows (the wgmma's N).
// - 3xTF32: x ~ hi + lo with both parts TF32 (hi rounded to nearest, lo =
//   x - hi, exact in f32, rounded to nearest too), and a·b ~ a_lo·b_hi +
//   a_hi·b_lo + a_hi·b_hi; only lo·lo, about 2^-22 of a·b, is dropped.  The
//   split is done here, in the register pass that every operand takes
//   anyway: w's fragments as they are read, x's tile once per stage into hi
//   and lo tiles (no separate split kernel, no split copy of the weights in
//   device memory).
// - The tensor cores' own sums lose more than f32 adds: summed there over
//   the whole of K, the error against float64 grew with K to 13-25 times
//   cuBLAS f32's at the served shapes (PERF.md §6).  So each stage of 32 k
//   (twelve wgmmas) sums into a fresh accumulator, which is then added into
//   f32 registers; the error is then within cuBLAS's.  The two sets of 64
//   accumulators are what bound the tile at 128 rows.
// - Stages of 32 k, one 128-byte row of the 128-byte swizzle (so the
//   wgmma's shared reads are free of bank conflicts): raw x and w tiles come
//   in by 16-byte cp.async into rings of three (x) and four (w) slots,
//   issued three stages ahead.  While stage k's wgmmas run, each thread
//   splits stage k+1's x chunks that it copied itself (so that split needs
//   no barrier) into a ring of three hi/lo pairs, then fences them for the
//   wgmmas' async proxy, then issues its copies: the fence's memory barrier
//   waits for this thread's copies in flight, so issued before it they
//   would land in the stage's critical path (9 % slower, PERF.md §6).  One
//   barrier a stage, before each warpgroup waits for its wgmmas: the two
//   then drift apart, and one's sum into f32 and next issue overlap the
//   other's products.  Raw w rows are padded to 136 floats, so that the
//   fragment reads are free of bank conflicts.  212 KB of shared memory:
//   one block an SM.  (Loading x and w into registers a stage ahead
//   instead, with no raw rings, ran 5-6 % slower: one stage does not hide
//   L2's latency.)
// - Ragged M, N and K are masked here: copies past an edge are zero-filled
//   (zeros add nothing to a sum) and stores past M or N are skipped; nothing
//   is padded in device memory.  K and N must be multiples of 4 and x and w
//   16-byte aligned (16-byte rows); kernels/ops.py::dense routes anything
//   else to the library.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "wgmma_tf32.cuh"

namespace {

using namespace repro::tf32x3;

// Grid (ceil(M / 128), ceil(N / 128)); 256 threads.  Block (bx, by) writes
// out[bx*128 : +128, by*128 : +128]; blocks that share x's rows run side by
// side, so a wave reads its x rows from L2 and streams w once.
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = 16 * warp;   // the warp's 16 columns of the block's 128
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;

  float acc[64];
  repro::tf32x3::mainloop(
      smem, w, K, N, n0,
      [&](int, int r, int k, const float*& src, bool& ok) {
        const int m = m0 + r;
        ok = m < M && k < K;
        src = ok ? x + (size_t)m * K + k : x;
      },
      acc);

  // acc[4j + q]: out^T row (column of out) nw + g + 8 (q >> 1), column (row
  // of out) 8j + 2t + (q & 1)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int m = m0 + 8 * j + 2 * t;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mm = m + (q & 1), n = n0 + nw + g + 8 * (q >> 1);
      if (mm < M && n < N) out[(size_t)mm * N + n] = acc[4 * j + q];
    }
  }
}

// Raise the kernel's dynamic shared-memory limit and its carveout to all
// shared, once per device.
int raise_smem() {
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (raised.load() & bit) return 0;
  err = cudaFuncSetAttribute(gemm_tf32x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gemm_tf32x3_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  raised.fetch_or(bit);
  return 0;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (M, K), w (K, N), out (M, N), f32, rows contiguous; K and N multiples
// of 4, x and w 16-byte aligned.
extern "C" int repro_gemm_tf32x3(const void* x, const void* w, void* out,
                                 int M, int K, int N, void* stream) {
  if (M < 0 || K < 0 || N < 0 || K % 4 || N % 4 || !aligned16(x) ||
      !aligned16(w) || (N + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const int err = raise_smem();
  if (err) return err;
  dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  gemm_tf32x3_kernel<<<grid, kThreads, kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}
