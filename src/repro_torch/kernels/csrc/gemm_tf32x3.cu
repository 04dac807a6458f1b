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

#include "tf32_mma.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_group;

constexpr int kThreads = 256;          // two warpgroups
constexpr int kTileM = 128;            // rows of out a block: the wgmma's N
constexpr int kTileN = 128;            // columns of out a block: 64 a warpgroup
constexpr int kTileK = 32;             // k a stage: one 128-byte swizzle row
constexpr int kAhead = 3;              // stages ahead that copies are issued
constexpr int kWStride = kTileN + 8;   // raw w row stride in floats (8 mod 32)
constexpr int kMaxSmem = 232448;       // 227 KB a block

// Shared memory, in bytes: kSplit slots each of x's hi and lo tiles (the
// wgmma operands, 1024-byte aligned), kAhead of raw x and kAhead + 1 of raw
// w (a stage's w slot is read by every thread at the stage's start, so it
// is refilled a stage later than x's, which only its own copier reads).
constexpr int kSplit = 3;
constexpr int kXTile = kTileM * kTileK * 4;
constexpr int kWTile = kTileK * kWStride * 4;
constexpr int kHi = 0;
constexpr int kLo = kSplit * kXTile;
constexpr int kXRaw = 2 * kSplit * kXTile;
constexpr int kWRaw = kXRaw + kAhead * kXTile;
constexpr int kSmem = kWRaw + (kAhead + 1) * kWTile;
constexpr int kXChunks = kTileM * kTileK / 4 / kThreads;   // a thread's
constexpr int kWChunks = kTileK * kTileN / 4 / kThreads;
static_assert(kSmem <= kMaxSmem, "the stages do not fit 227 KB");

// x ~ hi + lo, both TF32 rounded to nearest (ties away): hi as in
// repro::split, and lo = x - hi, exact in f32, rounded too, so that the
// tensor cores read a TF32 value and not the top 19 bits of an f32 one
// (an error of at most 2^-22 |x| for lo, against 2^-21 truncated).
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// Byte offset of 16-byte chunk c (0..7) of row r in a tile of 128-byte rows
// under the 128-byte swizzle: the chunk index XORed with the row's index in
// its group of 8 (the tile 1024-byte aligned).
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// The wgmma descriptor of a K-major operand in 128-byte-swizzled rows:
// start address, leading offset 16 bytes (unused when a k8 step lies in one
// swizzle row), stride 1024 bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory stores of this thread made visible to the async proxy that
// wgmma reads its shared operands through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep registers in place across the asynchronous wgmmas that read or write
// them: the compiler may neither move a read of the accumulators above the
// wait nor reuse a fragment's registers before it.
__device__ __forceinline__ void pin(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[j][q])::"memory");
}

// d = a·b + (acc ? d : 0), a 64 x 8 (this thread's fragment in
// registers), b 8 x 128 (K-major in shared memory, ``desc``), d 64 x 128 f32
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// Grid (ceil(M / 128), ceil(N / 128)); 256 threads.  Block (bx, by) writes
// out[bx*128 : +128, by*128 : +128]; blocks that share x's rows run side by
// side, so a wave reads its x rows from L2 and streams w once.
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = 16 * warp;   // the warp's 16 columns of the block's 128
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int stages = (K + kTileK - 1) / kTileK;

  // stage kt's raw x tile (128 rows x 32 k, swizzled) into its ring slot; a
  // thread's chunks are the ones it later splits
  auto load_x = [&](int kt) {
    const int k0 = kt * kTileK;
    unsigned char* dst = smem + kXRaw + (kt % kAhead) * kXTile;
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int idx = tid + kThreads * i, r = idx >> 3, c = idx & 7;
      const int m = m0 + r, k = k0 + 4 * c;
      const bool ok = m < M && k < K;
      cp_async16(dst + swz(r, c), ok ? x + (size_t)m * K + k : x, ok);
    }
  };
  // stage kt's raw w tile (32 k rows x 128 columns) into its ring slot
  auto load_w = [&](int kt) {
    const int k0 = kt * kTileK;
    unsigned char* dst = smem + kWRaw + (kt % (kAhead + 1)) * kWTile;
#pragma unroll
    for (int i = 0; i < kWChunks; ++i) {
      const int idx = tid + kThreads * i, kr = idx >> 5, c = idx & 31;
      const int k = k0 + kr, n = n0 + 4 * c;
      const bool ok = k < K && n < N;
      cp_async16(dst + (kr * kWStride + 4 * c) * 4,
                 ok ? w + (size_t)k * N + n : w, ok);
    }
  };
  // one cp.async group a stage, empty past the last
  auto load = [&](int kt) {
    if (kt < stages) {
      load_w(kt);
      load_x(kt);
    }
    cp_async_commit();
  };
  // this thread's chunks of stage kt's raw x into its hi/lo slot
  auto split_x = [&](int kt) {
    const unsigned char* src = smem + kXRaw + (kt % kAhead) * kXTile;
    const int slot = (kt % kSplit) * kXTile;
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int idx = tid + kThreads * i;
      const int off = swz(idx >> 3, idx & 7);
      const float4 v = *reinterpret_cast<const float4*>(src + off);
      uint4 hi, lo;
      split_rn(v.x, hi.x, lo.x);
      split_rn(v.y, hi.y, lo.y);
      split_rn(v.z, hi.z, lo.z);
      split_rn(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(smem + kHi + slot + off) = hi;
      *reinterpret_cast<uint4*>(smem + kLo + slot + off) = lo;
    }
  };

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (stages > 0) {
#pragma unroll
    for (int kt = 0; kt < kAhead; ++kt) load(kt);
    cp_async_wait_group<kAhead - 1>();    // stage 0 has landed
    split_x(0);
    fence_proxy_async();
    __syncthreads();
  }
  for (int kt = 0; kt < stages; ++kt) {
    // w's fragments of this stage, split: a0 (k t, column g), a1 (t, g+8),
    // a2 (t+4, g), a3 (t+4, g+8) of each k8 step j, w^T's rows being w's
    // columns
    const float* wr = reinterpret_cast<const float*>(
        smem + kWRaw + (kt % (kAhead + 1)) * kWTile);
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* p0 = wr + (8 * j + t) * kWStride + nw + g;
      const float* p1 = p0 + 4 * kWStride;
      split_rn(p0[0], ah[j][0], al[j][0]);
      split_rn(p0[8], ah[j][1], al[j][1]);
      split_rn(p1[0], ah[j][2], al[j][2]);
      split_rn(p1[8], ah[j][3], al[j][3]);
    }
    const uint32_t hi = sbase + kHi + (kt % kSplit) * kXTile;
    const uint32_t lo = sbase + kLo + (kt % kSplit) * kXTile;
    pin(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t dh = sw128_desc(hi + 32 * j);
      const uint64_t dl = sw128_desc(lo + 32 * j);
      wgmma_n128(part, al[j], dh, j > 0);  // the stage's sum starts afresh
      wgmma_n128(part, ah[j], dl, 1);
      wgmma_n128(part, ah[j], dh, 1);
    }
    wgmma_commit();
    pin(part);
    // while they run: the next x's split, its fence, then the copies kAhead
    // stages on
    cp_async_wait_group<kAhead - 2>();    // stage kt+1 has landed
    if (kt + 1 < stages) split_x(kt + 1);
    fence_proxy_async();
    load(kt + kAhead);
    // stage kt+1's hi/lo tiles and w tile ready for every thread; past this
    // barrier each warpgroup waits for its own wgmmas alone, so one's wait,
    // sum and next issue overlap the other's products.  (Stage kt+2's split,
    // after the next barrier, writes the hi/lo slot of stage kt-1, whose
    // wgmmas every thread waited for before reaching it.)
    __syncthreads();
    wgmma_wait_all();
    pin(part);
    pin(ah);
    pin(al);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

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
