// The 3xTF32 GEMMs' tile (gemm_tf32x3.cu and its grouped sibling
// gemm_tf32x3_grouped.cu): the hi/lo split, the 128-byte swizzle, the
// shared-operand descriptor, the m64n128k8 TF32 wgmma, and the main loop
// of a 128 x 128 tile of out that both kernels run (gemm_tf32x3.cu's notes
// give its design and its measurements).
#pragma once

#include <stdint.h>

#include "tf32_mma.cuh"

namespace repro {

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

namespace tf32x3 {

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

// acc = the tile's x rows @ w[:, n0 : n0 + 128], over all of K, for the
// block's 256 threads; smem is the block's kSmem bytes of dynamic shared
// memory, 1024-byte aligned.  The tile's x rows are the caller's:
// xsrc(i, r, k, src, ok) gives, for this thread's chunk i (tile row r =
// tid / 8 + 32 i), the address of x's element (row r, column k) in src
// and whether it exists in ok (src a valid address either way; a chunk
// that does not is zero-filled).  acc[4j + q] is out^T's row (column of
// out) nw + g + 8 (q >> 1) and column (row of the tile) 8j + 2t + (q & 1),
// with nw = 16 * warp, g = lane / 4, t = lane % 4.  The rings are free
// again once every thread has passed a barrier after the return.
template <class XSrc>
__device__ __forceinline__ void mainloop(unsigned char* smem,
                                         const float* __restrict__ w, int K,
                                         int N, int n0, const XSrc& xsrc,
                                         float (&acc)[64]) {
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = 16 * warp;   // the warp's 16 columns of the block's 128
  const int stages = (K + kTileK - 1) / kTileK;

  // stage kt's raw x tile (128 rows x 32 k, swizzled) into its ring slot; a
  // thread's chunks are the ones it later splits
  auto load_x = [&](int kt) {
    const int k0 = kt * kTileK;
    unsigned char* dst = smem + kXRaw + (kt % kAhead) * kXTile;
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int idx = tid + kThreads * i, r = idx >> 3, c = idx & 7;
      const float* src;
      bool ok;
      xsrc(i, r, k0 + 4 * c, src, ok);
      cp_async16(dst + swz(r, c), src, ok);
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

  float part[64];
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
}

}  // namespace tf32x3
}  // namespace repro
