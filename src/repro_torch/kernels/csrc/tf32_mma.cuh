// Helpers shared by the tensor-core kernels (flash_attention.cu, ssd_scan.cu):
// the 3xTF32 split, the m16n8k8 TF32 mma, and 16-byte cp.async copies.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most N of this thread's newest groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x ≈ hi + lo, both TF32: hi = cvt.rna.tf32.f32(x), written out for finite
// x (add half a TF32 ulp to the magnitude, drop the 13 low bits) because
// the PTX conversion also guards inf and NaN, which costs two more
// instructions; lo = x - hi is exact in f32, and the tensor cores read its
// top 19 bits, which truncates it to TF32 (an error of at most 2^-21 |x|,
// against 2^-22 for rounding it, which would take one more instruction).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a·b on the tensor cores: a 16x8 (row), b 8x8 (col), d 16x8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d + c += a·b at f32 accuracy (3xTF32): c += a_lo·b_hi + a_hi·b_lo, d +=
// a_hi·b_hi; only lo·lo (about 2^-22 of a·b) is dropped.  The corrections
// go to an accumulator of their own, so that the two chains of mma run side
// by side; the caller adds c into d.
__device__ __forceinline__ void mma3(float (&d)[4], float (&c)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(c, al, bh0, bh1);
  mma(c, ah, bl0, bl1);
  mma(d, ah, bh0, bh1);
}

}  // namespace repro
