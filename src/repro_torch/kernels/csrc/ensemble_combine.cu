// The paper's combination rule on Hopper: Y = [partial +] sum_m w_m * P_m.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/ensemble_combine.py:
//   ensemble_combine       (_kernel / _accum_kernel, pallas_call at :143)
//   ensemble_combine_quant (_quant_accum_kernel,     pallas_call at :108)
//
// Bound on this card: bytes.  Each output element costs M reads of 4 bytes
// (f32 members) or 1 byte (int8/fp8 members), one read of the partial and one
// 4-byte write, against M fused multiply-adds; at ~1 flop per 4 bytes it is
// far below the H100's ridge point, so the time is device-memory traffic.
//
// Design: the TPU kernel's sequential member grid axis carried an f32 VMEM
// tile from step to step.  Here no state crosses blocks: each thread owns
// output elements of the flattened (seg, C) plane, loops over the M members
// with an f32 sum held in registers, and writes each output once, so every
// input byte is read exactly once.  Loads are 16 bytes a thread (float4, or
// four int8/fp8 codes) where the pointers allow it, with a scalar tail; the
// ragged (seg, C) edge needs no padding.  Sums are taken in the reference's
// order with unfused multiply and add (__fmul_rn/__fadd_rn), so the kernel
// matches the plain version to the last bit where its order is the same.
// The output may alias the partial (in-place accumulate): every element is
// read and then written by the same thread.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

inline int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  return (int)(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float fold(float acc, float x, float w) {
  return __fadd_rn(acc, __fmul_rn(x, w));
}

// out[e] = (partial ? partial[e] : 0) + sum_m w[m] * preds[m * n + e]
template <bool kVec>
__global__ void combine_kernel(const float* __restrict__ preds,
                               const float* __restrict__ w,
                               const float* partial, float* out, int M,
                               long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (kVec) {
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      float4 acc = partial ? reinterpret_cast<const float4*>(partial)[i]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int m = 0; m < M; ++m) {
        const float wm = __ldg(w + m);
        const float4 p =
            __ldg(reinterpret_cast<const float4*>(preds + (long long)m * n) + i);
        acc.x = fold(acc.x, p.x, wm);
        acc.y = fold(acc.y, p.y, wm);
        acc.z = fold(acc.z, p.z, wm);
        acc.w = fold(acc.w, p.w, wm);
      }
      reinterpret_cast<float4*>(out)[i] = acc;
    }
    done = n4 * 4;
  }
  for (long long e = done + tid; e < n; e += stride) {
    float acc = partial ? partial[e] : 0.f;
    for (int m = 0; m < M; ++m)
      acc = fold(acc, __ldg(preds + (long long)m * n + e), __ldg(w + m));
    out[e] = acc;
  }
}

template <bool kFp8>
__device__ __forceinline__ float code_to_f32(uint32_t byte) {
  if (kFp8) {
    __nv_fp8_e4m3 v;
    v.__x = (__nv_fp8_storage_t)byte;
    return static_cast<float>(v);
  }
  return (float)(int8_t)(uint8_t)byte;
}

// out[e] = partial[e] + sum_m w[m] * (q[m, e] * s[m, row(e)]), row(e) = e / C
template <bool kFp8, bool kVec>
__global__ void combine_quant_kernel(const float* partial,
                                     const uint8_t* __restrict__ q,
                                     const float* __restrict__ scales,
                                     const float* __restrict__ w, float* out,
                                     int M, int seg, int C) {
  const long long n = (long long)seg * C;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {  // C % 4 == 0: the four elements of a group share one row
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) {
      const int row = (int)((i * 4) / C);
      float4 acc = reinterpret_cast<const float4*>(partial)[i];
      for (int m = 0; m < M; ++m) {
        const float s = __ldg(scales + (long long)m * seg + row);
        const float wm = __ldg(w + m);
        const uint32_t c4 = __ldg(
            reinterpret_cast<const uint32_t*>(q + (long long)m * n) + i);
        acc.x = fold(acc.x, __fmul_rn(code_to_f32<kFp8>(c4 & 0xff), s), wm);
        acc.y = fold(acc.y, __fmul_rn(code_to_f32<kFp8>((c4 >> 8) & 0xff), s), wm);
        acc.z = fold(acc.z, __fmul_rn(code_to_f32<kFp8>((c4 >> 16) & 0xff), s), wm);
        acc.w = fold(acc.w, __fmul_rn(code_to_f32<kFp8>(c4 >> 24), s), wm);
      }
      reinterpret_cast<float4*>(out)[i] = acc;
    }
    return;
  }
  for (long long e = tid; e < n; e += stride) {
    const int row = (int)(e / C);
    float acc = partial[e];
    for (int m = 0; m < M; ++m) {
      const float s = __ldg(scales + (long long)m * seg + row);
      const float x = code_to_f32<kFp8>(__ldg(q + (long long)m * n + e));
      acc = fold(acc, __fmul_rn(x, s), __ldg(w + m));
    }
    out[e] = acc;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// preds (M, n) f32, w (M,) f32, partial (n,) f32 or null, out (n,) f32.
int repro_ensemble_combine(const void* preds, const void* w,
                           const void* partial, void* out, int M, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  const float* p = static_cast<const float*>(preds);
  const float* pa = static_cast<const float*>(partial);
  float* o = static_cast<float*>(out);
  const bool vec = aligned16(p) && aligned16(pa) && aligned16(o) &&
                   (n % 4 == 0 || M == 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long work = vec ? n / 4 + n % 4 : n;
  if (vec)
    combine_kernel<true><<<blocks_for(work), kThreads, 0, s>>>(
        p, static_cast<const float*>(w), pa, o, M, n);
  else
    combine_kernel<false><<<blocks_for(work), kThreads, 0, s>>>(
        p, static_cast<const float*>(w), pa, o, M, n);
  return (int)cudaGetLastError();
}

// partial (seg, C) f32, q (M, seg, C) int8 or e4m3, scales (M, seg) f32,
// w (M,) f32, out (seg, C) f32.
int repro_ensemble_combine_quant(const void* partial, const void* q,
                                 const void* scales, const void* w, void* out,
                                 int M, int seg, int C, int fp8,
                                 void* stream) {
  const long long n = (long long)seg * C;
  if (n <= 0) return 0;
  const float* pa = static_cast<const float*>(partial);
  const uint8_t* qq = static_cast<const uint8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  const float* ww = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  const bool vec = C % 4 == 0 && aligned16(pa) && aligned16(o) &&
                   (reinterpret_cast<uintptr_t>(qq) & 3) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = blocks_for(vec ? n / 4 : n);
  if (fp8) {
    if (vec)
      combine_quant_kernel<true, true><<<g, kThreads, 0, s>>>(pa, qq, sc, ww, o, M, seg, C);
    else
      combine_quant_kernel<true, false><<<g, kThreads, 0, s>>>(pa, qq, sc, ww, o, M, seg, C);
  } else {
    if (vec)
      combine_quant_kernel<false, true><<<g, kThreads, 0, s>>>(pa, qq, sc, ww, o, M, seg, C);
    else
      combine_quant_kernel<false, false><<<g, kThreads, 0, s>>>(pa, qq, sc, ww, o, M, seg, C);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
