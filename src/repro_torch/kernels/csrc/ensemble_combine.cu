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
// input byte is read exactly once.  Sums are taken in the reference's order
// with unfused multiply and add (__fmul_rn/__fadd_rn), so the kernel matches
// the plain version to the last bit where its order is the same.  The output
// may alias the partial (in-place accumulate): every element is read and
// then written by the same thread.
//
// ensemble_combine keeps the memory system busy: every thread has kUnroll
// independent 16-byte loads of each operand in flight (the ragged tail, and
// operands that are not 16-byte aligned, take element loads, kUnroll of
// them in flight), and the grid covers the plane in one pass, with no cap.
// Every operand is touched once, so all loads and stores carry the
// streaming hint (__ldcs, __stcs), the partial's too: in serving, a
// member's forward runs between two folds into one partial and leaves
// nothing of it in L2.  On the H100, folding in place at qwen3's segment
// with each call's operands out of L2, this ran 5 % faster than a grid of
// SM count x resident blocks walking the plane in a grid-stride loop with
// four loads a thread and a plain load and store of the partial, and as
// fast as torch.add in place (PERF.md).  ensemble_combine_quant loads 16
// bytes a thread (float4, or four int8/fp8 codes) where the pointers allow
// it, with a scalar tail.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <limits.h>
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

constexpr int kUnroll = 2;   // independent loads of each operand in flight

__device__ __forceinline__ float4 fold(float4 acc, float4 x, float w) {
  return make_float4(fold(acc.x, x.x, w), fold(acc.y, x.y, w),
                     fold(acc.z, x.z, w), fold(acc.w, x.w, w));
}
__device__ __forceinline__ void set_zero(float4& x) {
  x = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }

// out[e] = (partial ? partial[e] : 0) + sum_m w[m] * preds[m * ld + e] for
// e < n, in units of V (float4: 16-byte loads, float: element loads); row m
// of the members starts ld units after row m - 1.
template <typename V>
__device__ __forceinline__ void combine_span(const V* __restrict__ preds,
                                             const float* __restrict__ w,
                                             const V* partial, V* out, int M,
                                             long long n, long long ld) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       base < n; base += stride * kUnroll) {
    V acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (partial != nullptr && i < n)
        acc[u] = __ldcs(partial + i);
      else set_zero(acc[u]);
    }
    for (int m = 0; m < M; ++m) {
      const float wm = __ldg(w + m);
      const V* row = preds + (long long)m * ld;
      V x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * stride;
        if (i < n) x[u] = __ldcs(row + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (base + u * stride < n) acc[u] = fold(acc[u], x[u], wm);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n) __stcs(out + i, acc[u]);
    }
  }
}

// kVec: the plane in float4s, then its last n % 4 elements (n % 4 == 0
// unless M == 1, so the members' rows stay 16-byte aligned)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ preds, const float* __restrict__ w,
               const float* partial, float* out, int M, long long n) {
  long long done = 0;
  if (kVec) {
    done = n / 4 * 4;
    combine_span<float4>(
        reinterpret_cast<const float4*>(preds), w,
        reinterpret_cast<const float4*>(partial),
        reinterpret_cast<float4*>(out), M, n / 4, n / 4);
  }
  combine_span<float>(preds + done, w, partial ? partial + done : nullptr,
                      out + done, M, n - done, n);
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

// One pass over the plane: kUnroll units (float4 or float) a thread.
template <bool kVec>
int launch_combine(const float* p, const float* w, const float* pa, float* o,
                   int M, long long n, cudaStream_t s) {
  const long long per_block = (long long)kThreads * kUnroll;
  const long long want = ((kVec ? n / 4 : n) + per_block - 1) / per_block;
  const int grid = (int)(want < 1 ? 1 : (want < INT_MAX ? want : INT_MAX));
  combine_kernel<kVec><<<grid, kThreads, 0, s>>>(p, w, pa, o, M, n);
  return (int)cudaGetLastError();
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
  const float* ww = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_combine<true>(p, ww, pa, o, M, n, s);
  return launch_combine<false>(p, ww, pa, o, M, n, s);
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
