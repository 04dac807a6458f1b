// Blocked causal GQA attention with online softmax, on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, _kernel at :26, pallas_call at :95).
//
// Bound on this card: at the serving shapes (S=256, hd=128, f32) each query
// row does 2*S*hd multiply-adds against 2*S*hd*4 bytes of K and V that many
// rows share, so the work is operations, not bytes; in f32 it runs on the CUDA
// cores (the serving path is all f32, and TF32 tensor cores would not meet
// the f32 tolerance).  On the CUDA cores the limit in practice is how many
// shared-memory reads feed each multiply-add.
//
// Design: the TPU kernel walked kv blocks along a sequential grid axis with
// the softmax state in VMEM scratch.  Here one block of 4 warps owns 64 query
// rows of one (batch, head) and loops over kv tiles of 32 rows inside the
// block; each warp owns 16 of the rows, and the running max, denominator and
// output accumulator of each row stay in registers.  The lanes of a warp form
// 4 row groups x 8 column groups, so each lane computes a 4x4 register tile
// of the scores (rows rg, rg+4, rg+8, rg+12 x keys cg, cg+8, cg+16, cg+24)
// and a 4 x 4·NC tile of the output (the same rows x dims 4·cg + 32·c):
// every 16-byte shared-memory read feeds 16 multiply-adds, and the row
// statistics reduce over only 8 lanes.  The probabilities pass from the
// score layout to the P·V layout through a small per-warp tile in shared
// memory.  Shared rows are padded to 4 mod 32 floats, so the reads are free
// of bank conflicts.  Each K/V tile is loaded once for
// the block's 64 rows, 16 bytes a lane where the pointers allow it.  Tiles
// that the causal or window mask leaves empty are skipped, by the block and,
// within a loaded tile, by each warp (the result is the same: a tile with no
// valid key contributes p = 0).  The ragged S edge is masked in the kernel and
// the head dim is any value up to 256; nothing is padded in device memory.  q
// arrives pre-scaled by hd^-0.5 in its own dtype, as on the TPU.  Q, K and V
// tiles are converted to f32 in shared memory (about 77 KB at hd=128, so the
// launch raises the dynamic shared-memory limit above its 48 KB default).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kWarpRows = 16;              // query rows per warp
constexpr int kBQ = kWarps * kWarpRows;    // query rows per block
constexpr int kBKV = 32;                   // kv rows per tile
constexpr int kLdP = 16;                   // per-warp P tile: [kBKV][kLdP]
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements as f32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Shared tile dst[rows x ld] (f32) <- rows first.. of src (row r at
// src + (first + r) * stride), zero past S and past hd.  A warp to a row.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          const T* __restrict__ src,
                                          long long stride, int first, int S,
                                          int hd, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const int p = first + r;
    const T* row = src + (long long)p * stride;
    float* out = dst + r * ld;
    if (vec) {               // hd % 4 == 0 and aligned rows
      for (int c = lane * 4; c < ld; c += 128) {
        const float4 x = (p < S && c < hd) ? load4(row + c)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(out + c) = x;
      }
    } else {
      for (int c = lane; c < ld; c += 32)
        out[c] = (p < S && c < hd) ? to_f32(row[c]) : 0.f;
    }
  }
}

// max / sum over the 8 lanes of a row group (lanes 8g .. 8g+7)
__device__ __forceinline__ float group_max(float x) {
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// q: (B,S,H,hd), k/v: (B,S,KV,hd), o: (B,S,H,hd).  NC = ceil(hd / 32): each
// lane owns dims 4·cg + 32·c + e (c < NC, e < 4) of its 4 rows.  ld: shared
// row stride of Q and K in floats (>= hd rounded up to 4, = 4 mod 32); V rows
// are 32·NC floats.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
             int hd, int causal, int window, int ld, int vec) {
  extern __shared__ float4 smem4[];
  constexpr int ldv = 32 * NC;
  float* Qs = reinterpret_cast<float*>(smem4);   // kBQ  x ld
  float* Ks = Qs + kBQ * ld;                     // kBKV x ld
  float* Vs = Ks + kBKV * ld;                    // kBKV x ldv
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, cg = lane & 7;       // row group, column group
  float* Ps = Vs + kBKV * ldv + warp * kBKV * kLdP;   // [key][row]

  load_tile(Qs, ld, kBQ, q + ((long long)b * S * H + h) * hd,
            (long long)H * hd, q0, S, hd, vec);

  // this lane's rows: w_first + rg + 4·r, r < 4 (interleaved, so the 4 row
  // groups read 4 consecutive Q rows: distinct banks)
  const int w_first = q0 + warp * kWarpRows;
  const int w_last = min(w_first + kWarpRows, S) - 1;
  const int row0 = w_first + rg;
  float m_i[4], l_i[4], acc[4][NC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][c][e] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const long long kv_off = ((long long)b * S * KV + kvh) * hd;
  const long long kv_stride = (long long)KV * hd;
  const float* qrow = Qs + (warp * kWarpRows + rg) * ld;
  for (int t = kv_begin / kBKV; t * kBKV < kv_end; ++t) {
    const int k0 = t * kBKV;
    __syncthreads();   // the previous tile is no longer read
    load_tile(Ks, ld, kBKV, k + kv_off, kv_stride, k0, S, hd, vec);
    load_tile(Vs, ldv, kBKV, v + kv_off, kv_stride, k0, S, hd, vec);
    __syncthreads();
    if (w_first > w_last || (causal && k0 > w_last) ||
        (window > 0 && k0 + kBKV - 1 <= w_first - window))
      continue;        // warp-uniform: no valid key for any of its rows

    // scores: rows row0 + 4·r, keys k0 + cg + 8·j
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < hd; d += 4) {
      float4 qq[4], kk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qq[r] = *reinterpret_cast<const float4*>(qrow + 4 * r * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kk[j] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * ld + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = fmaf(qq[r].x, kk[j].x, s[r][j]);
          s[r][j] = fmaf(qq[r].y, kk[j].y, s[r][j]);
          s[r][j] = fmaf(qq[r].z, kk[j].z, s[r][j]);
          s[r][j] = fmaf(qq[r].w, kk[j].w, s[r][j]);
        }
    }

    // online softmax per row, reduced over the row group's 8 lanes; s
    // becomes the probabilities
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = row0 + 4 * r;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 8 * j;
        ok[j] = kp < S && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window);
        mx = fmaxf(mx, ok[j] ? s[r][j] : kNegInf);
      }
      const float m_new = fmaxf(m_i[r], group_max(mx));
      const float alpha = expf(m_i[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[r][j] = ok[j] ? expf(s[r][j] - m_new) : 0.f;
        sum += s[r][j];
      }
      l_i[r] = l_i[r] * alpha + group_sum(sum);
      m_i[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][c][e] *= alpha;
    }
    // this warp's P tile, P[key][4·rg + r]: the lane's 4 rows side by side
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Ps + (cg + 8 * j) * kLdP + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();

    // P·V: rows row0 + 4·r, dims 4·cg + 32·c + e
#pragma unroll 4
    for (int j = 0; j < kBKV; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + j * kLdP + 4 * rg);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + j * ldv + 4 * cg + 32 * c);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][c][0] = fmaf(pr[r], vv.x, acc[r][c][0]);
          acc[r][c][1] = fmaf(pr[r], vv.y, acc[r][c][1]);
          acc[r][c][2] = fmaf(pr[r], vv.z, acc[r][c][2]);
          acc[r][c][3] = fmaf(pr[r], vv.w, acc[r][c][3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = row0 + 4 * r;
    if (qp >= S) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    T* orow = o + (((long long)b * S + qp) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * cg + 32 * c + e;
        if (d < hd) orow[d] = from_f32<T>(acc[r][c][e] / denom);
      }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, int causal, int window, cudaStream_t stream) {
  const int hd4 = (hd + 3) / 4 * 4;
  const int ld = hd4 + ((4 - hd4) % 32 + 32) % 32;    // = 4 mod 32
  const size_t smem = sizeof(float) *
      ((size_t)kBQ * ld + (size_t)kBKV * ld + (size_t)kBKV * 32 * NC +
       (size_t)kWarps * kBKV * kLdP);
  // 16-byte rows (8 for bf16) when hd % 4 == 0 and the bases are aligned
  const uintptr_t align = sizeof(T) * 4 - 1;
  const int vec = hd % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & align) == 0;
  auto kern = flash_kernel<T, NC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, hd, causal,
      window, ld, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int hd, int causal, int window,
             cudaStream_t st) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    case 2: return launch<T, 2>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    case 3: return launch<T, 3>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    case 4: return launch<T, 4>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    case 5: return launch<T, 5>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    case 6: return launch<T, 6>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    case 7: return launch<T, 7>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    case 8: return launch<T, 8>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int H, int KV, int hd, int causal,
                                     int window, int bf16, void* stream) {
  if (hd <= 0 || hd > 256 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KV, hd, causal, window, st)
              : dispatch<float>(q, k, v, o, B, S, H, KV, hd, causal, window, st);
}
