// Flash-decoding on Hopper: one query token per (batch, head) against a KV
// cache with a per-slot validity mask.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, _kernel at :24, pallas_call at :76).
//
// Bound on this card: bytes.  Each cache slot is read once and used by the
// group's H/KV query heads for 2·hd multiply-adds each, far below the ~20 f32
// operations per byte at which the CUDA cores, not device memory, would be
// the limit.  So the work is to stream the valid part of K and V once.
//
// Design: the TPU grid (b, h, kv block) walked the cache once per query head
// with the softmax state in VMEM scratch along the sequential kv-block axis.
// Here one block of 4 warps owns one (batch, kv head) and a split of the
// cache's tiles of 32 slots, and holds all of the group's query heads (up to
// 2048 / hd of them; a larger group is cut into chunks along grid y), so each
// K/V tile is read from device memory once for the whole group.  The splits
// over L fill the 132 SMs when B·KV alone would not (qwen3 at batch 16 has
// 128 (b, kv) pairs).  A tile whose 32 slots are all invalid is not loaded at
// all (__syncthreads_or over the mask), so a split with no valid slot ends
// with m = -inf, l = 0 and zero weight in the merge; a tile with some
// invalid slots gives them p = 0 explicitly.  Per tile: K and V converted to
// f32 in shared memory (16 bytes a lane where the pointers allow), scores of
// every (head, slot) pair, the online-softmax update per head by one warp
// (lane = slot), then P·V with each thread owning up to 16 (head, dim)
// outputs in registers.  Shared K rows are padded to 4 mod 32 floats, so the
// float4 reads of neighbouring slots are free of bank conflicts.  A second
// small kernel merges the splits' (m, l, acc) per (batch, head).  Where no
// slot at all is valid it returns the mean of V over every slot, which is
// what the plain version's softmax over equal -1e30 logits gives.  Any L, hd
// up to 256, nothing padded in device memory.  q arrives pre-scaled by
// hd^-0.5 in its own dtype, as on the TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;                     // slots per tile (one per lane)
constexpr int kMaxR = 16;                  // (head, dim) outputs per thread
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
// src + (first + r) * stride), zero past L and past hd.  A warp to a row.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, int rows,
                                          const T* __restrict__ src,
                                          long long stride, int first, int L,
                                          int hd, bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const int p = first + r;
    const T* row = src + (long long)p * stride;
    float* out = dst + r * ld;
    if (vec) {               // hd % 4 == 0 and aligned rows
      for (int c = lane * 4; c < ld; c += 128) {
        const float4 x = (p < L && c < hd) ? load4(row + c)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(out + c) = x;
      }
    } else {
      for (int c = lane; c < ld; c += 32)
        out[c] = (p < L && c < hd) ? to_f32(row[c]) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// q: (B,1,H,hd), k/v: (B,L,KV,hd), valid: (L,) 0/1 bytes.  Block
// (split, kvh·nchunk + chunk, b) owns query heads h0 .. h0+gn-1 of kv head
// kvh and tiles [split·tps, min((split+1)·tps, ntiles)).  Writes m, l
// (B,H,S) and the unnormalised acc (B,H,S,hd), S = gridDim.x.  ld: shared
// row stride of Q and K (>= hd rounded up to 4, = 4 mod 32); V rows are hd4.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int L, int H, int KV, int hd,
                    int gb, int tps, int ld, int vec) {
  extern __shared__ float4 smem4[];
  const int hd4 = (hd + 3) & ~3;
  float* Qs = reinterpret_cast<float*>(smem4);   // gb  x ld
  float* Ks = Qs + gb * ld;                      // kT  x ld
  float* Vs = Ks + kT * ld;                      // kT  x hd4
  float* Ps = Vs + kT * hd4;                     // gb  x kT
  float* Ms = Ps + gb * kT;                      // gb: running max
  float* Ls = Ms + gb;                           // gb: running denominator
  float* As = Ls + gb;                           // gb: this tile's rescale

  const int split = blockIdx.x, S = gridDim.x, b = blockIdx.z;
  const int group = H / KV, nchunk = (group + gb - 1) / gb;
  const int kvh = blockIdx.y / nchunk;
  const int g0 = (blockIdx.y % nchunk) * gb;
  const int gn = min(gb, group - g0);
  const int h0 = kvh * group + g0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_tile(Qs, ld, gn, q + ((long long)b * H + h0) * hd, (long long)hd, 0,
            gn, hd, vec);
  for (int g = tid; g < gn; g += kThreads) {
    Ms[g] = -INFINITY;
    Ls[g] = 0.f;
  }

  // this thread's outputs: i = tid + 128·r -> head i / hd, dim i % hd
  const int GD = gn * hd;
  float acc[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) acc[r] = 0.f;

  const int ntiles = (L + kT - 1) / kT;
  const int t_end = min((split + 1) * tps, ntiles);
  const long long kv_off = ((long long)b * L * KV + kvh) * hd;
  const long long kv_stride = (long long)KV * hd;
  for (int t = split * tps; t < t_end; ++t) {
    const int j0 = t * kT;
    const bool ok_j = j0 + lane < L && valid[j0 + lane] != 0;
    // also: the previous tile's P·V is done with Ks, Vs, Ps
    if (!__syncthreads_or(tid < kT && ok_j)) continue;
    load_tile(Ks, ld, kT, k + kv_off, kv_stride, j0, L, hd, vec);
    load_tile(Vs, hd4, kT, v + kv_off, kv_stride, j0, L, hd, vec);
    __syncthreads();

    // scores of every (head, slot) pair; neighbouring threads, neighbouring
    // slots
    for (int idx = tid; idx < gn * kT; idx += kThreads) {
      const int g = idx / kT, j = idx % kT;
      const float* qr = Qs + g * ld;
      const float* kr = Ks + j * ld;
      float s = 0.f;
      for (int d = 0; d < hd4; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 c = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(a.x, c.x, s);
        s = fmaf(a.y, c.y, s);
        s = fmaf(a.z, c.z, s);
        s = fmaf(a.w, c.w, s);
      }
      Ps[idx] = s;
    }
    __syncthreads();

    // online softmax, one warp per head, lane = slot; the tile has a valid
    // slot, so m_new is finite and alpha = 0 the first time
    for (int g = warp; g < gn; g += kWarps) {
      const float s = ok_j ? Ps[g * kT + lane] : -INFINITY;
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = ok_j ? expf(s - m_new) : 0.f;
      Ps[g * kT + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // P·V into this thread's outputs
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      const int i = tid + kThreads * r;
      if (i < GD) {
        const int g = i / hd, d = i - g * hd;
        const float* pr = Ps + g * kT;
        float a = acc[r] * As[g];
#pragma unroll 8
        for (int j = 0; j < kT; ++j) a = fmaf(pr[j], Vs[j * hd4 + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();     // Ms, Ls final

#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    const int i = tid + kThreads * r;
    if (i < GD) {
      const int g = i / hd, d = i - g * hd;
      const long long row = ((long long)b * H + h0 + g) * S + split;
      acc_part[row * hd + d] = acc[r];
    }
  }
  for (int g = tid; g < gn; g += kThreads) {
    const long long row = ((long long)b * H + h0 + g) * S + split;
    m_part[row] = Ms[g];
    l_part[row] = Ls[g];
  }
}

// One block per (batch, head): o = Σ_s e^(m_s - M)·acc_s / Σ_s e^(m_s - M)·l_s
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ m_part,
                    const float* __restrict__ l_part,
                    const float* __restrict__ acc_part,
                    const T* __restrict__ v, T* __restrict__ o, int L, int H,
                    int KV, int hd, int S) {
  const long long bh = blockIdx.x;
  const float* m = m_part + bh * S;
  const float* l = l_part + bh * S;
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) M = fmaxf(M, m[s]);
  T* orow = o + bh * hd;
  if (M == -INFINITY) {
    // no valid slot: every logit is the plain version's -1e30, so its
    // softmax weighs every slot equally
    const int b = (int)(bh / H), h = (int)(bh % H);
    const T* vcol = v + ((long long)b * L * KV + h / (H / KV)) * hd;
    for (int d = threadIdx.x; d < hd; d += kThreads) {
      float sum = 0.f;
      for (int j = 0; j < L; ++j)
        sum += to_f32(vcol[(long long)j * KV * hd + d]);
      orow[d] = from_f32<T>(sum / (float)L);
    }
    return;
  }
  float denom = 0.f;
  for (int s = 0; s < S; ++s) denom += expf(m[s] - M) * l[s];
  denom = fmaxf(denom, 1e-30f);
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float sum = 0.f;
    for (int s = 0; s < S; ++s)
      sum += expf(m[s] - M) * acc_part[(bh * S + s) * hd + d];
    orow[d] = from_f32<T>(sum / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           float* m_part, float* l_part, float* acc_part, void* o, int B,
           int L, int H, int KV, int hd, int gb, int tps, int nsplit,
           cudaStream_t stream) {
  const int hd4 = (hd + 3) / 4 * 4;
  const int ld = hd4 + ((4 - hd4) % 32 + 32) % 32;    // = 4 mod 32
  const size_t smem = sizeof(float) *
      ((size_t)gb * ld + (size_t)kT * ld + (size_t)kT * hd4 +
       (size_t)gb * kT + 3 * (size_t)gb);
  // 16-byte rows (8 for bf16) when hd % 4 == 0 and the bases are aligned
  const uintptr_t align = sizeof(T) * 4 - 1;
  const int vec = hd % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & align) == 0;
  auto split_kern = decode_split_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)split_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int group = H / KV, nchunk = (group + gb - 1) / gb;
  dim3 grid(nsplit, KV * nchunk, B);
  split_kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, m_part, l_part, acc_part, L, H, KV, hd,
      gb, tps, ld, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T><<<B * H, kThreads, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<const T*>(v), static_cast<T*>(o),
      L, H, KV, hd, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// m_part, l_part: (B,H,nsplit) f32 scratch; acc_part: (B,H,nsplit,hd) f32
// scratch.  gb: query heads per block (gb·hd <= 2048, gb <= H/KV); tps: tiles
// of 32 slots per split; nsplit = ceil(ceil(L/32) / tps).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* valid,
                                      void* m_part, void* l_part,
                                      void* acc_part, void* o, int B, int L,
                                      int H, int KV, int hd, int gb, int tps,
                                      int nsplit, int bf16, void* stream) {
  const int ntiles = (L + kT - 1) / kT;
  if (hd <= 0 || hd > 256 || KV <= 0 || H % KV != 0 || L <= 0 || gb <= 0 ||
      gb > H / KV || gb * hd > kThreads * kMaxR || tps <= 0 ||
      nsplit != (ntiles + tps - 1) / tps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  return bf16 ? launch<__nv_bfloat16>(q, k, v, ok, mp, lp, ap, o, B, L, H, KV,
                                       hd, gb, tps, nsplit, st)
              : launch<float>(q, k, v, ok, mp, lp, ap, o, B, L, H, KV, hd, gb,
                              tps, nsplit, st);
}
