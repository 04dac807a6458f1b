// Blocked causal GQA attention with online softmax, on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, _kernel at :26, pallas_call at :95).
//
// Bound on this card: at the serving shapes (S=256, f32) the 3xTF32
// products and the bytes (Q, K, V and O once each) take about as long:
// 0.026 and 0.030 ms at qwen3's chunk (B16 H16 KV8 hd128), 0.020 and 0.019
// at hymba's (B16 H25 KV5 hd64).  The products run on
// the tensor cores in TF32 (mma.sync m16n8k8), and the f32 tolerance is kept
// by the 3xTF32 split: x ≈ hi + lo with hi = tf32(x) and lo = x - hi (see
// split() in tf32_mma.cuh), and a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
// accumulated in f32; only lo·lo (about 2^-22 of a·b) is dropped.  One TF32 pass keeps 10
// mantissa bits, which is not enough: on the H100, at B16 S256 H16 KV8
// hd128 causal with q pre-scaled, the plain version with TF32 matmuls (one
// pass) is 2.5e-3 off a float64 reference, with 5.8 M elements over the f32
// tolerance of 2e-5, where this kernel is 3.8e-6 off with none over it (the
// plain version in f32: 1.9e-6; chip_smoke.py, kernel:flash_attention).
// So the operations bound is 3 x the operations over the TF32 tensor-core
// rate (495 TFLOP/s dense on an H100 SXM).  bf16
// inputs are exact in TF32: Q·Kᵀ takes one pass, and P·V two (P is split, V
// is exact).
//
// Design: the TPU kernel walked kv blocks along a sequential grid axis with
// the softmax state in VMEM scratch.  Here one block of 4 warps owns 64
// query rows of one (batch, head) and loops over kv tiles inside the block;
// each warp owns 16 rows (one mma row tile), and the running max, the
// denominator and the output accumulator stay in registers in the mma
// accumulator layout: a lane holds rows g and g+8 (g = lane/4) and columns
// 2t, 2t+1 (t = lane%4) of every 8-wide tile, so a row's max and sum reduce
// over the 4 lanes of a quad.  The contraction order inside an 8-wide mma
// step is free, which the layouts use: in Q·Kᵀ a lane reads 4 consecutive
// dims of a row as one 16-byte (f32) or 8-byte (bf16) shared-memory read and
// feeds them to two k-steps; in P·V the score accumulator is reused as the A
// operand with keys 2t, 2t+1 in the place of columns t, t+4, and V's rows
// 2t, 2t+1 are read to match.  Row strides are padded so that every
// fragment read is free of bank conflicts (Q and K: 16 mod 32 words; V: 4
// mod 32 f32, 8 mod 32 bf16 elements).  The split costs more instructions
// than the mma it feeds, so the kernel is bound by issue, not by the tensor
// cores: it keeps the split to three integer and float instructions and
// runs the correction products on accumulators of their own, so that more
// mma chains are in flight.
//
// K and V tiles are staged by cp.async (16 bytes a thread, zero-filled past
// S) into a ring of two stages: the next tile's copy is issued right after
// the barrier that frees its stage, so it overlaps this tile's products,
// with one barrier per tile.  The tile is as long as three blocks to an SM
// allow (Tile::BKV: 16 keys at hd 128 in f32, 32 at hd 64).  One block per
// (batch, query head): the group's other heads read the same K/V tile from
// L2 (hymba's group of 5 and qwen3's of 2 both fit their batch row's K/V in
// L2 many times over).  The blocks of the last query tiles, which see the
// most keys under a causal mask, are launched first.  Tiles that the causal
// or window mask leaves empty are skipped by the block and, within a
// loaded tile, by each warp; a masked score is -inf, so its probability is
// 0, and the row max starts at -1e30 as on the TPU (a row with no valid
// key, which only a padded row past S can be, ends at 0 / max(0, 1e-30) =
// 0).  The ragged S edge is masked in the kernel, the head dim is any value
// up to 256, zero-padded to a multiple of 16 in shared memory only; rows of
// hd % (16 bytes) != 0 or unaligned bases take element loads and stores.  q
// arrives pre-scaled by hd^-0.5 in its own dtype, as on the TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;             // query rows per block
constexpr float kNegInf = -1e30f;            // initial row max
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemPerSM = 228 * 1024;    // of which 1 KB per block is
                                             // the system's

// Shared-memory layout for head dims padded to HD = 16·NG.  The kv tile is
// the longest of 64, 32 and 16 keys that lets three blocks share an SM: on
// the H100 at hd 128 in f32, 16-key tiles with three blocks to an SM ran
// 6 % faster than 32-key tiles with two, and 64-key tiles with one slower
// still (PERF.md).
template <typename T, int NG>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int HD = 16 * NG;
  static constexpr int NT = HD / 8;          // 8-wide output column tiles
  static constexpr int kMod = kF32 ? 32 : 64;
  static constexpr int LD = HD + (kMod + 16 - HD % kMod) % kMod;  // Q, K
  static constexpr int LDV = HD + (32 + (kF32 ? 4 : 8) - HD % 32) % 32;
  static constexpr size_t bytes(int bkv) {
    return sizeof(T) * ((size_t)kBQ * LD + 2 * (size_t)bkv * (LD + LDV));
  }
  static constexpr bool fits3(int bkv) {
    return 3 * (bytes(bkv) + 1024) <= kSmemPerSM;
  }
  static constexpr int BKV = fits3(64) ? 64 : fits3(32) ? 32 : 16;
  static constexpr int kMinBlocks = fits3(BKV) ? 3 : 1;
  static constexpr int NJ = BKV / 8;         // 8-key slices of a tile
  static constexpr size_t SMEM = bytes(BKV);
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// four consecutive shared-memory elements as f32
__device__ __forceinline__ void frag4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void frag4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) {
  *p = __float2bfloat16(a);
}

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::mma;
using repro::split;

// Shared rows dst[r * LDS + c] (c < hd), r < ROWS, <- rows first + r of src,
// zero past S.  16-byte cp.async copies when vec, element loads otherwise;
// rows of exactly HD elements (the serving shapes) take a copy loop whose
// trip count and offsets are known at compile time.
template <typename T, int LDS, int HD, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          long long stride, int first, int S,
                                          int hd, bool vec) {
  if (vec && hd == HD) {
    constexpr int E = 16 / (int)sizeof(T), PR = HD / E, N = ROWS * PR;
#pragma unroll
    for (int u = 0; u < (N + kThreads - 1) / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (N % kThreads != 0 && i >= N) break;
      const int r = i / PR, c = (i % PR) * E, p = first + r;
      cp_async16(dst + r * LDS + c,
                 src + (long long)min(p, S - 1) * stride + c, p < S);
    }
    return;
  }
  const int E = vec ? 16 / (int)sizeof(T) : 1;
  const int per_row = hd / E;
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  while (r < ROWS) {
    const int p = first + r;
    if (vec)
      cp_async16(dst + r * LDS + c * E,
                 src + (long long)min(p, S - 1) * stride + c * E, p < S);
    else
      dst[r * LDS + c] = p < S ? src[(long long)p * stride + c] : zero<T>();
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// q: (B,S,H,hd), k/v: (B,S,KV,hd), o: (B,S,H,hd); hd <= 16·NG.
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, (Tile<T, NG>::kMinBlocks))
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H, int KV,
             int hd, int causal, int window, int vec) {
  using L = Tile<T, NG>;
  constexpr int LD = L::LD, LDV = L::LDV, BKV = L::BKV, NJ = L::NJ,
                NT = L::NT, HD = L::HD;
  constexpr bool kF32 = L::kF32;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);       // kBQ x LD
  T* Ks = Qs + kBQ * LD;                     // 2 stages of BKV x LD
  T* Vs = Ks + 2 * BKV * LD;                 // 2 stages of BKV x LDV
  // query tiles last in the launch order, the longest (last rows of a
  // causal mask) first, so the short ones fill the tail of the grid
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if (hd < HD) {     // the padded dims are read as zeros by Q·Kᵀ
    const int w = HD - hd;
    for (int i = threadIdx.x; i < (kBQ + 2 * BKV) * w; i += kThreads)
      Qs[(i / w) * LD + hd + i % w] = zero<T>();   // Q and both K stages
    for (int i = threadIdx.x; i < 2 * BKV * w; i += kThreads)
      Vs[(i / w) * LDV + hd + i % w] = zero<T>();
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_first = kv_begin / BKV, t_end = (kv_end + BKV - 1) / BKV;
  const long long kv_off = ((long long)b * S * KV + kvh) * hd;
  const long long kv_stride = (long long)KV * hd;
  load_rows<T, LD, HD, kBQ>(Qs, q + ((long long)b * S * H + h) * hd,
                            (long long)H * hd, q0, S, hd, vec);
  load_rows<T, LD, HD, BKV>(Ks, k + kv_off, kv_stride, t_first * BKV, S, hd,
                            vec);
  load_rows<T, LDV, HD, BKV>(Vs, v + kv_off, kv_stride, t_first * BKV, S, hd,
                             vec);
  cp_async_commit();

  const int w_first = q0 + warp * 16;
  const int w_last = min(w_first + 16, S) - 1;
  const int row0 = w_first + g, row1 = row0 + 8;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const T* qa_row = Qs + (warp * 16 + g) * LD + 4 * t;
  const T* qb_row = qa_row + 8 * LD;

  for (int it = t_first; it < t_end; ++it) {
    const int st = (it - t_first) & 1;
    cp_async_wait_all();
    __syncthreads();   // tile it is in; every warp is done with stage st^1
    if (it + 1 < t_end) {
      const int nx = (it + 1) * BKV;
      load_rows<T, LD, HD, BKV>(Ks + (st ^ 1) * BKV * LD, k + kv_off,
                                kv_stride, nx, S, hd, vec);
      load_rows<T, LDV, HD, BKV>(Vs + (st ^ 1) * BKV * LDV, v + kv_off,
                                 kv_stride, nx, S, hd, vec);
      cp_async_commit();
    }
    const int k0 = it * BKV;
    if (w_first > w_last || (causal && k0 > w_last) ||
        (window > 0 && k0 + BKV - 1 <= w_first - window))
      continue;        // warp-uniform: no valid key for any of its rows
    const bool full = k0 + BKV <= S &&
                      (!causal || k0 + BKV - 1 <= w_first) &&
                      (window <= 0 || k0 > w_last - window);
    const T* Kt = Ks + st * BKV * LD + g * LD + 4 * t;
    const T* Vt = Vs + st * BKV * LDV + 2 * t * LDV + g;

    // scores S[row][key]: s[j] is the accumulator tile of keys k0 + 8j ..,
    // c[j] that of the two correction products (two chains of mma each)
    float s[NJ][4], c[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = c[j][e] = 0.f;
#pragma unroll
    for (int G = 0; G < NG; ++G) {
      // dims 16G + 4t .. +3 of rows g and g+8: k-step 0 takes dims 4t, 4t+1
      // as columns t, t+4; k-step 1 takes 4t+2, 4t+3
      float qa[4], qb[4];
      frag4(qa_row + 16 * G, qa);
      frag4(qb_row + 16 * G, qb);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float x[4] = {qa[2 * ks], qb[2 * ks], qa[2 * ks + 1],
                            qb[2 * ks + 1]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kF32) split(x[i], ah[ks][i], al[ks][i]);
          else ah[ks][i] = __float_as_uint(x[i]);     // bf16: exact
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float kk[4];                 // key k0 + 8j + g, the same dims
        frag4(Kt + 8 * j * LD + 16 * G, kk);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          if constexpr (kF32) {
            uint32_t bh0, bl0, bh1, bl1;
            split(kk[2 * ks], bh0, bl0);
            split(kk[2 * ks + 1], bh1, bl1);
            mma(c[j], al[ks], bh0, bh1);
            mma(c[j], ah[ks], bl0, bl1);
            mma(s[j], ah[ks], bh0, bh1);
          } else {
            mma(s[j], ah[ks], __float_as_uint(kk[2 * ks]),
                __float_as_uint(kk[2 * ks + 1]));
          }
        }
      }
    }

    // online softmax; lane holds rows row0 (e = 0, 1) and row1 (e = 2, 3),
    // keys k0 + 8j + 2t + (e & 1)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kF32) s[j][e] += c[j][e];
        if (!full) {
          const int qp = e < 2 ? row0 : row1;
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const bool ok = kp < S && (!causal || kp <= qp) &&
                          (window <= 0 || kp > qp - window);
          if (!ok) s[j][e] = -INFINITY;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = exp2f((m_i[r] - m_new) * kLog2e);
      m_i[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - m_i[e >> 1]) * kLog2e);   // masked: 0
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P·V: the score tile of keys 8j.. is the A operand with keys 2t,
    // 2t+1 as columns t, t+4; B reads V rows 8j + 2t and 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(p[i], ph[i], pl[i]);
      const T* vj = Vt + 8 * j * LDV;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float v0 = to_f32(vj[8 * n]), v1 = to_f32(vj[LDV + 8 * n]);
        if constexpr (kF32) {
          uint32_t bh0, bl0, bh1, bl1;
          split(v0, bh0, bl0);
          split(v1, bh1, bl1);
          mma(acc[n], pl, bh0, bh1);
          mma(acc[n], ph, bl0, bl1);
          mma(acc[n], ph, bh0, bh1);
        } else {                     // bf16 V is exact in TF32
          mma(acc[n], pl, __float_as_uint(v0), __float_as_uint(v1));
          mma(acc[n], ph, __float_as_uint(v0), __float_as_uint(v1));
        }
      }
    }
  }

  // the denominators are the quad's partial sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int qp = r ? row1 : row0;
    if (qp >= S) continue;
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + (((long long)b * S + qp) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = 8 * n + 2 * t;
      const float x0 = acc[n][2 * r] / denom, x1 = acc[n][2 * r + 1] / denom;
      if (vec && d + 1 < hd) {
        store2(orow + d, x0, x1);
      } else {
        if (d < hd) store1(orow + d, x0);
        if (d + 1 < hd) store1(orow + d + 1, x1);
      }
    }
  }
}

template <typename T, int NG>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KV, int hd, int causal, int window, cudaStream_t stream) {
  using L = Tile<T, NG>;
  auto kern = flash_kernel<T, NG>;
  // the dynamic shared-memory limit is raised once per device and
  // instantiation, so a launch captured in a CUDA graph is the launch alone
  static std::atomic<unsigned long long> raised{0};
  if (L::SMEM > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(raised.load() & bit)) {
      err = cudaFuncSetAttribute((const void*)kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)L::SMEM);
      if (err != cudaSuccess) return (int)err;
      // all of the SM's 228 KB as shared memory, so three blocks fit
      err = cudaFuncSetAttribute((const void*)kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
      raised.fetch_or(bit);
    }
  }
  // 16-byte copies (and paired stores) when rows are whole 16-byte chunks
  // and the bases are aligned
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(o);
  const int vec = hd % (16 / (int)sizeof(T)) == 0 && (addr & 15) == 0;
  dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, L::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, hd, causal,
      window, vec);
  return (int)cudaGetLastError();
}

// head dims padded to 32, 48, 64, 80, 96, 128, 192 or 256
template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KV, int hd, int causal, int window,
             cudaStream_t st) {
  const int n16 = (hd + 15) / 16;
#define REPRO_FLASH(NG) \
  return launch<T, NG>(q, k, v, o, B, S, H, KV, hd, causal, window, st)
  if (n16 <= 2) REPRO_FLASH(2);
  if (n16 <= 3) REPRO_FLASH(3);
  if (n16 <= 4) REPRO_FLASH(4);
  if (n16 <= 5) REPRO_FLASH(5);
  if (n16 <= 6) REPRO_FLASH(6);
  if (n16 <= 8) REPRO_FLASH(8);
  if (n16 <= 12) REPRO_FLASH(12);
  REPRO_FLASH(16);
#undef REPRO_FLASH
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
