// Flash-decoding on Hopper: one query token per (batch, head) against a KV
// cache with a per-slot validity mask.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, _kernel at :24, pallas_call at :76).
//
// Bound on this card: bytes.  Each cache slot is read once and used by the
// group's H/KV query heads for 2·hd multiply-adds each, far below the ~20 f32
// operations per byte at which the CUDA cores, not device memory, would be
// the limit.  So the work is to stream the valid part of K and V once, with
// enough bytes in flight and every block busy.
//
// Design: the TPU grid (b, h, kv block) walked the cache once per query head
// with the softmax state in VMEM scratch along the sequential kv-block axis.
// Here one block of 4 warps owns one (batch, kv head) and one split of the
// cache's tiles of 32 slots, and holds all of the group's query heads (up to
// 2048 / hd of them; a larger group is cut into chunks along grid y), so each
// K/V tile is read from device memory once for the whole group.
//
// - Tiles are dealt to the splits, not cut into ranges: split s takes tiles
//   s, s + nsplit, s + 2·nsplit, ...  Any contiguous run of valid slots (the
//   prefix of a growing cache, a window) spreads within one tile over all
//   splits, without the host reading the mask.  The splits fill the 132 SMs
//   when B·KV alone would not (qwen3 at batch 16 has 128 (b, kv) pairs):
//   the wrapper takes as many as one wave of the grid holds, by this
//   kernel's occupancy (repro_decode_occupancy): 3 at qwen3's last step (3
//   blocks an SM), 8 at hymba's ring (6).  A second, partial wave cost more
//   than longer splits (tools/decode_variants.py, PERF.md).
// - A tile whose 32 slots are all invalid is never loaded: every warp finds
//   the next valid tile of its split itself (one byte of the mask a lane,
//   __any_sync), so the block agrees without a barrier, and that tile's
//   copy is issued before this tile's scores.  A split with no valid tile
//   ends with m = -inf, l = 0 and weighs nothing in the merge; in a loaded
//   tile the invalid slots get p = 0 explicitly.
// - K and V tiles come in raw (f32 or bf16) by 16-byte cp.async into a ring
//   of two stages and are converted to f32 as they are read; rows whose
//   bytes are not whole 16-byte chunks, or unaligned bases, take element
//   loads.  Two barriers a tile: one when the tile has landed (which also
//   frees the other stage), one between the softmax and P·V.  The scores
//   and the online softmax of a head are one warp's (lane = slot: the K row
//   is read 16 bytes a lane, the max and the sum are shuffles); P·V gives
//   each thread up to 16 (head, dim) outputs in registers.  K rows are
//   padded to 16 mod 128 bytes, so the 16-byte reads of 8 neighbouring
//   slots are free of bank conflicts.
// - Shared memory: 66 KB at hd 128 in f32, so three blocks share an SM
//   (34 KB in bf16; 35 KB at hymba's hd 64 and group of 5).
// - Two stages against three, at 2 to 16 blocks an SM
//   (tools/decode_variants.py, PERF.md): three were slower at both served
//   shapes.  Tiles of 64 slots were not tried: a lane would own two slots.
//
// A second small kernel merges the splits' (m, l, acc) per (batch, head).
// Where no slot at all is valid it returns the mean of V over every slot,
// which is what the plain version's softmax over equal -1e30 logits gives.
// Any L, hd up to 256, nothing padded in device memory.  q arrives
// pre-scaled by hd^-0.5 in its own dtype, as on the TPU.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait_group;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 32;                     // slots per tile (one per lane)
constexpr int kStages = 2;                 // tiles in the cp.async ring (2
                                           // or 3; PERF.md has both)
constexpr int kMaxR = 16;                  // (head, dim) outputs per thread
constexpr int kMaxSmem = 232448;           // 227 KB a block
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

// the 16 bytes at p (4 f32 or 8 bf16 elements) as f32
__device__ __forceinline__ void frag(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void frag(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
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

// Shared-memory layout: K and V stages (raw), then Q (f32), P, m, l, alpha.
// hde: hd rounded up to whole 16-byte chunks; ldk: K's row stride, 16 mod
// 128 bytes; V rows are hde.
template <typename T>
struct Layout {
  static constexpr int E = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  static constexpr int M = 128 / (int)sizeof(T);
  int hde, ldk;
  __host__ __device__ explicit Layout(int hd)
      : hde((hd + E - 1) / E * E), ldk(hde + ((E - hde) % M + M) % M) {}
  __host__ __device__ size_t bytes(int gb) const {
    return sizeof(T) * (size_t)kStages * kT * (ldk + hde) +
           sizeof(float) * ((size_t)gb * hde + (size_t)gb * kT + 3 * gb);
  }
};

// q: (B,1,H,hd), k/v: (B,L,KV,hd), valid: (L,) 0/1 bytes.  Block
// (split, kvh·nchunk + chunk, b) owns query heads h0 .. h0+gn-1 of kv head
// kvh and tiles split, split + S, ... (S = gridDim.x).  Writes m, l (B,H,S)
// and the unnormalised acc (B,H,S,hd).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    float* __restrict__ m_part, float* __restrict__ l_part,
                    float* __restrict__ acc_part, int L, int H, int KV, int hd,
                    int gb, int vec) {
  constexpr int E = Layout<T>::E;
  const Layout<T> lay(hd);
  const int hde = lay.hde, ldk = lay.ldk;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);           // kStages x kT x ldk
  T* Vs = Ks + kStages * kT * ldk;               // kStages x kT x hde
  float* Qs = reinterpret_cast<float*>(Vs + kStages * kT * hde);  // gb x hde
  float* Ps = Qs + gb * hde;                     // gb x kT
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

  // K's dims past hd are read by the scores (against Q's zeros): zero them
  // once; no copy writes them
  if (hd < hde) {
    const int w = hde - hd;
    for (int i = tid; i < kStages * kT * w; i += kThreads)
      Ks[(i / w) * ldk + hd + i % w] = from_f32<T>(0.f);
  }
  for (int i = tid; i < gn * hde; i += kThreads) {
    const int g = i / hde, d = i % hde;
    Qs[i] = d < hd ? to_f32(q[((long long)b * H + h0 + g) * hd + d]) : 0.f;
  }
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
  const long long kv_off = ((long long)b * L * KV + kvh) * hd;
  const long long kv_stride = (long long)KV * hd;
  // the first tile of this split at or after t with a valid slot
  auto next_tile = [&](int t) {
    for (; t < ntiles; t += S) {
      const int j = t * kT + lane;
      if (__any_sync(kFull, j < L && valid[j] != 0)) break;
    }
    return t;
  };
  // tile t's K and V rows into stage st, zero past L
  auto issue = [&](int t, int st) {
    T* kd = Ks + st * kT * ldk;
    T* vd = Vs + st * kT * hde;
    const int j0 = t * kT;
    if (vec) {                 // hd = hde, 16-byte aligned rows
      const int cpr = hde / E;
      for (int i = tid; i < kT * cpr; i += kThreads) {
        const int r = i / cpr, c = (i % cpr) * E, p = j0 + r;
        const long long off =
            kv_off + (long long)min(p, L - 1) * kv_stride + c;
        cp_async16(kd + r * ldk + c, k + off, p < L);
        cp_async16(vd + r * hde + c, v + off, p < L);
      }
    } else {
      for (int i = tid; i < kT * hd; i += kThreads) {
        const int r = i / hd, c = i % hd, p = j0 + r;
        const long long off = kv_off + (long long)p * kv_stride + c;
        kd[r * ldk + c] = p < L ? k[off] : from_f32<T>(0.f);
        vd[r * hde + c] = p < L ? v[off] : from_f32<T>(0.f);
      }
    }
  };

  // the ring: tile t is read from stage st while the next kStages - 1
  // valid tiles are in flight (t1: the one after t, with three stages);
  // one group of copies is committed per tile, empty past the last
  int t = next_tile(split), t1 = ntiles, st = 0;
  if (t < ntiles) issue(t, 0);
  cp_async_commit();
  if constexpr (kStages == 3) {
    t1 = next_tile(t + S);
    if (t1 < ntiles) issue(t1, 1);
    cp_async_commit();
  }
  while (t < ntiles) {
    const int tn = next_tile((kStages == 3 ? t1 : t) + S);
    cp_async_wait_group<kStages - 2>();
    // tile t is in; every thread is done with the previous tile's stage, P
    // and alpha
    __syncthreads();
    if (tn < ntiles) issue(tn, (st + kStages - 1) % kStages);
    cp_async_commit();
    const int j0 = t * kT;
    const bool ok_j = j0 + lane < L && valid[j0 + lane] != 0;
    const T* Kt = Ks + st * kT * ldk;
    const T* Vt = Vs + st * kT * hde;

    // scores and online softmax of head g by one warp, lane = slot; the
    // tile has a valid slot, so m_new is finite and alpha = 0 the first time
    for (int g = warp; g < gn; g += kWarps) {
      const float* qr = Qs + g * hde;
      const T* kr = Kt + lane * ldk;
      float s = 0.f;
      for (int d = 0; d < hde; d += E) {
        float kk[E];
        frag(kr + d, kk);
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[d + e], kk[e], s);
      }
      s = ok_j ? s : -INFINITY;
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
        for (int j = 0; j < kT; ++j)
          a = fmaf(pr[j], to_f32(Vt[j * hde + d]), a);
        acc[r] = a;
      }
    }
    if constexpr (kStages == 3) {
      t = t1;
      t1 = tn;
    } else {
      t = tn;
    }
    st = (st + 1) % kStages;
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

// The split kernel's dynamic shared-memory limit and carveout, raised once
// per device and instantiation, so a launch captured in a CUDA graph is
// the launch alone
template <typename T>
cudaError_t raise_smem() {
  static std::atomic<unsigned long long> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (raised.load() & bit) return cudaSuccess;
  const void* kern = (const void*)decode_split_kernel<T>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  raised.fetch_or(bit);
  return cudaSuccess;
}

template <typename T>
int occupancy(int hd, int gb, int* blocks) {
  cudaError_t err = raise_smem<T>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_split_kernel<T>, kThreads, Layout<T>(hd).bytes(gb));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid,
           float* m_part, float* l_part, float* acc_part, void* o, int B,
           int L, int H, int KV, int hd, int gb, int nsplit,
           cudaStream_t stream) {
  const Layout<T> lay(hd);
  const size_t smem = lay.bytes(gb);
  // 16-byte copies when rows are whole 16-byte chunks and the bases aligned
  const int vec = hd % Layout<T>::E == 0 &&
                  ((reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  auto split_kern = decode_split_kernel<T>;
  cudaError_t err = raise_smem<T>();
  if (err != cudaSuccess) return (int)err;
  const int group = H / KV, nchunk = (group + gb - 1) / gb;
  dim3 grid(nsplit, KV * nchunk, B);
  split_kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, m_part, l_part, acc_part, L, H, KV, hd,
      gb, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_merge_kernel<T><<<B * H, kThreads, 0, stream>>>(
      m_part, l_part, acc_part, static_cast<const T*>(v), static_cast<T*>(o),
      L, H, KV, hd, nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

// m_part, l_part: (B,H,nsplit) f32 scratch; acc_part: (B,H,nsplit,hd) f32
// scratch.  gb: query heads per block (gb·hd <= 2048, gb <= H/KV); tps: the
// most tiles of 32 slots a split takes (split s takes tiles s, s + nsplit,
// ...); nsplit = ceil(ceil(L/32) / tps).
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
                                       hd, gb, nsplit, st)
              : launch<float>(q, k, v, ok, mp, lp, ap, o, B, L, H, KV, hd, gb,
                              nsplit, st);
}

// The split kernel's blocks that fit one SM of the current device at head
// dim hd with gb query heads a block (the wrapper sizes the splits by it).
extern "C" int repro_decode_occupancy(int hd, int gb, int bf16, void* blocks) {
  int* n = static_cast<int*>(blocks);
  return bf16 ? occupancy<__nv_bfloat16>(hd, gb, n)
              : occupancy<float>(hd, gb, n);
}
