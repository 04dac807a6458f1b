// The Mamba2 SSD chunked scan on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// _kernel at :26, pallas_call at :73).  Per chunk of L positions, with cs the
// within-chunk cumulative sum of dt*A:
//
//   S          = C B^T                                 (L x L, depth N)
//   y_intra[i] = sum_{j <= i} S_ij exp(cs_i - cs_j) dt_j x_j
//   y_inter[i] = exp(cs_i) (C_i . h_in)
//   h_out      = exp(cs_end) h_in + sum_j B_j (exp(cs_end - cs_j) dt_j x_j)
//
// Bound on this card: at the served mamba2 shape (P 64, N 128, L 64) the
// products, run three times each (3xTF32, below), take a little longer
// than the bytes: 3 x 7.57 GFLOP / 495 TFLOP/s = 0.046 ms against 139.5 MB /
// 3.35 TB/s = 0.042 ms.  At hymba's (N 16) the bytes bound it.
//
// Two routes, by the state's size N:
//
// Tensor cores (32 <= N <= 256; mamba2).  The products run in TF32 (mma.sync
// m16n8k8) with the 3xTF32 split of tf32_mma.cuh, which keeps the f32
// tolerance; one TF32 pass would not (chip_smoke.py, kernel:ssd_scan,
// err_vs_f64).
// - The scores S = C B^T are the same for every head of a batch row, so a
//   first small kernel forms them once per (batch row, chunk) into a
//   scratch of B x chunks x L x L floats (1 MB at mamba2, which stays in
//   L2) that the wrapper allocates; the scan's blocks read them.  (A block
//   owning several heads would hold several P x N states and x tiles at
//   once: at mamba2 that does not fit beside a two-stage ring.)
// - The scan is computed transposed, with the head dim p as the mma's M:
//   y^T = (dt x)^T G^T + h^T (exp(cs) C)^T and h^T += (dt x)^T (B scaled by
//   exp(cs_end - cs)), G the gated scores.  Two warps own 16 p rows of one
//   head and split the state's n tiles: each keeps its 16 x N/2 part of h^T
//   in f32 mma accumulators across chunks (32 registers at mamba2),
//   decayed and accumulated in place and split into hi/lo only where it is
//   read as the A operand of y_inter: the state product's accumulator
//   layout is that operand's fragment layout when an mma step's 8
//   contraction indices are taken in the order n = 2t, 2t+1 (the order
//   inside one step is free).  The state is never stored, and never
//   rounded to TF32.  The pair splits y_intra by i tile (18 of the 36
//   tile steps each) and hands the other its y_inter partials through
//   shared memory (a 64-thread named barrier).  A block of up to 8 warps
//   covers 64 p of one (batch row, head); a wider head takes more blocks
//   (grid z).
// - The first kernel also forms the chunks' cumulative sums cs of dt*A,
//   per (batch row, chunk, head), in the plain version's order of addition
//   (see ssd_scores_kernel).
// - A chunk's x, dt, cs, B, C and S tiles come in by cp.async into a ring
//   of two stages: chunk c+1's copies are issued right after the barrier
//   that frees their stage and land while chunk c computes (one stage when
//   two do not fit, as at N 256).  The ragged last chunk is masked here: copies
//   past S are zero-filled, rows past S are never written, nothing is
//   padded in device memory.  Views that are not 16-byte aligned take
//   element loads.
// - The gate exp(cs_i - cs_j) is applied to S as its fragments are read,
//   with exp taken only where i >= j (an exp of the upper triangle could
//   overflow, and inf*0 is NaN); dt and exp(cs_end - cs_j) scale the x
//   fragments as they are read, and exp(cs_i) the y_inter result.  So
//   nothing is rescaled in place, and a chunk takes one barrier.
// - The 3xTF32 correction products go to accumulators of their own, so
//   two chains of mma run side by side.  The intra product skips the 8 x 8
//   blocks of G above the diagonal.  Padding to the mma tiles (P to 16, N
//   and L to 8) is zeros in shared memory; row strides are padded so that
//   every fragment read is free of bank conflicts (x, B, C: 8 mod 16 words;
//   S: 4 mod 8).  223 KB of shared memory at mamba2: one block (8 warps) an
//   SM.  The dynamic shared-memory limit and the carveout are raised once
//   per kernel and device, so a launch captured in a CUDA graph is the
//   launch alone.
// - What was measured on the way (PERF.md): with one warp per 16 p rows (4
//   warps, 1 block an SM) the kernel was slower than the CUDA-core one and
//   bound by latency in every phase, a pass that rescaled x, B and C in
//   place among them; pairs of warps, the rescaling and the gate folded
//   into the fragment reads and the split accumulators each took a share
//   off.
//
// CUDA cores (N < 32; hymba's N 16).  The earlier design, kept where it
// is faster: at N 16 the three TF32 passes cost more than the f32 products
// they replace (PERF.md: tools/ssd_variants.py, the tensor-core route
// forced at hymba's shape).  It also takes N > 256, where a warp's strip
// of the state would not fit its registers, up to the N at which the P x N
// state and one set of tiles fit 227 KB at L = 4 (760 at P 64; ssd_scan.py,
// plan).  See ssd_core_kernel.
//
// The chunk L is the kernel's own: the scan's result does not depend on it
// beyond rounding, so where a plan at the caller's chunk does not fit 227 KB
// the wrapper (ssd_scan.py, plan) passes the largest chunk that fits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tf32_mma.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait_all;
using repro::mma3;
using repro::split;

constexpr int kMaxWarps = 8;                  // a pair for each 16 p rows
constexpr int kScoreThreads = 256;
constexpr int kCoreThreads = 256;             // the CUDA-core route
constexpr int kMaxSmem = 232448;              // 227 KB a block
constexpr int kMaxState = 256;                // N: 32 n tiles of 8

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// the least y >= x with y = r (mod m)
inline int pad_to(int x, int r, int m) { return x + ((r - x) % m + m) % m; }

// Shared-memory layout of both kernels (mirrored by ssd_scan.plan in the
// wrapper, which tests it).  Lengths in floats.
struct Plan {
  int tc;                     // the tensor-core route (32 <= N <= 256), or
                              // CUDA cores
  int warps, pb, groups;      // warps and p columns a block; blocks a head
  int lr, ldx, ldn, lds;      // chunk rows padded to 8; row strides
  int stage, stages;          // floats of a stage (x, B, C, S, dt, cs); stages
  int smem;                   // bytes of the scan kernel
  int lr16, ldq, smem_scores; // the scores kernel: C rows to 16, stride, bytes
};

Plan make_plan(int P, int N, int L) {
  Plan p;
  const int pairs = (P + 15) / 16 < kMaxWarps / 2 ? (P + 15) / 16
                                                   : kMaxWarps / 2;
  p.warps = 2 * pairs;
  p.pb = 16 * pairs;
  p.groups = (P + p.pb - 1) / p.pb;
  p.lr = round_up(L, 8);
  const int n8 = round_up(N, 8);
  p.tc = N >= 32 && N <= kMaxState;
  p.ldx = pad_to(p.pb, 8, 16);
  p.ldn = pad_to(n8, 8, 16);
  p.lds = pad_to(p.lr, 4, 8);
  p.stage = p.lr * (p.ldx + 2 * p.ldn + p.lds + 2);     // + dt and cs
  const int cs = p.warps * 512;   // the partials a warp hands its pair
  p.stages = 4 * (2 * p.stage + cs) <= kMaxSmem ? 2
             : 4 * (p.stage + cs) <= kMaxSmem   ? 1
                                                : 0;
  p.smem = 4 * ((p.stages > 0 ? p.stages : 1) * p.stage + cs);
  p.lr16 = round_up(L, 16);
  p.ldq = pad_to(n8, 4, 32);
  p.smem_scores = 4 * (p.lr16 + p.lr) * p.ldq;
  if (!p.tc) {       // one set of tiles, loaded synchronously
    p.warps = kCoreThreads / 32;
    p.groups = 1;
    p.smem = 4 * (2 * L * (N + 4) + L * (P + 4) + L * (L + 4) + N * (P + 4) +
                  4 * L);
    p.stages = p.smem <= kMaxSmem ? 1 : 0;
    p.smem_scores = 0;
  }
  return p;
}

// Four floats from device memory into shared memory: a 16-byte cp.async
// (zero-filled when !in), or element loads when the view is not aligned.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool in,
                                      bool vec) {
  if (vec) {
    cp_async16(dst, src, in);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = in ? src[k] : 0.f;
  }
}

// bm, cm: (B,S,N); dt: (B,S,H); A: (H,).  Grid (chunks, B).
// scores[b][c][i][j] = C_i . B_j of chunk c (L x L, zero past S); tiles of
// 16 x 8 wholly above the diagonal are written as zeros without a product.
// After the B x chunks x L x L scores, cs[b][c][h][i]: the chunk's
// cumulative sum of dt*A of head h, in the plain version's order (dt*A
// rounded, then added one row after another; zero past S).  The gate takes
// exp of differences of these sums, which reach -200 within a chunk, so a
// sum in another order (a shuffle scan) moves the gate by 1e-5 and y past
// what a 48-layer model tolerates.
__global__ void __launch_bounds__(kScoreThreads)
ssd_scores_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  float* __restrict__ scores, int S, int H, int N, int L,
                  int vec, Plan pl) {
  extern __shared__ float4 smem4[];
  float* Cq = reinterpret_cast<float*>(smem4);   // [lr16][ldq]
  float* Bq = Cq + pl.lr16 * pl.ldq;             // [lr][ldq]
  const int c = blockIdx.x, b = blockIdx.y, nc = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = c * L, ldq = pl.ldq;
  const long long row0 = (long long)b * S + c0;

  for (int e = tid; e < (pl.lr16 + pl.lr) * ldq; e += kScoreThreads)
    Cq[e] = 0.f;                                 // padding stays zero
  __syncthreads();
  const int nq = N / 4;
  for (int e = tid; e < L * nq; e += kScoreThreads) {
    const int i = e / nq, q = 4 * (e % nq);
    const bool in = c0 + i < S;
    const long long off = (row0 + (in ? i : 0)) * N + q;
    copy4(Cq + i * ldq + q, cm + off, in, vec);
    copy4(Bq + i * ldq + q, bm + off, in, vec);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float* cs = scores + (long long)gridDim.y * nc * L * L +
              ((long long)b * nc + c) * H * L;
  for (int hh = tid; hh < H; hh += kScoreThreads) {
    const float ah = __ldg(A + hh);
    float acc = 0.f;
    for (int i = 0; i < L; ++i) {
      const float d = c0 + i < S ? __ldg(dt + (row0 + i) * H + hh) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(d, ah));
      cs[hh * L + i] = acc;
    }
  }

  const int nj = pl.lr / 8, ntiles = (pl.lr16 / 16) * nj;
  const int ksteps = round_up(N, 8) / 8;
  float* out = scores + ((long long)b * nc + c) * L * L;
  for (int tile = warp; tile < ntiles; tile += kScoreThreads / 32) {
    const int mi = tile / nj, j0 = 8 * (tile % nj), i0 = 16 * mi;
    float d[4] = {0.f, 0.f, 0.f, 0.f}, dc[4] = {0.f, 0.f, 0.f, 0.f};
    if (i0 + 15 >= j0) {                         // some i >= j in the tile
      const float* ar = Cq + (i0 + g) * ldq + t;
      const float* br = Bq + (j0 + g) * ldq + t;
      for (int ks = 0; ks < ksteps; ++ks) {
        uint32_t ah[4], al[4];
        split(ar[8 * ks], ah[0], al[0]);
        split(ar[8 * ldq + 8 * ks], ah[1], al[1]);
        split(ar[8 * ks + 4], ah[2], al[2]);
        split(ar[8 * ldq + 8 * ks + 4], ah[3], al[3]);
        mma3(d, dc, ah, al, br[8 * ks], br[8 * ks + 4]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += dc[e];
    const int j = j0 + 2 * t;                    // L is even: j < L => j+1 < L
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      if (i < L && j < L)
        *reinterpret_cast<float2*>(out + (long long)i * L + j) =
            make_float2(d[2 * r], d[2 * r + 1]);
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ float4 sh4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// acc[r][c] += dot(a[r], b[c]) over the four components
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float4 (&a)[4],
                                         const float4 (&b)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
      acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
      acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
      acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
    }
}

// acc[r][e] += a.r * b.e (outer product of two float4)
__device__ __forceinline__ void outer_tile(float (&acc)[4][4], const float4& a,
                                           const float4& b) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float ar = comp(a, r);
    acc[r][0] = fmaf(ar, b.x, acc[r][0]);
    acc[r][1] = fmaf(ar, b.y, acc[r][1]);
    acc[r][2] = fmaf(ar, b.z, acc[r][2]);
    acc[r][3] = fmaf(ar, b.w, acc[r][3]);
  }
}

// The CUDA-core route (the earlier kernel, for a state of N < 32, and of
// N > 256, past the tensor-core route's register strips): one block of 256
// threads per (batch, head) loops over its chunks with the P x N state in
// shared memory (transposed, hT[n][p]); each chunk's tiles are loaded by
// __ldg (zero past S); three phases of 4x4 register tiles in f32: (A) the
// gated scores C.B^T * exp(cs_i - cs_j), exp only where i >= j; (B) y =
// intra + inter; (C) the state update.  Shared rows padded by 4 floats.
// Nothing here depends on N beyond the loop bounds: no register array has N
// in it.
// x, y: (B,S,H,P); dt: (B,S,H); A: (H,); bm, cm: (B,S,N); all f32.
// P, N and L are multiples of 4.  Grid (H, B).
__global__ void __launch_bounds__(kCoreThreads)
ssd_core_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y, int S, int H,
           int P, int N, int L, int vec) {
  extern __shared__ float4 smem4[];
  const int ldn = N + 4, ldp = P + 4, ldl = L + 4;
  float* Cs = reinterpret_cast<float*>(smem4);  // [L][ldn]  C rows
  float* Bs = Cs + L * ldn;                     // [L][ldn]  B rows
  float* Xs = Bs + L * ldn;                     // [L][ldp]  dt * x
  float* Gt = Xs + L * ldp;                     // [L][ldl]  gated scores, [j][i]
  float* hT = Gt + L * ldl;                     // [N][ldp]  state, [n][p]
  float* cs = hT + N * ldp;                     // [L] cumsum of dt*A
  float* ecs = cs + L;                          // [L] exp(cs_i)
  float* dec = ecs + L;                         // [L] exp(cs_end - cs_j)
  float* dts = dec + L;                         // [L] dt

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int P4 = P / 4, N4 = N / 4, L4 = L / 4;
  const float a = __ldg(A + h);
  const long long row0 = (long long)b * S;      // first (b, s) row

  for (int e = tid; e < N * ldp; e += kCoreThreads) hT[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int i = tid; i < L; i += kCoreThreads)
      dts[i] = c0 + i < S ? __ldg(dt + (row0 + c0 + i) * H + h) : 0.f;
    for (int e = tid; e < L * N4; e += kCoreThreads) {
      const int i = e / N4, q = 4 * (e % N4);
      const bool in = c0 + i < S;
      const long long off = (row0 + c0 + i) * N + q;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(Bs + i * ldn + q) = in ? ld4(bm + off, vec) : zero;
      *reinterpret_cast<float4*>(Cs + i * ldn + q) = in ? ld4(cm + off, vec) : zero;
    }
    __syncthreads();  // dts is read below
    for (int e = tid; e < L * P4; e += kCoreThreads) {
      const int i = e / P4, q = 4 * (e % P4);
      const float4 v = c0 + i < S
          ? ld4(x + ((row0 + c0 + i) * H + h) * P + q, vec)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(Xs + i * ldp + q) = scale4(v, dts[i]);
    }
    if (tid == 0) {  // sequential, in the reference's order; rows past S add 0
      float acc = 0.f;
      for (int i = 0; i < L; ++i) {
        acc += dts[i] * a;
        cs[i] = acc;
      }
    }
    __syncthreads();

    // (A) gated scores: rows i = 4*it + r, columns j = jt + L4*c (interleaved,
    // so the lanes of a quarter-warp read distinct B rows: distinct banks)
    for (int i = tid; i < L; i += kCoreThreads) {
      ecs[i] = expf(cs[i]);
      dec[i] = expf(cs[L - 1] - cs[i]);
    }
    for (int t = tid; t < L4 * L4; t += kCoreThreads) {
      const int it = t / L4, jt = t % L4;
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cc[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cc[r] = sh4(Cs + (4 * it + r) * ldn + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = sh4(Bs + (jt + L4 * c) * ldn + n);
        dot_tile(acc, cc, bb);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = jt + L4 * c;
        float g[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * it + r;
          g[r] = i >= j ? acc[r][c] * expf(cs[i] - cs[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(Gt + j * ldl + 4 * it) =
            make_float4(g[0], g[1], g[2], g[3]);
      }
    }
    __syncthreads();

    // (B) y rows i = 4*it + r, head dims p = 4*pt + e
    for (int t = tid; t < L4 * P4; t += kCoreThreads) {
      const int it = t / P4, pt = t % P4;
      float intra[4][4] = {}, inter[4][4] = {};
      const int jend = 4 * it + 4;       // Gt is 0 for j > i
      for (int j = 0; j < jend; ++j)
        outer_tile(intra, sh4(Gt + j * ldl + 4 * it), sh4(Xs + j * ldp + 4 * pt));
      for (int n = 0; n < N; n += 4) {
        float4 cc[4], hh[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cc[r] = sh4(Cs + (4 * it + r) * ldn + n);
#pragma unroll
        for (int k = 0; k < 4; ++k) hh[k] = sh4(hT + (n + k) * ldp + 4 * pt);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float ck = comp(cc[r], k);
            inter[r][0] = fmaf(ck, hh[k].x, inter[r][0]);
            inter[r][1] = fmaf(ck, hh[k].y, inter[r][1]);
            inter[r][2] = fmaf(ck, hh[k].z, inter[r][2]);
            inter[r][3] = fmaf(ck, hh[k].w, inter[r][3]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * it + r;
        if (c0 + i >= S) continue;
        const float ei = ecs[i];
        const float4 out = make_float4(
            intra[r][0] + inter[r][0] * ei, intra[r][1] + inter[r][1] * ei,
            intra[r][2] + inter[r][2] * ei, intra[r][3] + inter[r][3] * ei);
        float* dst = y + ((row0 + c0 + i) * H + h) * P + 4 * pt;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = out;
        } else {
          dst[0] = out.x; dst[1] = out.y; dst[2] = out.z; dst[3] = out.w;
        }
      }
    }
    if (c0 + L >= S) break;  // no later chunk reads the state
    __syncthreads();         // hT is no longer read by (B)

    // (C) state: rows n = 4*nt + k, columns p = 4*pt + e
    const float chunk_decay = ecs[L - 1];
    for (int t = tid; t < N4 * P4; t += kCoreThreads) {
      const int nt = t / P4, pt = t % P4;
      float acc[4][4] = {};
      for (int j = 0; j < L; ++j)
        outer_tile(acc, scale4(sh4(Bs + j * ldn + 4 * nt), dec[j]),
                   sh4(Xs + j * ldp + 4 * pt));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float4* hp = reinterpret_cast<float4*>(hT + (4 * nt + k) * ldp + 4 * pt);
        const float4 old = *hp;
        *hp = make_float4(old.x * chunk_decay + acc[k][0],
                          old.y * chunk_decay + acc[k][1],
                          old.z * chunk_decay + acc[k][2],
                          old.w * chunk_decay + acc[k][3]);
      }
    }
  }
}

// The warp of a pair (0 or 1) that owns i tile k of a group of 8: tiles
// 0, 3, 4, 7 and 1, 2, 5, 6, so that the two take 18 of the 36 tile steps
// of the triangular intra product each; k >> 1 numbers either's other
// four.
__device__ __forceinline__ constexpr int owner(int k) {
  return (k ^ (k >> 1)) & 1;
}

__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// x, y: (B,S,H,P); dt: (B,S,H); bm, cm: (B,S,N); scores and cs from
// ssd_scores_kernel; all f32.  Grid (H, B, pl.groups), 32 * pl.warps
// threads: warp w owns p rows 16 (w / 2) .. + 15 of the block's and half
// w % 2 of the state's n tiles; NT >= ceil(ceil(N / 8) / 2).
template <int NT>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ bm,
           const float* __restrict__ cm, const float* __restrict__ scores,
           float* __restrict__ y, int S, int H, int P, int N, int L, int vec,
           Plan pl) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * pl.pb;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nc = (S + L - 1) / L, lt = pl.lr / 8, ntn = (N + 7) / 8;
  const int ldx = pl.ldx, ldn = pl.ldn, lds = pl.lds;
  const int half = warp & 1, pw = 16 * (warp >> 1);
  const int nth = (ntn + 1) / 2, n_lo = half * nth;
  const int n_cnt = min(nth, ntn - n_lo);      // this warp's n tiles
  const int nstage = pl.stages;
  // the scores kernel's cs of this head, chunk by chunk, after the scores
  const float* cs_h = scores + (long long)gridDim.y * nc * L * L +
                      ((long long)b * nc * H + h) * L;
  // the y_inter partials a warp hands its pair: 4 i tiles x 4 x 32 lanes
  float* red = base + nstage * pl.stage;
  float* mine = red + warp * 512;
  const float* theirs = red + (warp ^ 1) * 512;

  // zero the padding that the fragments read and no copy writes: rows L ..
  // lr of every tile, x's columns past P, B's and C's past N, S's past L
  auto zero_pad = [&](float* t0, int ld, int cols_valid, int cols) {
    const int w = cols - cols_valid;
    for (int e = tid; e < pl.lr * w; e += nthreads)
      t0[(e / w) * ld + cols_valid + e % w] = 0.f;
    for (int e = tid; e < (pl.lr - L) * cols_valid; e += nthreads)
      t0[(L + e / cols_valid) * ld + e % cols_valid] = 0.f;
  };
  const int n8 = 8 * ntn;
  for (int st = 0; st < nstage; ++st) {
    float* X = base + st * pl.stage;
    float* Bt = X + pl.lr * ldx;
    float* Ct = Bt + pl.lr * ldn;
    float* St = Ct + pl.lr * ldn;
    zero_pad(X, ldx, min(pl.pb, P - p0), pl.pb);
    zero_pad(Bt, ldn, N, n8);
    zero_pad(Ct, ldn, N, n8);
    zero_pad(St, lds, L, pl.lr);
    for (int j = L + tid; j < pl.lr; j += nthreads) St[pl.lr * lds + j] = 0.f;
  }
  __syncthreads();

  // chunk c's tiles into stage st: x rows of this block's p columns, dt,
  // B and C rows, and the chunk's scores
  auto issue = [&](int c, int st) {
    float* X = base + st * pl.stage;
    float* Bt = X + pl.lr * ldx;
    float* Ct = Bt + pl.lr * ldn;
    float* St = Ct + pl.lr * ldn;
    float* Dt = St + pl.lr * lds;
    const int c0 = c * L;
    const long long row0 = (long long)b * S + c0;
    const int xq = pl.pb / 4, nq = N / 4, sq = L / 4;
    for (int e = tid; e < L * xq; e += nthreads) {
      const int j = e / xq, q = 4 * (e % xq);
      if (p0 + q >= P) continue;
      const bool in = c0 + j < S;
      copy4(X + j * ldx + q, x + ((row0 + (in ? j : 0)) * H + h) * P + p0 + q,
            in, vec);
    }
    for (int e = tid; e < L * nq; e += nthreads) {
      const int j = e / nq, q = 4 * (e % nq);
      const bool in = c0 + j < S;
      const long long off = (row0 + (in ? j : 0)) * N + q;
      copy4(Bt + j * ldn + q, bm + off, in, vec);
      copy4(Ct + j * ldn + q, cm + off, in, vec);
    }
    const float* sc = scores + ((long long)b * nc + c) * L * L;
    for (int e = tid; e < L * sq; e += nthreads) {
      const int i = e / sq, q = 4 * (e % sq);
      cp_async16(St + i * lds + q, sc + (long long)i * L + q, true);
    }
    for (int j = tid; j < L; j += nthreads) {
      const bool in = c0 + j < S;
      cp_async4(Dt + j, dt + (row0 + (in ? j : 0)) * H + h, in);
    }
    for (int q = 4 * tid; q < L; q += 4 * nthreads)
      cp_async16(Dt + pl.lr + q, cs_h + (long long)c * H * L + q, true);
    cp_async_commit();
  };

  // this warp's part of the state, h^T[p][n]: hacc[nt] is the accumulator
  // tile of n = 8 (n_lo + nt) .., rows p = pw + g (e = 0, 1) and + 8
  // (e = 2, 3), columns n = 8 (n_lo + nt) + 2t + (e & 1)
  float hacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[n][e] = 0.f;
  const bool active = p0 + pw < P;             // the same for both warps

  if (nstage == 2) issue(0, 0);
  for (int c = 0; c < nc; ++c) {
    const int st = nstage == 2 ? (c & 1) : 0;
    if (nstage == 1) {
      __syncthreads();                         // chunk c-1 is done with it
      issue(c, 0);
    }
    cp_async_wait_all();
    __syncthreads();   // chunk c is in; every warp is done with chunk c-1
    if (nstage == 2 && c + 1 < nc) issue(c + 1, st ^ 1);
    float* X = base + st * pl.stage;
    float* Bt = X + pl.lr * ldx;
    float* Ct = Bt + pl.lr * ldn;
    float* St = Ct + pl.lr * ldn;
    const float* Dt = St + pl.lr * lds;
    const int c0 = c * L;
    const long long row0 = (long long)b * S + c0;

    // cs, rows past L as row L - 1 (dt is 0 there)
    const float* csw = Dt + pl.lr;
    const float cs_end = csw[L - 1];

    if (!active) continue;

    // A operand (dt x)^T of j step js, each column j scaled by w_j: rows
    // p = pw + g (+8), columns j = 8 js + t (+4)
    auto load_x = [&](int js, float w0, float w1, uint32_t (&ah)[4],
                      uint32_t (&al)[4]) {
      const float* xr = X + (8 * js + t) * ldx + pw + g;
      split(xr[0] * w0, ah[0], al[0]);
      split(xr[8] * w0, ah[1], al[1]);
      split(xr[4 * ldx] * w1, ah[2], al[2]);
      split(xr[4 * ldx + 8] * w1, ah[3], al[3]);
    };

    // y^T in groups of 8 i tiles (64 rows): yacc[k] + ycor[k] hold rows
    // p = pw + g (+8), columns i = 8 (8 ig + k) + 2t (+1).  The pair splits
    // y_inter by n (each its half of the state) and y_intra by i tile
    // (owner(k) == half), then each adds the other's y_inter partial of
    // its own tiles.
    for (int ig = 0; 8 * ig < lt; ++ig) {
      float yacc[8][4], ycor[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[k][e] = ycor[k][e] = 0.f;
      if (c > 0) {     // y_inter = h_in^T C^T, contraction n = 2t, 2t+1
#pragma unroll
        for (int ns = 0; ns < NT; ++ns) {
          if (ns >= n_cnt) break;
          uint32_t ah[4], al[4];
          split(hacc[ns][0], ah[0], al[0]);
          split(hacc[ns][2], ah[1], al[1]);
          split(hacc[ns][1], ah[2], al[2]);
          split(hacc[ns][3], ah[3], al[3]);
          const float* cr = Ct + (64 * ig + g) * ldn + 8 * (n_lo + ns) + 2 * t;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (8 * ig + k < lt) {
              const float2 cv =
                  *reinterpret_cast<const float2*>(cr + 8 * k * ldn);
              mma3(yacc[k], ycor[k], ah, al, cv.x, cv.y);
            }
          }
        }
        // times exp(cs_i), column i of the tile
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = 8 * (8 * ig + k) + 2 * t;
          if (8 * ig + k < lt) {
            const float e0 = expf(csw[min(i, L - 1)]);
            const float e1 = expf(csw[min(i + 1, L - 1)]);
            yacc[k][0] = (yacc[k][0] + ycor[k][0]) * e0;
            yacc[k][1] = (yacc[k][1] + ycor[k][1]) * e1;
            yacc[k][2] = (yacc[k][2] + ycor[k][2]) * e0;
            yacc[k][3] = (yacc[k][3] + ycor[k][3]) * e1;
#pragma unroll
            for (int e = 0; e < 4; ++e) ycor[k][e] = 0.f;
          }
        }
      }
      // y_intra = (dt x)^T G^T of this warp's tiles, over the j steps up to
      // the group's last row; G = S exp(cs_i - cs_j), gated as it is read,
      // with exp taken only where i >= j (an exp of the upper triangle
      // could overflow, and inf*0 is NaN)
      const int it_end = min(8 * ig + 8, lt);
      float ci[8];     // cs of row i = 8 it + g of each tile
#pragma unroll
      for (int k = 0; k < 8; ++k)
        ci[k] = csw[min(8 * (8 * ig + k) + g, L - 1)];
      for (int js = 0; js < it_end; ++js) {
        const int j0 = 8 * js + t;
        const float cj0 = csw[min(j0, L - 1)];
        const float cj1 = csw[min(j0 + 4, L - 1)];
        uint32_t ah[4], al[4];
        load_x(js, Dt[j0], Dt[j0 + 4], ah, al);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int it = 8 * ig + k, i = 8 * it + g;
          if (owner(k) == half && it >= js && it < lt) {
            const float* sr = St + i * lds + j0;
            const float b0 = j0 <= i ? sr[0] * expf(ci[k] - cj0) : 0.f;
            const float b1 = j0 + 4 <= i ? sr[4] * expf(ci[k] - cj1) : 0.f;
            mma3(yacc[k], ycor[k], ah, al, b0, b1);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[k][e] += ycor[k][e];
      if (c > 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (owner(k) != half)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mine[((k >> 1) * 4 + e) * 32 + lane] = yacc[k][e];
        pair_sync(1 + (warp >> 1));
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (owner(k) == half)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              yacc[k][e] += theirs[((k >> 1) * 4 + e) * 32 + lane];
        if (8 * ig + 8 < lt) pair_sync(1 + (warp >> 1));  // red is free
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int it = 8 * ig + k;
        if (owner(k) != half || it >= lt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * it + 2 * t + (e & 1);
          const int p = p0 + pw + g + 8 * (e >> 1);
          if (i < L && c0 + i < S && p < P)
            y[((row0 + i) * H + h) * P + p] = yacc[k][e];
        }
      }
    }

    // h^T = exp(cs_end) h^T + (dt x)^T B', skipped after the last chunk
    if (c + 1 < nc) {
      const float decay = expf(cs_end);
      float hcor[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hacc[n][e] *= decay;
          hcor[n][e] = 0.f;
        }
      for (int js = 0; js < lt; ++js) {
        const int j = 8 * js + t;   // dt_j exp(cs_end - cs_j); 0 past L
        uint32_t ah[4], al[4];
        load_x(js, Dt[j] * expf(cs_end - csw[min(j, L - 1)]),
               Dt[j + 4] * expf(cs_end - csw[min(j + 4, L - 1)]), ah, al);
        const float* br = Bt + (8 * js + t) * ldn + 8 * n_lo + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (nt < n_cnt)
            mma3(hacc[nt], hcor[nt], ah, al, br[8 * nt],
                 br[4 * ldn + 8 * nt]);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[n][e] += hcor[n][e];
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to 227 KB and its carveout
// to all shared, once per device; ``raised`` is the kernel's own bit set.
int raise_smem(const void* kern, std::atomic<unsigned long long>& raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (raised.load() & bit) return 0;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  raised.fetch_or(bit);
  return 0;
}

template <int NT>
int launch_scan(const float* x, const float* dt, const float* bm,
                const float* cm, const float* scores,
                float* y, int B, int S, int H, int P, int N, int L, int vec,
                const Plan& pl, cudaStream_t stream) {
  static std::atomic<unsigned long long> raised{0};
  auto kern = ssd_kernel<NT>;
  const int err = raise_smem((const void*)kern, raised);
  if (err) return err;
  dim3 grid(H, B, pl.groups);
  kern<<<grid, 32 * pl.warps, pl.smem, stream>>>(x, dt, bm, cm, scores, y, S,
                                                 H, P, N, L, vec, pl);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), A (H,), bm/cm (B,S,N), y (B,S,H,P); scores:
// scratch of B * ceil(S/L) * L * (L + H) floats (null on the CUDA-core
// route).
// f32.  P, N and L multiples of 4, and a plan whose shared memory fits
// 227 KB.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* bm, const void* cm, void* scores,
                              void* y, int B, int S, int H, int P, int N,
                              int L, void* stream) {
  if (P <= 0 || N <= 0 || L <= 0 || P % 4 || N % 4 || L % 4)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(P, N, L);
  if (pl.stages == 0 || pl.smem_scores > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(x) && aligned16(bm) && aligned16(cm);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  float* sf = static_cast<float*>(scores);
  float* yf = static_cast<float*>(y);

  if (!pl.tc) {
    static std::atomic<unsigned long long> raised{0};
    const int err = raise_smem((const void*)ssd_core_kernel, raised);
    if (err) return err;
    ssd_core_kernel<<<dim3(H, B), kCoreThreads, pl.smem, st>>>(
        xf, dtf, Af, bf, cf, yf, S, H, P, N, L, vec && aligned16(y));
    return (int)cudaGetLastError();
  }
  static std::atomic<unsigned long long> raised{0};
  int err = raise_smem((const void*)ssd_scores_kernel, raised);
  if (err) return err;
  dim3 sgrid((S + L - 1) / L, B);
  ssd_scores_kernel<<<sgrid, kScoreThreads, pl.smem_scores, st>>>(
      bf, cf, dtf, Af, sf, S, H, N, L, vec, pl);
  err = (int)cudaGetLastError();
  if (err) return err;

  const int nth = ((N + 7) / 8 + 1) / 2;       // n tiles of a warp
#define REPRO_SCAN(NT)                                                      \
  return launch_scan<NT>(xf, dtf, bf, cf, sf, yf, B, S, H, P, N, L, vec, pl, \
                         st)
  if (nth <= 2) REPRO_SCAN(2);
  if (nth <= 4) REPRO_SCAN(4);
  if (nth <= 8) REPRO_SCAN(8);
  REPRO_SCAN(16);
#undef REPRO_SCAN
}
