// The Mamba2 SSD chunked scan on Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan,
// _kernel at :26, pallas_call at :73).  Per chunk of L positions, with cs the
// within-chunk cumulative sum of dt*A:
//
//   y_intra[i] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//   y_inter[i] = exp(cs_i) (C_i . h_in)
//   h_out      = exp(cs_end) h_in + sum_j B_j (exp(cs_end - cs_j) dt_j x_j)
//
// Bound on this card: operations.  At the served mamba2 shape (P 64, N 128,
// L 64) each position of each head costs about L/2*P (intra) + 2*P*N (inter
// and state) multiply-adds against 8*P bytes of x and y, some 70 flops a
// byte, far above the H100's f32 ridge point of 20; the arithmetic is f32 on
// the CUDA cores (TF32 tensor cores would not meet the f32 tolerance).  As in
// the flash kernel, the practical limit is how many shared-memory reads feed
// each multiply-add.
//
// Design: the TPU kernel walks the chunks along a sequential grid axis with
// the whole (H, P, N) state in VMEM (2 MiB for mamba2), far more than an SM's
// 227 KB.  Here one block of 256 threads owns one (batch, head) and loops over
// its chunks in order; the head's P x N f32 state stays in shared memory
// (32 KB for mamba2, 4 KB for hymba), stored transposed (hT[n][p]).  Each
// chunk's dt, dt*x, B and C tiles are loaded into shared memory (zero past S:
// the ragged last chunk is masked here, nothing is padded in device memory,
// and rows past S are never written).  Three phases per chunk, each a loop
// over 4x4 register tiles so that every 16-byte shared read feeds 16
// multiply-adds: (A) the gated scores C.B^T * exp(cs_i - cs_j), stored
// transposed, with exp taken only where i >= j (elsewhere the score is 0; an
// exp of the upper triangle could overflow, and inf*0 is NaN); (B) y = intra
// + inter; (C) the state update, skipped after the last chunk.  Shared rows
// are padded by 4 floats so the tile reads are free of bank conflicts.  The
// scores C.B^T are the same for every head of a batch row; each block
// recomputes them for its own head (H-fold redundant work, about a third of
// the block's multiply-adds at the mamba2 shape; sharing them is work for the
// PR that makes this kernel fast, with wgmma and TMA).  At mamba2's shape the
// tiles take about 138 KB, so the launch raises the dynamic shared-memory
// limit and one block runs per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// x, y: (B,S,H,P); dt: (B,S,H); A: (H,); bm, cm: (B,S,N); all f32.
// P, N and L are multiples of 4.  Grid (H, B).
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
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

  for (int e = tid; e < N * ldp; e += kThreads) hT[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's tiles are no longer read
    for (int i = tid; i < L; i += kThreads)
      dts[i] = c0 + i < S ? __ldg(dt + (row0 + c0 + i) * H + h) : 0.f;
    for (int e = tid; e < L * N4; e += kThreads) {
      const int i = e / N4, q = 4 * (e % N4);
      const bool in = c0 + i < S;
      const long long off = (row0 + c0 + i) * N + q;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(Bs + i * ldn + q) = in ? ld4(bm + off, vec) : zero;
      *reinterpret_cast<float4*>(Cs + i * ldn + q) = in ? ld4(cm + off, vec) : zero;
    }
    __syncthreads();  // dts is read below
    for (int e = tid; e < L * P4; e += kThreads) {
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
    for (int i = tid; i < L; i += kThreads) {
      ecs[i] = expf(cs[i]);
      dec[i] = expf(cs[L - 1] - cs[i]);
    }
    for (int t = tid; t < L4 * L4; t += kThreads) {
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
    for (int t = tid; t < L4 * P4; t += kThreads) {
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
    for (int t = tid; t < N4 * P4; t += kThreads) {
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (B,S,H,P), dt (B,S,H), A (H,), bm/cm (B,S,N), y (B,S,H,P); f32.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* bm, const void* cm, void* y, int B,
                              int S, int H, int P, int N, int L,
                              void* stream) {
  if (P <= 0 || N <= 0 || L <= 0 || P % 4 || N % 4 || L % 4)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return 0;
  const size_t smem = sizeof(float) *
      (2 * (size_t)L * (N + 4) + (size_t)L * (P + 4) + (size_t)L * (L + 4) +
       (size_t)N * (P + 4) + 4 * (size_t)L);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec = aligned16(x) && aligned16(bm) && aligned16(cm) && aligned16(y);
  dim3 grid(H, B);
  ssd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<float*>(y), S, H, P, N, L,
      vec);
  return (int)cudaGetLastError();
}
