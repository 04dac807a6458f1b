// Grouped f32 products on Hopper's tensor cores at f32 accuracy (3xTF32),
// for the experts of a dropless MoE layer:
//
//   grouped row i of expert e (offsets[e] <= i < offsets[e+1]):
//     y_i = x[rows ? rows[i] : i] @ w[e]          x (R, K), w (E, K, N)
//   without scatter: out[i] = y_i                 out (A, N)
//   with scatter:    out[scatter[i]] += scale[i] * y_i   (atomic adds)
//
// Replaces no Pallas kernel: the JAX package's MoE layers are einsums.  It
// serves models/moe.py::moe_ffn_dropless through kernels/ops.py::
// grouped_dense: the gate and up products gather each held expert's token
// rows by index, and the down product scatters its rows, weighted by the
// router, onto the shared expert's output.  The offsets live in device
// memory and the host never reads them, so a forward queues its layers
// without waiting on the card.
//
// The tile is gemm_tf32x3.cu's, and its main loop the same code
// (wgmma_tf32.cuh's tf32x3::mainloop): 128 x 128 of out a block, two
// warpgroups of wgmma m64n128k8 (out^T = w^T x^T, w^T's fragments split in
// registers, x's tile split once a stage into swizzled hi/lo tiles), each
// 32-k stage summed afresh on the tensor cores and added into f32
// registers (one accumulator over all of K read 13-25x cuBLAS f32's error
// against float64, PERF.md §6), cp.async rings three stages ahead.  What
// differs:
// - Persistent blocks: one a multiprocessor (212 KB of shared memory each),
//   walking the work items (m-tile of an expert, n-tile) that the offsets
//   give; an expert of c rows has ceil(c / 128) m-tiles.  The host bounds
//   nothing but the grid: no block is launched to find its tile empty.
// - x's rows are gathered: each thread's four rows of a tile are looked up
//   once a tile, and cp.async reads them where they lie.
// - The store skips rows past the expert's last; with scatter it is an
//   atomic add of scale x row into the destination row (a token's held
//   experts add in no fixed order: rounding-level nondeterminism).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "wgmma_tf32.cuh"

namespace {

using namespace repro::tf32x3;

constexpr int kMaxExperts = 256;       // experts a call may group
static_assert(kSmem + 8 * (kMaxExperts + 1) <= kMaxSmem,
              "the stages and the tile table do not fit 227 KB");

struct Args {
  const float* x;
  const float* w;
  float* out;
  const int* offsets;   // (E + 1,)
  const int* rows;      // (A,) or null
  const int* scatter;   // (A,) or null
  const float* scale;   // (A,) with scatter
  int E, K, N;
};

__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_grouped_kernel(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int s_off[kMaxExperts + 1];    // the experts' first rows
  __shared__ int s_tile[kMaxExperts + 1];   // the experts' first m-tiles
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nw = 16 * warp;   // the warp's 16 columns of the block's 128
  const int K = a.K, N = a.N, E = a.E;
  const int ntn = (N + kTileN - 1) / kTileN;

  for (int e = tid; e <= E; e += kThreads) s_off[e] = a.offsets[e];
  __syncthreads();
  if (tid == 0) {
    int tiles = 0;
    for (int e = 0; e < E; ++e) {
      s_tile[e] = tiles;
      tiles += (s_off[e + 1] - s_off[e] + kTileM - 1) / kTileM;
    }
    s_tile[E] = tiles;
  }
  __syncthreads();
  const int items = s_tile[E] * ntn;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    // blocks side by side share an m-tile, so its x rows come from L2
    const int mt = item / ntn, n0 = (item % ntn) * kTileN;
    int e = 0;
    while (s_tile[e + 1] <= mt) ++e;
    const int r0 = s_off[e] + (mt - s_tile[e]) * kTileM;   // grouped row
    const int rend = s_off[e + 1];

    // this thread's x rows of the tile (rows tid / 8 + 32 i), null past
    // the expert's last
    const float* xrow[kXChunks];
#pragma unroll
    for (int i = 0; i < kXChunks; ++i) {
      const int r = r0 + (tid >> 3) + 32 * i;
      xrow[i] = r < rend
                    ? a.x + (size_t)(a.rows ? a.rows[r] : r) * K
                    : nullptr;
    }

    float acc[64];
    repro::tf32x3::mainloop(
        smem, a.w + (size_t)e * K * N, K, N, n0,
        [&](int i, int, int k, const float*& src, bool& ok) {
          ok = xrow[i] != nullptr && k < K;
          src = ok ? xrow[i] + k : a.x;
        },
        acc);

    // acc[4j + q]: out^T row (column of out) nw + g + 8 (q >> 1), column
    // (grouped row) 8j + 2t + (q & 1)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * j + 2 * t + h;
        if (r >= rend) continue;
        float* dst;
        float s = 1.f;
        if (a.scatter) {
          dst = a.out + (size_t)a.scatter[r] * N;
          s = a.scale[r];
        } else {
          dst = a.out + (size_t)r * N;
        }
#pragma unroll
        for (int q2 = 0; q2 < 2; ++q2) {
          const int n = n0 + nw + g + 8 * q2;
          if (n >= N) continue;
          const float v = acc[4 * j + 2 * q2 + h];
          if (a.scatter)
            atomicAdd(dst + n, s * v);
          else
            dst[n] = v;
        }
      }
    }
    // every warpgroup's wgmmas and reads of this tile are done before the
    // next tile's prologue refills the rings
    __syncthreads();
  }
}

struct Device {
  int sms = 0;
  bool raised = false;
};

// The device's multiprocessors, and the kernel's dynamic shared-memory
// limit and carveout raised, once per device.
int prepare(int* sms) {
  static Device devices[64];
  static std::atomic<int> lock{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  Device& d = devices[dev & 63];
  if (!d.raised) {
    while (lock.exchange(1)) {
    }
    if (!d.raised) {
      err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            gemm_tf32x3_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kSmem);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            gemm_tf32x3_grouped_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      if (err == cudaSuccess) d.raised = true;
    }
    lock.store(0);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = d.sms;
  return 0;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x (R, K), w (E, K, N), f32, rows contiguous; K and N multiples of 4, x and
// w 16-byte aligned; offsets (E + 1,) int32 non-decreasing, offsets[E] <= A;
// rows, scatter (A,) int32 or null; scale (A,) f32 where scatter is given;
// out (A, N), or with scatter the destination rows.
extern "C" int repro_gemm_tf32x3_grouped(const void* x, const void* w,
                                         void* out, const void* offsets,
                                         const void* rows,
                                         const void* scatter,
                                         const void* scale, int E, int A,
                                         int K, int N, void* stream) {
  if (E <= 0 || E > kMaxExperts || A < 0 || K < 0 || N < 0 || K % 4 ||
      N % 4 || !aligned16(x) || !aligned16(w) || (scatter && !scale))
    return (int)cudaErrorInvalidValue;
  if (A == 0 || N == 0) return 0;
  int sms = 0;
  const int err = prepare(&sms);
  if (err) return err;
  // at most ceil(A / 128) + E m-tiles, whatever the offsets
  const long long bound =
      ((long long)(A + kTileM - 1) / kTileM + E) * ((N + kTileN - 1) / kTileN);
  const int grid = (int)(bound < sms ? bound : sms);
  Args args{static_cast<const float*>(x),   static_cast<const float*>(w),
            static_cast<float*>(out),       static_cast<const int*>(offsets),
            static_cast<const int*>(rows),  static_cast<const int*>(scatter),
            static_cast<const float*>(scale), E, K, N};
  gemm_tf32x3_grouped_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      args);
  return (int)cudaGetLastError();
}
