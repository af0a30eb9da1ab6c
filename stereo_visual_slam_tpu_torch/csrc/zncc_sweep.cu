// Per-keypoint epipolar ZNCC sweep, for sm_90a.
//
// Replaces: stereo_visual_slam_tpu/ops/pallas/stereo_kernel.py,
//           zncc_sweep (kernel _kernel).
// Semantics: stereo_visual_slam_tpu/ops/stereo.py zncc_sweep_xla, eps
//   placement included: for keypoint (y, x) (clamped to the image) the
//   zero-mean left patch is normalised by (sqrt(sum sq) + eps), each right
//   window centred at (y, x - d), d = 0..D-1, likewise, and the score is
//   their dot product. Pixels outside either image read as 0.
//   Only the summation order differs from the plain version (atol 2e-5).
//
// The bound on the H100: per keypoint a p x p left patch and a
// p x (p + D - 1) right strip (~5 KB at p = 11, D = 96), ~5 D p^2 flops
// (a window's difference from its mean, its square sum and its product
// with the patch): 119 MFLOP for 2,048 keypoints, 1.8 us at 67 TFLOP/s.
// At that size launch latency and the last wave's tail set the floor.
//
// Design:
//  - One warp per keypoint, 8 keypoints per block, no block-wide barrier:
//    the warp stages its patch and strip in its own slice of shared memory
//    and normalises the patch with warp shuffles.
//  - The strip is loaded row by row: p rows of p + D - 1 contiguous floats,
//    coalesced, with no per-element division or modulo, every load of a
//    lane issued before the first is used (one memory latency, not p).
//  - Register tiling along the row: lane l owns K = ceil(D / 32) adjacent
//    disparities (3 at D = 96), whose windows start at adjacent strip
//    columns. Per strip row it holds p + K - 1 strip values in registers,
//    so each shared-memory value feeds K windows, and the patch row is a
//    broadcast read.
//  - Window means from box sums: column sums of the strip over the p rows,
//    from the registers the strip was loaded into, then p of them per
//    window.
//  - Window square sums stay two-pass (sum of (w - mean)^2), as in the
//    plain version: the one-pass form S2 - S1^2 / p^2 cancels in f32 (S2
//    reaches 8e6 on 8-bit images) and misses atol 2e-5 on low-texture
//    windows next to an edge. The patch sums to 0 only up to rounding, so
//    the window mean is subtracted in the dot product too.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;  // keypoints per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared floats per warp: the patch (P*P), the strip (P rows of SW) and its
// column sums (SW), with SW = P + D - 1 + (K - 1): K - 1 zero columns on
// the left let the lane of the last disparities read whole register tiles.
__host__ __device__ constexpr int strip_width(int P, int D, int K) { return P + D - 1 + K - 1; }
__host__ __device__ constexpr int warp_floats(int P, int D, int K) {
  return P * P + (P + 1) * strip_width(P, D, K);
}

template <int P, int K>
__global__ void __launch_bounds__(32 * WARPS)
zncc_kernel(const float* __restrict__ left, const float* __restrict__ right,
            const int* __restrict__ yx, float* __restrict__ out,
            int N, int H, int W, int D) {
  extern __shared__ float smem[];
  constexpr int PP = P * P;
  constexpr int R = P / 2;
  constexpr int KT = P + K - 1;  // strip values a lane holds per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;  // whole warps; nothing below syncs the block
  const int SW = strip_width(P, D, K);
  float* lp = smem + warp * warp_floats(P, D, K);  // (P, P) left patch
  float* strip = lp + PP;                          // (P, SW) right strip
  float* colsum = strip + P * SW;                  // (SW,)
  const int y = clampi(yx[2 * n], 0, H - 1);
  const int x = clampi(yx[2 * n + 1], 0, W - 1);
  const float eps = 1e-6f;

  // strip column c holds right-image column x + 1 + c - (K - 1) - D - R.
  // Lane l loads columns l, l + 32, ... of every strip row and column l of
  // every patch row, all loads in flight before the first store.
  constexpr int JMAX = (P + 32 * K + K - 2 + 31) / 32;  // strip columns per lane
  const int sx0 = x + 1 - (K - 1) - D - R;
  float rv[P][JMAX], lv[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int gy = y + i - R;
    const bool row_in = gy >= 0 && gy < H;
    const size_t row = (size_t)(row_in ? gy : 0) * W;
    const int gxl = x + lane - R;
    lv[i] = (lane < P && row_in && gxl >= 0 && gxl < W) ? left[row + gxl] : 0.0f;
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int c = lane + 32 * j, gx = sx0 + c;
      rv[i][j] = (c < SW && c >= K - 1 && row_in && gx >= 0 && gx < W) ? right[row + gx] : 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < JMAX; ++j) {
    const int c = lane + 32 * j;
    if (c < SW) {
      float cs = 0.0f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        strip[i * SW + c] = rv[i][j];
        cs += rv[i][j];
      }
      colsum[c] = cs;
    }
  }

  // normalise the patch: (lp - mean) / (sqrt(sum sq) + eps); lanes >= P
  // hold zeros and add nothing
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) acc += lv[i];
  const float mean = warp_sum(acc) / (float)PP;
  acc = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float m = lv[i] - mean;
    acc += lane < P ? m * m : 0.0f;
  }
  const float nrm = sqrtf(warp_sum(acc)) + eps;
  if (lane < P) {
#pragma unroll
    for (int i = 0; i < P; ++i) lp[i * P + lane] = (lv[i] - mean) / nrm;
  }
  __syncwarp();

  // lane's disparities d = lane*K + K-1-q, q = 0..K-1, start at strip
  // column (padded) base + q, base = D - 1 - (lane*K + K-1) + (K - 1)
  if (lane * K >= D) return;
  const int base = D - 1 - lane * K;
  float wmean[K], ss[K], dot[K];
  {
    float cs[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) cs[j] = colsum[base + j];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < P; ++j) s += cs[q + j];
      wmean[q] = s / (float)PP;
      ss[q] = 0.0f;
      dot[q] = 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float sv[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) sv[j] = strip[i * SW + base + j];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float l = lp[i * P + j];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float w = sv[j + q] - wmean[q];
        ss[q] = fmaf(w, w, ss[q]);
        dot[q] = fmaf(l, w, dot[q]);
      }
    }
  }
  float* o = out + (size_t)n * D;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int d = lane * K + K - 1 - q;
    if (d < D) o[d] = dot[q] / (sqrtf(ss[q]) + eps);
  }
}

template <int P, int K>
int launch(const float* left, const float* right, const int* yx, float* out,
           int n, int H, int W, int D, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)WARPS * warp_floats(P, D, K);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        zncc_kernel<P, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (n + WARPS - 1) / WARPS;
  zncc_kernel<P, K><<<blocks, 32 * WARPS, smem, stream>>>(left, right, yx, out, n, H, W, D);
  return (int)cudaGetLastError();
}

template <int P>
int launch_k(const float* left, const float* right, const int* yx, float* out,
             int n, int H, int W, int D, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch<P, 1>(left, right, yx, out, n, H, W, D, stream);
    case 2: return launch<P, 2>(left, right, yx, out, n, H, W, D, stream);
    case 3: return launch<P, 3>(left, right, yx, out, n, H, W, D, stream);
    case 4: return launch<P, 4>(left, right, yx, out, n, H, W, D, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// P odd in 3..15 and 1 <= D <= 128 (the wrapper checks both).
extern "C" int svs_zncc_sweep(const float* left, const float* right, const int* yx,
                              float* out, int n, int H, int W, int P, int D,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (P) {
    case 3: return launch_k<3>(left, right, yx, out, n, H, W, D, s);
    case 5: return launch_k<5>(left, right, yx, out, n, H, W, D, s);
    case 7: return launch_k<7>(left, right, yx, out, n, H, W, D, s);
    case 9: return launch_k<9>(left, right, yx, out, n, H, W, D, s);
    case 11: return launch_k<11>(left, right, yx, out, n, H, W, D, s);
    case 13: return launch_k<13>(left, right, yx, out, n, H, W, D, s);
    case 15: return launch_k<15>(left, right, yx, out, n, H, W, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
