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
// What bounds it on the H100: per keypoint it needs a p x p left patch and
// a p x (p + D - 1) right strip (~5 KB at p = 11, D = 96) and does ~3 D p^2
// flops; the plain version materialises an (N, D, p, p) window tensor
// (95 MB at N = 2048). Design: one block per keypoint with one thread per
// disparity; the block stages the patch and the strip in shared memory
// once, normalises the patch with a block reduction, and each thread then
// computes its window's mean, norm and dot product from shared memory.
// Nothing but the (N, D) scores reaches device memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Sum of v over the block (blockDim.x a multiple of 32); every thread gets it.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float t = 0.0f;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) t += red[w];
  return t;
}

__global__ void zncc_kernel(const float* __restrict__ left,
                            const float* __restrict__ right,
                            const int* __restrict__ yx, float* __restrict__ out,
                            int H, int W, int P, int D) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int PP = P * P;
  const int SW = P + D - 1;
  float* lp = smem;          // (P, P) left patch
  float* strip = smem + PP;  // (P, SW) right strip
  const int n = blockIdx.x;
  const int r = P / 2;
  const int y = clampi(yx[2 * n], 0, H - 1);
  const int x = clampi(yx[2 * n + 1], 0, W - 1);
  const float eps = 1e-6f;

  for (int k = threadIdx.x; k < PP; k += blockDim.x) {
    const int gy = y + k / P - r, gx = x + k % P - r;
    lp[k] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? left[(size_t)gy * W + gx] : 0.0f;
  }
  // strip column c holds right-image column x + 1 + c - D - r
  for (int k = threadIdx.x; k < P * SW; k += blockDim.x) {
    const int gy = y + k / SW - r, gx = x + 1 + k % SW - D - r;
    strip[k] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? right[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  float acc = 0.0f;
  for (int k = threadIdx.x; k < PP; k += blockDim.x) acc += lp[k];
  const float mean = block_sum(acc, red) / (float)PP;
  acc = 0.0f;
  for (int k = threadIdx.x; k < PP; k += blockDim.x) {
    const float m = lp[k] - mean;
    lp[k] = m;
    acc += m * m;
  }
  const float inv = 1.0f / (sqrtf(block_sum(acc, red)) + eps);
  for (int k = threadIdx.x; k < PP; k += blockDim.x) lp[k] *= inv;
  __syncthreads();

  const int d = threadIdx.x;
  if (d >= D) return;
  const int t = D - 1 - d;  // window start column in the strip
  float s = 0.0f;
  for (int i = 0; i < P; ++i)
    for (int j = 0; j < P; ++j) s += strip[i * SW + t + j];
  const float wmean = s / (float)PP;
  float ss = 0.0f, dot = 0.0f;
  for (int i = 0; i < P; ++i) {
    for (int j = 0; j < P; ++j) {
      const float w = strip[i * SW + t + j] - wmean;
      ss += w * w;
      dot += lp[i * P + j] * w;
    }
  }
  out[(size_t)n * D + d] = dot / (sqrtf(ss) + eps);
}

}  // namespace

extern "C" int svs_zncc_sweep(const float* left, const float* right, const int* yx,
                              float* out, int n, int H, int W, int P, int D,
                              void* stream) {
  const int threads = ((D + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)(P * P + P * (P + D - 1));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        zncc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  zncc_kernel<<<n, threads, smem, (cudaStream_t)stream>>>(left, right, yx, out, H, W, P, D);
  return (int)cudaGetLastError();
}
