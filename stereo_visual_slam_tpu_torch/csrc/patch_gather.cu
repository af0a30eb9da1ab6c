// Per-keypoint patch gather feeding BRIEF, every pyramid level in one
// launch, for sm_90a.
//
// Replaces: stereo_visual_slam_tpu/ops/pallas/patch_kernel.py,
//           gather_patches_aligned (kernel _kernel), called once per level.
// Semantics: the P x P window (P = 33 in production) whose top-left is
//   clip(y - P/2, 0, H - P), clip(x - P/2, 0, W - P); with frame_h > 0 the
//   image is a vertical stack of frames of that height and the row clamp is
//   done inside the keypoint's own frame (its frame index is clamped to the
//   stack, so no read ever leaves the image). Exact copies of the f32 image
//   values: bit-identical to the plain torch indexing gather.
//
// What bounds it on the H100: it is a pure copy, 4,356 B out per keypoint
// at P = 33, 16,384 keypoints over the 8 levels of a chunk: 71 MB of
// patches and the 45 MB of level images they are cut from, ~35 us of HBM
// traffic. A copy that size is bound by the bytes it keeps in flight and by
// how evenly its blocks fill the card.
//
// Design (one launch for all levels): a by-value table of at most 8 level
// descriptors (image, keypoints, H, W, frame_h, index of the level's first
// keypoint in the output) needs no host-to-device copy. The output is one
// (sum N, P, P) tensor; a keypoint finds its level from the first indices.
// G = 8 consecutive keypoints a block: every thread issues all of its
// 4-byte cp.async copies of the G windows (flattened over the block: no
// idle lanes, ~34 copies a thread in flight at P = 33) into shared memory
// laid out as the output, waits once, then writes the G patches back as one
// contiguous run of 16-byte stores (G * P * P floats, 16-byte aligned as G
// is a multiple of 4). A window too large for G of them in shared memory
// takes fewer keypoints a block.
// The Pallas kernel's 8-row shift selects and lane rolls exist for the TPU
// tiling and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int G = 8;                   // keypoints a block, at most
constexpr int DEFAULT_SMEM = 48 * 1024;  // more needs the kernel's opt-in

struct Level {
  const float* img;
  const int* yx;  // (n, 2) of this level
  int H, W, frame_h;
  int first;      // index of the level's first keypoint in the output
};

struct Levels {
  Level lv[MAX_LEVELS];
  int n_levels;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Top-left of keypoint n's window, as a pointer into its level's image, and
// that image's row stride. The level is the last whose first index is <= n
// (an empty level shares its first index with the next); every index is a
// constant, so the table stays in the parameter space.
__device__ __forceinline__ const float* window(const Levels& L, int n, int P, int* stride) {
  Level d = L.lv[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < L.n_levels && n >= L.lv[i].first) d = L.lv[i];
  const int j = n - d.first;
  const int y = d.yx[2 * j], x = d.yx[2 * j + 1];
  const int r = P / 2;
  int y0;
  if (d.frame_h > 0) {
    const int b = clampi(floor_div(y, d.frame_h), 0, d.H / d.frame_h - 1);
    y0 = clampi(y - b * d.frame_h - r, 0, d.frame_h - P) + b * d.frame_h;
  } else {
    y0 = clampi(y - r, 0, d.H - P);
  }
  const int x0 = clampi(x - r, 0, d.W - P);
  *stride = d.W;
  return d.img + (size_t)y0 * d.W + x0;
}

__device__ __forceinline__ void cp_async4(float* dst_smem, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst_smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// Element e = (k * P + r) * P + c of a run of windows advanced by THREADS:
// (k, r, c) moves by a fixed (dk, dr, dc) and at most two carries, so the
// loops divide by P only once.
struct Walk {
  int k, r, c, dk, dr, dc;
  __device__ Walk(int e, int P) {
    const int PP = P * P;
    k = e / PP; r = (e - k * PP) / P; c = e - k * PP - r * P;
    dk = THREADS / PP; dr = (THREADS - dk * PP) / P; dc = THREADS - dk * PP - dr * P;
  }
  __device__ __forceinline__ void next(int P) {
    c += dc; r += dr; k += dk;
    if (c >= P) { c -= P; ++r; }
    if (r >= P) { r -= P; ++k; }
  }
};

__global__ void __launch_bounds__(THREADS)
gather_patches_kernel(const Levels L, int n_total, int P, int g, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // (g, P, P), as the output
  __shared__ const float* base[G];
  __shared__ int stride[G];
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * g;
  const int cnt = min(g, n_total - g0);
  if (t < cnt) base[t] = window(L, g0 + t, P, &stride[t]);
  __syncthreads();

  const int total = cnt * P * P;
  Walk w(t, P);
  for (int e = t; e < total; e += THREADS, w.next(P))
    cp_async4(tile + e, base[w.k] + (size_t)w.r * stride[w.k] + w.c);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float* dst = out + (size_t)g0 * P * P;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int i = t; i < total / 4; i += THREADS) dst4[i] = smem4[i];
    done = total / 4 * 4;
  }
  for (int i = done + t; i < total; i += THREADS) dst[i] = tile[i];
}

int launch(const Levels& L, int n_total, int P, float* out, cudaStream_t st) {
  if (n_total <= 0) return (int)cudaGetLastError();
  const size_t tile_bytes = (size_t)P * P * sizeof(float);
  int g = G;
  size_t smem = g * tile_bytes;
  if (smem > DEFAULT_SMEM) {
    int dev, most;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    most -= (int)(G * (sizeof(const float*) + sizeof(int)));  // base[], stride[]
    g = (int)std::min((size_t)G, (size_t)std::max(most, 0) / tile_bytes);
    if (g < 1) return (int)cudaErrorInvalidValue;
    smem = g * tile_bytes;
    const cudaError_t err = cudaFuncSetAttribute(
        gather_patches_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gather_patches_kernel<<<(n_total + g - 1) / g, THREADS, smem, st>>>(L, n_total, P, g, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Every level in one launch. imgs and yxs: n_levels device pointers (as
// int64) of each level's (H, W) f32 image and (n, 2) int32 keypoints; dims:
// n_levels rows of (H, W, frame_h, n), frame_h 0 for an unstacked image.
// out: (sum n, P, P) f32, level by level.
extern "C" int svs_gather_patches_levels(const int64_t* imgs, const int64_t* yxs,
                                         const int* dims, int n_levels, float* out,
                                         int P, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels L = {};
  L.n_levels = n_levels;
  int first = 0;
  for (int i = 0; i < n_levels; ++i) {
    const int* d = dims + 4 * i;
    L.lv[i] = Level{reinterpret_cast<const float*>(imgs[i]),
                    reinterpret_cast<const int*>(yxs[i]), d[0], d[1], d[2], first};
    first += d[3];
  }
  return launch(L, first, P, out, (cudaStream_t)stream);
}

// One level: the same kernel with a table of one.
extern "C" int svs_gather_patches(const float* img, const int* yx, float* out,
                                  int n, int H, int W, int frame_h, int P,
                                  void* stream) {
  Levels L = {};
  L.n_levels = 1;
  L.lv[0] = Level{img, yx, H, W, frame_h, 0};
  return launch(L, n, P, out, (cudaStream_t)stream);
}
