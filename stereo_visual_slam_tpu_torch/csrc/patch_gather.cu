// Per-keypoint patch gather feeding BRIEF, for sm_90a.
//
// Replaces: stereo_visual_slam_tpu/ops/pallas/patch_kernel.py,
//           gather_patches_aligned (kernel _kernel).
// Semantics: the P x P window (P = 33 in production) whose top-left is
//   clip(y - P/2, 0, H - P), clip(x - P/2, 0, W - P); with frame_h > 0 the
//   image is a vertical stack of frames of that height and the row clamp is
//   done inside the keypoint's own frame (its frame index is clamped to the
//   stack, so no read ever leaves the image). Exact copies of the f32 image
//   values: bit-identical to the plain torch indexing gather.
//
// What bounds it on the H100: it is a pure copy (4.4 KB per keypoint,
// ~16k keypoints per chunk), bound by memory latency and by the scattered
// rows of each window. Design: one block per keypoint, its 32x8 threads
// walk the window row by row, so each warp reads one contiguous 32-float
// run of an image row and writes one contiguous run of the output patch.
// The Pallas kernel's 8-row shift selects and lane rolls exist for the TPU
// tiling and have no counterpart here.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(256)
gather_patches_kernel(const float* __restrict__ img, const int* __restrict__ yx,
                      float* __restrict__ out, int H, int W, int frame_h, int P) {
  const int n = blockIdx.x;
  const int r = P / 2;
  const int y = yx[2 * n], x = yx[2 * n + 1];
  int y0;
  if (frame_h > 0) {
    const int b = clampi(floor_div(y, frame_h), 0, H / frame_h - 1);
    y0 = clampi(y - b * frame_h - r, 0, frame_h - P) + b * frame_h;
  } else {
    y0 = clampi(y - r, 0, H - P);
  }
  const int x0 = clampi(x - r, 0, W - P);
  float* dst = out + (size_t)n * P * P;
  for (int i = threadIdx.y; i < P; i += blockDim.y) {
    const float* src = img + (size_t)(y0 + i) * W + x0;
    for (int j = threadIdx.x; j < P; j += blockDim.x) dst[i * P + j] = src[j];
  }
}

}  // namespace

extern "C" int svs_gather_patches(const float* img, const int* yx, float* out,
                                  int n, int H, int W, int frame_h, int P,
                                  void* stream) {
  const dim3 block(32, 8);
  gather_patches_kernel<<<n, block, 0, (cudaStream_t)stream>>>(
      img, yx, out, H, W, frame_h, P);
  return (int)cudaGetLastError();
}
