// FAST-9/16 corner score + 3x3 non-max suppression, fused, for sm_90a.
//
// Replaces: stereo_visual_slam_tpu/ops/pallas/fast_kernel.py,
//           fast_nms_score_map (kernel _fast_nms_kernel).
// Semantics: stereo_visual_slam_tpu/ops/fast.py nms_3x3(fast_score_map(img))
//   - circle pixels outside the image read as 0,
//   - a pixel's score is the best 9-contiguous-arc strength above the
//     threshold (bright or dark), else 0,
//   - NMS keeps a pixel that is >= its later raster neighbours and > its
//     earlier ones; neighbours outside the image count as -inf.
// Every step is a subtraction, compare, min or max of exact floats, so the
// output is bit-identical to the plain torch version.
//
// What bounds it on the H100: memory traffic and latency, not arithmetic.
// The input is the B stacked frames of one pyramid level, (B*H, W) f32
// (12.6 MB at level 0 for B=8); the plain version materialises 16 shifted
// copies plus two (25, H, W) stacks of it. Design: one thread per output
// pixel in a 32x8 block; the block stages its (8+8)x(32+8) halo tile in
// shared memory once (coalesced rows), computes the arc score on the
// (8+2)x(32+2) ring the NMS needs into shared memory, and writes one score
// per pixel. HBM traffic is one image read (plus the halo) and one write.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TW = 32;            // output tile width  (one warp per row)
constexpr int TH = 8;             // output tile height
constexpr int HALO = 4;           // 3 px circle radius + 1 px NMS ring
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int CW = TW + 2;        // score ring width
constexpr int CH = TH + 2;        // score ring height

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void __launch_bounds__(TW * TH)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, float threshold) {
  __shared__ float tile[SH][SW];
  __shared__ float score[CH][CW];
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;
  const int tid = threadIdx.y * TW + threadIdx.x;

  for (int i = tid; i < SH * SW; i += TW * TH) {
    const int ty = i / SW, tx = i % SW;
    const int gy = r0 - HALO + ty, gx = c0 - HALO + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? img[(size_t)gy * W + gx] : 0.0f;
  }
  __syncthreads();

  for (int i = tid; i < CH * CW; i += TW * TH) {
    const int sy = i / CW, sx = i % CW;
    const int gy = r0 - 1 + sy, gx = c0 - 1 + sx;
    float s = -INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int ty = sy + HALO - 1, tx = sx + HALO - 1;
      const float c = tile[ty][tx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = tile[ty + kDy[k]][tx + kDx[k]] - c;
      // bright: max over arcs of the arc minimum; dark: min over arcs of the
      // arc maximum (its negation is the dark strength)
      float best_bright = -INFINITY, worst_dark = INFINITY;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mn = d[k], mx = d[k];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          mn = fminf(mn, d[(k + j) & 15]);
          mx = fmaxf(mx, d[(k + j) & 15]);
        }
        best_bright = fmaxf(best_bright, mn);
        worst_dark = fminf(worst_dark, mx);
      }
      const float sb = best_bright > threshold ? best_bright : 0.0f;
      const float sd = -worst_dark > threshold ? -worst_dark : 0.0f;
      s = fmaxf(sb, sd);
    }
    score[sy][sx] = s;
  }
  __syncthreads();

  const int oy = r0 + threadIdx.y, ox = c0 + threadIdx.x;
  if (oy >= H || ox >= W) return;
  const int cy = threadIdx.y + 1, cx = threadIdx.x + 1;
  const float s = score[cy][cx];
  bool keep = true;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float n = score[cy + dy][cx + dx];
      const bool later = dy > 0 || (dy == 0 && dx > 0);
      keep = keep && (later ? s >= n : s > n);
    }
  }
  out[(size_t)oy * W + ox] = keep ? s : 0.0f;
}

}  // namespace

extern "C" int svs_fast_nms(const float* img, float* out, int H, int W,
                            float threshold, void* stream) {
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, H, W, threshold);
  return (int)cudaGetLastError();
}
