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
// output is bit-identical to the plain torch version in any order.
//
// The bound on the H100: 8 bytes per pixel (one image read, one score
// write: 9.4 us for the (8*384, 1280) level-0 stack at 3.35 TB/s) and, for
// a pixel that is scored in full, ~195 operations (16 differences, the
// 2 x 64 min/max of the doubling network, 30 to reduce over the 16 arcs,
// the threshold selects and 8 NMS compares).
//
// Design:
//  - 128 x 16 output tiles, 256 threads; 128 x 8 on a level too small to
//    give every SM four blocks of 128 x 16 (the coarse pyramid levels), so
//    that more blocks share the latency. (128 x 32 tiles were slower at
//    every level: at 61 registers against 40, a third fewer warps fit an
//    SM.) The block stages its
//    (TH+8) x (128+8) halo tile in shared memory once: 16-byte loads where
//    the rows allow them (W a multiple of 4, so that each 4-float group is
//    wholly inside or wholly outside the image), all of a thread's loads in
//    flight before its first store. The halo read is 1.6x the tile at
//    128 x 16, against 2.5x for the 32 x 8 tiles of the first version.
//  - An exact early reject. A 9-arc of the 16 circle pixels always covers
//    at least two of the compass pixels 0, 4, 8 and 12 (they are 4 apart).
//    The bright score needs all 9 differences of an arc above the
//    threshold, so a pixel with fewer than two compass differences above
//    it has no bright arc; likewise for dark (below -threshold). Such a
//    pixel scores exactly 0, as in the plain version. Only the others
//    (candidates) get the full arc evaluation.
//  - Candidates are compacted per block into a list that all 256 threads
//    then share, so a thread never waits on a neighbour's candidates. Each
//    thread tests its TH / 2 + 1 (or + 2) ring positions into a bit mask
//    with no barrier between the tests; each warp then packs its
//    candidates into its own segment of the list with warp ballots,
//    without atomics.
//  - Arc minimum and maximum by the TPU kernel's doubling network: the
//    min (max) over the 9-arc starting at k is built from pairs, quads and
//    octets: 64 + 64 operations per pixel instead of 2 x 128.
//  - NMS with vertical register blocking: each thread writes TH / 2
//    vertically adjacent outputs and slides a 3 x 3 window of scores down
//    its column, 3 shared loads per output instead of 9.
//  - No per-element division or modulo: loops walk rows and columns.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;            // output tile width
constexpr int NTX = 128;           // threads along x
constexpr int NTY = 2;             // threads along y
constexpr int NT = NTX * NTY;
constexpr int NWARP = NT / 32;
constexpr int HALO = 4;            // 3 px circle radius + 1 px NMS ring
constexpr int SW = TW + 2 * HALO;  // 136
constexpr int CW = TW + 2;         // score ring width, 130

// The shapes that follow from the tile height TH.
template <int TH>
struct Tile {
  static constexpr int SH = TH + 2 * HALO;        // halo tile height
  static constexpr int CH = TH + 2;               // score ring height
  static constexpr int RPT = TH / NTY;            // output rows per thread in the NMS pass
  static constexpr int RPW = SH / NWARP;          // halo rows per warp
  static constexpr int RING_BITS = CH / NTY + 1;  // ring rows per thread + 1 of the last 2 columns
  static constexpr int SEG = RING_BITS * 32;      // candidate slots per warp
  static_assert(CW < 256 && CH < 256, "candidate codes pack (row, col) in 8 bits each");
  static_assert(SW % 4 == 0 && SH % NWARP == 0, "halo rows are float4 rows, whole rows per warp");
  static_assert(CH % NTY == 0 && 2 * CH <= 3 * 32, "the last two ring columns fit in three warps");
  static_assert(RING_BITS <= 32, "one bit per ring position in a 32-bit mask");

  float4 tile4[SH][SW / 4];        // the halo tile, rows of SW floats
  float score[CH][CW];             // score ring: scores of the tile and its 1 px ring
  uint16_t cand[NWARP * SEG];      // candidate codes (row << 8 | col), a segment per warp
  int count[NWARP];                // candidates in each warp's segment
};

template <int TH>
__device__ __forceinline__ float tile_at(const Tile<TH>& s, int y, int x) {
  return reinterpret_cast<const float*>(s.tile4[y])[x];
}

// Ring position of bit k of thread (tx, ty): rows ty, ty + 2, ... of column
// tx for k < RING_BITS - 1; for the last bit, position tid < 2 * CH of the
// last two columns.
template <int TH>
__device__ __forceinline__ void ring_pos(int k, int tx, int ty, int tid, int& sy, int& sx) {
  if (k < Tile<TH>::RING_BITS - 1) {
    sy = ty + k * NTY;
    sx = tx;
  } else {
    sy = tid >> 1;
    sx = TW + (tid & 1);
  }
}

// Score-ring position (sy, sx): write -inf outside the image, else 0, and
// report whether the compass test leaves it a candidate.
template <int TH>
__device__ __forceinline__ bool classify(Tile<TH>& s, int sy, int sx, int r0, int c0,
                                         int H, int W, float thr) {
  const int gy = r0 - 1 + sy, gx = c0 - 1 + sx;
  if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
    s.score[sy][sx] = -INFINITY;
    return false;
  }
  s.score[sy][sx] = 0.0f;
  const int ty = sy + HALO - 1, tx = sx + HALO - 1;
  const float c = tile_at<TH>(s, ty, tx);
  const float d0 = tile_at(s, ty - 3, tx) - c;
  const float d4 = tile_at(s, ty, tx + 3) - c;
  const float d8 = tile_at(s, ty + 3, tx) - c;
  const float d12 = tile_at(s, ty, tx - 3) - c;
  const int nb = (d0 > thr) + (d4 > thr) + (d8 > thr) + (d12 > thr);
  const int nd = (-d0 > thr) + (-d4 > thr) + (-d8 > thr) + (-d12 > thr);
  return nb >= 2 || nd >= 2;
}

// The FAST-9/16 score of the pixel at halo-tile position (ty, tx).
template <int TH>
__device__ __forceinline__ float arc_score(const Tile<TH>& s, int ty, int tx, float thr) {
  const float c = tile_at(s, ty, tx);
  // circle in circular order (ops/fast.py CIRCLE_OFFSETS)
  float d[16];
  d[0] = tile_at(s, ty - 3, tx) - c;
  d[1] = tile_at(s, ty - 3, tx + 1) - c;
  d[2] = tile_at(s, ty - 2, tx + 2) - c;
  d[3] = tile_at(s, ty - 1, tx + 3) - c;
  d[4] = tile_at(s, ty, tx + 3) - c;
  d[5] = tile_at(s, ty + 1, tx + 3) - c;
  d[6] = tile_at(s, ty + 2, tx + 2) - c;
  d[7] = tile_at(s, ty + 3, tx + 1) - c;
  d[8] = tile_at(s, ty + 3, tx) - c;
  d[9] = tile_at(s, ty + 3, tx - 1) - c;
  d[10] = tile_at(s, ty + 2, tx - 2) - c;
  d[11] = tile_at(s, ty + 1, tx - 3) - c;
  d[12] = tile_at(s, ty, tx - 3) - c;
  d[13] = tile_at(s, ty - 1, tx - 3) - c;
  d[14] = tile_at(s, ty - 2, tx - 2) - c;
  d[15] = tile_at(s, ty - 3, tx - 1) - c;

  // min9_k = min(d_k .. d_{k+8}) as min(octet_k, d_{k+8}); max9 likewise
  float n2[16], x2[16], n4[16], x4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    n2[k] = fminf(d[k], d[(k + 1) & 15]);
    x2[k] = fmaxf(d[k], d[(k + 1) & 15]);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    n4[k] = fminf(n2[k], n2[(k + 2) & 15]);
    x4[k] = fmaxf(x2[k], x2[(k + 2) & 15]);
  }
  float best_bright = -INFINITY, worst_dark = INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float n8 = fminf(n4[k], n4[(k + 4) & 15]);
    const float x8 = fmaxf(x4[k], x4[(k + 4) & 15]);
    best_bright = fmaxf(best_bright, fminf(n8, d[(k + 8) & 15]));
    worst_dark = fminf(worst_dark, fmaxf(x8, d[(k + 8) & 15]));
  }
  const float sb = best_bright > thr ? best_bright : 0.0f;
  const float sd = -worst_dark > thr ? -worst_dark : 0.0f;
  return fmaxf(sb, sd);
}

// Stage halo rows warp, warp + NWARP, ... of the tile at (r0 - 4, c0 - 4).
template <bool VEC, int TH>
__device__ __forceinline__ void stage_halo(Tile<TH>& s, const float* __restrict__ img,
                                           int H, int W, int r0, int c0, int warp, int lane) {
  constexpr int RPW = Tile<TH>::RPW;
  if (VEC) {
    constexpr int Q = SW / 4, JQ = (Q + 31) / 32;
    float4 v[RPW][JQ];
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int gy = r0 - HALO + warp + k * NWARP;
      const bool row_in = gy >= 0 && gy < H;
      const float* row = img + (size_t)(row_in ? gy : 0) * W;
#pragma unroll
      for (int j = 0; j < JQ; ++j) {
        const int gx = c0 - HALO + 4 * (lane + 32 * j);
        v[k][j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (lane + 32 * j < Q && row_in && gx >= 0 && gx < W)
          v[k][j] = *reinterpret_cast<const float4*>(row + gx);
      }
    }
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int j = 0; j < JQ; ++j)
        if (lane + 32 * j < Q) s.tile4[warp + k * NWARP][lane + 32 * j] = v[k][j];
  } else {
    constexpr int JX = (SW + 31) / 32;
    float v[RPW][JX];
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int gy = r0 - HALO + warp + k * NWARP;
      const bool row_in = gy >= 0 && gy < H;
      const float* row = img + (size_t)(row_in ? gy : 0) * W;
#pragma unroll
      for (int j = 0; j < JX; ++j) {
        const int gx = c0 - HALO + lane + 32 * j;
        v[k][j] = (lane + 32 * j < SW && row_in && gx >= 0 && gx < W) ? row[gx] : 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < RPW; ++k)
#pragma unroll
      for (int j = 0; j < JX; ++j)
        if (lane + 32 * j < SW)
          reinterpret_cast<float*>(s.tile4[warp + k * NWARP])[lane + 32 * j] = v[k][j];
  }
}

template <bool VEC, int TH>
__global__ void __launch_bounds__(NT)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, float thr) {
  using T = Tile<TH>;
  constexpr int CH = T::CH, RING_BITS = T::RING_BITS, SEG = T::SEG, RPT = T::RPT;
  __shared__ T s;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * NTX + tx;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * TH;
  const int c0 = blockIdx.x * TW;

  // 1. the halo tile; outside the image reads 0
  stage_halo<VEC, TH>(s, img, H, W, r0, c0, warp, lane);
  __syncthreads();

  // 2. compass test of this thread's ring positions into a bit mask; then
  //    each warp packs its candidates into its own segment
  unsigned mask = 0u;
#pragma unroll
  for (int k = 0; k < RING_BITS; ++k) {
    int sy, sx;
    ring_pos<TH>(k, tx, ty, tid, sy, sx);
    const bool mine = k < RING_BITS - 1 || tid < 2 * CH;
    if (mine && classify<TH>(s, sy, sx, r0, c0, H, W, thr)) mask |= 1u << k;
  }
  uint16_t* seg = s.cand + warp * SEG;
  int count = 0;  // the same in every lane
#pragma unroll
  for (int k = 0; k < RING_BITS; ++k) {
    const bool pass = (mask >> k) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, pass);
    if (pass) {
      int sy, sx;
      ring_pos<TH>(k, tx, ty, tid, sy, sx);
      seg[count + __popc(m & ((1u << lane) - 1u))] = (uint16_t)((sy << 8) | sx);
    }
    count += __popc(m);
  }
  if (lane == 0) s.count[warp] = count;
  __syncthreads();

  // 3. full arc score of the candidates, shared evenly by the block:
  //    candidate k is entry k - start[w] of the segment w it falls in
  int start[NWARP + 1];
  start[0] = 0;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) start[w + 1] = start[w] + s.count[w];
  for (int k = tid; k < start[NWARP]; k += NT) {
    int w = 0, first = 0;  // selected with constant indices: start stays in registers
#pragma unroll
    for (int i = 1; i < NWARP; ++i)
      if (k >= start[i]) {
        w = i;
        first = start[i];
      }
    const int code = s.cand[w * SEG + k - first];
    const int sy = code >> 8, sx = code & 255;
    s.score[sy][sx] = arc_score<TH>(s, sy + HALO - 1, sx + HALO - 1, thr);
  }
  __syncthreads();

  // 4. NMS: column tx, output rows ty*RPT .. ty*RPT + RPT - 1, a 3 x 3
  //    window sliding down (a: row above, b: this row, e: row below)
  const int ox = c0 + tx;
  const int cx = tx + 1;
  const int y0 = ty * RPT;  // score ring row of the row above the first output
  float a0 = s.score[y0][cx - 1], a1 = s.score[y0][cx], a2 = s.score[y0][cx + 1];
  float b0 = s.score[y0 + 1][cx - 1], b1 = s.score[y0 + 1][cx], b2 = s.score[y0 + 1][cx + 1];
#pragma unroll 4
  for (int i = 0; i < RPT; ++i) {
    const int yc = y0 + i + 2;
    const float e0 = s.score[yc][cx - 1], e1 = s.score[yc][cx], e2 = s.score[yc][cx + 1];
    const float v = b1;
    const bool keep = v > a0 && v > a1 && v > a2 && v > b0 && v >= b2 &&
                      v >= e0 && v >= e1 && v >= e2;
    const int oy = r0 + y0 + i;
    if (oy < H && ox < W) out[(size_t)oy * W + ox] = keep ? v : 0.0f;
    a0 = b0; a1 = b1; a2 = b2;
    b0 = e0; b1 = e1; b2 = e2;
  }
}


template <int TH>
void launch(const float* img, float* out, int H, int W, float thr, bool vec, cudaStream_t st) {
  const dim3 block(NTX, NTY);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  if (vec)
    fast_nms_kernel<true, TH><<<grid, block, 0, st>>>(img, out, H, W, thr);
  else
    fast_nms_kernel<false, TH><<<grid, block, 0, st>>>(img, out, H, W, thr);
}

}  // namespace

extern "C" int svs_fast_nms(const float* img, float* out, int H, int W,
                            float threshold, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  // 128 x 16 tiles, unless they give fewer than four blocks per SM
  const long cols = (W + TW - 1) / TW;
  if (cols * ((H + 15) / 16) >= 4L * sms)
    launch<16>(img, out, H, W, threshold, vec, st);
  else
    launch<8>(img, out, H, W, threshold, vec, st);
  return (int)cudaGetLastError();
}
