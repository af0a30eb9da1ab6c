// PnP-RANSAC and its robust refinement in two kernels, for sm_90a.
//
// Replaces: the ~5,700 tensor ops of tracking/pnp.solve_pnp_ransac_plain
//           (one CUDA graph of them a frame before), for CUDA inputs.
// Semantics: solve_pnp_ransac_plain, op for op:
//   - H minimal sets of S entries: the Gumbel top-S of each row over the
//     valid entries (invalid ones at -inf), value descending and the lowest
//     index first among equal values, -inf ties included (top_k_stable's
//     stable sort): integers, equal to the plain path's.
//   - each hypothesis starts at exp(twist_noise[h] * half[h] * spread *
//     rot_w) T_init and takes gn_hyp damped (1e-4) Gauss-Newton steps on
//     its S points (ba/residuals' Jacobian, depth_ok weights, the closed
//     6x6 solve of geom/linalg: 3x3-block Schur complement, adjugates);
//   - its score: the valid entries in front of the camera whose
//     reprojection error is under inlier_px;
//   - the winner (the first of the highest scores, as torch.argmax) takes
//     gn_ref Huber-weighted (1e-6) steps on its inlier set, then two Newton
//     steps of the polar decomposition; the final inlier set at that pose;
//     under 4 winning inliers the prior pose and an empty set.
//   The file builds with -fmad=false (ops/kernels/_build.SOURCE_FLAGS):
//   every product and sum rounds alone, as each tensor op rounds it, with
//   fmaf written where the plain path's ops fuse (addcmul, the products).
//   Each small sum and product follows the order of the kernel the plain
//   path runs on the card for it (read off torch 2.11 + cuBLAS on the H100
//   by comparing with every candidate order): last-axis sums of 3 as
//   (p0 + p2) + p1 and of 6 as ((p0 + p4) + p2) + ((p1 + p5) + p3); the
//   batched 3x3 and 4x4 products as fmaf chains over k, the unbatched ones
//   (the refinement's) and every matrix-vector product in pairs; the
//   hypotheses' normal equations as opt_einsum contracts them (JtJ an fmaf
//   chain over (point, row), Jtr a pairwise tree). So the minimal sets,
//   each hypothesis's pose and its score equal the plain path's. Only the
//   refinement's sums over all N points take another order (cuBLAS splits
//   k = 2N its own way): its pose moves by rounding, and a point on the
//   inlier_px line can flip.
//
// The bound: a few MFLOP a frame (128 x 10 GN steps on 4 points, a 128 x N
// score, 10 GN steps over N). Launch latency and the serial GN chains set
// the time, so the design is for latency: no tensor cores, one block a
// hypothesis, the 6x6 algebra in one thread's registers.
//
// Design:
//  - pnp_hypotheses_kernel: grid H, 128 threads. Each thread keeps a sorted
//    top-S of a strided slice of its row; warp shuffles merge the lanes'
//    lists and thread 0 the warps'. Thread 0 then runs the hypothesis's GN
//    chain; all threads score it over N, summed by shuffles and shared
//    memory. Writes the minimal set, T_hyp (4x4) and the score.
//  - pnp_refine_kernel: one block of 512 threads (N strided). The argmax,
//    the winner's inlier set (kept in the output mask, each entry read back
//    by the thread that wrote it), then per step each thread sums its
//    points' 21 JtJ and 6 Jtr terms, warp shuffles and one shared-memory
//    pass in a fixed order (a replay gives the same bits), thread 0 solves
//    and updates the pose in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float MIN_Z = 1e-3f;
constexpr int HYP_THREADS = 128;
constexpr int REFINE_THREADS = 512;
constexpr int HYP_WARPS = HYP_THREADS / 32;
constexpr int REFINE_WARPS = REFINE_THREADS / 32;
constexpr int NSUM = 27;  // 21 unique JtJ entries + 6 Jtr entries

struct Cam {
  float fx, fy, cx, cy;
};

__device__ __forceinline__ Cam load_cam(const float* K) { return {K[0], K[4], K[2], K[5]}; }

// a pose's top three rows [R | t]; the last row is [0 0 0 1]
struct Pose {
  float m[3][4];
};

__device__ __forceinline__ Pose load_pose(const float* T) {
  Pose p;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p.m[i][j] = T[4 * i + j];
  return p;
}

__device__ __forceinline__ void store_pose(const Pose& p, float* T) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) T[4 * i + j] = p.m[i][j];
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

// A @ B of two poses. Batched (cuBLAS's batched kernel): fmaf over k in
// order. Unbatched: the pairs (0, 1) and (2, 3), each an fmaf, then their
// sum; B's last row [0 0 0 1] leaves (a0 b0 ~ a1 b1) + a2 b2, and a3 in
// the last column's second pair.
template <bool BATCHED>
__device__ __forceinline__ Pose compose(const Pose& A, const Pose& B) {
  Pose C;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a3 = j == 3 ? A.m[i][3] : 0.0f;
      if (BATCHED) {
        float acc = A.m[i][0] * B.m[0][j];
        acc = fmaf(A.m[i][1], B.m[1][j], acc);
        acc = fmaf(A.m[i][2], B.m[2][j], acc);
        C.m[i][j] = j == 3 ? acc + a3 : acc;
      } else {
        const float lo = fmaf(A.m[i][1], B.m[1][j], A.m[i][0] * B.m[0][j]);
        const float hi = j == 3 ? fmaf(a3, 1.0f, A.m[i][2] * B.m[2][j]) : A.m[i][2] * B.m[2][j];
        C.m[i][j] = lo + hi;
      }
    }
  }
  return C;
}

// a dot product of 3 as cuBLAS's batched 3x3 product sums it (fmaf chain)
__device__ __forceinline__ float dot3_chain(float a0, float b0, float a1, float b1, float a2, float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, a0 * b0));
}

// and as its matrix-vector and unbatched 3x3 products do (a pair, then one)
__device__ __forceinline__ float dot3_pair(float a0, float b0, float a1, float b1, float a2, float b2) {
  return fmaf(a1, b1, a0 * b0) + a2 * b2;
}

// (3x3) @ (3x3) by cuBLAS, batched or not
template <bool BATCHED>
__device__ __forceinline__ void matmul3(const float A[3][3], const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = BATCHED ? dot3_chain(A[i][0], B[0][j], A[i][1], B[1][j], A[i][2], B[2][j])
                        : dot3_pair(A[i][0], B[0][j], A[i][1], B[1][j], A[i][2], B[2][j]);
}

// geom/linalg._mm3: products, then a sum over the middle axis in order
__device__ __forceinline__ void matmul3_sum(const float A[3][3], const float B[3][3],
                                            float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = (A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j];
}

// the last-axis sum of three products: (p0 + p2) + p1
__device__ __forceinline__ float sum3(float p0, float p1, float p2) { return (p0 + p2) + p1; }

// geom/linalg.inv3x3: cofactors fma(x, y, -(z w)), det by two fmas
__device__ __forceinline__ void inv3x3(const float A[3][3], float out[3][3]) {
  const float a = A[0][0], b = A[0][1], c = A[0][2];
  const float d = A[1][0], e = A[1][1], f = A[1][2];
  const float g = A[2][0], h = A[2][1], i = A[2][2];
  const float c11 = fmaf(e, i, -(f * h));
  const float c12 = fmaf(c, h, -(b * i));
  const float c13 = fmaf(b, f, -(c * e));
  const float c21 = fmaf(f, g, -(d * i));
  const float c22 = fmaf(a, i, -(c * g));
  const float c23 = fmaf(c, d, -(a * f));
  const float c31 = fmaf(d, h, -(e * g));
  const float c32 = fmaf(b, g, -(a * h));
  const float c33 = fmaf(a, e, -(b * d));
  const float det = fmaf(c, c31, fmaf(a, c11, b * c21));
  const float eps = 1e-12f;
  const float sgn = (float)((0.0f < det) - (det < 0.0f));
  const float inv_det = 1.0f / (fabsf(det) > eps ? det : sgn * eps + eps);
  out[0][0] = c11 * inv_det; out[0][1] = c12 * inv_det; out[0][2] = c13 * inv_det;
  out[1][0] = c21 * inv_det; out[1][1] = c22 * inv_det; out[1][2] = c23 * inv_det;
  out[2][0] = c31 * inv_det; out[2][1] = c32 * inv_det; out[2][2] = c33 * inv_det;
}

// geom/linalg.solve6: the inverse by the 3x3-block Schur complement, then
// x_i = sum_j inv_ij b_j, a last-axis sum of six
__device__ void solve6(const float A[6][6], const float rhs[6], float x[6]) {
  float A11[3][3], A12[3][3], A21[3][3], A22[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A11[i][j] = A[i][j];
      A12[i][j] = A[i][j + 3];
      A21[i][j] = A[i + 3][j];
      A22[i][j] = A[i + 3][j + 3];
    }
  float i11[3][3], B[3][3], C[3][3], S[3][3], iS[3][3], BiS[3][3], B11[3][3], B21[3][3], t[3][3];
  inv3x3(A11, i11);
  matmul3_sum(i11, A12, B);
  matmul3_sum(A21, i11, C);
  matmul3_sum(A21, B, t);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) S[i][j] = A22[i][j] - t[i][j];
  inv3x3(S, iS);
  matmul3_sum(B, iS, BiS);
  matmul3_sum(BiS, C, t);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) B11[i][j] = i11[i][j] + t[i][j];
  matmul3_sum(iS, C, B21);
  float inv[6][6];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      inv[i][j] = B11[i][j];
      inv[i][j + 3] = -BiS[i][j];
      inv[i + 3][j] = -B21[i][j];
      inv[i + 3][j + 3] = iS[i][j];
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float p[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) p[j] = inv[i][j] * rhs[j];
    x[i] = ((p[0] + p[4]) + p[2]) + ((p[1] + p[5]) + p[3]);
  }
}

// geom/se3.exp of the twist [v, w]: Rodrigues and the left Jacobian, the
// Taylor branches under theta^2 < 1e-6 (torch's division by a number on
// the card multiplies by its float reciprocal); W W and J v by cuBLAS,
// batched or not
template <bool BATCHED>
__device__ Pose se3_exp(const float tau[6]) {
  const float w0 = tau[3], w1 = tau[4], w2 = tau[5];
  const float theta2 = sum3(w0 * w0, w1 * w1, w2 * w2);
  const float theta = sqrtf(clamp_min(theta2, 1e-8f));
  const bool small = theta2 < 1e-6f;
  const float st = sinf(theta), ct = cosf(theta);
  const float a = small ? 1.0f - theta2 * (1.0f / 6.0f) : st / theta;
  const float b = small ? 0.5f - theta2 * (1.0f / 24.0f) : (1.0f - ct) / theta2;
  const float c = small ? 0.16666667f - theta2 * (1.0f / 120.0f) : (theta - st) / (theta2 * theta);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3];
  matmul3<BATCHED>(W, W, W2);
  Pose E;
  float J[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      E.m[i][j] = (I + a * W[i][j]) + b * W2[i][j];
      J[i][j] = (I + b * W[i][j]) + c * W2[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) E.m[i][3] = dot3_pair(J[i][0], tau[0], J[i][1], tau[1], J[i][2], tau[2]);
  return E;
}

// geom/se3.normalize_rotation of the refined pose (unbatched): R <- R
// (1.5 I - 0.5 R^T R), twice; cuBLAS sums R^T R as a chain, R M in pairs
__device__ Pose normalize_rotation(const Pose& T) {
  float R[3][3], RtR[3][3], M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = T.m[i][j];
#pragma unroll
  for (int it = 0; it < 2; ++it) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        RtR[i][j] = dot3_chain(R[0][i], R[0][j], R[1][i], R[1][j], R[2][i], R[2][j]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) M[i][j] = (i == j ? 1.5f : 0.0f) - 0.5f * RtR[i][j];
    float Rn[3][3];
    matmul3<false>(R, M, Rn);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
  }
  Pose out = T;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out.m[i][j] = R[i][j];
  return out;
}

// ba/residuals.residual_and_jacobians for one point: r = pi(K T p) - uv,
// depth_ok = Z > 1e-3, and with JAC the 2x6 pose Jacobian
template <bool JAC>
__device__ __forceinline__ void residual(const Pose& T, const Cam& k, const float* p, const float* uv,
                                         float r[2], bool& depth_ok, float J0[6], float J1[6]) {
  const float px = p[0], py = p[1], pz = p[2];
  const float X = sum3(T.m[0][0] * px, T.m[0][1] * py, T.m[0][2] * pz) + T.m[0][3];
  const float Y = sum3(T.m[1][0] * px, T.m[1][1] * py, T.m[1][2] * pz) + T.m[1][3];
  const float Zr = sum3(T.m[2][0] * px, T.m[2][1] * py, T.m[2][2] * pz) + T.m[2][3];
  depth_ok = Zr > MIN_Z;
  const float Z = clamp_min(Zr, MIN_Z);
  r[0] = (k.fx * X) / Z + k.cx - uv[0];
  r[1] = (k.fy * Y) / Z + k.cy - uv[1];
  if (JAC) {
    const float iz = 1.0f / Z;
    const float iz2 = iz * iz;
    const float a = k.fx * iz;
    const float c = (-k.fx * X) * iz2;
    const float b = k.fy * iz;
    const float d = (-k.fy * Y) * iz2;
    J0[0] = a; J0[1] = 0.0f; J0[2] = c; J0[3] = c * Y;
    J0[4] = k.fx + ((k.fx * X) * X) * iz2;
    J0[5] = (-k.fx * Y) * iz;
    J1[0] = 0.0f; J1[1] = b; J1[2] = d;
    J1[3] = -k.fy - ((k.fy * Y) * Y) * iz2;
    J1[4] = (-d) * X;
    J1[5] = (k.fy * X) * iz;
  }
}

// torch.linalg.vector_norm of a residual: each square, then their sum
__device__ __forceinline__ float norm2(const float r[2]) { return sqrtf(r[0] * r[0] + r[1] * r[1]); }

__device__ __forceinline__ bool is_inlier(const Pose& T, const Cam& k, const float* pts,
                                          const float* uv, const unsigned char* valid, int n,
                                          float inlier_px) {
  float r[2], J0[6], J1[6];
  bool ok;
  residual<false>(T, k, pts + 3 * n, uv + 2 * n, r, ok, J0, J1);
  return valid[n] && ok && norm2(r) < inlier_px;
}

// The 27 sums (JtJ's upper triangle row by row, then Jtr) of the rows
// k = 2 n + r of S points, as opt_einsum contracts them on the card: JtJ an
// fmaf chain over k of (J_ki w_n) J_kj; Jtr the products J_ki (r_k w_n)
// summed by a tree that halves k (offsets S, S / 2, ..., 1).
template <int S>
__device__ __forceinline__ void hypothesis_sums(const float J[S][2][6], const float r[S][2],
                                                const float w[S], float s[NSUM]) {
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++q) {
      float acc = (J[0][0][i] * w[0]) * J[0][0][j];
#pragma unroll
      for (int k = 1; k < 2 * S; ++k) acc = fmaf(J[k / 2][k % 2][i] * w[k / 2], J[k / 2][k % 2][j], acc);
      s[q] = acc;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float p[2 * S];
#pragma unroll
    for (int k = 0; k < 2 * S; ++k) p[k] = J[k / 2][k % 2][i] * (r[k / 2][k % 2] * w[k / 2]);
#pragma unroll
    for (int o = S; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < o; ++k) p[k] = p[k] + p[k + o];
    s[21 + i] = p[0];
  }
}

// one point's terms of the refinement's 27 sums, added to acc: the same
// products, (J_ri w) J_rj and J_ri (r_r w)
__device__ __forceinline__ void add_point_sums(const float J0[6], const float J1[6], const float r[2],
                                               float w, float acc[NSUM]) {
  const float* Jr[2] = {J0, J1};
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const float* Jv = Jr[row];
    const float rw = r[row] * w;
    int q = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float Jw = Jv[i] * w;
#pragma unroll
      for (int j = i; j < 6; ++j, ++q) acc[q] = fmaf(Jw, Jv[j], acc[q]);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] = fmaf(Jv[i], rw, acc[21 + i]);
  }
}

// one damped GN update from the 27 sums: T <- exp(solve6(JtJ + damping I,
// -Jtr)) T, its products by cuBLAS batched (the hypotheses) or not
template <bool BATCHED>
__device__ Pose gn_update(const Pose& T, const float s[NSUM], float damping) {
  float A[6][6], rhs[6], delta[6];
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++q) {
      A[i][j] = s[q] + (i == j ? damping : 0.0f);
      A[j][i] = A[i][j];
    }
#pragma unroll
  for (int i = 0; i < 6; ++i) rhs[i] = -s[21 + i];
  solve6(A, rhs, delta);
  return compose<BATCHED>(se3_exp<BATCHED>(delta), T);
}

// a top-S list, sorted: value descending, then index ascending
template <int S>
struct TopS {
  float v[S];
  int i[S];
};

__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

template <int S>
__device__ __forceinline__ void top_init(TopS<S>& t) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    t.v[k] = -INFINITY;
    t.i[k] = INT32_MAX;  // after every real entry, -inf ones included
  }
}

template <int S>
__device__ __forceinline__ void top_insert(TopS<S>& t, float v, int i) {
  if (!before(v, i, t.v[S - 1], t.i[S - 1])) return;
  t.v[S - 1] = v;
  t.i[S - 1] = i;
#pragma unroll
  for (int k = S - 1; k > 0; --k) {
    if (before(t.v[k], t.i[k], t.v[k - 1], t.i[k - 1])) {
      const float tv = t.v[k]; t.v[k] = t.v[k - 1]; t.v[k - 1] = tv;
      const int ti = t.i[k]; t.i[k] = t.i[k - 1]; t.i[k - 1] = ti;
    }
  }
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int S>
__global__ void __launch_bounds__(HYP_THREADS)
pnp_hypotheses_kernel(const float* __restrict__ pts, const float* __restrict__ uv,
                      const unsigned char* __restrict__ valid, const float* __restrict__ K,
                      const float* __restrict__ T_init, const float* __restrict__ gumbel,
                      const float* __restrict__ twist_noise, const float* __restrict__ half,
                      const float* __restrict__ rot_w, const float* __restrict__ spread,
                      int N, int gn_iters, float inlier_px,
                      int64_t* __restrict__ sample_idx, float* __restrict__ T_hyp,
                      int* __restrict__ scores) {
  __shared__ float s_v[HYP_WARPS][S];
  __shared__ int s_i[HYP_WARPS][S];
  __shared__ int s_count[HYP_WARPS];
  __shared__ Pose s_T;
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Cam k = load_cam(K);

  // the minimal set: a strided top-S a thread, merged across lanes and warps
  TopS<S> top;
  top_init(top);
  const float* g = gumbel + (size_t)h * N;
  for (int n = tid; n < N; n += HYP_THREADS) top_insert(top, valid[n] ? g[n] : -INFINITY, n);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    float ov[S];
    int oi[S];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      ov[q] = __shfl_xor_sync(0xffffffffu, top.v[q], o);
      oi[q] = __shfl_xor_sync(0xffffffffu, top.i[q], o);
    }
#pragma unroll
    for (int q = 0; q < S; ++q) top_insert(top, ov[q], oi[q]);
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < S; ++q) {
      s_v[warp][q] = top.v[q];
      s_i[warp][q] = top.i[q];
    }
  }
  __syncthreads();

  if (tid == 0) {
    for (int w = 1; w < HYP_WARPS; ++w)
#pragma unroll
      for (int q = 0; q < S; ++q) top_insert(top, s_v[w][q], s_i[w][q]);
#pragma unroll
    for (int q = 0; q < S; ++q) sample_idx[(size_t)h * S + q] = top.i[q];

    // the start: exp(twist_noise * (half * spread) * rot_w) T_init
    const float scale = half[h] * spread[0];
    float tw[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) tw[q] = (twist_noise[6 * h + q] * scale) * rot_w[q];
    Pose T = compose<true>(se3_exp<true>(tw), load_pose(T_init));

    // gn_iters damped steps on the S points, weights depth_ok
    float P[S][3], U[S][2];
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int n = top.i[q];
      P[q][0] = pts[3 * n]; P[q][1] = pts[3 * n + 1]; P[q][2] = pts[3 * n + 2];
      U[q][0] = uv[2 * n]; U[q][1] = uv[2 * n + 1];
    }
    for (int it = 0; it < gn_iters; ++it) {
      float J[S][2][6], r[S][2], w[S], sums[NSUM];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        bool ok;
        residual<true>(T, k, P[q], U[q], r[q], ok, J[q][0], J[q][1]);
        w[q] = ok ? 1.0f : 0.0f;
      }
      hypothesis_sums<S>(J, r, w, sums);
      T = gn_update<true>(T, sums, 1e-4f);
    }
    s_T = T;
    store_pose(T, T_hyp + (size_t)16 * h);
  }
  __syncthreads();

  // the score over every entry
  const Pose T = s_T;
  int count = 0;
  for (int n = tid; n < N; n += HYP_THREADS) count += is_inlier(T, k, pts, uv, valid, n, inlier_px);
  count = warp_sum_int(count);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < HYP_WARPS; ++w) total += s_count[w];
    scores[h] = total;
  }
}

__global__ void __launch_bounds__(REFINE_THREADS)
pnp_refine_kernel(const float* __restrict__ pts, const float* __restrict__ uv,
                  const unsigned char* __restrict__ valid, const float* __restrict__ K,
                  const float* __restrict__ T_init, const float* __restrict__ T_hyp,
                  const int* __restrict__ scores, int N, int H, int gn_iters, float inlier_px,
                  float huber_px, float* __restrict__ T_out, bool* __restrict__ mask,
                  int* __restrict__ n_inliers, int* __restrict__ best_score) {
  __shared__ int s_best[REFINE_WARPS][2];
  __shared__ float s_sum[REFINE_WARPS][NSUM];
  __shared__ int s_count[REFINE_WARPS];
  __shared__ Pose s_T;
  __shared__ int s_win[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Cam k = load_cam(K);

  // the winner: the highest score, the first index among equal ones
  int bs = INT32_MIN, bi = INT32_MAX;
  for (int h = tid; h < H; h += REFINE_THREADS) {
    const int s = scores[h];
    if (s > bs) { bs = s; bi = h; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int os = __shfl_xor_sync(0xffffffffu, bs, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (os > bs || (os == bs && oi < bi)) { bs = os; bi = oi; }
  }
  if (lane == 0) { s_best[warp][0] = bs; s_best[warp][1] = bi; }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < REFINE_WARPS; ++w) {
      const int os = s_best[w][0], oi = s_best[w][1];
      if (os > bs || (os == bs && oi < bi)) { bs = os; bi = oi; }
    }
    s_win[0] = bs;
    s_win[1] = bi;
    s_T = load_pose(T_hyp + (size_t)16 * bi);
    *best_score = bs;
  }
  __syncthreads();
  const int score = s_win[0];
  if (score < 4) {  // no consensus: the prior pose, no inliers
    for (int n = tid; n < N; n += REFINE_THREADS) mask[n] = false;
    if (tid < 16) T_out[tid] = T_init[tid];
    if (tid == 0) *n_inliers = 0;
    return;
  }

  // the winner's inlier set, kept in `mask` until the final pass (each
  // entry written and read by the same thread)
  Pose T = s_T;
  for (int n = tid; n < N; n += REFINE_THREADS) mask[n] = is_inlier(T, k, pts, uv, valid, n, inlier_px);

  for (int it = 0; it < gn_iters; ++it) {
    float acc[NSUM];
#pragma unroll
    for (int q = 0; q < NSUM; ++q) acc[q] = 0.0f;
    for (int n = tid; n < N; n += REFINE_THREADS) {
      float r[2], J0[6], J1[6];
      bool ok;
      residual<true>(T, k, pts + 3 * n, uv + 2 * n, r, ok, J0, J1);
      // res.huber_weight * inl0 * depth_ok, times depth_ok again in the step
      const float hw = clamp_max(huber_px / clamp_min(norm2(r), 1e-9f), 1.0f);
      const float dok = ok ? 1.0f : 0.0f;
      const float w = ((hw * (mask[n] ? 1.0f : 0.0f)) * dok) * dok;
      add_point_sums(J0, J1, r, w, acc);
    }
#pragma unroll
    for (int q = 0; q < NSUM; ++q) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < NSUM; ++q) s_sum[warp][q] = acc[q];
    }
    __syncthreads();
    if (tid == 0) {
      float s[NSUM];
#pragma unroll
      for (int q = 0; q < NSUM; ++q) {
        float v = s_sum[0][q];
        for (int w = 1; w < REFINE_WARPS; ++w) v += s_sum[w][q];
        s[q] = v;
      }
      s_T = gn_update<false>(T, s, 1e-6f);
    }
    __syncthreads();
    T = s_T;
  }
  __syncthreads();  // every thread holds T before s_T changes
  if (tid == 0) {
    s_T = normalize_rotation(T);
    store_pose(s_T, T_out);
  }
  __syncthreads();
  T = s_T;

  // the final inlier set at the refined pose
  int count = 0;
  for (int n = tid; n < N; n += REFINE_THREADS) {
    const bool in = is_inlier(T, k, pts, uv, valid, n, inlier_px);
    mask[n] = in;
    count += in;
  }
  count = warp_sum_int(count);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < REFINE_WARPS; ++w) total += s_count[w];
    *n_inliers = total;
  }
}

}  // namespace

// Every pointer a contiguous device array (the wrapper checks): pts (N, 3),
// uv (N, 2), valid (N,) bool, K (3, 3), T_init (4, 4), gumbel (H, N),
// twist_noise (H, 6), half (H,), rot_w (6,), spread (); writes
// sample_idx (H, S) int64, T_hyp (H, 4, 4), scores (H,) int32. S = 4 only.
extern "C" int svs_pnp_hypotheses(const float* pts, const float* uv, const void* valid,
                                  const float* K, const float* T_init, const float* gumbel,
                                  const float* twist_noise, const float* half, const float* rot_w,
                                  const float* spread, int N, int H, int S, int gn_iters,
                                  float inlier_px, void* sample_idx, float* T_hyp, int* scores,
                                  void* stream) {
  if (S != 4 || N < S || H < 1) return (int)cudaErrorInvalidValue;
  pnp_hypotheses_kernel<4><<<H, HYP_THREADS, 0, (cudaStream_t)stream>>>(
      pts, uv, (const unsigned char*)valid, K, T_init, gumbel, twist_noise, half, rot_w, spread, N,
      gn_iters, inlier_px, (int64_t*)sample_idx, T_hyp, scores);
  return (int)cudaGetLastError();
}

// T_hyp (H, 4, 4) and scores (H,) as svs_pnp_hypotheses wrote them; writes
// T_out (4, 4), mask (N,) bool, n_inliers () and best_score () int32.
extern "C" int svs_pnp_refine(const float* pts, const float* uv, const void* valid,
                              const float* K, const float* T_init, const float* T_hyp,
                              const int* scores, int N, int H, int gn_iters, float inlier_px,
                              float huber_px, float* T_out, void* mask, int* n_inliers,
                              int* best_score, void* stream) {
  if (N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  pnp_refine_kernel<<<1, REFINE_THREADS, 0, (cudaStream_t)stream>>>(
      pts, uv, (const unsigned char*)valid, K, T_init, T_hyp, scores, N, H, gn_iters, inlier_px,
      huber_px, T_out, (bool*)mask, n_inliers, best_score);
  return (int)cudaGetLastError();
}
