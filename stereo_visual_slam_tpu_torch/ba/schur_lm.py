"""Levenberg-Marquardt bundle adjustment with an explicit Schur complement
(port of ba/schur_lm.py).

The window is a dense (L, K) observation grid with masks. The reference's
early-exit `lax.while_loop` becomes a loop of exactly `iters` iterations in
which a `done` flag freezes the carry with `torch.where`: the result equals
the while loop's, and no iteration needs a device-to-host sync. The
scalar constants are filled on the device, so nothing here waits on the
host and a CUDA graph can capture it (utils/cuda_graph.Graphed).

With `mesh` (utils/dist.LandmarkMesh, the JAX `axis_name`), the problem
holds this rank's landmark rows and every cross-landmark sum is summed over
the mesh where the JAX program psums: the Huber cost, the reduced camera
system (U, b_p, S_cross, b_cross: one all_reduce per LM iteration), the edge
count and each adaptive round's inlier count. V, Wb, b_l, V_inv and dP stay
local; the 6K x 6K solve is replicated. The fixed iteration count means
every rank makes the same sequence of collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_visual_slam_tpu_torch.ba import residuals as res
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.geom.linalg import inv3x3
from stereo_visual_slam_tpu_torch.utils import trace


class BAProblem(NamedTuple):
    """Dense-window BA problem; masks are float32."""

    T_c_w: torch.Tensor       # (K, 4, 4) keyframe poses, world -> camera
    points: torch.Tensor      # (L, 3) landmark positions (world)
    uv: torch.Tensor          # (L, K, 2) pixel observations
    obs_mask: torch.Tensor    # (L, K) 1.0 where observed
    point_mask: torch.Tensor  # (L,) 1.0 for participating landmarks
    pose_mask: torch.Tensor   # (K,) 1.0 for valid keyframes
    fixed_pose: torch.Tensor  # (K,) 1.0 for gauge-anchored poses


class BAResult(NamedTuple):
    T_c_w: torch.Tensor
    points: torch.Tensor
    chi2_edges: torch.Tensor       # (L, K) final squared pixel errors
    landmark_inlier: torch.Tensor  # (L,) bool after adaptive thresholding
    chi2_threshold: torch.Tensor   # () final adaptive threshold
    cost: torch.Tensor             # () final robustified cost


def edge_mask(problem: BAProblem, depth_ok: torch.Tensor) -> torch.Tensor:
    return (
        problem.obs_mask * problem.point_mask[:, None]
        * problem.pose_mask[None, :] * depth_ok
    )


def psum(mesh, *ts: torch.Tensor):
    """The tensors summed over the mesh's ranks (JAX `_maybe_psum`), or
    the tensors themselves without a mesh."""
    return ts if mesh is None else mesh.all_reduce(*ts)


def robust_cost(r, problem: BAProblem, huber_delta: float, depth_ok, mesh=None) -> torch.Tensor:
    """Total Huber cost (what LM accept/reject compares)."""
    n = torch.linalg.vector_norm(r, dim=-1)
    d = huber_delta
    rho = torch.where(n <= d, n * n, 2.0 * d * n - d * d)
    return psum(mesh, torch.sum(rho * edge_mask(problem, depth_ok)))[0]


def classify(chi2, m, chi2_threshold, adaptive_rounds, target_inlier_ratio, mesh=None):
    """Adaptive chi2 outlier classification (optimization.cpp:224-252):
    double the threshold until more than `target_inlier_ratio` of the edges
    pass, then flag landmarks whose worst observation fails it. The counts
    are f32 sums of masks: exact up to 2^24 edges."""
    (n_edges,) = psum(mesh, torch.sum(m))
    # a fill on the device: a tensor from a host number would copy and wait
    th = torch.full((), chi2_threshold, dtype=chi2.dtype, device=chi2.device)
    for _ in range(adaptive_rounds):
        (n_in,) = psum(mesh, torch.sum((chi2 <= th) * m))
        ratio = n_in / torch.clamp(n_edges, min=1.0)
        th = torch.where(ratio > target_inlier_ratio, th, th * 2.0)
    worst = torch.amax(torch.where(m > 0, chi2, 0.0), dim=1)
    has_obs = torch.sum(m, dim=1) > 0
    return (worst <= th) & has_obs, th


def lm_step_frozen(done, new, old):
    """The carry after one fixed-count iteration: unchanged once done."""
    return torch.where(done, old, new)


def lm_optimize(
    problem: BAProblem, K: torch.Tensor, *, iters: int,
    update_points: bool = True, huber_delta: float = 5.991,
    chi2_threshold: float = 5.991, adaptive_rounds: int = 5,
    target_inlier_ratio: float = 0.5, lambda_init: float = 1e-4,
    lambda_up: float = 10.0, lambda_down: float = 0.5, rel_tol: float = 1e-6,
    mesh=None,
) -> BAResult:
    """Up to `iters` LM iterations (frozen once an accepted step improves
    the cost by < rel_tol or the damping saturates), then the adaptive
    outlier classification. With `mesh`, `problem` holds this rank's
    landmark rows, and so do the result's points, chi2 and verdicts."""
    dtype, dev = problem.points.dtype, problem.points.device
    nK = problem.T_c_w.shape[0]
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    free_k = problem.pose_mask * (1.0 - problem.fixed_pose)     # (K,)
    diag = torch.arange(nK, device=dev)

    def solve_normal_eqs(r, Jp, Jl, depth_ok, lam):
        w = edge_mask(problem, depth_ok) * res.huber_weight(r, huber_delta)
        Jp = Jp * free_k[None, :, None, None]     # fixed / invalid poses: 0

        U = torch.einsum("lkri,lkrj,lk->kij", Jp, Jp, w)        # (K, 6, 6)
        V = torch.einsum("lkri,lkrj,lk->lij", Jl, Jl, w)        # (L, 3, 3)
        Wb = torch.einsum("lkri,lkrj,lk->lkij", Jp, Jl, w)      # (L, K, 6, 3)
        b_p = -torch.einsum("lkri,lkr,lk->ki", Jp, r, w)        # (K, 6)
        b_l = -torch.einsum("lkri,lkr,lk->li", Jl, r, w)        # (L, 3)

        V_d = V + lam * (eye3 * torch.clamp(
            torch.diagonal(V, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0, min=1.0)
        ) + eye3 * 1e-6
        V_inv = inv3x3(V_d)                                     # (L, 3, 3)

        if update_points:
            Y = torch.einsum("lkij,ljm->lkim", Wb, V_inv)       # (L, K, 6, 3)
            S_cross = torch.einsum("lkij,lmnj->kimn", Y, Wb)    # (K, 6, K, 6)
            b_cross = torch.einsum("lkij,lj->ki", Y, b_l)       # (K, 6)
            U, b_p, S_cross, b_cross = psum(mesh, U, b_p, S_cross, b_cross)
        else:
            U, b_p = psum(mesh, U, b_p)
            S_cross = torch.zeros((nK, 6, nK, 6), dtype=dtype, device=dev)
            b_cross = torch.zeros((nK, 6), dtype=dtype, device=dev)

        U_d = U + lam * (eye6 * torch.clamp(
            torch.diagonal(U, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0, min=1.0))

        # S[k, :, k, :] is the k-th diagonal 6x6 block (numpy advanced
        # indexing puts the k axis first)
        S = torch.zeros((nK, 6, nK, 6), dtype=dtype, device=dev)
        S[diag, :, diag, :] = U_d
        S = S - S_cross
        b_s = b_p - b_cross
        # identity rows for fixed / invalid poses keep the matrix SPD
        S = S * (free_k[:, None, None, None] * free_k[None, None, :, None])
        S[diag, :, diag, :] += eye6 * (1.0 - free_k)[:, None, None]
        S[diag, :, diag, :] += eye6 * 1e-8
        b_s = b_s * free_k[:, None]
        sol, _ = torch.linalg.solve_ex(
            S.reshape(6 * nK, 6 * nK), b_s.reshape(6 * nK, 1)
        )
        dxi = sol.reshape(nK, 6) * free_k[:, None]
        if update_points:
            rhs = b_l - torch.einsum("lkij,ki->lj", Wb, dxi)
            dP = torch.einsum("lij,lj->li", V_inv, rhs) * problem.point_mask[:, None]
        else:
            dP = torch.zeros_like(b_l)
        return dxi, dP

    def residual_cheap(T, P):
        return res.residual_only(T[None], P[:, None, :], problem.uv, K)

    T, P = problem.T_c_w, problem.points
    r0, d0 = residual_cheap(T, P)
    cost = robust_cost(r0, problem, huber_delta, d0, mesh)
    lam = torch.full((), lambda_init, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    trace.add("ba.lm_iters", iters)
    for _ in range(iters):
        if trace.enabled():
            trace.add("ba.lm_useful", ~done)   # an iteration that can still move the state
        r, Jp, Jl, depth_ok = res.residual_and_jacobians(
            T[None], P[:, None, :], problem.uv, K
        )
        dxi, dP = solve_normal_eqs(r, Jp, Jl, depth_ok, lam)
        T_new = se3.normalize_rotation(se3.compose(se3.exp(dxi), T))
        P_new = P + dP
        r2, d2 = residual_cheap(T_new, P_new)
        cost_new = robust_cost(r2, problem, huber_delta, d2, mesh)
        accept = cost_new < cost
        step_done = (accept & (cost - cost_new <= rel_tol * cost)) | (lam >= 1e7)
        lam_new = torch.where(
            accept, torch.clamp(lam * lambda_down, min=1e-10),
            torch.clamp(lam * lambda_up, max=1e8),
        )
        T = lm_step_frozen(done, torch.where(accept, T_new, T), T)
        P = lm_step_frozen(done, torch.where(accept, P_new, P), P)
        cost = lm_step_frozen(done, torch.where(accept, cost_new, cost), cost)
        lam = lm_step_frozen(done, lam_new, lam)
        done = done | step_done

    r, depth_ok = residual_cheap(T, P)
    chi2 = torch.sum(r * r, dim=-1)
    inlier, th = classify(
        chi2, edge_mask(problem, depth_ok), chi2_threshold, adaptive_rounds,
        target_inlier_ratio, mesh,
    )
    return BAResult(T, P, chi2, inlier, th, cost)
