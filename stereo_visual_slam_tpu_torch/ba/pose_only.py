"""Pose-only bundle adjustment, landmarks fixed (port of ba/pose_only.py).

Unary edges: the normal equations decouple into one 6x6 system per
keyframe, solved in closed form. The early-exit while loop becomes a
fixed-count loop frozen by a `done` flag, as in schur_lm. With `mesh`, H
and b (one all_reduce per iteration), the cost and the counts are summed
over the mesh, as the JAX program psums them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_visual_slam_tpu_torch.ba import residuals as res
from stereo_visual_slam_tpu_torch.ba.schur_lm import (
    BAProblem, classify, edge_mask, lm_step_frozen, psum, robust_cost,
)
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.geom.linalg import solve6
from stereo_visual_slam_tpu_torch.utils import trace


class PoseOnlyResult(NamedTuple):
    T_c_w: torch.Tensor
    chi2_edges: torch.Tensor
    landmark_inlier: torch.Tensor
    chi2_threshold: torch.Tensor
    cost: torch.Tensor


def optimize_pose_only(
    problem: BAProblem, K: torch.Tensor, *, iters: int,
    huber_delta: float = 5.991, chi2_threshold: float = 5.991,
    adaptive_rounds: int = 5, target_inlier_ratio: float = 0.5,
    lambda_init: float = 1e-4, lambda_up: float = 10.0,
    lambda_down: float = 0.5, rel_tol: float = 1e-6, mesh=None,
) -> PoseOnlyResult:
    dtype, dev = problem.points.dtype, problem.points.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    free = problem.pose_mask * (1.0 - problem.fixed_pose)

    def residual_cheap(T):
        return res.residual_only(T[None], problem.points[:, None, :], problem.uv, K)

    def solve(T, lam):
        r, Jp, depth_ok = res.reprojection_residual_jac(
            T[None], problem.points[:, None, :], problem.uv, K
        )
        w = edge_mask(problem, depth_ok) * res.huber_weight(r, huber_delta)
        Hm = torch.einsum("lkri,lkrj,lk->kij", Jp, Jp, w)
        b = -torch.einsum("lkri,lkr,lk->ki", Jp, r, w)
        Hm, b = psum(mesh, Hm, b)
        Hm = Hm + lam * eye6 * torch.clamp(
            torch.diagonal(Hm, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 6.0, min=1.0
        ) + eye6 * 1e-8
        return solve6(Hm, b) * free[:, None]

    T = problem.T_c_w
    r0, d0 = residual_cheap(T)
    cost = robust_cost(r0, problem, huber_delta, d0, mesh)
    lam = torch.full((), lambda_init, dtype=dtype, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    trace.add("ba.lm_iters", iters)
    for _ in range(iters):
        if trace.enabled():
            trace.add("ba.lm_useful", ~done)   # an iteration that can still move the state
        dxi = solve(T, lam)
        T_new = se3.normalize_rotation(se3.compose(se3.exp(dxi), T))
        r2, d2 = residual_cheap(T_new)
        cost_new = robust_cost(r2, problem, huber_delta, d2, mesh)
        accept = cost_new < cost
        step_done = (accept & (cost - cost_new <= rel_tol * cost)) | (lam >= 1e7)
        lam_new = torch.where(
            accept, torch.clamp(lam * lambda_down, min=1e-10),
            torch.clamp(lam * lambda_up, max=1e8),
        )
        T = lm_step_frozen(done, torch.where(accept, T_new, T), T)
        cost = lm_step_frozen(done, torch.where(accept, cost_new, cost), cost)
        lam = lm_step_frozen(done, lam_new, lam)
        done = done | step_done

    r, depth_ok = residual_cheap(T)
    chi2 = torch.sum(r * r, dim=-1)
    inlier, th = classify(
        chi2, edge_mask(problem, depth_ok), chi2_threshold, adaptive_rounds,
        target_inlier_ratio, mesh,
    )
    return PoseOnlyResult(T, chi2, inlier, th, cost)
