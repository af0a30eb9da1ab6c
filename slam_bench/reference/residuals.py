# Frozen copy of stereo_visual_slam_tpu_torch/ba/residuals.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""Reprojection residual + analytic Jacobians (port of ba/residuals.py).

r = pi(K T P) - u, with the closed-form 2x6 left-perturbation pose Jacobian
and the 2x3 point Jacobian, all as explicit elementwise math. Broadcasts
over leading batch dimensions; `depth_ok` flags points in front of the
camera.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MIN_Z = 1e-3


def transform(T_c_w: torch.Tensor, pts_w: torch.Tensor) -> torch.Tensor:
    """Rigid transform (..., 4, 4) x (..., 3) -> (..., 3), elementwise."""
    R = T_c_w[..., :3, :3]
    t = T_c_w[..., :3, 3]
    return torch.sum(R * pts_w[..., None, :], dim=-1) + t


def project(Xc: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = torch.clamp(Xc[..., 2], min=_MIN_Z)
    u = fx * Xc[..., 0] / z + cx
    v = fy * Xc[..., 1] / z + cy
    return torch.stack([u, v], dim=-1)


def residual_only(
    T_c_w: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor, K: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residual + depth mask without Jacobians."""
    Xc = transform(T_c_w, pts_w)
    depth_ok = (Xc[..., 2] > _MIN_Z).to(pts_w.dtype)
    return project(Xc, K) - uv, depth_ok


def residual_and_jacobians(
    T_c_w: torch.Tensor, pts_w: torch.Tensor, uv: torch.Tensor, K: torch.Tensor,
):
    """Returns (r (..., 2), J_pose (..., 2, 6), J_point (..., 2, 3),
    depth_ok (...,) f32)."""
    fx, fy = K[0, 0], K[1, 1]
    R = T_c_w[..., :3, :3]
    Xc = transform(T_c_w, pts_w)
    depth_ok = (Xc[..., 2] > _MIN_Z).to(pts_w.dtype)
    r = project(Xc, K) - uv

    X, Y = Xc[..., 0], Xc[..., 1]
    Z = torch.clamp(Xc[..., 2], min=_MIN_Z)
    iz = 1.0 / Z
    iz2 = iz * iz
    zero = torch.zeros_like(X)

    a = fx * iz
    c = -fx * X * iz2
    b = fy * iz
    d = -fy * Y * iz2

    row0 = torch.stack(
        [a, zero, c, c * Y, fx + fx * X * X * iz2, -fx * Y * iz], dim=-1
    )
    row1 = torch.stack(
        [zero, b, d, -fy - fy * Y * Y * iz2, -d * X, fy * X * iz], dim=-1
    )
    J_pose = torch.stack([row0, row1], dim=-2)

    Jpt_u = a[..., None] * R[..., 0, :] + c[..., None] * R[..., 2, :]
    Jpt_v = b[..., None] * R[..., 1, :] + d[..., None] * R[..., 2, :]
    J_point = torch.stack([Jpt_u, Jpt_v], dim=-2)
    return r, J_pose, J_point, depth_ok


def reprojection_residual_jac(T_c_w, pts_w, uv, K):
    """Pose-only variant: (r, J_pose, depth_ok)."""
    r, J_pose, _, depth_ok = residual_and_jacobians(T_c_w, pts_w, uv, K)
    return r, J_pose, depth_ok


def huber_weight(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS Huber weight on the residual 2-norm: min(1, delta / ||r||)."""
    n = torch.linalg.vector_norm(r, dim=-1)
    # a divide, not `delta / t` (python's reflected division multiplies by
    # the reciprocal and differs from the reference by an ulp)
    return torch.clamp(torch.full_like(n, delta) / torch.clamp(n, min=1e-9), max=1.0)
