"""SE(3)/SO(3) Lie group core (port of geom/se3.py).

Conventions as in the JAX package: twists are [upsilon (trans), omega (rot)],
updates are left-multiplicative T <- exp(delta) T, poses are 4x4 T_c_w.
Every function broadcasts over leading batch dimensions. The reference runs
this at highest f32 precision; the package turns TF32 off, so the 3x3 and
4x4 products below are plain fp32.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_SMALL = 1e-6  # theta^2 below this -> Taylor series


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat: (..., 3) -> (..., 3, 3) skew-symmetric."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _eye3_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < _SMALL
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(omega)
    W2 = W @ W
    return _eye3_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> unit quaternion (..., 4) [w, x, y, z], w >= 0
    (branch-free Shepperd: the candidate with the largest pivot wins)."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = r00 + r11 + r22

    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=0.0)) * 0.5
    s0 = 0.25 / torch.clamp(qw0, min=_EPS)
    c0 = torch.stack([qw0, (r21 - r12) * s0, (r02 - r20) * s0, (r10 - r01) * s0], -1)

    qx1 = torch.sqrt(torch.clamp(1.0 + r00 - r11 - r22, min=0.0)) * 0.5
    s1 = 0.25 / torch.clamp(qx1, min=_EPS)
    c1 = torch.stack([(r21 - r12) * s1, qx1, (r01 + r10) * s1, (r02 + r20) * s1], -1)

    qy2 = torch.sqrt(torch.clamp(1.0 - r00 + r11 - r22, min=0.0)) * 0.5
    s2 = 0.25 / torch.clamp(qy2, min=_EPS)
    c2 = torch.stack([(r02 - r20) * s2, (r01 + r10) * s2, qy2, (r12 + r21) * s2], -1)

    qz3 = torch.sqrt(torch.clamp(1.0 - r00 - r11 + r22, min=0.0)) * 0.5
    s3 = 0.25 / torch.clamp(qz3, min=_EPS)
    c3 = torch.stack([(r10 - r01) * s3, (r02 + r20) * s3, (r12 + r21) * s3, qz3], -1)

    pivots = torch.stack(
        [tr, r00 - r11 - r22, -r00 + r11 - r22, -r00 - r11 + r22], -1
    )
    choice = torch.argmax(pivots, dim=-1)          # first max, as jnp.argmax
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4, 4)
    idx = choice[..., None, None].expand(*choice.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    return q * torch.where(q[..., :1] >= 0, 1.0, -1.0)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), via quaternion — stable at every angle."""
    q = rotation_to_quaternion(R)
    w, xyz = q[..., 0], q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(n, w)
    small = n < 1e-6
    scale = torch.where(
        small, 2.0 + theta * theta / 12.0, theta / torch.clamp(n, min=_EPS)
    )
    return xyz * scale[..., None]


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < _SMALL
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    W = hat(omega)
    W2 = W @ W
    return _eye3_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < _SMALL
    half = theta * 0.5
    sin_half = torch.where(small, torch.ones_like(half), torch.sin(half))
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / sin_half) / theta2,
    )
    W = hat(omega)
    W2 = W @ W
    return _eye3_like(W) - 0.5 * W + cot_term[..., None, None] * W2


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 from (..., 3, 3) and (..., 3)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    # the identity's last row, not a write of 1.0: on an unbatched T that
    # slice is 0-dim, and the write a copy from the host
    T = torch.eye(4, dtype=R.dtype, device=R.device).expand(batch + (4, 4)).contiguous()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def exp(tau: torch.Tensor) -> torch.Tensor:
    """se(3) exp: (..., 6) twist [v, w] -> (..., 4, 4)."""
    v, w = tau[..., :3], tau[..., 3:]
    return make(so3_exp(w), _matvec(_left_jacobian(w), v))


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist [v, w]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    v = _matvec(_left_jacobian_inv(w), t)
    return torch.cat([v, w], dim=-1)


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make(Rt, -_matvec(Rt, t))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def act(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3)."""
    return _matvec(T[..., :3, :3], pts) + T[..., :3, 3]


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def angle_y(T: torch.Tensor) -> torch.Tensor:
    """|log(R)_y| — the keyframe rule's yaw (visual_odometry.cpp:353)."""
    return torch.abs(so3_log(rotation(T))[..., 1])


def normalize_rotation(T: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation block: two Newton steps of the polar
    decomposition, R <- R (3I - R^T R) / 2."""
    R = T[..., :3, :3]
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = R @ (1.5 * _eye3_like(RtR) - 0.5 * RtR)
    return make(R, T[..., :3, 3])
