# Frozen copy of stereo_visual_slam_tpu_torch/geom/linalg.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""Closed-form batched small inverses (port of geom/linalg.py).

Kept as closed forms, not `torch.linalg`, so the results track the
reference's arithmetic; every caller inverts a damped normal-equation block,
which bounds the condition number.
"""

from __future__ import annotations

import torch


def _fms(x, y, z, w):
    """x*y - z*w as fma(x, y, -(z*w)): one rounding for the first product."""
    return torch.addcmul(-(z * w), x, y)


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det).

    The cofactors and the determinant are fused multiply-adds in the order
    XLA's CPU backend contracts the reference's expressions into (bit-equal
    to it, tests/test_torch_geom.py). It matters for the rank-2 landmark
    blocks of BA, where the two products of a cofactor nearly cancel."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = _fms(e, i, f, h)
    c12 = _fms(c, h, b, i)
    c13 = _fms(b, f, c, e)
    c21 = _fms(f, g, d, i)
    c22 = _fms(a, i, c, g)
    c23 = _fms(c, d, a, f)
    c31 = _fms(d, h, e, g)
    c32 = _fms(b, g, a, h)
    c33 = _fms(a, e, b, d)
    det = torch.addcmul(torch.addcmul(b * c21, a, c11), c, c31)
    inv_det = 1.0 / torch.where(det.abs() > eps, det, torch.sign(det) * eps + eps)
    adj = torch.stack(
        [
            torch.stack([c11, c12, c13], dim=-1),
            torch.stack([c21, c22, c23], dim=-1),
            torch.stack([c31, c32, c33], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as elementwise mul + reduce."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def inv6x6(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 6x6 inverse via the 3x3-block Schur complement."""
    A11, A12 = A[..., :3, :3], A[..., :3, 3:]
    A21, A22 = A[..., 3:, :3], A[..., 3:, 3:]
    i11 = inv3x3(A11)
    B = _mm3(i11, A12)
    C = _mm3(A21, i11)
    S = A22 - _mm3(A21, B)
    iS = inv3x3(S)
    BiS = _mm3(B, iS)
    B11 = i11 + _mm3(BiS, C)
    B12 = -BiS
    B21 = -_mm3(iS, C)
    return torch.cat(
        [torch.cat([B11, B12], dim=-1), torch.cat([B21, iS], dim=-1)], dim=-2
    )


def solve6(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 solve A x = b via the closed-form inverse.
    A (..., 6, 6), b (..., 6) -> (..., 6)."""
    return torch.sum(inv6x6(A) * b[..., None, :], dim=-1)
