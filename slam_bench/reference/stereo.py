# Frozen copy of stereo_visual_slam_tpu_torch/ops/stereo.py at commit c627a7a, part of
# the benchmark's plain reference: the ZNCC kernel's branch removed: the sweep is always the plain one.
"""Per-keypoint stereo depth via epipolar ZNCC search (port of ops/stereo.py).

`zncc_sweep` is the plain torch version of the ZNCC kernel
(ops/kernels/stereo_kernel.py) and follows the reference's XLA formulation
(`zncc_sweep_xla`), eps placement included. Depth gates match the
reference: valid 10 m < z < 400 m, reliable z < 40 m.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class StereoResult(NamedTuple):
    disparity: torch.Tensor  # (N,) f32, sub-pixel
    depth: torch.Tensor      # (N,) f32 metres
    valid: torch.Tensor      # (N,) bool — passed score + depth gates
    reliable: torch.Tensor   # (N,) bool — z < reliable_depth
    score: torch.Tensor      # (N,) best ZNCC


def zncc_sweep(
    left: torch.Tensor, right: torch.Tensor, yx: torch.Tensor, *,
    patch: int, max_disparity: int,
) -> torch.Tensor:
    """(N, D) ZNCC of the p x p left patch at (y, x) against the right
    windows centred at (y, x - d), d = 0..D-1; zero outside the images."""
    D, p = max_disparity, patch
    r = p // 2
    H, W = left.shape
    left_p = F.pad(left, (r, r, r, r))
    right_p = F.pad(right, (D + r, r, r, r))
    y = torch.clamp(yx[:, 0].long(), 0, H - 1)
    x = torch.clamp(yx[:, 1].long(), 0, W - 1)
    rows = (y[:, None] + torch.arange(p, device=left.device))[:, :, None]
    lp = left_p[rows, (x[:, None] + torch.arange(p, device=left.device))[:, None, :]]
    scols = x[:, None] + 1 + torch.arange(p + D - 1, device=left.device)
    strip = right_p[rows, scols[:, None, :]]                 # (N, p, p + D - 1)
    # window start t = D - 1 - d  ->  (N, D, p, p)
    win = strip.unfold(2, p, 1).flip(2).permute(0, 2, 1, 3)

    eps = 1e-6
    # means as sum / n with n a tensor: on a CUDA tensor torch's mean(), and
    # its division by a python number, multiply by 1 / n, which gives a flat
    # 8-bit patch a uniform offset of ~1e-5 that then normalises to a
    # constant (ZNCC ~0.98 between two flat patches). True division keeps
    # flat patches at 0, as mean() does on the CPU (bit-equal there) and as
    # the JAX reference does.
    s = lp.sum(dim=(1, 2), keepdim=True)
    lp_m = lp - s / torch.full_like(s, p * p)
    lp_n = lp_m / (torch.sqrt(torch.sum(lp_m * lp_m, dim=(1, 2), keepdim=True)) + eps)
    s = win.sum(dim=(2, 3), keepdim=True)
    win_m = win - s / torch.full_like(s, p * p)
    win_n = win_m / (torch.sqrt(torch.sum(win_m * win_m, dim=(2, 3), keepdim=True)) + eps)
    return torch.einsum("npq,ndpq->nd", lp_n, win_n)


def match_disparity(
    left: torch.Tensor, right: torch.Tensor, yx: torch.Tensor,
    valid_kp: torch.Tensor, *, fx: float, baseline: float,
    max_disparity: int = 96, patch: int = 11, min_zncc: float = 0.6,
    min_depth: float = 10.0, max_depth: float = 400.0,
    reliable_depth: float = 40.0,
) -> StereoResult:
    """Sub-pixel disparity for N left keypoints yx (N, 2) int."""
    D = max_disparity
    W = left.shape[1]
    eps = 1e-6
    zncc = zncc_sweep(left, right, yx, patch=patch, max_disparity=D)

    x = torch.clamp(yx[:, 1].long(), 0, W - 1)
    d_range = torch.arange(D, device=left.device)[None, :]
    zncc = torch.where((x[:, None] - d_range) >= 0, zncc, -2.0)

    best = torch.argmax(zncc, dim=1)
    best_s = torch.gather(zncc, 1, best[:, None])[:, 0]
    bm = torch.clamp(best - 1, 0, D - 1)
    bp = torch.clamp(best + 1, 0, D - 1)
    sm = torch.gather(zncc, 1, bm[:, None])[:, 0]
    sp = torch.gather(zncc, 1, bp[:, None])[:, 0]
    denom = sm - 2.0 * best_s + sp
    delta = torch.where(denom.abs() > eps, 0.5 * (sm - sp) / denom, 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    disp = best.float() + delta

    # a scalar numerator divides (python `c / t` is t.reciprocal() * c)
    depth = torch.full_like(disp, fx * baseline) / torch.clamp(disp, min=eps)
    valid = (
        valid_kp & (best_s > min_zncc) & (best > 0) & (best < D - 1)
        & (depth > min_depth) & (depth < max_depth)
    )
    reliable = valid & (depth < reliable_depth)
    return StereoResult(disp, depth, valid, reliable, best_s)


def backproject(
    yx: torch.Tensor, depth: torch.Tensor, *,
    fx: float, fy: float, cx: float, cy: float,
) -> torch.Tensor:
    """Pinhole back-projection to camera-frame 3D. yx (..., 2) (y, x)."""
    z = depth
    xcam = (yx[..., 1].float() - cx) * z / fx
    ycam = (yx[..., 0].float() - cy) * z / fy
    return torch.stack([xcam, ycam, z], dim=-1)
