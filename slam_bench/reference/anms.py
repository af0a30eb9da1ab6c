# Frozen copy of stereo_visual_slam_tpu_torch/ops/anms.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""Adaptive non-maximal suppression mask (port of ops/anms.py `anms_mask`).

Batched over any leading dimensions: yx (..., N, 2), score (..., N).
"""

from __future__ import annotations

import torch

from slam_bench.reference.fast import top_k_stable


def anms_mask(
    yx: torch.Tensor, score: torch.Tensor, *, num: int, robust_coeff: float = 1.11
) -> torch.Tensor:
    """Boolean mask over the input slots marking the `num` keypoints with
    the largest suppression radius (distance to the nearest keypoint more
    than `robust_coeff` times stronger)."""
    valid = score > 0.0
    s = score.float()
    pts = yx.float()
    # integer coords: every square and sum below is exact in f32
    dy = pts[..., :, None, 0] - pts[..., None, :, 0]
    dx = pts[..., :, None, 1] - pts[..., None, :, 1]
    d2 = dy * dy + dx * dx
    suppresses = (s[..., None, :] > robust_coeff * s[..., :, None]) & valid[..., None, :]
    d2 = torch.where(suppresses, d2, float("inf"))
    radius = torch.sqrt(torch.amin(d2, dim=-1))
    radius = torch.where(valid, radius, float("-inf"))
    order_key = radius + s * 1e-9
    top_r, top_i = top_k_stable(order_key, num)
    sel_valid = top_r > float("-inf")
    # top_i holds distinct slots, so the scatter has no duplicate indices
    mask = torch.zeros_like(valid)
    return mask.scatter(-1, top_i, sel_valid)
