# Frozen copy of stereo_visual_slam_tpu_torch/ops/fast.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""FAST-9/16 corner score, 3x3 NMS and pooled top-k (port of ops/fast.py).

`fast_score_map` + `nms_3x3` are the plain torch version of the FAST+NMS
kernel (ops/kernels/fast_kernel.py) and its test oracle. Every step is a
subtraction, compare, min or max of exact values, so the result is
bit-identical to the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, in circular order, as (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shifted_views(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W): view j holds I(p + offset_j), zero outside the image."""
    H, W = img.shape
    padded = F.pad(img, (3, 3, 3, 3))
    return torch.stack(
        [padded[3 + dy: 3 + dy + H, 3 + dx: 3 + dx + W]
         for dy, dx in CIRCLE_OFFSETS],
        dim=0,
    )


def fast_score_map(img: torch.Tensor, threshold: float, arc: int = 9) -> torch.Tensor:
    """Dense FAST-9/16 score map, zero where not a corner. img: (H, W) f32."""
    diff = _shifted_views(img) - img[None]
    score = torch.zeros_like(img)
    for sign in (1.0, -1.0):
        d = diff * sign
        ok = d > threshold
        mag = torch.where(ok, d, 0.0)
        ok2 = torch.cat([ok, ok[: arc - 1]], dim=0)
        mag2 = torch.cat([mag, mag[: arc - 1]], dim=0)
        best = torch.zeros_like(img)
        for k in range(16):
            valid = torch.all(ok2[k: k + arc], dim=0)
            strength = torch.amin(mag2[k: k + arc], dim=0)
            best = torch.maximum(best, torch.where(valid, strength, 0.0))
        score = torch.maximum(score, best)
    return score


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep 3x3 local maxima; ties go to the earlier pixel in raster order
    (>= against later neighbours, > against earlier ones). Out-of-image
    neighbours count as -inf."""
    H, W = score.shape
    padded = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = padded[1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
            later = (dy > 0) or (dy == 0 and dx > 0)
            keep &= (score >= neigh) if later else (score > neigh)
    return torch.where(keep, score, 0.0)


def top_k_stable(x: torch.Tensor, k: int):
    """`lax.top_k` semantics: the k largest along the last axis, the lowest
    index first among equal values. `torch.topk` promises no tie order, so
    this is a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_topk(score: torch.Tensor, k: int):
    """Top-k of an NMS'd score map via the lossless 2x2 max-pool of the
    reference (fast.py:89-144). score: (..., H, W) with H, W even.
    Returns (scores (..., k), yx (..., k, 2) int32)."""
    *lead, H, W = score.shape
    if H % 2 or W % 2:
        top_scores, top_idx = top_k_stable(score.reshape(*lead, H * W), k)
        yx = torch.stack([top_idx // W, top_idx % W], dim=-1)
        return top_scores, yx.to(torch.int32)
    H2, W2 = H // 2, W // 2
    pooled = score.reshape(*lead, H2, 2, W2, 2).amax(dim=(-3, -1))
    top_scores, top_idx = top_k_stable(pooled.reshape(*lead, H2 * W2), k)
    y2 = top_idx // W2
    x2 = top_idx % W2
    base = (2 * y2) * W + 2 * x2
    sflat = score.reshape(*lead, H * W)
    ga = torch.gather(sflat, -1, base)
    gb = torch.gather(sflat, -1, base + 1)
    gc = torch.gather(sflat, -1, base + W)
    sel = torch.where(
        ga == top_scores, 0,
        torch.where(gb == top_scores, 1, torch.where(gc == top_scores, 2, 3)),
    )
    y = 2 * y2 + sel // 2
    x = 2 * x2 + (sel & 1)
    return top_scores, torch.stack([y, x], dim=-1).to(torch.int32)
