# Frozen copy of stereo_visual_slam_tpu_torch/ops/matcher.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""Brute-force Hamming matcher with cross-check, margin and motion gate
(port of ops/matcher.py). argmin/argmax keep first-occurrence semantics,
as `jnp.argmin` does."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from slam_bench.reference.orb import hamming_from_signs

_BIG = 1e9


class MatchResult(NamedTuple):
    idx_last: torch.Tensor          # (M,) index into "last" features
    idx_curr: torch.Tensor          # (M,) index into "current" features
    dist: torch.Tensor              # (M,) f32 Hamming distance
    mask: torch.Tensor              # (M,) bool valid-match mask
    idx_last_of_curr: torch.Tensor  # (N_curr,) partner row per curr slot
    mask_curr: torch.Tensor         # (N_curr,) bool — mutual + all row gates


def match(
    signs_last: torch.Tensor, valid_last: torch.Tensor,
    signs_curr: torch.Tensor, valid_curr: torch.Tensor,
    frame_gap: torch.Tensor,
    pred_yx: Optional[torch.Tensor] = None,
    curr_yx: Optional[torch.Tensor] = None,
    search_radius: Optional[torch.Tensor] = None,
    *, base_gate: float = 30.0, min_dist_factor: float = 2.0,
    margin: float = 15.0,
) -> MatchResult:
    """Cross-checked Hamming matching between two padded descriptor sets;
    one match slot per "last" feature."""
    D = hamming_from_signs(signs_last, signs_curr)
    D = torch.where(valid_last[:, None] & valid_curr[None, :], D, _BIG)
    if pred_yx is not None and curr_yx is not None and search_radius is not None:
        diff = pred_yx[:, None, :].float() - curr_yx[None, :, :].float()
        d2 = torch.sum(diff * diff, dim=-1)
        D = torch.where(d2 <= search_radius * search_radius, D, _BIG)

    best_j = torch.argmin(D, dim=1)
    best_d = torch.gather(D, 1, best_j[:, None])[:, 0]
    n_last, n_curr = D.shape
    cols = torch.arange(n_curr, device=D.device)
    second_d = torch.amin(torch.where(cols[None, :] == best_j[:, None], _BIG, D), dim=1)
    distinct = (second_d - best_d) >= margin

    best_i = torch.argmin(D, dim=0)
    rows = torch.arange(n_last, device=D.device)
    mutual = best_i[best_j] == rows
    ok = mutual & (best_d < _BIG) & distinct

    min_d = torch.amin(torch.where(ok, best_d, _BIG))
    gate = torch.maximum(min_dist_factor * min_d, base_gate * frame_gap)
    ok = ok & (best_d <= gate)

    mutual_curr = best_j[best_i] == cols
    mask_curr = mutual_curr & ok[best_i]
    return MatchResult(
        idx_last=rows, idx_curr=best_j, dist=best_d, mask=ok,
        idx_last_of_curr=best_i, mask_curr=mask_curr,
    )
