"""Batched PnP-RANSAC + robust Gauss-Newton refinement (port of
tracking/pnp.py).

The random draws come in as tensors — `gumbel` (H, N) for the minimal-set
sampling and `twist_noise` (H, 6) for the hypothesis-start diversity —
instead of a key. The drivers draw them on the device from the JAX
package's own stream (`utils/prng.pnp_draws`: split(key) -> gumbel,
normal, as tracking/pnp.py there), so both packages fit the same
hypotheses.

`solve_pnp_ransac` takes its path from its input's device: CUDA tensors
run two hand-written kernels (ops/kernels/pnp_kernel, csrc/pnp_ransac.cu);
CPU tensors run `solve_pnp_ransac_plain`, some 5,700 tensor ops, the CPU
tests' oracle. The cost model counts a call on either as one unit of the
kernels' work (`measure.pnp_work`). On the card the per-frame tracker
calls `graphed(...)`: the same function captured once as a CUDA graph (of
the two kernels) and replayed (utils/cuda_graph).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from stereo_visual_slam_tpu_torch.ba import residuals as res
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.geom.linalg import solve6
from stereo_visual_slam_tpu_torch.ops.fast import top_k_stable
from stereo_visual_slam_tpu_torch.ops.kernels import measure, pnp_kernel
from stereo_visual_slam_tpu_torch.utils import cuda_graph, roofline, trace


class PnPResult(NamedTuple):
    T_c_w: torch.Tensor        # (4, 4) estimated pose
    inlier_mask: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor    # () int32
    best_score: torch.Tensor   # () int32 — inliers of the winning hypothesis


def _gn_step(T, pts_w, uv, w, K, damping):
    """One damped Gauss-Newton step on pose only, batched over leading dims
    of T (..., 4, 4); pts_w (..., n, 3), uv (..., n, 2), w (..., n)."""
    r, Jp, depth_ok = res.reprojection_residual_jac(T[..., None, :, :], pts_w, uv, K)
    w = w * depth_ok
    JtJ = torch.einsum("...nri,...nrj,...n->...ij", Jp, Jp, w)
    Jtr = torch.einsum("...nri,...nr,...n->...i", Jp, r, w)
    A = JtJ + damping * torch.eye(6, dtype=T.dtype, device=T.device)
    delta = solve6(A, -Jtr)
    return se3.compose(se3.exp(delta), T)


_START_WEIGHTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _start_weights(H: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H,) 0 for the first half of the hypotheses and the ramp 0..1 over
    the rest, and the (6,) per-axis weights of a start's twist; made once
    per (H, dtype, device). Made per call they were launches every frame and
    a copy from the host, which a CUDA graph cannot capture."""
    key = (H, dtype, torch.device(device))
    if key not in _START_WEIGHTS:
        ramp = torch.linspace(0.0, 1.0, H, dtype=dtype, device=device)
        half = torch.where(torch.arange(H, device=device) < H // 2, 0.0, ramp)
        rot_w = torch.tensor([1.0, 1.0, 1.0, 0.05, 0.05, 0.05], dtype=dtype, device=device)
        _START_WEIGHTS[key] = (half, rot_w)
    return _START_WEIGHTS[key]


@roofline.kernel_unit("pnp_ransac", measure.pnp_work)
def solve_pnp_ransac(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
    K: torch.Tensor, T_init: torch.Tensor,
    gumbel: torch.Tensor, twist_noise: torch.Tensor, *,
    sample_size: int = 4, inlier_px: float = 4.0,
    gn_iters_hypothesis: int = 10, gn_iters_refine: int = 10,
    huber_px: float = 4.0, prior_spread=0.0,
) -> PnPResult:
    """Estimate T_c_w from world points (N, 3) and pixels (N, 2) with
    outliers; H = gumbel.shape[0] hypotheses start from T_init (half of
    them perturbed by twist_noise scaled up to prior_spread). CUDA inputs
    run the two kernels (and count `track.pnp_kernel`), CPU inputs
    `solve_pnp_ransac_plain`."""
    if not pts_w.is_cuda:
        return solve_pnp_ransac_plain(
            pts_w, uv, valid, K, T_init, gumbel, twist_noise, sample_size=sample_size,
            inlier_px=inlier_px, gn_iters_hypothesis=gn_iters_hypothesis,
            gn_iters_refine=gn_iters_refine, huber_px=huber_px, prior_spread=prior_spread)
    trace.add("track.pnp_kernel", 1)
    half, rot_w = _start_weights(gumbel.shape[0], pts_w.dtype, pts_w.device)
    c = [t.contiguous() for t in (pts_w, uv, valid, K, T_init, gumbel, twist_noise)]
    return PnPResult(*pnp_kernel.pnp_ransac(
        *c, half, rot_w, prior_spread, sample_size=sample_size, inlier_px=inlier_px,
        gn_iters_hypothesis=gn_iters_hypothesis, gn_iters_refine=gn_iters_refine,
        huber_px=huber_px))


def solve_pnp_ransac_plain(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
    K: torch.Tensor, T_init: torch.Tensor,
    gumbel: torch.Tensor, twist_noise: torch.Tensor, *,
    sample_size: int = 4, inlier_px: float = 4.0,
    gn_iters_hypothesis: int = 10, gn_iters_refine: int = 10,
    huber_px: float = 4.0, prior_spread=0.0,
) -> PnPResult:
    """The plain version of `solve_pnp_ransac`, in tensor ops on any
    device."""
    dtype = pts_w.dtype
    _, T_hyp, scores, inlier_sets = hypotheses_plain(
        pts_w, uv, valid, K, T_init, gumbel, twist_noise, sample_size=sample_size,
        inlier_px=inlier_px, gn_iters_hypothesis=gn_iters_hypothesis, prior_spread=prior_spread)
    # the winner by a one-element index: indexing by the 0-dim argmax would
    # read it on the host
    best = torch.argmax(scores).reshape(1)
    best_score = scores.index_select(0, best)[0]
    T_best = T_hyp.index_select(0, best)[0]
    inl0 = inlier_sets.index_select(0, best)[0].to(dtype)

    # --- robust refinement on the winning consensus set
    T_ref = T_best
    for _ in range(gn_iters_refine):
        r, _, depth_ok = res.reprojection_residual_jac(T_ref, pts_w, uv, K)
        w_ref = res.huber_weight(r, huber_px) * inl0 * depth_ok
        T_ref = _gn_step(T_ref, pts_w, uv, w_ref, K, 1e-6)
    T_ref = se3.normalize_rotation(T_ref)

    # --- final inlier classification at the refined pose
    r, _, depth_ok = res.reprojection_residual_jac(T_ref, pts_w, uv, K)
    err = torch.linalg.vector_norm(r, dim=-1)
    inlier_mask = valid & depth_ok.bool() & (err < inlier_px)
    ok = best_score >= 4
    T_out = torch.where(ok, T_ref, T_init)
    inlier_mask = inlier_mask & ok
    return PnPResult(
        T_c_w=T_out,
        inlier_mask=inlier_mask,
        n_inliers=inlier_mask.sum(dtype=torch.int32),
        best_score=best_score,
    )


def hypotheses_plain(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
    K: torch.Tensor, T_init: torch.Tensor,
    gumbel: torch.Tensor, twist_noise: torch.Tensor, *,
    sample_size: int = 4, inlier_px: float = 4.0,
    gn_iters_hypothesis: int = 10, prior_spread=0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hypothesis stage of `solve_pnp_ransac_plain` (the first kernel's
    twin): (sample_idx (H, S) int64, T_hyp (H, 4, 4), scores (H,) int32,
    inlier_sets (H, N) bool)."""
    H = gumbel.shape[0]
    dtype, dev = pts_w.dtype, pts_w.device

    # --- H minimal sets over valid entries (Gumbel top-k, lowest index
    #     first among ties, -inf ties included)
    g = torch.where(valid[None, :], gumbel, float("-inf"))
    _, sample_idx = top_k_stable(g, sample_size)             # (H, S)

    # --- hypothesis starts: half the exact prior, half perturbed
    half, rot_w = _start_weights(H, dtype, dev)
    scale = half * prior_spread
    twists = twist_noise * scale[:, None] * rot_w
    T_starts = se3.compose(se3.exp(twists), T_init)          # (H, 4, 4)

    p = pts_w[sample_idx]                                    # (H, S, 3)
    u = uv[sample_idx]                                       # (H, S, 2)
    w = torch.ones((H, sample_size), dtype=dtype, device=dev)
    T_hyp = T_starts
    for _ in range(gn_iters_hypothesis):
        T_hyp = _gn_step(T_hyp, p, u, w, K, 1e-4)

    # --- score every hypothesis against every point
    r, _, depth_ok = res.reprojection_residual_jac(T_hyp[:, None], pts_w[None], uv[None], K)
    err = torch.linalg.vector_norm(r, dim=-1)
    inlier_sets = valid[None] & depth_ok.bool() & (err < inlier_px)  # (H, N)
    scores = inlier_sets.sum(dim=1, dtype=torch.int32)
    return sample_idx, T_hyp, scores, inlier_sets


def graphed(**settings) -> cuda_graph.Graphed:
    """The process's one `cuda_graph.Graphed` of `solve_pnp_ransac` with these
    settings (its keywords but `prior_spread`), shared by every tracker."""
    return cuda_graph.shared(
        ("track.pnp", tuple(sorted(settings.items()))),
        lambda: cuda_graph.Graphed(functools.partial(solve_pnp_ransac, **settings), "track.pnp"))
