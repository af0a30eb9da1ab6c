"""PnP-RANSAC and its robust refinement as two CUDA kernels
(csrc/pnp_ransac.cu): the path `tracking/pnp.solve_pnp_ransac` takes for
CUDA inputs, in place of the plain version's ~5,700 tensor ops
(`pnp.solve_pnp_ransac_plain`, its twin).

`pnp_hypotheses` launches the first kernel (minimal sets, each
hypothesis's GN chain, its score), `pnp_refine` the second (the winner,
its Huber-weighted refinement, the final inlier set), and `pnp_ransac`
both, on the current stream: a CUDA graph captures them as two nodes.
Nothing waits on the host. The first two carry a `launches` counter
(ops/kernels/__init__.launch_counts).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereo_visual_slam_tpu_torch.ops.kernels import _build

SAMPLE_SIZES = (4,)   # the minimal-set sizes the kernel is instantiated for


class Hypotheses(NamedTuple):
    sample_idx: torch.Tensor   # (H, S) int64: each hypothesis's minimal set
    T_hyp: torch.Tensor        # (H, 4, 4) f32: its pose after the GN chain
    scores: torch.Tensor       # (H,) int32: its inliers


def _check(pts_w, uv, valid, K, T_init, *more) -> int:
    """Raise unless the inputs take the kernels: the points, and `more`
    (tensor, name, dtype, rank) of the other inputs, every dtype and rank
    checked before any device (a CPU tensor shows those faults too).
    Returns N."""
    f32 = torch.float32
    specs = [(pts_w, "pnp pts_w", f32, 2), (uv, "pnp uv", f32, 2),
             (valid, "pnp valid", torch.bool, 1), (K, "pnp K", f32, 2),
             (T_init, "pnp T_init", f32, 2), *more]
    for spec in specs:
        _build.require_type(*spec)
    for spec in specs:
        _build.require(*spec)
    N = pts_w.shape[0]
    if pts_w.shape != (N, 3) or uv.shape != (N, 2) or valid.shape != (N,):
        raise ValueError(f"pnp: pts_w (N, 3), uv (N, 2) and valid (N,) required, got "
                         f"{tuple(pts_w.shape)}, {tuple(uv.shape)}, {tuple(valid.shape)}")
    if K.shape != (3, 3) or T_init.shape != (4, 4):
        raise ValueError(f"pnp: K (3, 3) and T_init (4, 4) required, got "
                         f"{tuple(K.shape)}, {tuple(T_init.shape)}")
    if len({spec[0].device for spec in specs}) != 1:
        raise ValueError("pnp: every input on one device")
    if N == 0:
        raise ValueError("pnp: no points")
    return N


def _spread(prior_spread, like: torch.Tensor) -> torch.Tensor:
    """prior_spread as a 0-dim f32 tensor on the points' device: a number is
    filled in (a launch, no copy from the host)."""
    if not torch.is_tensor(prior_spread):
        return torch.full((), float(prior_spread), dtype=torch.float32, device=like.device)
    _build.require(prior_spread, "pnp prior_spread", torch.float32, 0)
    if prior_spread.device != like.device:
        raise ValueError("pnp: prior_spread on the points' device")
    return prior_spread


def pnp_hypotheses(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
    T_init: torch.Tensor, gumbel: torch.Tensor, twist_noise: torch.Tensor,
    half: torch.Tensor, rot_w: torch.Tensor, prior_spread, *,
    sample_size: int = 4, inlier_px: float = 4.0, gn_iters_hypothesis: int = 10,
) -> Hypotheses:
    """Launch `pnp_hypotheses_kernel`: H = gumbel.shape[0] hypotheses over
    the N points. `half` (H,) and `rot_w` (6,) are the start weights
    (`pnp._start_weights`)."""
    if sample_size not in SAMPLE_SIZES:
        raise ValueError(f"pnp: the kernel takes minimal sets of {SAMPLE_SIZES}, "
                         f"not {sample_size}")
    f32 = torch.float32
    N = _check(pts_w, uv, valid, K, T_init, (gumbel, "pnp gumbel", f32, 2),
               (twist_noise, "pnp twist_noise", f32, 2), (half, "pnp half", f32, 1),
               (rot_w, "pnp rot_w", f32, 1))
    if N < sample_size:
        raise ValueError(f"pnp: {N} points, fewer than a minimal set of {sample_size}")
    H = gumbel.shape[0]
    if gumbel.shape != (H, N) or twist_noise.shape != (H, 6) or half.shape != (H,) \
            or rot_w.shape != (6,) or H == 0:
        raise ValueError(f"pnp: gumbel (H, {N}), twist_noise (H, 6), half (H,) and rot_w (6,) "
                         f"required, got {tuple(gumbel.shape)}, {tuple(twist_noise.shape)}, "
                         f"{tuple(half.shape)}, {tuple(rot_w.shape)}")
    spread = _spread(prior_spread, pts_w)
    dev = pts_w.device
    out = Hypotheses(torch.empty((H, sample_size), dtype=torch.int64, device=dev),
                     torch.empty((H, 4, 4), dtype=torch.float32, device=dev),
                     torch.empty((H,), dtype=torch.int32, device=dev))
    err = _build.library().svs_pnp_hypotheses(
        pts_w.data_ptr(), uv.data_ptr(), valid.data_ptr(), K.data_ptr(), T_init.data_ptr(),
        gumbel.data_ptr(), twist_noise.data_ptr(), half.data_ptr(), rot_w.data_ptr(),
        spread.data_ptr(), N, H, sample_size, gn_iters_hypothesis, inlier_px,
        out.sample_idx.data_ptr(), out.T_hyp.data_ptr(), out.scores.data_ptr(),
        _build.stream_handle(pts_w),
    )
    _build.check("pnp_hypotheses", err)
    pnp_hypotheses.launches += 1
    return out


pnp_hypotheses.launches = 0


def pnp_refine(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
    T_init: torch.Tensor, T_hyp: torch.Tensor, scores: torch.Tensor, *,
    inlier_px: float = 4.0, gn_iters_refine: int = 10, huber_px: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch `pnp_refine_kernel` on `pnp_hypotheses`' T_hyp and scores:
    (T_c_w (4, 4), inlier_mask (N,) bool, n_inliers () int32, best_score ()
    int32), the fields of `pnp.PnPResult`."""
    N = _check(pts_w, uv, valid, K, T_init, (T_hyp, "pnp T_hyp", torch.float32, 3),
               (scores, "pnp scores", torch.int32, 1))
    H = scores.shape[0]
    if T_hyp.shape != (H, 4, 4) or H == 0:
        raise ValueError(f"pnp: T_hyp (H, 4, 4) and scores (H,) required, got "
                         f"{tuple(T_hyp.shape)}, {tuple(scores.shape)}")
    dev = pts_w.device
    T_c_w = torch.empty((4, 4), dtype=torch.float32, device=dev)
    mask = torch.empty((N,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int32, device=dev)
    best_score = torch.empty((), dtype=torch.int32, device=dev)
    err = _build.library().svs_pnp_refine(
        pts_w.data_ptr(), uv.data_ptr(), valid.data_ptr(), K.data_ptr(), T_init.data_ptr(),
        T_hyp.data_ptr(), scores.data_ptr(), N, H, gn_iters_refine, inlier_px, huber_px,
        T_c_w.data_ptr(), mask.data_ptr(), n_inliers.data_ptr(), best_score.data_ptr(),
        _build.stream_handle(pts_w),
    )
    _build.check("pnp_refine", err)
    pnp_refine.launches += 1
    return T_c_w, mask, n_inliers, best_score


pnp_refine.launches = 0


def pnp_ransac(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, K: torch.Tensor,
    T_init: torch.Tensor, gumbel: torch.Tensor, twist_noise: torch.Tensor,
    half: torch.Tensor, rot_w: torch.Tensor, prior_spread, *,
    sample_size: int = 4, inlier_px: float = 4.0, gn_iters_hypothesis: int = 10,
    gn_iters_refine: int = 10, huber_px: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both kernels: the fields of `pnp.PnPResult`."""
    hyp = pnp_hypotheses(pts_w, uv, valid, K, T_init, gumbel, twist_noise, half, rot_w,
                         prior_spread, sample_size=sample_size, inlier_px=inlier_px,
                         gn_iters_hypothesis=gn_iters_hypothesis)
    return pnp_refine(pts_w, uv, valid, K, T_init, hyp.T_hyp, hyp.scores, inlier_px=inlier_px,
                      gn_iters_refine=gn_iters_refine, huber_px=huber_px)
