"""The per-keyframe BA schedule (port of ba/schedule.py): classify passes,
full BA (poses kept, landmarks not), pose-only refinement, with the inlier
set flowing from pass to pass.

With `mesh` (the JAX shard_map path), each rank runs the three passes on
its landmark rows of the window, the sums go over the mesh (ba/schur_lm,
ba/pose_only), and the full (L,) inlier verdicts are assembled on every
rank; poses and costs are replicated.

On the card, without a mesh, `make_ba_schedule` hands out the process's
one `cuda_graph.Graphed` of the schedule for the config: captured once as a
CUDA graph and replayed, one launch from the host where the eager run makes
6,000-18,000."""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_visual_slam_tpu_torch.ba import pose_only as pose_only_mod
from stereo_visual_slam_tpu_torch.ba import schur_lm
from stereo_visual_slam_tpu_torch.utils import cuda_graph
from stereo_visual_slam_tpu_torch.utils.config import BAConfig


class ScheduleInput(NamedTuple):
    """The window; masks are float32 {0, 1}."""

    T_c_w: torch.Tensor       # (K, 4, 4)
    points: torch.Tensor      # (L, 3)
    uv: torch.Tensor          # (L, K, 2)
    obs_mask: torch.Tensor    # (L, K)
    inlier: torch.Tensor      # (L,) current landmark is_inlier flags
    reliable: torch.Tensor    # (L,) landmark reliable_depth_ flags
    present: torch.Tensor     # (L,) row holds a real landmark
    pose_mask: torch.Tensor   # (K,)
    fixed_pose: torch.Tensor  # (K,)


# the fields with a landmark axis (JAX in_specs P(LM_AXIS))
LANDMARK_FIELDS = ("points", "uv", "obs_mask", "inlier", "reliable", "present")


class ScheduleResult(NamedTuple):
    T_c_w: torch.Tensor      # (K, 4, 4) optimized poses
    inlier: torch.Tensor     # (L,) final is_inlier verdicts
    cost_full: torch.Tensor  # () robust cost after the full BA pass
    cost_pose: torch.Tensor  # () robust cost after pose-only
    threshold: torch.Tensor  # () final adaptive chi2 threshold


def make_ba_schedule(cfg: BAConfig, mesh=None):
    """The schedule closed over the static BA config:
    run(inp: ScheduleInput, K) -> ScheduleResult. With `mesh`,
    `eager_schedule(cfg, mesh)`: every rank passes the whole window and gets
    the whole result; without, the process's one `cuda_graph.Graphed` of
    `eager_schedule(cfg)`."""
    if mesh is not None:
        return eager_schedule(cfg, mesh)
    return cuda_graph.shared(("ba.schedule", cfg),
                             lambda: cuda_graph.Graphed(eager_schedule(cfg), "ba.schedule"))


def eager_schedule(cfg: BAConfig, mesh=None):
    """The schedule as eager torch calls: `run(inp, K)`."""
    common = dict(
        huber_delta=cfg.huber_delta,
        chi2_threshold=cfg.chi2_threshold,
        adaptive_rounds=cfg.adaptive_rounds,
        target_inlier_ratio=cfg.target_inlier_ratio,
        lambda_init=cfg.lm_lambda_init,
        lambda_up=cfg.lm_lambda_up,
        lambda_down=cfg.lm_lambda_down,
        rel_tol=cfg.rel_tol,
        mesh=mesh,
    )

    def run(inp: ScheduleInput, K: torch.Tensor) -> ScheduleResult:
        if mesh is not None:
            inp = mesh.shard(inp, LANDMARK_FIELDS)
        inlier = inp.inlier * inp.present

        def problem(point_mask, T):
            return schur_lm.BAProblem(
                T_c_w=T, points=inp.points, uv=inp.uv, obs_mask=inp.obs_mask,
                point_mask=point_mask, pose_mask=inp.pose_mask,
                fixed_pose=inp.fixed_pose,
            )

        def apply_verdict(inlier, participated, verdict):
            # verdicts touch only landmarks that took part in the pass
            return torch.where(participated > 0, inlier * verdict.to(inlier.dtype), inlier)

        T = inp.T_c_w
        for _ in range(cfg.classify_passes):
            pm = inlier * inp.reliable
            r = schur_lm.lm_optimize(problem(pm, T), K, iters=cfg.classify_iters, **common)
            inlier = apply_verdict(inlier, pm, r.landmark_inlier)

        pm = inlier * inp.reliable
        res_full = schur_lm.lm_optimize(problem(pm, T), K, iters=cfg.full_iters, **common)
        T = res_full.T_c_w
        inlier = apply_verdict(inlier, pm, res_full.landmark_inlier)

        res_po = pose_only_mod.optimize_pose_only(
            problem(inlier, T), K, iters=cfg.pose_only_iters, **common
        )
        T = res_po.T_c_w
        inlier = apply_verdict(inlier, inlier, res_po.landmark_inlier)
        if mesh is not None:
            inlier = mesh.all_gather(inlier)
        return ScheduleResult(
            T_c_w=T, inlier=inlier > 0, cost_full=res_full.cost,
            cost_pose=res_po.cost, threshold=res_po.chi2_threshold,
        )

    return run
