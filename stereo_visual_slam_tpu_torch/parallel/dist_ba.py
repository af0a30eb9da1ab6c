"""Distributed bundle adjustment over a landmark mesh (port of
parallel/dist_ba.py).

The map's landmark rows are split over the ranks; each rank reduces its
landmarks' contributions to the Schur-complement camera system, one
all_reduce of the reduced (6K x 6K + 6K) system per LM iteration gives
every rank the global system, the solve is replicated and the landmark
back-substitution is local. The sums live in ba/schur_lm and ba/pose_only
(`mesh=`); this module cuts a problem to a rank's rows and assembles the
landmark-axis results, as the JAX shard_map's in/out specs do. The mesh
itself (JAX `make_mesh`) comes from utils/dist.make_landmark_mesh.
"""

from __future__ import annotations

import torch

from stereo_visual_slam_tpu_torch.ba import pose_only as pose_only_mod
from stereo_visual_slam_tpu_torch.ba import schur_lm
from stereo_visual_slam_tpu_torch.utils.dist import LandmarkMesh

# the BAProblem fields with a landmark axis (JAX _PROBLEM_SPECS P(LM_AXIS));
# poses and their masks are replicated
LANDMARK_FIELDS = ("points", "uv", "obs_mask", "point_mask")


def shard_problem(problem: schur_lm.BAProblem, mesh: LandmarkMesh) -> schur_lm.BAProblem:
    """This rank's rows of a BAProblem (L must divide over the mesh)."""
    return mesh.shard(problem, LANDMARK_FIELDS)


def distributed_lm_optimize(
    problem: schur_lm.BAProblem, K: torch.Tensor, mesh: LandmarkMesh, *, iters: int, **kwargs,
) -> schur_lm.BAResult:
    """Landmark-sharded LM + Schur BA on this rank's shard (`shard_problem`);
    poses replicated, the landmark-axis results assembled on every rank."""
    r = schur_lm.lm_optimize(problem, K, iters=iters, mesh=mesh, **kwargs)
    return r._replace(points=mesh.all_gather(r.points), chi2_edges=mesh.all_gather(r.chi2_edges),
                      landmark_inlier=mesh.all_gather(r.landmark_inlier))


def distributed_pose_only(
    problem: schur_lm.BAProblem, K: torch.Tensor, mesh: LandmarkMesh, *, iters: int, **kwargs,
) -> pose_only_mod.PoseOnlyResult:
    r = pose_only_mod.optimize_pose_only(problem, K, iters=iters, mesh=mesh, **kwargs)
    return r._replace(chi2_edges=mesh.all_gather(r.chi2_edges),
                      landmark_inlier=mesh.all_gather(r.landmark_inlier))
