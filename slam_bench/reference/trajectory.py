# Frozen copy of stereo_visual_slam_tpu_torch/pipeline/trajectory.py at commit c627a7a, part of
# the benchmark's plain reference: the error metrics alone (the pose writer and
# reader are left out).
"""Trajectory error metrics.

Metrics: ATE RMSE after SE(3)-free alignment at the origin (trajectories
share the first frame) and KITTI-devkit-style translational %% / rotational
deg/m averaged over sub-trajectories of standard lengths.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def _positions(T_w_c_list: np.ndarray) -> np.ndarray:
    return T_w_c_list[:, :3, 3]


def ate_rmse(est_T_c_w: np.ndarray, gt_T_c_w: np.ndarray) -> float:
    """Absolute trajectory error (RMSE over positions, no alignment —
    trajectories share the starting pose by construction)."""
    est = _positions(np.linalg.inv(est_T_c_w))
    gt = _positions(np.linalg.inv(gt_T_c_w))
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def trajectory_distances(gt_T_w_c: np.ndarray) -> np.ndarray:
    p = _positions(gt_T_w_c)
    d = np.linalg.norm(np.diff(p, axis=0), axis=-1)
    return np.concatenate([[0.0], np.cumsum(d)])


def kitti_errors(
    est_T_c_w: np.ndarray,
    gt_T_c_w: np.ndarray,
    lengths: Sequence[float] = KITTI_LENGTHS,
    step: int = 10,
) -> Tuple[float, float]:
    """KITTI odometry metric: average translational error (%%) and rotational
    error (deg/m) over all sub-trajectories of the given lengths.

    Falls back to shorter lengths if the trajectory is short (synthetic
    sequences); returns (nan, nan) when nothing fits.
    """
    est_w = np.linalg.inv(est_T_c_w)
    gt_w = np.linalg.inv(gt_T_c_w)
    dist = trajectory_distances(gt_w)
    total = dist[-1]
    usable = [L for L in lengths if L <= total * 0.8]
    if not usable:
        usable = [total * f for f in (0.25, 0.5, 0.75) if total * f > 1.0]
    if not usable:
        return float("nan"), float("nan")

    t_errs: List[float] = []
    r_errs: List[float] = []
    n = len(est_w)
    for L in usable:
        for i in range(0, n, step):
            target = dist[i] + L
            j = int(np.searchsorted(dist, target))
            if j >= n:
                continue
            # relative poses over [i, j]
            gt_rel = np.linalg.inv(gt_w[i]) @ gt_w[j]
            est_rel = np.linalg.inv(est_w[i]) @ est_w[j]
            err = np.linalg.inv(est_rel) @ gt_rel
            t_err = np.linalg.norm(err[:3, 3])
            cos_r = np.clip((np.trace(err[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
            r_err = np.degrees(np.arccos(cos_r))
            seg = dist[j] - dist[i]
            if seg > 1.0:
                t_errs.append(t_err / seg * 100.0)
                r_errs.append(r_err / seg)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs)), float(np.mean(r_errs))
