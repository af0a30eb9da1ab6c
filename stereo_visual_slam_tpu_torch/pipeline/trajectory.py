"""Trajectory write-out and error metrics.

Writer emits the exact row format of the reference
(Map::write_pose, map.cpp:168-196): `frame_id r00 r01 r02 x r10 r11 r12 y
r20 r21 r22 z` of T_w_c = T_c_w^-1, appended per evicted keyframe plus the
remaining window at shutdown (map.cpp:198-204) — so existing KITTI eval
tooling consumes our output unchanged.

Metrics: ATE RMSE after SE(3)-free alignment at the origin (trajectories
share the first frame) and KITTI-devkit-style translational %% / rotational
deg/m averaged over sub-trajectories of standard lengths.

The port's own copy of stereo_visual_slam_tpu/pipeline/trajectory.py: the port imports
nothing of the JAX package. tests/test_torch_shared_copies.py holds the
copy equal to the original.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

KITTI_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)


def format_pose_row(frame_id: int, T_c_w: np.ndarray) -> str:
    T_w_c = np.linalg.inv(T_c_w)
    R = T_w_c[:3, :3]
    t = T_w_c[:3, 3]
    vals = [
        R[0, 0], R[0, 1], R[0, 2], t[0],
        R[1, 0], R[1, 1], R[1, 2], t[1],
        R[2, 0], R[2, 1], R[2, 2], t[2],
    ]
    return str(frame_id) + " " + " ".join(f"{v:.9g}" for v in vals)


class TrajectoryWriter:
    def __init__(self, path: str):
        self.path = path
        open(path, "w").close()

    def write(self, frame_id: int, T_c_w: np.ndarray):
        with open(self.path, "a") as f:
            f.write(format_pose_row(frame_id, T_c_w) + "\n")


def read_trajectory(path: str) -> Dict[int, np.ndarray]:
    """Read writer output back to {frame_id: T_w_c}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 13:
                continue
            fid = int(float(parts[0]))
            M = np.array([float(x) for x in parts[1:]]).reshape(3, 4)
            T = np.eye(4)
            T[:3, :4] = M
            out[fid] = T
    return out


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
