"""The JAX package's own runs at full size, as data the port is held to.

`data/reference_runs.json` holds two runs of the JAX package on the CPU at
production `Config()` on `make_world(Config(), 64, 8000, seed 0)`, the
world `chip_smoke.py` phases 4 and 5 drive: `ChunkedSlam` at chunk 8
("chunked") and `VisualOdometry` at lookahead 1 ("host"). Per frame: its
record (state, keyframe, matches, inliers, new landmarks) and its pose in
the finished trajectory (T_c_w, 16 float32 values); per run its ATE and
KITTI trans. Both drivers draw their PnP hypotheses from the JAX stream,
which the port reproduces (utils/prng.py), so a port run can be set beside
them number for number. Rewrite the file with the JAX package:

    JAX_PLATFORMS=cpu python tests/test_torch_reference_runs.py

`compare` measures a run against one of them; `misses` holds it to the
bound: the fixed part (same frame ids, neither Lost, keyframe counts
within 1, ATE <= max(1.5 x the reference's, the reference's + 0.05 m))
and the per-frame part: every camera centre within `CENTRE_BOUND_M` of
the reference's, every frame-to-frame motion within `MOTION_BOUND_M`.
The per-frame bound is ~30-75x what rounding alone gives on this world
(the port on the CPU or the card against the JAX package on the CPU, or
the card against the CPU: at most 3.1e-5 m between centres and 1.3e-5 m
between motions) and far below what a fault gives (the pyramid's sample
positions rounded after the multiply: 0.129 m and 0.069 m; the bench's
degraded PnP: 0.69 m and 0.61 m; PERF.md).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from stereo_visual_slam_tpu_torch.pipeline import trajectory

PATH = os.path.join(os.path.dirname(__file__), "..", "data", "reference_runs.json")
FIELDS = ("state", "keyframe", "n_matches", "n_inliers", "n_new_landmarks")
# a frame whose record differs, or whose pose differs by more than this
# (elementwise, the slice tests' tolerance), is where two runs part
PART_ATOL = 1e-4
ATE_FACTOR = 1.5
ATE_SLACK_M = 0.05
CENTRE_BOUND_M = 1e-3
MOTION_BOUND_M = 1e-3


def load(path: str = PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def records(stats: List[dict], estimates: Dict[int, np.ndarray]) -> List[dict]:
    """One entry a frame of a driver's run (either package's `stats` and
    `estimates`, after finish()), in the file's form; host-driver records
    still pending are skipped, a field a record lacks is None."""
    out = []
    for s in stats:
        if s["state"] == "pending":
            continue
        rec = {"frame_id": int(s["frame_id"])}
        for k in FIELDS:
            v = s.get(k)
            rec[k] = v if v is None or isinstance(v, str) else (
                bool(v) if k == "keyframe" else int(v))
        T = estimates.get(s["frame_id"])
        rec["T_c_w"] = None if T is None else [float(f"{v:.9g}") for v in
                                               np.asarray(T, np.float32).reshape(-1)]
        out.append(rec)
    return out


def _centres(recs: List[dict]) -> Dict[int, np.ndarray]:
    """frame id -> camera centre (-R^T t) of every frame with a pose."""
    out = {}
    for r in recs:
        if r["T_c_w"] is not None:
            T = np.asarray(r["T_c_w"], np.float64).reshape(4, 4)
            out[r["frame_id"]] = -T[:3, :3].T @ T[:3, 3]
    return out


def accuracy(recs: List[dict], gt_T_c_w: np.ndarray) -> dict:
    """ATE (m) and KITTI trans (%) of the run's trajectory against the
    world's poses."""
    fids = [r["frame_id"] for r in recs if r["T_c_w"] is not None]
    est = np.stack([np.asarray(r["T_c_w"], np.float32).reshape(4, 4)
                    for r in recs if r["T_c_w"] is not None])
    t_err, _ = trajectory.kitti_errors(est, gt_T_c_w[fids])
    return dict(ate_m=trajectory.ate_rmse(est, gt_T_c_w[fids]), kitti_trans_pct=t_err)


def compare(recs: List[dict], ref: dict, gt_T_c_w: np.ndarray) -> dict:
    """How far a run (`records(...)`) is from a reference run (an entry of
    the file's "runs"): frames with equal records, the first frame where
    they part, the camera-centre gaps (median, max), the largest gap in
    frame-to-frame motion (the change of camera centre from the previous
    frame with a pose in both), Lost, keyframe counts and both ATEs."""
    rrecs = ref["frames"]
    by_id = {r["frame_id"]: r for r in recs}
    equal = [r["frame_id"] for r in rrecs
             if r["frame_id"] in by_id and all(by_id[r["frame_id"]][k] == r[k] for k in FIELDS)]
    first_part = None
    for r in rrecs:
        o = by_id.get(r["frame_id"])
        if o is None or any(o[k] != r[k] for k in FIELDS) or (
                (o["T_c_w"] is None) != (r["T_c_w"] is None)) or (
                r["T_c_w"] is not None and not np.allclose(o["T_c_w"], r["T_c_w"],
                                                          rtol=0, atol=PART_ATOL)):
            first_part = r["frame_id"]
            break
    c_run, c_ref = _centres(recs), _centres(rrecs)
    common = sorted(set(c_run) & set(c_ref))
    gaps = np.array([np.linalg.norm(c_run[f] - c_ref[f]) for f in common])
    motion = [np.linalg.norm((c_run[b] - c_run[a]) - (c_ref[b] - c_ref[a]))
              for a, b in zip(common, common[1:])]
    worst_motion = int(np.argmax(motion)) if motion else None
    acc = accuracy(recs, gt_T_c_w)
    return dict(
        frames=len(recs), ref_frames=len(rrecs),
        same_frame_ids=[r["frame_id"] for r in recs] == [r["frame_id"] for r in rrecs],
        records_equal=len(equal), first_part=first_part,
        centre_gap_median_m=float(np.median(gaps)) if len(gaps) else None,
        centre_gap_max_m=float(gaps.max()) if len(gaps) else None,
        centre_gap_max_frame=common[int(np.argmax(gaps))] if len(gaps) else None,
        motion_gap_max_m=float(motion[worst_motion]) if motion else None,
        motion_gap_max_frame=common[worst_motion + 1] if motion else None,
        lost=any(r["state"] == "lost" for r in recs),
        ref_lost=any(r["state"] == "lost" for r in rrecs),
        keyframes=sum(bool(r["keyframe"]) for r in recs),
        ref_keyframes=sum(bool(r["keyframe"]) for r in rrecs),
        ate_m=acc["ate_m"], kitti_trans_pct=acc["kitti_trans_pct"], ref_ate_m=ref["ate_m"],
        ate_bound_m=max(ATE_FACTOR * ref["ate_m"], ref["ate_m"] + ATE_SLACK_M),
    )


def misses(gaps: dict) -> List[str]:
    """The parts of the bound a comparison misses (empty: it holds)."""
    out = []
    if not gaps["same_frame_ids"]:
        out.append(f"frame ids differ ({gaps['frames']} frames against {gaps['ref_frames']})")
    if gaps["lost"] or gaps["ref_lost"]:
        out.append(f"Lost (run {gaps['lost']}, reference {gaps['ref_lost']})")
    if abs(gaps["keyframes"] - gaps["ref_keyframes"]) > 1:
        out.append(f"{gaps['keyframes']} keyframes against {gaps['ref_keyframes']}")
    if not gaps["ate_m"] <= gaps["ate_bound_m"]:
        out.append(f"ATE {gaps['ate_m']:.6f} m > {gaps['ate_bound_m']:.6f} m")
    if not gaps["centre_gap_max_m"] <= CENTRE_BOUND_M:
        out.append(f"camera centre {gaps['centre_gap_max_m']:.6f} m from the reference's at "
                   f"frame {gaps['centre_gap_max_frame']} > {CENTRE_BOUND_M} m")
    if not (gaps["motion_gap_max_m"] or 0.0) <= MOTION_BOUND_M:
        out.append(f"frame-to-frame motion {gaps['motion_gap_max_m']:.6f} m from the "
                   f"reference's at frame {gaps['motion_gap_max_frame']} > {MOTION_BOUND_M} m")
    return out


def summary(gaps: dict) -> str:
    return (f"records equal on {gaps['records_equal']} of {gaps['ref_frames']} frames, first "
            f"parts at frame {gaps['first_part']}; camera centres {gaps['centre_gap_median_m']:.6f} m "
            f"apart (median), {gaps['centre_gap_max_m']:.6f} m (max, frame "
            f"{gaps['centre_gap_max_frame']}); frame-to-frame motion at most "
            f"{gaps['motion_gap_max_m']:.6f} m apart (frame {gaps['motion_gap_max_frame']}); "
            f"keyframes {gaps['keyframes']} / {gaps['ref_keyframes']}; ATE {gaps['ate_m']:.6f} m "
            f"(reference {gaps['ref_ate_m']:.6f} m, bound {gaps['ate_bound_m']:.6f} m)")
