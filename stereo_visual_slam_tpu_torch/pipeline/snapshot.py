"""Checkpoint / resume of the host driver (port of pipeline/snapshot.py).

The whole `VisualOdometry` state — landmark arena, keyframe window, the
counters and the device TrackState — goes to one compressed npz under the
JAX package's keys, so a snapshot of either package's host driver loads
into the other. The counterpart of the chunked driver's carry conversion
(`slam_core.carry_to_numpy` / `carry_from_numpy`).

The `rng` entry is the driver's PRNG key chain (utils/prng.py), as in the
JAX package, so a resumed driver draws what the JAX driver draws after the
same resume.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.mapping.store import Keyframe
from stereo_visual_slam_tpu_torch.models import vslam

SNAPSHOT_VERSION = 1


def save_snapshot(vo, path: str):
    """Serialize a VisualOdometry's full state (drains the pipeline first
    so nothing is in flight)."""
    vo.drain()
    vo._apply_pending_ba()
    m = vo.map
    kf_ids = sorted(m.keyframes)
    kfs = [m.keyframes[k] for k in kf_ids]
    data = dict(
        version=np.int64(SNAPSHOT_VERSION),
        pos=m.pos, reliable=m.reliable, inlier=m.inlier, obs_count=m.obs_count,
        row_id=m.row_id, alive=m.alive, id_to_row=m.id_to_row,
        kf_ids=np.array(kf_ids, np.int64),
        kf_frame_ids=np.array([kf.frame_id for kf in kfs], np.int64),
        kf_T=np.stack([kf.T_c_w for kf in kfs]) if kfs else np.zeros((0, 4, 4), np.float32),
        kf_rows=np.stack([kf.rows for kf in kfs]) if kfs else np.zeros((0, 0), np.int32),
        kf_uv=np.stack([kf.uv for kf in kfs]) if kfs else np.zeros((0, 0, 2), np.float32),
        kf_valid=np.stack([kf.valid for kf in kfs]) if kfs else np.zeros((0, 0), bool),
        current_keyframe_id=np.int64(m.current_keyframe_id),
        next_lm_id=np.int64(vo.next_lm_id),
        next_kf_id=np.int64(vo.next_kf_id),
        last_frame_id=np.int64(vo.last_frame_id),
        num_lost=np.int64(vo.num_lost),
        vo_state=np.int64(vo.state.value),
        rng=np.array(vo.rng, np.uint32),
    )
    if vo.dstate is not None:
        for name, t in vo.dstate._asdict().items():
            data[f"dstate_{name}"] = t.cpu().numpy()
    np.savez_compressed(path, **data)


def load_snapshot(vo, path: str):
    """Restore a snapshot of either package's host driver into a
    VisualOdometry built with the same Config."""
    from stereo_visual_slam_tpu_torch.pipeline.vo import TrackState as VoState

    z = np.load(path, allow_pickle=False)
    assert int(z["version"]) == SNAPSHOT_VERSION
    m = vo.map
    for name in ("pos", "reliable", "inlier", "obs_count", "row_id", "alive", "id_to_row"):
        setattr(m, name, z[name].copy())
    m._free = [int(r) for r in np.nonzero(~m.alive)[0][::-1]]
    m.keyframes = {}
    for i, kf_id in enumerate(z["kf_ids"]):
        m.keyframes[int(kf_id)] = Keyframe(
            keyframe_id=int(kf_id),
            frame_id=int(z["kf_frame_ids"][i]),
            T_c_w=z["kf_T"][i].copy(),
            rows=z["kf_rows"][i].copy(),
            uv=z["kf_uv"][i].copy(),
            valid=z["kf_valid"][i].copy(),
        )
    m.current_keyframe_id = int(z["current_keyframe_id"])

    # a reference snapshot taken on its first frame has not reserved the
    # ids it spawned there
    vo.next_lm_id = max(int(z["next_lm_id"]), int(m.row_id.max(initial=-1)) + 1)
    vo.next_kf_id = int(z["next_kf_id"])
    vo.last_frame_id = int(z["last_frame_id"])
    vo.num_lost = int(z["num_lost"])
    vo.state = VoState(int(z["vo_state"]))
    vo.rng = tuple(int(k) for k in z["rng"])
    if "dstate_yx" in z:
        vo.dstate = vslam.TrackState(**{
            name: torch.from_numpy(np.array(z[f"dstate_{name}"])).to(vo.device)
            for name in vslam.TrackState._fields
        })
