# Frozen copy of stereo_visual_slam_tpu_torch/pipeline/chunked.py at commit c627a7a, part of
# the benchmark's plain reference: trimmed to the streamed path.
"""The chunked host loop of the plain reference: a trimmed copy of the
port's pipeline/chunked.py. It keeps the streamed path the benchmark's
window drives (`process`, `flush`, `finish`) and drops staging, the
rolling window, snapshots, the map views and the mesh.

The host stacks B frames into a uint8 (B, 2, H, W) buffer, copies it to
the device, runs the chunk step (slam_core.ChunkStep) and fetches the
chunk's frame records. Frame f's PnP draws come from fold_in(PRNGKey(seed),
f) (prng.py), as in the port.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from slam_bench.reference import prng, slam_core
from slam_bench.reference.config import Config


def _to_host(records: List[slam_core.FrameRecord]) -> List[dict]:
    """All tensor fields of a chunk's records to the host."""
    fields = [f for f in slam_core.FrameRecord._fields
              if torch.is_tensor(getattr(records[0], f))]
    host = {f: torch.stack([getattr(r, f) for r in records]).cpu() for f in fields}
    out = []
    for i, r in enumerate(records):
        row = {f: host[f][i].numpy() for f in fields}
        row["frame_id"] = r.frame_id
        row["ba_ran"] = r.ba_ran
        out.append(row)
    return out


class ChunkedSlam:
    """The reference's driver: `device` is any torch device; every op is a
    plain torch op there."""

    def __init__(self, config: Config, chunk: int = 8, seed: int = 0, *, device):
        self.config = config
        self.chunk = chunk
        self.device = torch.device(device)
        self.chunk_step = slam_core.ChunkStep(config, self.device)
        self.carry = slam_core.init_carry(config, self.device)
        self.key = prng.prng_key(seed)
        self._upload = torch.zeros((chunk, 2, *config.padded_hw), dtype=torch.uint8)
        self._upload_hw = np.zeros((chunk, 2), np.int64)
        self.pending: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.estimates: Dict[int, np.ndarray] = {}
        self.stats: List[dict] = []
        self.evictions: List[Tuple[int, np.ndarray]] = []
        self.lost = False

    def process(self, frame_id: int, left: np.ndarray, right: np.ndarray):
        """Feed one frame; a full chunk runs at once."""
        if self.lost:
            return
        self.pending.append((frame_id, left, right))
        if len(self.pending) >= self.chunk:
            frames, self.pending = self.pending[: self.chunk], self.pending[self.chunk:]
            self._dispatch(*self._fill(frames))

    def flush(self):
        """Run any buffered partial chunk."""
        if self.pending and not self.lost:
            self._dispatch(*self._fill(self.pending))
        self.pending = []

    def _fill(self, frames):
        """Write frames into the host buffer (zeroing a margin a smaller
        frame leaves) and copy the chunk to the device."""
        host = self._upload.numpy()
        hw = self._upload_hw
        for i, (_, left, right) in enumerate(frames):
            h, w = left.shape
            if h < hw[i, 0] or w < hw[i, 1]:
                host[i] = 0
            hw[i] = (h, w)
            host[i, 0, :h, :w] = left
            host[i, 1, :h, :w] = right
        images = self._upload[:len(frames)].to(self.device)
        return images, [f for f, _, _ in frames]

    def _dispatch(self, images: torch.Tensor, fids: List[int]):
        self.carry, records = self.chunk_step(self.carry, images, fids, self._draws)
        self._consume(_to_host(records))

    def _draws(self, fids: List[int]):
        """The chunk's PnP draws: one threefry pass for all its frames."""
        cfg = self.config
        return prng.frame_draws(self.key, cfg.pnp.n_hypotheses,
                                cfg.frontend.max_raw_keypoints, self.device)(fids)

    def _consume(self, rows: List[dict]):
        for row in rows:
            fid = row["frame_id"]
            lost = bool(row["lost"])
            tracked = bool(row["tracked"])
            if lost:
                self.lost = True
            self.stats.append(dict(
                frame_id=fid,
                state="lost" if lost else ("tracked" if tracked else "rejected"),
                keyframe=bool(row["is_keyframe"]),
                n_matches=int(row["n_matches"]),
                n_inliers=int(row["n_inliers"]),
                n_new_landmarks=int(row["n_new"]),
                twist=float(row["twist"]),
                ba_cost=float(row["ba_cost"]) if row["ba_ran"] else None,
            ))
            if tracked:
                self.estimates[fid] = row["T_c_w"].copy()
            if row["evict_valid"]:
                efid = int(row["evict_frame_id"])
                eT = row["evict_T"].copy()
                self.evictions.append((efid, eT))
                self.estimates[efid] = eT

    def finish(self):
        """Flush and write the remaining window poses (write_remaining_pose,
        map.cpp:198-204)."""
        self.flush()
        m = self.carry.mstate
        kf_ids = m.kf_frame_id.cpu().numpy()
        kf_T = m.kf_T.cpu().numpy()
        count = int(m.kf_count)
        for j in np.argsort(kf_ids[:count]):
            fid = int(kf_ids[j])
            if fid < 0:
                continue
            self.estimates[fid] = kf_T[j]
