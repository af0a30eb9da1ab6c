"""The host-sequenced SLAM driver (port of pipeline/vo.py) — the
reference-sequenced oracle that the chunked path is held against.

The map (`MapStore`, the port's copy of the JAX package's) and the INIT -> TRACK ->
LOST state machine live on the host; each frame is one call of the
branchless `vslam.make_full_step` on the device:

  * on rejection the previous state is kept, so the gates scale with the
    frame gap; more than `max_lost` consecutive rejections blow the fuse;
  * per inserted keyframe the whole BA schedule runs on the device once the
    window is full, and tracking restarts from the optimized pose of the
    newest keyframe when nothing newer is in flight;
  * evicted keyframes stream to the trajectory writer.

Transfers. A frame's images go up from a ring of pinned buffers, each
reused only after the event that follows its copy. What the host may need
of a frame (StepInfo, the feature table a keyframe registers, the
upgrades) leaves the device as ONE stacked float64 tensor, copied
non-blocking into pinned memory right after the dispatch; an event marks
its arrival and `_collect` waits on that event only, never on the whole
device. Ids cross as exact float64 integers and land as int64.

Pipelining: `lookahead=k` dispatches k frames ahead of the one it collects.
The device state chains on the device; keyframe bookkeeping, BA feedback
and the Lost fuse lag by k frames, as in the reference. `lookahead=0` is
exact reference sequencing.

The PnP draws are the JAX driver's: a key chain starts at PRNGKey(seed),
and each submitted frame takes `rng, key = split(rng)` and draws from `key`
(utils/prng.py); a snapshot carries the chain. `noise_fn(frame_id)`, if
given, replaces them. The reference's JAX-only members (`warmup`, its
compile timing) are not ported.
"""

from __future__ import annotations

import collections
import enum
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.ba import schedule as ba_schedule
from stereo_visual_slam_tpu_torch.mapping.store import Keyframe, MapStore
from stereo_visual_slam_tpu_torch.models import frontend as frontend_mod
from stereo_visual_slam_tpu_torch.models import vslam
from stereo_visual_slam_tpu_torch.pipeline import trajectory
from stereo_visual_slam_tpu_torch.utils import prng
from stereo_visual_slam_tpu_torch.utils.config import Config

# columns of the per-frame host table: yx (2), valid, lm_id, lm_pos (3),
# lm_reliable, upgrade
_TABLE_COLS = 9
# StepInfo scalars, then T_c_l and T_c_w (16 each)
_INFO = ("n_matches", "n_inliers", "twist_norm", "angle_y", "ok", "is_keyframe", "n_new")


class TrackState(enum.Enum):
    INIT = 0
    TRACK = 1
    LOST = 2


def _event_on(device: torch.device) -> "torch.cuda.Event":
    """An event recorded on `device`'s current stream, where that device's
    work was queued (the current device may be another card)."""
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class _Fetch:
    """A non-blocking device-to-host copy and the event that marks its end
    (no event on the CPU, where the copy is the tensor itself)."""

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = t.to("cpu", non_blocking=True)
            self.event = _event_on(t.device)
        else:
            self.host, self.event = t, None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _frame_table(state: vslam.TrackState, upgrade: torch.Tensor) -> torch.Tensor:
    """(N, 9) float64: the columns a keyframe registration reads."""
    return torch.cat([
        state.yx, state.valid[:, None], state.lm_id[:, None], state.lm_pos,
        state.lm_reliable[:, None], upgrade[:, None],
    ], dim=1).double()


class VisualOdometry:
    """`device` is required: "cuda" runs the kernels, "cpu" their plain
    versions."""

    def __init__(
        self,
        config: Config,
        pose_path: Optional[str] = None,
        seed: int = 0,
        enable_ba: bool = True,
        lookahead: int = 0,
        *,
        device,
        noise_fn=None,
    ):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VisualOdometry: device 'cuda' requested, but no CUDA device")
        self.extract = frontend_mod.make_extractor(config, self.device)
        self.full_step = vslam.make_full_step(config, self.extract, self.device)
        _, self.keyframe_update = vslam.make_tracker(config, self.device)
        self.run_schedule = ba_schedule.make_ba_schedule(config.ba)
        self.K = vslam.camera_matrix(config, self.device)
        self.map = MapStore(config)
        self.writer = trajectory.TrajectoryWriter(pose_path) if pose_path else None
        self.enable_ba = enable_ba
        self.lookahead = lookahead
        self.noise_fn = noise_fn
        self.rng = prng.prng_key(seed)

        self.state = TrackState.INIT
        self.dstate: Optional[vslam.TrackState] = None
        self.last_frame_id = -1
        self.num_lost = 0
        self.next_lm_id = 0
        self.next_kf_id = 0
        self.syncs = 0            # host waits on device results
        self.estimates: Dict[int, np.ndarray] = {}
        self.stats: List[dict] = []
        # in-flight frames: (frame_id, _Fetch of info + table)
        self.inflight: Deque = collections.deque()
        # deferred BA: (kf_ids, rows, _Fetch of the result)
        self.pending_ba = None
        # pinned upload ring: a slot is rewritten only after the event that
        # follows its last copy
        self._ring = []
        if self.device.type == "cuda":
            self._ring = [
                [torch.zeros((2, *config.padded_hw), dtype=torch.uint8, pin_memory=True), None]
                for _ in range(lookahead + 2)
            ]
        self._ring_pos = 0

    # ------------------------------------------------------------------
    def _upload(self, left: np.ndarray, right: np.ndarray) -> torch.Tensor:
        """Both images as one (2, H, W) uint8 tensor on the device."""
        h, w = left.shape
        if not self._ring:
            buf = torch.zeros((2, *self.config.padded_hw), dtype=torch.uint8)
            buf[0, :h, :w] = torch.from_numpy(np.asarray(left, np.uint8))
            buf[1, :h, :w] = torch.from_numpy(np.asarray(right, np.uint8))
            return buf.to(self.device)
        slot = self._ring[self._ring_pos % len(self._ring)]
        self._ring_pos += 1
        buf, event = slot
        if event is not None:
            event.synchronize()
        host = buf.numpy()
        host[:] = 0
        host[0, :h, :w] = left
        host[1, :h, :w] = right
        images = buf.to(self.device, non_blocking=True)
        slot[1] = _event_on(self.device)
        return images

    def _wait(self, fetch: _Fetch) -> np.ndarray:
        self.syncs += 1
        return fetch.wait()

    # ------------------------------------------------------------------
    def process(self, frame_id: int, left: np.ndarray, right: np.ndarray) -> dict:
        """Feed one stereo frame. With lookahead=0, returns this frame's
        stats; with lookahead>0, those of an earlier frame (or a
        {'state': 'pending'} record while the pipeline fills)."""
        t0 = time.perf_counter()
        if self.state == TrackState.INIT:
            rec = self._initialize(frame_id, left, right)
            rec["wall_s"] = time.perf_counter() - t0
            self.stats.append(rec)
            return rec
        if self.state == TrackState.LOST:
            return dict(frame_id=frame_id, state="lost", wall_s=0.0)

        self._submit(frame_id, left, right)
        if len(self.inflight) > self.lookahead:
            rec = self._collect()
        else:
            rec = dict(frame_id=frame_id, state="pending")
        rec["wall_s"] = time.perf_counter() - t0
        self.stats.append(rec)
        return rec

    def drain(self) -> List[dict]:
        """Collect all in-flight frames (call at the end of a sequence)."""
        out = []
        while self.inflight:
            rec = self._collect()
            self.stats.append(rec)
            out.append(rec)
        return out

    # ------------------------------------------------------------------
    def _initialize(self, frame_id: int, left, right) -> dict:
        """First frame: spawn landmarks from stereo, insert keyframe 0
        (VO::initialization, visual_odometry.cpp:491-545)."""
        feats = self.extract(self._upload(left, right))
        st = vslam.empty_state(self.config, self.device)._replace(
            yx=feats.yx, signs=feats.signs
        )
        st, n_new, _ = self.keyframe_update(st, feats, self.next_lm_id)
        # reserve the id range, as _submit does; the reference does not, so
        # a keyframe at the next frame would reuse these ids
        self.next_lm_id += self.config.frontend.n_features
        self.dstate = st
        table = _frame_table(st, torch.zeros_like(st.valid))
        fetch = _Fetch(torch.cat([n_new.double()[None], st.T_c_w.reshape(-1).double(),
                                  table.reshape(-1)]))
        host = self._wait(fetch)
        self._register_keyframe(frame_id, host[17:].reshape(-1, _TABLE_COLS),
                                host[1:17].reshape(4, 4), upgrades=False)
        self.state = TrackState.TRACK
        self.last_frame_id = frame_id
        self.estimates[frame_id] = np.eye(4, dtype=np.float32)
        return dict(frame_id=frame_id, state="init", keyframe=True,
                    n_landmarks=int(host[0]))

    # ------------------------------------------------------------------
    def _submit(self, frame_id: int, left, right):
        frame_gap = float(max(frame_id - self.last_frame_id, 1))
        images = self._upload(left, right)
        self.rng, key = prng.split(self.rng)
        if self.noise_fn is not None:
            gumbel, twist_noise = self.noise_fn(frame_id)
        else:
            gumbel, twist_noise = prng.pnp_draws(key, self.config.pnp.n_hypotheses,
                                                 self.config.frontend.max_raw_keypoints,
                                                 self.device)
        gap = torch.tensor(frame_gap, dtype=torch.float32, device=self.device)
        new_state, info, upgrade = self.full_step(
            images, self.dstate, gap, gumbel, twist_noise, self.next_lm_id
        )
        # reserve an id range for this frame's potential spawns so frames
        # dispatched ahead never collide
        self.next_lm_id += self.config.frontend.n_features
        self.dstate = new_state
        self.last_frame_id = frame_id
        # start the frame's one host transfer now; _collect waits for it
        head = torch.stack([getattr(info, k).double() for k in _INFO])
        packed = torch.cat([head, info.T_c_l.reshape(-1).double(),
                            info.T_c_w.reshape(-1).double(),
                            _frame_table(new_state, upgrade).reshape(-1)])
        self.inflight.append((frame_id, _Fetch(packed)))

    # ------------------------------------------------------------------
    def _collect(self) -> dict:
        cfg = self.config
        frame_id, fetch = self.inflight.popleft()
        host = self._wait(fetch)           # the one blocking wait per frame
        info = dict(zip(_INFO, host[:len(_INFO)]))
        T_c_w = host[len(_INFO) + 16: len(_INFO) + 32].reshape(4, 4).astype(np.float32)
        self._apply_pending_ba()           # BA dispatched at an earlier keyframe

        if not info["ok"]:
            self.num_lost += 1
            if self.num_lost > cfg.keyframe.max_lost:
                self.state = TrackState.LOST
            return dict(
                frame_id=frame_id,
                state="rejected" if self.state == TrackState.TRACK else "lost",
                n_matches=int(info["n_matches"]),
                n_inliers=int(info["n_inliers"]),
                twist=float(info["twist_norm"]),
            )

        self.num_lost = 0
        is_keyframe = bool(info["is_keyframe"])
        ba_stats = {}
        if is_keyframe:
            table = host[len(_INFO) + 32:].reshape(-1, _TABLE_COLS)
            self._register_keyframe(frame_id, table, T_c_w, upgrades=True)
            if self.enable_ba and self.map.n_keyframes() >= cfg.keyframe.window_size:
                ba_stats = self._run_ba()
            self.estimates[frame_id] = np.asarray(
                self.map.keyframes[self.map.current_keyframe_id].T_c_w
            )
        else:
            self.estimates[frame_id] = T_c_w

        self._drain_evicted()
        return dict(
            frame_id=frame_id,
            state="tracked",
            keyframe=is_keyframe,
            n_matches=int(info["n_matches"]),
            n_inliers=int(info["n_inliers"]),
            n_new_landmarks=int(info["n_new"]),
            twist=float(info["twist_norm"]),
            yaw=float(info["angle_y"]),
            **ba_stats,
        )

    # ------------------------------------------------------------------
    def _register_keyframe(self, frame_id: int, table: np.ndarray, T_c_w: np.ndarray,
                           upgrades: bool):
        """Update the arena map from a keyframe's fetched table
        (VO::insert_key_frame bookkeeping, visual_odometry.cpp:358-427)."""
        yx = table[:, 0:2].astype(np.float32)
        valid = table[:, 2] > 0.5
        lm_id = table[:, 3].astype(np.int64)
        lm_pos = table[:, 4:7].astype(np.float32)
        lm_rel = table[:, 7] > 0.5

        live = valid & (lm_id >= 0)
        known_rows = self.map.rows_of(lm_id)
        is_new = live & (known_rows < 0)
        if is_new.any():
            self.map.spawn(lm_id[is_new], lm_pos[is_new], lm_rel[is_new])

        rows = self.map.rows_of(lm_id)
        known = live & (rows >= 0)
        if upgrades:
            up = known & (table[:, 8] > 0.5) & ~is_new
            if up.any():
                self.map.upgrade(rows[up], lm_pos[up])

        self.map.insert_keyframe(Keyframe(
            keyframe_id=self.next_kf_id,
            frame_id=frame_id,
            T_c_w=np.asarray(T_c_w, np.float32),
            rows=np.where(known, rows, -1).astype(np.int32),
            uv=np.stack([yx[:, 1], yx[:, 0]], axis=-1),
            valid=known,
        ))
        self.next_kf_id += 1

    # ------------------------------------------------------------------
    def _run_ba(self) -> dict:
        """Dispatch the whole BA schedule; the result is fetched at once
        (lookahead 0) or at the next collect."""
        asm = self.map.assemble_schedule_input()
        if asm is None:
            return {}
        arrays, kf_ids, rows = asm
        inp = ba_schedule.ScheduleInput(
            **{k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()}
        )
        res = self.run_schedule(inp, self.K)
        packed = torch.cat([res.cost_full.double()[None], res.cost_pose.double()[None],
                            res.T_c_w.reshape(-1).double(), res.inlier.double()])
        self.pending_ba = (kf_ids, rows, _Fetch(packed))
        if self.lookahead > 0:
            return dict(ba_dispatched=True)
        return self._apply_pending_ba()

    def _apply_pending_ba(self) -> dict:
        if self.pending_ba is None:
            return {}
        kf_ids, rows, fetch = self.pending_ba
        self.pending_ba = None
        host = self._wait(fetch)
        Kw = self.config.keyframe.window_size
        T = host[2:2 + 16 * Kw].reshape(Kw, 4, 4).astype(np.float32)
        inlier = host[2 + 16 * Kw:] > 0.5
        self.map.write_back_schedule(kf_ids, rows, T[:len(kf_ids)], inlier[:len(rows)])
        # feed the optimized pose back into the live tracking state (only
        # meaningful when nothing newer is already in flight)
        T_opt = self.map.keyframes[self.map.current_keyframe_id].T_c_w
        if not self.inflight:
            self.dstate = self.dstate._replace(T_c_w=torch.from_numpy(T_opt).to(self.device))
        for kf in self.map.keyframes.values():
            self.estimates[kf.frame_id] = kf.T_c_w
        return dict(ba_cost=float(host[0]), pose_only_cost=float(host[1]))

    # ------------------------------------------------------------------
    def _drain_evicted(self):
        if self.writer is not None:
            for kf in self.map.evicted:
                self.writer.write(kf.frame_id, kf.T_c_w)
        self.map.evicted.clear()

    def finish(self):
        """Flush in-flight frames + remaining keyframe poses
        (write_remaining_pose, map.cpp:198-204)."""
        self.drain()
        self._apply_pending_ba()
        self._drain_evicted()
        if self.writer is not None:
            for kf_id in sorted(self.map.keyframes):
                kf = self.map.keyframes[kf_id]
                self.writer.write(kf.frame_id, kf.T_c_w)
