"""How `correct` is decided: what a side produced in its run, the plain
reference that follows it (the judge), and the numbers compared.

A side is the program in the window (for the control, the reference itself
in a lower precision, in the program's place). `Capture` keeps, without a
copy or a sync, what its chunk program hands on:
  * `extract`: the batched extraction of each chunk of the first pass
    (keypoints, scores, validity, ANMS picks, descriptor words);
  * `depth`: the lazy stereo depth of each keyframe of the first pass;
  * `steps`: each frame of the first pass, with the state it started from,
    the state it handed on and its record; of later passes, the records;
  * each pass's estimates, as the driver wrote them on the host.

Tracking is chaotic: an inlier on the 4 px line flips on rounding alone,
and from there two sound runs part by decimetres. So the judge follows the
side step by step: frame f runs in the reference from the side's own
state before f, on the reference's own extraction, depth and PnP draws of
the same frame, and its record and the state it hands on are compared with
the side's. What this skips, the hand-over of the state from one frame to
the next, is checked by itself: frame f must start from the state frame
f - 1 handed on, and a pass's first frame from the initial state. So is
the host's part: a pass's estimates must be what its records and its final
state give. A bias of every step under the pose limit would add up over a
pass unseen by the steps, so the first pass's trajectory is also held to
the world's ground truth, which neither side made.

The numbers (each held to a limit of the cell's `limits/<cell>.json`):
  extract_differ  share of keypoint rows whose coordinates, score,
                  validity, ANMS pick or descriptor words differ from the
                  reference's extraction of the same frames;
  depth_differ    share of the keyframes' keypoint rows, valid on either
                  side, whose depth validity differs or whose depths part
                  by more than DEPTH_RTOL of the reference's;
  frames_differ   share of the frames handed in whose step differs: no
                  record; counts or flags of the record or of the state
                  handed on that differ from the reference's step from
                  the same state; a starting state that is not the one
                  handed on; an estimate its records do not give; or, in a
                  later pass, a record unlike the first pass's;
  pose_gap_m      the largest distance between two camera centres that
                  should be one: the side's step and the reference's, of
                  the frame's pose and of every live keyframe's (after
                  BA); a later pass's frame and the first pass's;
  trans_pct       the KITTI translational error (%) of the first pass's
                  estimates against the world's ground truth; its limit is
                  the deployment's published accuracy, not a reading.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

# Depths within this share of each other are one depth: the ZNCC kernel
# matches its plain twin to 2e-5 in score, which moves a sub-pixel
# disparity of 10-90 px by ~1e-4 px (a relative 1e-6 to 1e-5); another
# disparity bin or another keypoint parts them by 1e-2 or more.
DEPTH_RTOL = 1e-4
EXTRACT_FIELDS = ("yx", "score", "valid", "spawn_mask", "packed")
DEPTH_FIELDS = ("disparity", "depth", "depth_valid", "reliable", "pts_cam")
# the counts and flags of a record, and of the state a step hands on
RECORD_FLAGS = ("tracked", "lost", "is_keyframe", "n_matches", "n_inliers", "n_new",
                "ba_ran", "evict_valid", "evict_frame_id")
STATE_FLAGS = (("tstate", "valid"), ("tstate", "lm_id"), ("tstate", "lm_reliable"),
               ("mstate", "reliable"), ("mstate", "inlier"), ("mstate", "kf_frame_id"),
               ("mstate", "kf_count"), (None, "last_frame_id"), (None, "num_lost"),
               (None, "lost"))
NUMBERS = ("extract_differ", "depth_differ", "frames_differ", "pose_gap_m", "trans_pct")


@dataclasses.dataclass
class Pass:
    chunks: int                        # chunks completed
    complete: bool                     # finish() ran after the last chunk
    estimates: Dict[int, np.ndarray]   # as the driver wrote them
    records: dict                      # frame id -> the step's record
    final: object = None               # the state after the last step


@dataclasses.dataclass
class Outputs:
    extract: List[tuple] = dataclasses.field(default_factory=list)
    depth: Dict[int, dict] = dataclasses.field(default_factory=dict)
    steps: List[tuple] = dataclasses.field(default_factory=list)  # (fid, state in, out, record)
    passes: List[Pass] = dataclasses.field(default_factory=list)


class Capture:
    """Wraps the instance attributes a ChunkStep's program calls through
    (`extract`, `depth_fn`, `feats_step`) to keep what they return; the
    calls themselves are unchanged. The port's ChunkStep and the
    reference's have all three. The first pass keeps everything, a later
    one its records."""

    def __init__(self, outputs: Outputs):
        self.outputs = outputs
        self.first = not outputs.passes
        self.records: dict = {}
        self.final = None
        self._frame = None

    def attach(self, chunk_step):
        out = self.outputs
        extract, depth_fn, feats_step = (chunk_step.extract, chunk_step.depth_fn,
                                         chunk_step.feats_step)

        def step(carry, feats, frame_id, *a):
            self._frame = frame_id
            carry2, record = feats_step(carry, feats, frame_id, *a)
            self.records[frame_id] = record
            self.final = carry2
            if self.first:
                out.steps.append((frame_id, carry, carry2, record))
            return carry2, record

        chunk_step.feats_step = step
        if not self.first:
            return

        def captured_extract(images):
            feats = extract(images)
            out.extract.append(tuple(getattr(feats, f) for f in EXTRACT_FIELDS))
            return feats

        def captured_depth(image, feats):
            fields = depth_fn(image, feats)
            out.depth[self._frame] = {k: fields[k] for k in DEPTH_FIELDS}
            return fields

        chunk_step.extract = captured_extract
        chunk_step.depth_fn = captured_depth

    def close(self, slam, chunks: int, complete: bool) -> None:
        """The pass is over: keep its records, final state and estimates."""
        self.outputs.passes.append(Pass(chunks=chunks, complete=complete,
                                        estimates=dict(slam.estimates),
                                        records=self.records, final=self.final))


def stream(make_slam, frames, chunk: int, outputs: Outputs) -> None:
    """One whole pass of `frames` through a fresh driver from
    `make_slam()`, frame by frame, then finish(), captured into `outputs`."""
    slam = make_slam()
    cap = Capture(outputs)
    cap.attach(slam.chunk_step)
    for f in frames:
        slam.process(*f)
    slam.finish()
    cap.close(slam, -(-len(frames) // chunk), True)


def upload(cfg, frames, device) -> torch.Tensor:
    """(n, 2, H, W) uint8 on `device`: frames padded as the drivers pad them."""
    H, W = cfg.padded_hw
    images = torch.zeros((len(frames), 2, H, W), dtype=torch.uint8)
    for i, (_, left, right) in enumerate(frames):
        images[i, 0, :left.shape[0], :left.shape[1]] = torch.from_numpy(left)
        images[i, 1, :right.shape[0], :right.shape[1]] = torch.from_numpy(right)
    return images.to(device)


def _centres(T: torch.Tensor) -> torch.Tensor:
    """Camera centres of poses T_c_w (..., 4, 4), in float64."""
    T = T.double()
    return -(T[..., :3, :3].transpose(-1, -2) @ T[..., :3, 3:4])[..., 0]


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if not a.numel():
        return 0.0
    return float((_centres(a) - _centres(b.to(a.device))).norm(dim=-1).max())


def _equal(a, b) -> bool:
    return torch.equal(torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu())


def _same_state(a, b) -> bool:
    """Two SlamCarry's (either package's) hold equal values."""
    def leaves(c):
        return [*c.tstate, *c.mstate, c.last_frame_id, c.num_lost, c.lost]
    return all(_equal(x, y) for x, y in zip(leaves(a), leaves(b)))


class Judge:
    """The plain reference that follows a side: float32 with TF32 off, or,
    with `tf32`, the control's precision. It draws its own PnP hypotheses
    from the seed and extracts its own features from the frames; `truth`
    holds the world's poses T_c_w, one a frame."""

    def __init__(self, ref_cfg, frames, truth: np.ndarray, seed: int, chunk: int, device,
                 tf32: bool = False):
        from slam_bench.reference import frontend, prng, slam_core

        self.cfg, self.frames, self.truth, self.chunk = ref_cfg, frames, truth, chunk
        self.device = torch.device(device)
        self.tf32 = tf32
        self.key = prng.prng_key(seed)
        self.step = slam_core.ChunkStep(ref_cfg, self.device)
        self.depth_stage = frontend.make_depth_stage(ref_cfg)
        self._feats: Dict[int, tuple] = {}

    def _frame(self, fid: int):
        """(the reference's features of frame fid, its images (2, H, W)),
        the features from its extraction of fid's chunk (kept)."""
        from slam_bench.reference import precision
        from slam_bench.reference.frontend import FrameFeatures

        c, b = divmod(fid, self.chunk)
        if c not in self._feats:
            images = upload(self.cfg, self.frames[c * self.chunk:(c + 1) * self.chunk],
                            self.device)
            with precision(self.tf32):
                self._feats[c] = (self.step.extract(images), images)
        feats, images = self._feats[c]
        return FrameFeatures(*[f[b] for f in feats]), images[b]

    def extraction(self, c: int) -> tuple:
        self._frame(c * self.chunk)
        return tuple(getattr(self._feats[c][0], f) for f in EXTRACT_FIELDS)

    def depth_of(self, fid: int) -> dict:
        from slam_bench.reference import precision

        feats, image = self._frame(fid)
        with precision(self.tf32):
            return self.depth_stage(image, feats)

    def follow(self, fid: int, state):
        """The reference's step of frame fid from `state` (the side's):
        (the state it hands on, its record)."""
        from slam_bench.reference import precision, prng, slam_core, vslam

        feats, image = self._frame(fid)
        cfg = self.cfg
        gumbel, twist = prng.pnp_draws(prng.fold_in(self.key, fid), cfg.pnp.n_hypotheses,
                                       cfg.frontend.max_raw_keypoints, self.device)
        carry = slam_core.SlamCarry(
            tstate=vslam.TrackState(*state.tstate), mstate=slam_core.MapState(*state.mstate),
            last_frame_id=state.last_frame_id, num_lost=state.num_lost, lost=state.lost)
        with precision(self.tf32):
            return self.step.feats_step(carry, feats, fid, gumbel, twist, image)

    def initial_state(self):
        from slam_bench.reference import slam_core

        return slam_core.init_carry(self.cfg, self.device)


def expected_estimates(records: dict, final, complete: bool) -> Dict[int, np.ndarray]:
    """The estimates a driver writes from a pass's records and, once
    finished, its final state (the reference's ChunkedSlam._consume and
    finish, on the side's own records)."""
    est: Dict[int, np.ndarray] = {}
    for fid in sorted(records):
        r = records[fid]
        if bool(r.tracked):
            est[fid] = r.T_c_w.cpu().numpy()
        if bool(r.evict_valid):
            est[int(r.evict_frame_id)] = r.evict_T.cpu().numpy()
    if complete and final is not None:
        m = final.mstate
        ids = m.kf_frame_id.cpu().numpy()
        kf_T = m.kf_T.cpu().numpy()
        for j in np.argsort(ids[:int(m.kf_count)]):
            if ids[j] >= 0:
                est[int(ids[j])] = kf_T[j]
    return est


def trans_pct(estimates: Dict[int, np.ndarray], truth: np.ndarray) -> float:
    """The KITTI translational error (%) of `estimates` (frame id -> T_c_w)
    against the ground truth of the same frames; nan with fewer than two."""
    from slam_bench.reference import trajectory

    fids = sorted(estimates)
    if len(fids) < 2:
        return float("nan")
    return trajectory.kitti_errors(np.stack([estimates[f] for f in fids]), truth[fids])[0]


def compare(side: Outputs, judge: Judge) -> Dict[str, float]:
    """The numbers of NUMBERS for `side`, the judge following it."""
    rows = differ = 0
    for c, mine in enumerate(side.extract):
        theirs = judge.extraction(c)
        if any(a.shape != b.shape for a, b in zip(mine, theirs)):
            # another number of frames or keypoints: every row differs
            rows += theirs[2].numel()
            differ += theirs[2].numel()
            continue
        bad = torch.zeros(mine[2].shape, dtype=torch.bool, device=mine[2].device)
        for a, b in zip(mine, theirs):
            ne = a != b.to(a.device)
            bad |= ne.reshape(*bad.shape, -1).any(-1) if ne.dim() > bad.dim() else ne
        rows += bad.numel()
        differ += int(bad.sum())

    d_rows = d_differ = 0
    for fid, mine in side.depth.items():
        theirs = {k: v.to(mine["depth"].device) for k, v in judge.depth_of(fid).items()}
        vs, vr = mine["depth_valid"], theirs["depth_valid"]
        far = (mine["depth"] - theirs["depth"]).abs() > DEPTH_RTOL * theirs["depth"].abs()
        d_rows += int((vs | vr).sum())
        d_differ += int(((vs != vr) | (vs & vr & far)).sum())

    bad = set()   # (pass, frame id)
    gap = 0.0
    prev = judge.initial_state()
    for fid, state_in, state_out, rec in side.steps:
        ref_out, ref_rec = judge.follow(fid, state_in)
        ok = _same_state(state_in, prev)
        ok &= all(_equal(getattr(rec, k), getattr(ref_rec, k)) for k in RECORD_FLAGS)
        for part, name in STATE_FLAGS:
            a, b = ((s if part is None else getattr(s, part)) for s in (state_out, ref_out))
            ok &= _equal(getattr(a, name), getattr(b, name))
        m = ref_out.mstate
        live = torch.arange(m.kf_T.shape[0], device=m.kf_T.device) < m.kf_count
        gap = max(gap, _gap(rec.T_c_w, ref_rec.T_c_w),
                  _gap(state_out.tstate.T_c_w, ref_out.tstate.T_c_w),
                  _gap(state_out.mstate.kf_T[live.to(state_out.mstate.kf_T.device)],
                       m.kf_T[live]))
        if not ok:
            bad.add((0, fid))
        prev = state_out

    handed = 0
    first = side.passes[0].records if side.passes else {}
    for k, p in enumerate(side.passes):
        expected = range(min(p.chunks * judge.chunk, len(judge.frames)))
        # a driver that is Lost takes no more frames: none is due after it
        lost = [f for f, r in p.records.items() if bool(r.lost)]
        if lost:
            expected = range(min(lost) + 1)
        handed += len(expected)
        bad.update((k, f) for f in expected if f not in p.records)
        est = expected_estimates(p.records, p.final, p.complete)
        bad.update((k, f) for f in set(est) | set(p.estimates)
                   if f not in est or f not in p.estimates
                   or not np.array_equal(est[f], p.estimates[f]))
        if k == 0:
            continue
        for fid, rec in p.records.items():
            r0 = first.get(fid)
            if r0 is None or not all(_equal(getattr(rec, f), getattr(r0, f))
                                     for f in RECORD_FLAGS):
                bad.add((k, fid))
            if r0 is not None:
                gap = max(gap, _gap(rec.T_c_w, r0.T_c_w))
    return dict(extract_differ=differ / max(rows, 1), depth_differ=d_differ / max(d_rows, 1),
                frames_differ=len(bad) / max(handed, 1), pose_gap_m=gap,
                trans_pct=trans_pct(side.passes[0].estimates if side.passes else {},
                                    judge.truth))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is within its limit (a number above it,
    or one that is not a number, fails)."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in NUMBERS)
