"""The SLAM core on the device (port of models/slam_core.py).

State lives on the device between frames: `MapState` is the landmark arena
(L rows) with its (L, Kw) observation grid and the keyframe window;
`SlamCarry` adds the tracking state and the Lost fuse. One chunk is a
batched extraction of its frames followed by a Python loop over them.

Control flow that the JAX program expresses as `lax.cond` becomes a host
branch: per frame, ONE device-to-host fetch brings `is_kf & ~lost` and the
window's keyframe count, which also decides whether BA runs
(`kf_count >= Kw` after insertion). Rejection keeps the previous tracking
state through `torch.where`. The map needs no select: the keyframe branch
only runs for accepted frames.

`.at[row].set(..., mode="drop")` with the sentinel row L becomes an
`index_put` into a buffer with one spare row that absorbs the sentinel;
real rows are unique there (asserted by the tests), so the write is
deterministic on CUDA.

With a landmark mesh (utils/dist.LandmarkMesh) every rank runs this same
loop on the same frames with the whole state: the BA schedule is sharded
by landmark rows, extraction is data-parallel when the mesh divides the
chunk, and the per-frame branch fetch takes rank 0's values, so that every
rank makes the one decision the JAX program makes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.ba import schedule as ba_schedule
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.models import frontend as frontend_mod
from stereo_visual_slam_tpu_torch.models import vslam
from stereo_visual_slam_tpu_torch.models.frontend import FrameFeatures
from stereo_visual_slam_tpu_torch.utils import trace
from stereo_visual_slam_tpu_torch.utils.config import Config


class MapState(NamedTuple):
    """Sliding-window map: L = ba.max_landmarks arena rows, Kw ordered
    keyframe slots (0 oldest)."""

    pos: torch.Tensor          # (L, 3) landmark world positions
    reliable: torch.Tensor     # (L,) bool
    inlier: torch.Tensor       # (L,) bool
    obs_mask: torch.Tensor     # (L, Kw) f32 1.0 where observed
    obs_uv: torch.Tensor       # (L, Kw, 2) f32 pixel (u, v)
    kf_T: torch.Tensor         # (Kw, 4, 4) keyframe poses T_c_w
    kf_frame_id: torch.Tensor  # (Kw,) int32, -1 = empty slot
    kf_count: torch.Tensor     # () int32 live keyframes


class FrameRecord(NamedTuple):
    """What the host learns about one frame (device scalars)."""

    frame_id: int
    tracked: torch.Tensor
    lost: torch.Tensor
    is_keyframe: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    n_new: torch.Tensor
    twist: torch.Tensor
    angle_y: torch.Tensor
    T_c_w: torch.Tensor
    ba_ran: bool
    ba_cost: torch.Tensor
    evict_valid: torch.Tensor
    evict_frame_id: torch.Tensor
    evict_T: torch.Tensor


class SlamCarry(NamedTuple):
    tstate: vslam.TrackState
    mstate: MapState
    last_frame_id: torch.Tensor  # () int32 last accepted frame
    num_lost: torch.Tensor       # () int32 consecutive failures
    lost: torch.Tensor           # () bool fuse blown


def empty_map(config: Config, device) -> MapState:
    L = config.ba.max_landmarks
    Kw = config.keyframe.window_size
    f32 = dict(dtype=torch.float32, device=device)
    return MapState(
        pos=torch.zeros((L, 3), **f32),
        reliable=torch.zeros((L,), dtype=torch.bool, device=device),
        inlier=torch.zeros((L,), dtype=torch.bool, device=device),
        obs_mask=torch.zeros((L, Kw), **f32),
        obs_uv=torch.zeros((L, Kw, 2), **f32),
        kf_T=torch.eye(4, **f32).repeat(Kw, 1, 1),
        kf_frame_id=torch.full((Kw,), -1, dtype=torch.int32, device=device),
        kf_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def init_carry(config: Config, device) -> SlamCarry:
    return SlamCarry(
        tstate=vslam.empty_state(config, device),
        mstate=empty_map(config, device),
        last_frame_id=torch.full((), -1, dtype=torch.int32, device=device),
        num_lost=torch.zeros((), dtype=torch.int32, device=device),
        lost=torch.zeros((), dtype=torch.bool, device=device),
    )


def carry_to_numpy(carry: SlamCarry) -> Dict[str, np.ndarray]:
    """The carry under the JAX snapshot's key names and dtypes
    (`tstate_*`, `mstate_*`, `carry_*`, pipeline/chunked.py:558-566)."""
    out = {}
    for part in ("tstate", "mstate"):
        for name, t in getattr(carry, part)._asdict().items():
            out[f"{part}_{name}"] = t.detach().cpu().numpy()
    for name in ("last_frame_id", "num_lost", "lost"):
        out[f"carry_{name}"] = getattr(carry, name).detach().cpu().numpy()
    return out


def carry_from_numpy(data, device) -> SlamCarry:
    """Inverse of `carry_to_numpy`; reads a JAX snapshot's arrays too."""
    def t(key):
        return torch.from_numpy(np.array(data[key])).to(device)

    return SlamCarry(
        tstate=vslam.TrackState(**{n: t(f"tstate_{n}") for n in vslam.TrackState._fields}),
        mstate=MapState(**{n: t(f"mstate_{n}") for n in MapState._fields}),
        last_frame_id=t("carry_last_frame_id"),
        num_lost=t("carry_num_lost"),
        lost=t("carry_lost"),
    )


def _allocate_rows(free: torch.Tensor, want: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign the k-th wanting slot the k-th free arena row. Returns
    (row per slot (N,) int32, -1 where not served; n_alloc () int32)."""
    L = free.shape[0]
    order = torch.argsort(torch.where(free, 0, 1), stable=True)   # free rows first
    n_free = free.sum()
    rank = torch.cumsum(want.to(torch.int64), dim=0) - 1
    served = want & (rank < n_free)
    rows = torch.where(served, order[torch.clamp(rank, 0, L - 1)], -1)
    return rows.to(torch.int32), served.sum(dtype=torch.int32)


def _set_rows(arr: torch.Tensor, rows: torch.Tensor, vals, col: Optional[int] = None):
    """`arr.at[rows(, col)].set(vals, mode="drop")` for rows in [0, L] where
    L (= arr.shape[0]) means "drop": the write goes to a copy with one spare
    row that absorbs the sentinel."""
    ext = torch.cat([arr, arr[:1]], dim=0)
    idx = (rows.long(),) if col is None else (rows.long(), torch.full_like(rows, col).long())
    ext[idx] = vals.to(arr.dtype) if torch.is_tensor(vals) else vals
    return ext[:-1]


class ChunkStep:
    """The production chunk program: batched extraction, then the B frames
    in order with the state on the device.

        step(carry, images (n, 2, H, W) u8, frame_ids, noise)
            -> (carry', [FrameRecord] * n)

    `noise(frame_ids)` returns the chunk's PnP draws, one (gumbel (H, N),
    twist_noise (H, 6)) pair a frame (`utils/prng.frame_draws`: the JAX
    chunk program's). `syncs` counts the host's waits on the device
    (`wait`)."""

    def __init__(self, config: Config, device, mesh=None):
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh
        self.syncs = 0
        # lazy stereo (the production default): depth in the keyframe branch
        # only; with frontend.lazy_depth=False the extractor computes it
        lazy = config.frontend.lazy_depth
        self.extract = frontend_mod.make_batch_extractor(
            config, self.device, with_depth=not lazy
        )
        self.depth_fn = frontend_mod.make_depth_stage(config) if lazy else None
        self.track_step, _ = vslam.make_tracker(config, self.device)
        self.run_schedule = ba_schedule.make_ba_schedule(config.ba, mesh=mesh)
        self.K = vslam.camera_matrix(config, self.device)
        Kw = config.keyframe.window_size
        self._eye4 = torch.eye(4, dtype=torch.float32, device=self.device)
        self._slots = torch.arange(Kw, device=self.device)
        fixed = torch.zeros((Kw,), dtype=torch.float32, device=self.device)
        if config.ba.fix_oldest_pose:
            fixed[0] = 1.0
        self._fixed_pose = fixed

    # ------------------------------------------------------------------ host
    def wait(self):
        """A context around one host wait that the driver makes on purpose
        (the branch fetch, a chunk's record fetch, a staged chunk's upload):
        counted in `syncs` and traced as a `driver.wait` span."""
        self.syncs += 1
        return trace.span("driver.wait")

    def fetch(self, *scalars: torch.Tensor) -> List[int]:
        """One device-to-host sync for a few integer/bool scalars. On a
        mesh, rank 0's values: a rank that alone took the keyframe branch
        would wait forever in the BA's first collective."""
        vals = torch.stack([s.to(torch.int64) for s in scalars])
        if self.mesh is not None:
            vals = self.mesh.broadcast(vals)
        with self.wait():
            return vals.tolist()

    def extract_chunk(self, images: torch.Tensor) -> FrameFeatures:
        """Batched extraction; on a mesh whose size divides B, rank r
        extracts its B/n frames and every rank assembles the B tables."""
        m = self.mesh
        with trace.span("extract"):
            if m is None or images.shape[0] % m.size:
                return self.extract(images)
            feats = self.extract(images[m.rows(images.shape[0])])
            return FrameFeatures(*[m.all_gather(f) for f in feats])

    # ---------------------------------------------------------------- insert
    def insert_keyframe(self, tstate, mstate, feats, frame_id: int, kf_count: int):
        """VO::insert_key_frame + Map::insert_keyframe / remove_keyframe /
        clean_map as tensor ops. kf_count is the window's count before the
        insertion (known on the host from the branch fetch).
        Returns (tstate', mstate', n_new, (evict_valid, evict_fid, evict_T))."""
        kc = self.config.keyframe
        Kw = kc.window_size
        L = mstate.pos.shape[0]
        T_w_c = se3.inverse(tstate.T_c_w)
        pts_w_new = se3.act(T_w_c, feats.pts_cam)

        # upgrade: a tracked landmark gains reliable depth
        upgrade = tstate.valid & ~tstate.lm_reliable & feats.reliable
        lm_pos = torch.where(upgrade[:, None], pts_w_new, tstate.lm_pos)
        lm_rel = tstate.lm_reliable | upgrade

        # spawn: untracked ANMS pick with valid depth; rows the tracker still
        # references must not be reallocated (scatter-max, sentinel row L)
        ref_rows = torch.where(tstate.valid & (tstate.lm_id >= 0), tstate.lm_id, L).long()
        referenced = torch.zeros(L + 1, dtype=torch.float32, device=self.device).scatter_reduce(
            0, ref_rows, torch.ones_like(ref_rows, dtype=torch.float32), reduce="amax"
        )[:L]
        occupied = mstate.obs_mask.amax(dim=1) + referenced
        want = ~tstate.valid & feats.valid & feats.spawn_mask & feats.depth_valid
        new_rows, n_new = _allocate_rows(occupied <= 0, want)
        spawned = new_rows >= 0
        lm_id = torch.where(spawned, new_rows, tstate.lm_id)
        lm_pos = torch.where(spawned[:, None], pts_w_new, lm_pos)
        lm_rel = torch.where(spawned, feats.reliable, lm_rel)
        valid = tstate.valid | spawned

        srow = torch.where(spawned, new_rows, L)
        urow = torch.where(upgrade & ~spawned, tstate.lm_id, L)
        pos = _set_rows(_set_rows(mstate.pos, srow, pts_w_new), urow, pts_w_new)
        reliable = _set_rows(_set_rows(mstate.reliable, srow, feats.reliable), urow, True)
        inlier = _set_rows(mstate.inlier, srow, True)

        # window slots: evict before inserting when full, by the reference
        # rule relative to the new keyframe (map.cpp:48-130)
        full = kf_count >= Kw
        rel = se3.compose(mstate.kf_T, T_w_c[None])
        d = torch.linalg.vector_norm(se3.log(rel), dim=-1)
        slot_live = self._slots < kf_count
        d_min = torch.where(slot_live, d, float("inf"))
        d_max = torch.where(slot_live, d, float("-inf"))
        victim = torch.where(
            d_min.amin() < kc.eviction_min_dist, torch.argmin(d_min), torch.argmax(d_max)
        )
        evict_frame_id = mstate.kf_frame_id[victim]
        evict_T = mstate.kf_T[victim]

        idx = self._slots
        if full:
            perm = torch.clamp(torch.where(idx >= victim, idx + 1, idx), 0, Kw - 1)
            keep = idx < Kw - 1
        else:
            perm = idx
            keep = idx < kf_count
        obs_mask = torch.where(keep[None, :], mstate.obs_mask[:, perm], 0.0)
        obs_uv = torch.where(keep[None, :, None], mstate.obs_uv[:, perm], 0.0)
        kf_T = torch.where(keep[:, None, None], mstate.kf_T[perm], self._eye4)
        kf_frame_id = torch.where(keep, mstate.kf_frame_id[perm], -1)
        slot = min(kf_count, Kw - 1)

        # the new keyframe's observation column
        wrow = torch.where(valid, lm_id, L)
        obs_mask = _set_rows(obs_mask, wrow, 1.0, col=slot)
        uv = torch.stack([tstate.yx[:, 1], tstate.yx[:, 0]], dim=-1)
        obs_uv = _set_rows(obs_uv, wrow, uv, col=slot)
        kf_T = kf_T.clone()
        kf_T[slot] = tstate.T_c_w
        kf_frame_id = kf_frame_id.clone()
        kf_frame_id[slot] = frame_id

        tstate2 = tstate._replace(valid=valid, lm_id=lm_id, lm_pos=lm_pos, lm_reliable=lm_rel)
        mstate2 = MapState(
            pos=pos, reliable=reliable, inlier=inlier, obs_mask=obs_mask,
            obs_uv=obs_uv, kf_T=kf_T, kf_frame_id=kf_frame_id,
            kf_count=torch.clamp(mstate.kf_count + 1, max=Kw),
        )
        evict_valid = torch.full((), full, dtype=torch.bool, device=self.device)
        return tstate2, mstate2, n_new, (evict_valid, evict_frame_id, evict_T)

    # -------------------------------------------------------------------- BA
    def run_ba(self, tstate, mstate, kf_count: int):
        """The per-keyframe schedule on the map arrays; tracking continues
        from the optimized pose of the newest keyframe."""
        inp = ba_schedule.ScheduleInput(
            T_c_w=mstate.kf_T, points=mstate.pos, uv=mstate.obs_uv,
            obs_mask=mstate.obs_mask, inlier=mstate.inlier.float(),
            reliable=mstate.reliable.float(),
            present=(mstate.obs_mask.amax(dim=1) > 0).float(),
            pose_mask=(self._slots < kf_count).float(),
            fixed_pose=self._fixed_pose,
        )
        res = self.run_schedule(inp, self.K)
        mstate2 = mstate._replace(kf_T=res.T_c_w, inlier=res.inlier)
        return tstate._replace(T_c_w=res.T_c_w[kf_count - 1]), mstate2, res.cost_full

    # ------------------------------------------------------------ frame step
    def feats_step(self, carry: SlamCarry, feats: FrameFeatures, frame_id: int,
                   gumbel, twist_noise, image) -> Tuple[SlamCarry, FrameRecord]:
        cfg = self.config
        pc, kc = cfg.pnp, cfg.keyframe
        Kw = kc.window_size
        N = cfg.frontend.max_raw_keypoints
        dev = self.device
        tstate, mstate = carry.tstate, carry.mstate
        is_first = mstate.kf_count == 0
        frame_gap = torch.clamp((frame_id - carry.last_frame_id).float(), min=1.0)

        # constant-velocity prior scaled by the frame gap
        T_init = se3.compose(se3.exp(frame_gap * se3.log(tstate.T_c_l)), tstate.T_c_w)
        tracked_state, tinfo = self.track_step(
            feats, tstate, T_init, frame_gap, gumbel, twist_noise
        )
        ok = (tinfo.n_inliers >= pc.min_inliers) & (
            tinfo.twist_norm <= pc.max_twist * frame_gap
        )
        is_kf = ok & ~((tinfo.n_inliers >= kc.min_inliers_skip) & (tinfo.angle_y < kc.max_yaw_skip))
        # first frame: identity pose, everything spawns, always a keyframe
        ok = ok | is_first
        is_kf = is_kf | is_first
        first_state = tstate._replace(
            yx=feats.yx, signs=feats.signs,
            valid=torch.zeros((N,), dtype=torch.bool, device=dev),
            lm_id=torch.full((N,), -1, dtype=torch.int32, device=dev),
            T_c_w=self._eye4, T_c_l=self._eye4,
        )
        base = vslam.select(is_first, first_state, tracked_state)

        # the host branch: one fetch per frame
        branch, kf_count = self.fetch(is_kf & ~carry.lost, mstate.kf_count)
        zero_f = torch.zeros((), dtype=torch.float32, device=dev)
        if branch:
            # is_kf implies ok, so this frame is accepted: the map needs no
            # select against the previous one
            if self.depth_fn is not None:
                with trace.span("keyframe.depth"):
                    feats = feats._replace(**self.depth_fn(image, feats))
            with trace.span("keyframe.insert"):
                new_t, new_m, n_new, evict = self.insert_keyframe(
                    base, mstate, feats, frame_id, kf_count
                )
            ba_ran = cfg.ba.enable_ba and min(kf_count + 1, Kw) >= Kw
            ba_cost = zero_f
            if ba_ran:
                with trace.span("keyframe.ba"):
                    new_t, new_m, ba_cost = self.run_ba(new_t, new_m, Kw)
        else:
            new_t, new_m, ba_ran, ba_cost = base, mstate, False, zero_f
            n_new = torch.zeros((), dtype=torch.int32, device=dev)
            evict = (torch.zeros((), dtype=torch.bool, device=dev),
                     torch.full((), -1, dtype=torch.int32, device=dev), self._eye4)

        # rejection keeps the previous tracking state (the gap gates grow)
        accept = ok & ~carry.lost
        new_t = vslam.select(accept, new_t, tstate)
        num_lost = torch.where(accept, 0, carry.num_lost + 1).to(torch.int32)
        lost = carry.lost | (num_lost > kc.max_lost)
        record = FrameRecord(
            frame_id=frame_id, tracked=accept, lost=lost,
            is_keyframe=is_kf & accept, n_matches=tinfo.n_matches,
            n_inliers=tinfo.n_inliers, n_new=n_new, twist=tinfo.twist_norm,
            angle_y=tinfo.angle_y, T_c_w=new_t.T_c_w,
            ba_ran=ba_ran, ba_cost=ba_cost,
            evict_valid=evict[0], evict_frame_id=evict[1], evict_T=evict[2],
        )
        carry2 = SlamCarry(
            tstate=new_t, mstate=new_m,
            last_frame_id=torch.where(accept, frame_id, carry.last_frame_id).to(torch.int32),
            num_lost=num_lost, lost=lost,
        )
        return carry2, record

    # ----------------------------------------------------------------- chunk
    def __call__(self, carry: SlamCarry, images: torch.Tensor, frame_ids,
                 noise: Callable[[Sequence[int]], Sequence[Tuple[torch.Tensor, torch.Tensor]]]):
        feats = self.extract_chunk(images)
        records = []
        for b, (fid, (gumbel, twist_noise)) in enumerate(zip(frame_ids, noise(frame_ids))):
            with trace.span("frame", frame=fid):
                frame = FrameFeatures(*[f[b] for f in feats])
                carry, rec = self.feats_step(carry, frame, fid, gumbel, twist_noise, images[b])
            records.append(rec)
        return carry, records
