"""The per-frame tracking step (port of models/vslam.py): motion-predicted
Hamming matching against the previous frame, landmark inheritance and
PnP-RANSAC (`track_step`); landmark spawning and depth upgrades at a
keyframe (`keyframe_update`); and `make_full_step`, the host driver's whole
frame (extraction, tracking, the motion-sanity and keyframe rules, the
keyframe update) as branchless tensor code, so its accept / keyframe
decisions are the reference's."""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.models.frontend import FrameFeatures
from stereo_visual_slam_tpu_torch.ops import matcher as matcher_ops
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import trace
from stereo_visual_slam_tpu_torch.utils.config import Config


class TrackState(NamedTuple):
    yx: torch.Tensor           # (N, 2) f32 full-res pixel coords
    valid: torch.Tensor        # (N,) bool live feature
    signs: torch.Tensor        # (N, 256) descriptor
    lm_id: torch.Tensor        # (N,) int32 landmark (arena row), -1 if none
    lm_pos: torch.Tensor       # (N, 3) landmark world position
    lm_reliable: torch.Tensor  # (N,) bool landmark has reliable depth
    T_c_w: torch.Tensor        # (4, 4) pose of this frame
    T_c_l: torch.Tensor        # (4, 4) last relative motion (velocity prior)


class StepInfo(NamedTuple):
    """What the host needs from one full frame step."""

    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    twist_norm: torch.Tensor
    angle_y: torch.Tensor
    T_c_l: torch.Tensor
    ok: torch.Tensor           # () bool motion sanity verdict
    is_keyframe: torch.Tensor  # () bool
    n_new: torch.Tensor        # () int32 landmarks spawned (0 if not keyframe)
    T_c_w: torch.Tensor        # (4, 4) this frame's estimated pose


class TrackInfo(NamedTuple):
    n_matches: torch.Tensor    # () int32 gated matches fed to PnP
    n_inliers: torch.Tensor    # () int32 PnP inliers
    twist_norm: torch.Tensor   # () ||log(T_c_l)||
    angle_y: torch.Tensor      # () |yaw(T_c_l)|
    T_c_l: torch.Tensor        # (4, 4) last -> current


def camera_matrix(config: Config, device) -> torch.Tensor:
    cam = config.camera
    return torch.tensor(
        [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
        dtype=torch.float32, device=device,
    )


def empty_state(config: Config, device) -> TrackState:
    n = config.frontend.max_raw_keypoints
    bits = config.frontend.descriptor_bits
    f32 = dict(dtype=torch.float32, device=device)
    return TrackState(
        yx=torch.zeros((n, 2), **f32),
        valid=torch.zeros((n,), dtype=torch.bool, device=device),
        signs=torch.zeros((n, bits), **f32),
        lm_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        lm_pos=torch.zeros((n, 3), **f32),
        lm_reliable=torch.zeros((n,), dtype=torch.bool, device=device),
        T_c_w=torch.eye(4, **f32),
        T_c_l=torch.eye(4, **f32),
    )


def select(flag: torch.Tensor, a: NamedTuple, b: NamedTuple) -> NamedTuple:
    """Field-wise torch.where(flag, a, b) over two NamedTuples of tensors."""
    return type(a)(*[torch.where(flag, x, y) for x, y in zip(a, b)])


def make_tracker(config: Config, device):
    """(track_step, keyframe_update), closed over the config:

        track_step(curr, prev, T_init, frame_gap, gumbel, twist_noise)
            -> (TrackState, TrackInfo)
        keyframe_update(state, curr, next_lm_id) -> (TrackState, n_new, upgrade)

    On the card, PnP-RANSAC replays as one CUDA graph a frame
    (`pnp.graphed`), shared by every tracker of the process."""
    mc, pc = config.matcher, config.pnp
    K = camera_matrix(config, device)
    solve_pnp = pnp.graphed(
        sample_size=pc.sample_size, inlier_px=pc.inlier_px,
        gn_iters_hypothesis=pc.gn_iters_hypothesis,
        gn_iters_refine=pc.gn_iters_refine, huber_px=pc.huber_px,
    )

    def track_step(curr: FrameFeatures, prev: TrackState, T_init, frame_gap,
                   gumbel, twist_noise):
        with trace.span("track"):
            # predict each tracked landmark in the current frame from the prior
            Xc = se3.act(T_init, prev.lm_pos)
            z = torch.clamp(Xc[:, 2], min=1e-3)
            pred_yx = torch.stack(
                [K[1, 1] * Xc[:, 1] / z + K[1, 2], K[0, 0] * Xc[:, 0] / z + K[0, 2]],
                dim=-1,
            )
            with trace.span("track.match"):
                m = matcher_ops.match(
                    prev.signs, prev.valid, curr.signs, curr.valid, frame_gap,
                    pred_yx=pred_yx, curr_yx=curr.yx,
                    search_radius=mc.search_radius * frame_gap,
                    base_gate=mc.base_gate, min_dist_factor=mc.min_dist_factor,
                    margin=mc.margin,
                )
            trace.add("track.matches", m.mask)
            yx_c = curr.yx[m.idx_curr]
            uv = torch.stack([yx_c[:, 1], yx_c[:, 0]], dim=-1)
            corr_valid = m.mask & prev.valid & (prev.lm_id >= 0)
            with trace.span("track.pnp"):
                res = solve_pnp(
                    prev.lm_pos, uv, corr_valid, K, T_init, gumbel, twist_noise,
                    prior_spread=pc.prior_spread * frame_gap,
                )
            # outside the graph: the replay's cloned outputs
            trace.add("track.inliers", res.n_inliers)
            # current-slot state by gathering through the matcher's
            # current-side view
            src = m.idx_last_of_curr
            tracked = m.mask_curr & res.inlier_mask[src]
            T_c_l = se3.compose(res.T_c_w, se3.inverse(prev.T_c_w))
            new_state = TrackState(
                yx=curr.yx,
                valid=tracked,
                signs=curr.signs,
                lm_id=torch.where(tracked, prev.lm_id[src], -1),
                lm_pos=torch.where(tracked[:, None], prev.lm_pos[src], 0.0),
                lm_reliable=tracked & prev.lm_reliable[src],
                T_c_w=res.T_c_w,
                T_c_l=T_c_l,
            )
            info = TrackInfo(
                n_matches=corr_valid.sum(dtype=torch.int32),
                n_inliers=res.n_inliers,
                twist_norm=torch.linalg.vector_norm(se3.log(T_c_l)),
                angle_y=se3.angle_y(T_c_l),
                T_c_l=T_c_l,
            )
            return new_state, info

    def keyframe_update(state: TrackState, curr: FrameFeatures, next_lm_id: int):
        """Spawn landmarks (ids next_lm_id, next_lm_id + 1, ...) for untracked
        ANMS picks with valid depth and upgrade tracked landmarks whose depth
        just became reliable (VO::insert_key_frame,
        visual_odometry.cpp:348-432)."""
        T_w_c = se3.inverse(state.T_c_w)
        pts_w_new = se3.act(T_w_c, curr.pts_cam)
        upgrade = state.valid & ~state.lm_reliable & curr.reliable
        lm_pos = torch.where(upgrade[:, None], pts_w_new, state.lm_pos)
        lm_rel = state.lm_reliable | upgrade
        new = ~state.valid & curr.valid & curr.spawn_mask & curr.depth_valid
        new_ids = next_lm_id + torch.cumsum(new.to(torch.int32), dim=0) - 1
        out = state._replace(
            valid=state.valid | new,
            lm_id=torch.where(new, new_ids, state.lm_id).to(torch.int32),
            lm_pos=torch.where(new[:, None], pts_w_new, lm_pos),
            lm_reliable=torch.where(new, curr.reliable, lm_rel),
        )
        return out, new.sum(dtype=torch.int32), upgrade

    return track_step, keyframe_update


def make_full_step(config: Config, extract, device):
    """The host driver's frame as one function (vslam.py:222-299):

        full_step(images (2, H, W), prev, frame_gap () f32, gumbel,
                  twist_noise, next_lm_id) -> (TrackState, StepInfo, upgrade)

    ok    = inliers >= min_inliers and ||log(T_c_l)|| <= max_twist * gap
    is_kf = ok and not (inliers >= min_inliers_skip and |yaw| < max_yaw_skip)
    The keyframe update runs on every frame and its result is selected, so
    nothing here waits for the host."""
    track_step, keyframe_update = make_tracker(config, device)
    pc, kc = config.pnp, config.keyframe

    def full_step(images, prev: TrackState, frame_gap, gumbel, twist_noise,
                  next_lm_id: int):
        # constant-velocity prior from the state's own last motion, scaled
        # by the frame gap
        T_init = se3.compose(se3.exp(frame_gap * se3.log(prev.T_c_l)), prev.T_c_w)
        feats = extract(images)
        tracked, tinfo = track_step(feats, prev, T_init, frame_gap, gumbel, twist_noise)
        ok = (tinfo.n_inliers >= pc.min_inliers) & (
            tinfo.twist_norm <= pc.max_twist * frame_gap
        )
        is_kf = ok & ~((tinfo.n_inliers >= kc.min_inliers_skip)
                       & (tinfo.angle_y < kc.max_yaw_skip))
        kf_state, n_new, upgrade = keyframe_update(tracked, feats, next_lm_id)
        state = select(ok, select(is_kf, kf_state, tracked), prev)
        info = StepInfo(
            n_matches=tinfo.n_matches, n_inliers=tinfo.n_inliers,
            twist_norm=tinfo.twist_norm, angle_y=tinfo.angle_y,
            T_c_l=tinfo.T_c_l, ok=ok, is_keyframe=is_kf,
            n_new=torch.where(is_kf, n_new, 0).to(torch.int32),
            T_c_w=state.T_c_w,
        )
        return state, info, upgrade

    return full_step
