"""Split of the per-frame tracking scan on the card: the counterpart of
tools/profile_scan_split.py.

    python -m stereo_visual_slam_tpu_torch.profiling.scan_split [--device cuda] [--r 8]

Production Config() on the first B=8 frames of make_world(cfg, 9, 8000,
seed 0). The first chunk runs through the real step (ChunkStep.feats_step
over its extracted features, frame f's PnP draws from fold_in(PRNGKey(0),
f), as the JAX tool's) to give a mid-sequence carry. Then, with frame 0's
features as the next frame, rows under the JAX tool's labels
(timing.measure: wall, device busy time, launches and syncs per
iteration):

  feats_step   ChunkStep.feats_step from that carry (the keyframe branch
               live: it runs whenever the frame is a keyframe)
  track_step   the ChunkStep's tracker (vslam.make_tracker) on the inputs
               feats_step gives it: the constant-velocity prior and the
               frame gap
  matcher      ops/matcher.match with the config's gates on the inputs
               track_step gives it
  PnP-RANSAC   tracking/pnp.solve_pnp_ransac on the JAX tool's N random
               points, 20 % valid (default_rng(0))

(every row with the draws of PRNGKey(0) itself, the key the JAX tool
passes its rows) and the JAX tool's derived line: insert and map
bookkeeping is about feats_step minus track_step.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.models import slam_core, vslam
from stereo_visual_slam_tpu_torch.ops import matcher as matcher_ops
from stereo_visual_slam_tpu_torch.profiling import production, timing
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import prng

B = production.B
LABELS = ("feats_step (one frame, kf branch live)", "track_step (matcher+PnP+gathers)",
          "matcher", "PnP-RANSAC")


def setup(cfg, device, images: Optional[torch.Tensor] = None) -> dict:
    """The step, the mid-sequence carry after the first chunk, frame 0's
    features and what feats_step hands the tracker and the tracker the
    matcher for the next frame id."""
    device = torch.device(device)
    if images is None:
        images = production.chunk_images(cfg, device, n_world=B + 1)
    N = cfg.frontend.max_raw_keypoints
    step = slam_core.ChunkStep(cfg, device)
    key = prng.prng_key(0)
    noise = prng.frame_draws(key, cfg.pnp.n_hypotheses, N, device)
    feats = step.extract_chunk(images)
    carry = production.feats_scan(step, slam_core.init_carry(cfg, device), feats, images,
                                  list(range(B)), noise)
    fid = int(carry.last_frame_id) + 1
    gumbel, twist_noise = prng.pnp_draws(key, cfg.pnp.n_hypotheses, N, device)
    f0 = production.frame(feats, 0)
    tstate = carry.tstate
    # feats_step's tracker inputs (slam_core.ChunkStep.feats_step)
    frame_gap = torch.clamp((fid - carry.last_frame_id).float(), min=1.0)
    T_init = se3.compose(se3.exp(frame_gap * se3.log(tstate.T_c_l)), tstate.T_c_w)
    # track_step's matcher inputs (vslam.make_tracker)
    K = vslam.camera_matrix(cfg, device)
    Xc = se3.act(T_init, tstate.lm_pos)
    z = torch.clamp(Xc[:, 2], min=1e-3)
    pred_yx = torch.stack([K[1, 1] * Xc[:, 1] / z + K[1, 2], K[0, 0] * Xc[:, 0] / z + K[0, 2]],
                          dim=-1)
    # the JAX tool's PnP problem
    rng = np.random.default_rng(0)
    pts_w = np.stack([rng.uniform(-20, 20, N), rng.uniform(-5, 5, N),
                      rng.uniform(10, 60, N)], -1)
    uv = rng.uniform(0, 1000, (N, 2))
    valid = rng.random(N) < 0.2
    f32 = dict(dtype=torch.float32, device=device)
    return dict(step=step, carry=carry, fid=fid, f0=f0, image=images[0], gumbel=gumbel,
                twist_noise=twist_noise, frame_gap=frame_gap, T_init=T_init, pred_yx=pred_yx,
                K=K, pnp=(torch.tensor(pts_w, **f32), torch.tensor(uv, **f32),
                          torch.tensor(valid, device=device)))


def calls(cfg, s: dict) -> dict:
    """label -> fn() of each row on the setup `s`; each returns the call's
    outputs."""
    mc, pc = cfg.matcher, cfg.pnp
    step, carry, f0, tstate = s["step"], s["carry"], s["f0"], s["carry"].tstate
    gap = s["frame_gap"]
    pts_w, uv, valid = s["pnp"]
    eye = torch.eye(4, dtype=torch.float32, device=step.device)
    return {
        LABELS[0]: lambda: step.feats_step(carry, f0, s["fid"], s["gumbel"], s["twist_noise"],
                                           s["image"]),
        LABELS[1]: lambda: step.track_step(f0, tstate, s["T_init"], gap, s["gumbel"],
                                           s["twist_noise"]),
        LABELS[2]: lambda: matcher_ops.match(
            tstate.signs, tstate.valid, f0.signs, f0.valid, gap,
            pred_yx=s["pred_yx"], curr_yx=f0.yx, search_radius=mc.search_radius * gap,
            base_gate=mc.base_gate, min_dist_factor=mc.min_dist_factor, margin=mc.margin),
        LABELS[3]: lambda: pnp.solve_pnp_ransac(
            pts_w, uv, valid, s["K"], eye, s["gumbel"], s["twist_noise"],
            sample_size=pc.sample_size, inlier_px=pc.inlier_px,
            gn_iters_hypothesis=pc.gn_iters_hypothesis, gn_iters_refine=pc.gn_iters_refine,
            huber_px=pc.huber_px, prior_spread=pc.prior_spread),
    }


def run(cfg, device, r: int = 8, best_of: int = 3,
        images: Optional[torch.Tensor] = None) -> dict:
    """Every row measured on `device`. `images`: the first B frames to use
    instead of rendering make_world's."""
    device = timing.require(device)
    s = setup(cfg, device, images)
    rows = [timing.measure(fn, label, device, r, best_of)
            for label, fn in calls(cfg, s).items()]
    by = {row["label"]: row for row in rows}
    step_row, track_row = by[LABELS[0]], by[LABELS[1]]
    derived = dict(label="insert+map bookkeeping ~ feats_step - track_step",
                   wall_ms=step_row["wall_ms"] - track_row["wall_ms"])
    if step_row["device_ms"] is not None:
        derived["device_ms"] = step_row["device_ms"] - track_row["device_ms"]
    return dict(timing.header("scan_split", device, r, best_of), frame_id=s["fid"],
                rows=rows, derived=derived)


def render(result: dict) -> str:
    d = result["device"]
    der = result["derived"]
    dev = der.get("device_ms")
    return "\n".join([
        timing.table(result["rows"], f"tracking scan split on {d['card'] or d['kind']}, "
                                     f"frame {result['frame_id']}, r={result['r']}, "
                                     f"best of {result['best_of']}"),
        f"{der['label']}: {der['wall_ms']:.3f} ms wall"
        + ("" if dev is None else f", {dev:.3f} ms device")])


def main(argv=None) -> int:
    return timing.cli("scan_split", __doc__, run, render, default_r=8, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
