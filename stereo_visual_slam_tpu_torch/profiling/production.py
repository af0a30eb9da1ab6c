"""Per-phase table of the production chunk program on the card: the
counterpart of tools/profile_production.py.

    python -m stereo_visual_slam_tpu_torch.profiling.production [--device cuda] [--r 6]

Production Config() on make_world(cfg, 8, 8000, seed 0), the B=8 frames
packed to (8, 2, H, W) uint8 on the device as the driver packs them. Rows,
under the JAX tool's labels, each measured by timing.measure (wall, device
busy time, launches and syncs per iteration):

  chunk_step        ChunkStep.__call__ from init_carry each iteration, the
                    JAX tool's PnP draws, fold_in(PRNGKey(0), frame id)
                    (no BA: the window is empty)
  batch_extract     ChunkStep.extract_chunk
  feats scan        the 8 ChunkStep.feats_step calls on the chunk's
                    precomputed features, from init_carry each iteration
  BA schedule       make_ba_schedule(cfg.ba) at Kw, L of the config on the
                    JAX tool's random window
  the extractor's stages, the very calls batch_extract makes
  (frontend.ExtractStages): the pyramid resize, detect (FAST+NMS kernel,
  border, pooled top-k), box blur, describe (`describe_levels`: one patch
  gather kernel launch for every level + BRIEF per level) at the JAX
  tool's random keypoints, ANMS at its random (B, N) keypoints,
  and the stereo search (ZNCC kernel) over the stacked B*N keypoints.

The random inputs come from one np.random.default_rng(0) in the JAX tool's
order (BA points, uv, the per-level keypoints, the ANMS keypoints and
scores). The host's share is each composed row's wall minus its device
time: on the TPU the composed program was one dispatch, here the host
dispatches every launch.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.ba import schedule as ba_schedule
from stereo_visual_slam_tpu_torch.data import synthetic
from stereo_visual_slam_tpu_torch.models import slam_core, vslam
from stereo_visual_slam_tpu_torch.models.frontend import ExtractStages, FrameFeatures
from stereo_visual_slam_tpu_torch.profiling import timing
from stereo_visual_slam_tpu_torch.utils import prng

B = 8
N_POINTS = 8000
# the JAX tool's draw ranges for the ANMS/stereo keypoints (rows, cols),
# cut to the image for smaller configs
ANMS_YX_HIGH = (350, 1200)
COMPOSED = 3  # the first three rows: chunk_step, batch_extract, feats scan
# extract_by_stages's stages, in its order ("blur" runs inside "describe")
STAGES = ("pyramid", "score", "topk", "describe", "blur", "anms", "stereo")


def labels(cfg) -> List[str]:
    """The JAX tool's row labels (its pyramid and level counts are the
    config's)."""
    n = cfg.frontend.n_levels
    return [f"chunk_step B={B} (no-BA window)", f"batch_extract B={B}",
            f"feats scan B={B} (no-BA window)", "BA schedule (per keyframe)",
            f"  pyramid resize ({n - 1} levels)", "  detect: score maps + nms_topk",
            f"  box blur ({n} levels)", f"  describe ({n} levels)", "  anms",
            "  stereo zncc sweep"]


def pack(cfg, frames, device) -> torch.Tensor:
    """(n, 2, H, W) uint8 on `device` of frames [(id, left, right)], each
    image at the top left of the padded shape."""
    H, W = cfg.padded_hw
    stacked = np.zeros((len(frames), 2, H, W), np.uint8)
    for i, (_, left, right) in enumerate(frames):
        h, w = left.shape
        stacked[i, 0, :h, :w] = left
        stacked[i, 1, :h, :w] = right
    return torch.from_numpy(stacked).to(device)


def chunk_images(cfg, device, n_world: int = B) -> torch.Tensor:
    """The first B frames of make_world(cfg, n_world, 8000, seed 0), packed."""
    world = synthetic.make_world(cfg, n_frames=n_world, n_points=N_POINTS, seed=0)
    frames = [f for f in synthetic.frames(world) if f[0] < B]
    return pack(cfg, frames, device)


def frame(feats: FrameFeatures, b: int) -> FrameFeatures:
    return FrameFeatures(*[f[b] for f in feats])


def feats_scan(step, carry, feats, images, frame_ids, noise):
    """The frame loop of ChunkStep.__call__ on precomputed features, with
    the chunk's draws `noise(frame_ids)`."""
    for b, (fid, (gumbel, twist_noise)) in enumerate(zip(frame_ids, noise(frame_ids))):
        carry, _ = step.feats_step(carry, frame(feats, b), fid, gumbel, twist_noise, images[b])
    return carry


def extract_by_stages(st: ExtractStages, images: torch.Tensor, with_depth: bool = False,
                      scope: Callable = lambda stage: contextlib.nullcontext()):
    """batch_extract composed from the stage rows' calls, stage by stage:
    the pyramid, the score maps and the pooled top-k at every level, the
    blur at every level and one `describe_levels` for all of them, the
    levels' table (which runs ANMS), the depth. Its FrameFeatures equal batch_extract's. Each stage's calls run
    inside `scope(stage)`, stage one of STAGES ("blur" inside "describe")."""
    n = len(st.levels)
    with scope("pyramid"):
        left = images[:, 0].float()
        pyramid = [st.level_image(left, i) for i in range(n)]
    with scope("score"):
        scored = [st.score_map(i, pyramid[i]) for i in range(n)]
    with scope("topk"):
        tops = [st.topk(i, score) for i, (_, score) in enumerate(scored)]
    with scope("describe"):
        with scope("blur"):
            blurred = [st.blur(stacked) for stacked, _ in scored]
        described = st.describe_levels(blurred, [yx for _, yx in tops])
    with scope("anms"):
        table = st.table([(s, yx, p, g) for (s, yx), (p, g) in zip(tops, described)])
    with scope("stereo"):
        depth = st.depth(images, table) if with_depth else None
    return st.features(table, depth)


def random_inputs(cfg, st: ExtractStages, device):
    """The JAX tool's random inputs, drawn in its order from one
    default_rng(0): the BA window (points, uv), the keypoints of every
    level, the ANMS keypoints and scores."""
    fe = cfg.frontend
    Kw, L = cfg.keyframe.window_size, cfg.ba.max_landmarks
    vh, vw = cfg.image_hw
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
                    rng.uniform(10, 60, L)], -1)
    uv = rng.uniform(0, 1000, (L, Kw, 2))
    f32 = dict(dtype=torch.float32, device=device)
    fixed = torch.zeros((Kw,), **f32)
    fixed[0] = 1.0
    window = ba_schedule.ScheduleInput(
        T_c_w=torch.eye(4, **f32).repeat(Kw, 1, 1),
        points=torch.tensor(pts, **f32), uv=torch.tensor(uv, **f32),
        obs_mask=torch.ones((L, Kw), **f32), inlier=torch.ones((L,), **f32),
        reliable=torch.ones((L,), **f32), present=torch.ones((L,), **f32),
        pose_mask=torch.ones((Kw,), **f32), fixed_pose=fixed)
    yxs = [torch.tensor(np.stack([rng.integers(24, h_i - 24, (B, budget)),
                                  rng.integers(24, w_i - 24, (B, budget))], -1),
                        dtype=torch.int32, device=device)
           for _, (h_i, w_i), _, budget in st.levels]
    N = fe.max_raw_keypoints
    hy, hx = min(ANMS_YX_HIGH[0], vh - 24), min(ANMS_YX_HIGH[1], vw - 24)
    yxN = torch.tensor(np.stack([rng.integers(24, hy, (B, N)), rng.integers(24, hx, (B, N))], -1),
                       dtype=torch.int32, device=device)
    scN = torch.tensor(rng.uniform(0, 50, (B, N)), **f32)
    return window, yxs, yxN, scN


def phases(cfg, device, images: Optional[torch.Tensor] = None):
    """[(label, fn, frames per call)] of every row, set up on `device`:
    fn() runs one iteration of the row's calls."""
    device = torch.device(device)
    if images is None:
        images = chunk_images(cfg, device)
    fe = cfg.frontend
    step = slam_core.ChunkStep(cfg, device)
    st = step.extract.stages
    noise = prng.frame_draws(prng.prng_key(0), cfg.pnp.n_hypotheses, fe.max_raw_keypoints,
                             device)
    fids = list(range(B))
    feats0 = step.extract_chunk(images)
    carry0 = slam_core.init_carry(cfg, device)
    window, yxs, yxN, scN = random_inputs(cfg, st, device)
    run_schedule = ba_schedule.make_ba_schedule(cfg.ba)
    K = vslam.camera_matrix(cfg, device)

    n = len(st.levels)
    H, W = cfg.padded_hw
    left = images[:, 0].float()
    pyramid = [st.level_image(left, i) for i in range(n)]
    stacked = [pyramid[i].reshape(B * lv[2][0], lv[2][1]).contiguous()
               for i, lv in enumerate(st.levels)]
    blurred = [st.blur(s) for s in stacked]
    left_st = left.reshape(B * H, W).contiguous()
    right_st = images[:, 1].float().reshape(B * H, W).contiguous()
    row_off = (torch.arange(B, dtype=torch.int32, device=device) * H)[:, None]
    BN = B * fe.max_raw_keypoints
    yx_st = torch.stack([yxN[..., 0] + row_off, yxN[..., 1]], -1).reshape(BN, 2).contiguous()
    all_valid = torch.ones((BN,), dtype=torch.bool, device=device)

    fns = [
        (lambda: step(carry0, images, fids, noise), B),
        (lambda: step.extract_chunk(images), B),
        (lambda: feats_scan(step, carry0, feats0, images, fids, noise), B),
        (lambda: run_schedule(window, K), None),
        (lambda: [st.level_image(left, i) for i in range(1, n)], B),
        (lambda: [st.detect(i, pyramid[i]) for i in range(n)], B),
        (lambda: [st.blur(s) for s in stacked], B),
        (lambda: st.describe_levels(blurred, yxs), B),
        (lambda: st.anms(yxN, scN), B),
        (lambda: st.stereo(left_st, right_st, yx_st, all_valid), B),
    ]
    return [(label, fn, per) for label, (fn, per) in zip(labels(cfg), fns)]


def run(cfg, device, r: int = 6, best_of: int = 3, composed_r: Optional[int] = None,
        images: Optional[torch.Tensor] = None) -> dict:
    """Every row measured on `device`; `composed_r` (default r) is the r of
    the chunk_step and feats scan rows, the longest. `images`: the chunk
    to use instead of rendering make_world's first B frames."""
    device = timing.require(device)
    rows = []
    for i, (label, fn, per) in enumerate(phases(cfg, device, images)):
        r_i = composed_r if composed_r and i in (0, 2) else r
        rows.append(timing.measure(fn, label, device, r_i, best_of, per=per))
    host = [dict(label=row["label"], wall_ms=row["wall_ms"], device_ms=row["device_ms"],
                 host_ms=row["host_ms"],
                 host_share=None if row["host_ms"] is None else row["host_ms"] / row["wall_ms"])
            for row in rows[:COMPOSED]]
    return dict(timing.header("production", device, r, best_of), composed_r=composed_r or r,
                B=B, image_hw=list(cfg.image_hw), rows=rows, host_share=host)


def render(result: dict) -> str:
    d = result["device"]
    out = [timing.table(result["rows"], f"production chunk program on {d['card'] or d['kind']}, "
                                        f"B={result['B']}, r={result['r']}, "
                                        f"best of {result['best_of']}")]
    out.append("# the host's share (wall - device) of the composed rows")
    for h in result["host_share"]:
        share = "-" if h["host_share"] is None else f"{h['host_share']:.3f}"
        host = "-" if h["host_ms"] is None else f"{h['host_ms']:.3f} ms"
        out.append(f"{h['label']:40s} host {host} of {h['wall_ms']:.3f} ms wall (share {share})")
    return "\n".join(out)


def main(argv=None) -> int:
    return timing.cli("production", __doc__, run, render, default_r=6, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
