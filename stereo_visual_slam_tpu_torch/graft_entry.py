"""Driver entry points of the PyTorch port (counterpart of the repo's
__graft_entry__.py): the per-frame step as one callable, and a dry run of
the production chunk step on a landmark mesh.

    python -m stereo_visual_slam_tpu_torch.graft_entry [--device cuda]
    python -m stereo_visual_slam_tpu_torch.graft_entry dryrun [N] [--device cuda]

`dryrun N` joins an N-rank group: from torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR, MASTER_PORT; one process per rank), or, with none
set and N=1, a one-rank group in this process (nccl on a card, gloo on the
CPU). `--params small.yaml` overrides the full-size Config().
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.utils.config import Config


def entry(device, config: Config | None = None):
    """(fn, example_args): the per-frame forward step - feature extraction
    (stereo depth included) followed by descriptor matching, landmark
    inheritance and PnP-RANSAC - as one callable

        fn(left, right, prev_state, T_init, frame_gap, gumbel, twist_noise)
            -> (TrackState, TrackInfo)

    The example previous state has live random landmarks and descriptors
    (numpy's default_rng(0)), so that the PnP path is real; the PnP draws
    are those of PRNGKey(0), the key the JAX entry point passes."""
    from stereo_visual_slam_tpu_torch.models import frontend as frontend_mod
    from stereo_visual_slam_tpu_torch.models import vslam
    from stereo_visual_slam_tpu_torch.utils import prng

    cfg = Config() if config is None else config
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: device 'cuda' requested, but no CUDA device")
    extract = frontend_mod.make_extractor(cfg, device)
    track_step, _ = vslam.make_tracker(cfg, device)

    def step(left, right, prev_state, T_init, frame_gap, gumbel, twist_noise):
        feats = extract(torch.stack([left, right]))
        return track_step(feats, prev_state, T_init, frame_gap, gumbel, twist_noise)

    H, W = cfg.padded_hw
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    left, right = f32(rng.uniform(0, 255, (H, W))), f32(rng.uniform(0, 255, (H, W)))
    # n live previous features (the ANMS target), as the JAX entry point
    # draws them; the tracker takes any number of previous rows
    n = cfg.frontend.n_features
    prev = vslam.empty_state(cfg, device)._replace(
        valid=torch.ones((n,), dtype=torch.bool, device=device),
        lm_id=torch.arange(n, dtype=torch.int32, device=device),
        lm_pos=f32(np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                             rng.uniform(10, 60, n)], axis=-1)),
        signs=f32(np.where(rng.integers(0, 2, (n, cfg.frontend.descriptor_bits)), 1.0, -1.0)),
    )
    gumbel, twist_noise = prng.pnp_draws(prng.prng_key(0), cfg.pnp.n_hypotheses, n, device)
    example_args = (left, right, prev, torch.eye(4, dtype=torch.float32, device=device),
                    torch.tensor(1.0, device=device), gumbel, twist_noise)
    return step, example_args


def dryrun_multichip(n_devices: int, device, config: Config | None = None,
                     n_frames: int = 16, chunk: int = 8, n_points: int = 6000) -> dict:
    """The production chunk step (models/slam_core.ChunkStep) with the BA
    schedule sharded over an n-rank landmark mesh, at the shapes of
    `config` (default: full-size Config()) with every tracked frame a
    keyframe, so that the window fills and the sharded BA runs within a
    short sequence. Asserts no Lost, keyframes in the window and BA run on
    the mesh; rank 0 prints the summary line. Returns the run's summary."""
    from stereo_visual_slam_tpu_torch.data import render_pool, synthetic
    from stereo_visual_slam_tpu_torch.models import slam_core
    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils
    from stereo_visual_slam_tpu_torch.utils import prng

    base = Config() if config is None else config
    cfg = base.replace(keyframe=dataclasses.replace(base.keyframe, min_inliers_skip=10**6))
    if cfg.ba.max_landmarks % n_devices:
        raise ValueError(f"{cfg.ba.max_landmarks} landmark rows do not divide over "
                         f"{n_devices} ranks")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: device 'cuda' requested, but no CUDA device")
    created = dist_utils.initialize_distributed(device=device)
    try:
        mesh = dist_utils.make_landmark_mesh(n_devices)
        if mesh is None:
            return {}   # a rank beyond the mesh holds no landmarks
        H, W = cfg.padded_hw
        h, w = cfg.image_hw
        world = synthetic.make_world(cfg, n_frames=n_frames, n_points=n_points, seed=0)
        step = slam_core.ChunkStep(cfg, device, mesh)
        carry = slam_core.init_carry(cfg, device)
        noise = prng.frame_draws(prng.prng_key(0), cfg.pnp.n_hypotheses,
                                 cfg.frontend.max_raw_keypoints, device)
        images = torch.zeros((chunk, 2, H, W), dtype=torch.uint8)
        records = []
        for f, left, right in render_pool.Renderer(0).frames(world):
            images[f % chunk, 0, :h, :w] = torch.from_numpy(left)
            images[f % chunk, 1, :h, :w] = torch.from_numpy(right)
            if f % chunk == chunk - 1:
                fids = list(range(f - chunk + 1, f + 1))
                carry, recs = step(carry, images.to(device), fids, noise)
                records += recs
        lost = any(bool(r.lost) for r in records)
        ba_ran = any(r.ba_ran for r in records)
        kf_count = int(carry.mstate.kf_count)
        if lost:
            raise AssertionError("dryrun lost tracking")
        if kf_count <= 0:
            raise AssertionError("dryrun inserted no keyframe")
        if not ba_ran:
            raise AssertionError("sharded BA schedule never executed")
        fe = cfg.frontend
        if mesh.rank == 0:
            print(
                f"dryrun_multichip({n_devices}): production chunked step sharded over "
                f"{n_devices} devices — {n_frames} frames, kf_count={kf_count}, BA executed "
                f"sharded — OK [full-size config: image {h}x{w} (padded {H}x{W}), "
                f"N={fe.max_raw_keypoints} kp, {fe.n_levels}-level pyramid, "
                f"L={cfg.ba.max_landmarks}, Kw={cfg.keyframe.window_size}]", flush=True)
        return dict(rank=mesh.rank, size=mesh.size, backend=torch.distributed.get_backend(),
                    kf_count=kf_count, ba_runs=sum(r.ba_ran for r in records),
                    keyframes=sum(bool(r.is_keyframe) for r in records),
                    frames=len(records), T_c_w=carry.tstate.T_c_w.cpu().numpy())
    finally:
        if created:
            dist_utils.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", nargs="?", choices=("entry", "dryrun"), default="entry")
    p.add_argument("n_devices", nargs="?", type=int, default=1)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--params", help="YAML config overrides (needs pyyaml)")
    args = p.parse_args(argv)
    cfg = Config()
    if args.params:
        from stereo_visual_slam_tpu_torch.utils import config_io

        cfg = config_io.config_from_yaml(args.params, cfg)
    if args.mode == "dryrun":
        dryrun_multichip(args.n_devices, args.device, cfg)
        return 0
    fn, example_args = entry(args.device, cfg)
    out = fn(*example_args)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    print(f"entry() ran OK on {args.device}: {int(out[1].n_matches)} matches, "
          f"{int(out[1].n_inliers)} inliers")
    return 0


if __name__ == "__main__":
    sys.exit(main())
