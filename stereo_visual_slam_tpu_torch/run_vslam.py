"""Command-line entry point of the PyTorch port (counterpart of
stereo_visual_slam_tpu/run_vslam.py, chunked path only): loops a stereo
sequence through `ChunkedSlam`, writes the trajectory, reports errors.

Usage:
    python -m stereo_visual_slam_tpu_torch.run_vslam --synthetic 64 --device cuda
    python -m stereo_visual_slam_tpu_torch.run_vslam --dataset /path/to/seq00 \
        [--sequence 00] [--frames N] [--pose-out estimated_traj.txt]

    --chunk N     frames per chunk (default 8)
    --hard        harder synthetic profile (with --synthetic)
    --no-ba       frontend-only ("Without Optimization" row)
    --device D    torch device (default cuda; cpu runs the kernels' plain
                  versions)
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", help="KITTI sequence dir (or dataset root)")
    p.add_argument("--sequence", help="sequence id when --dataset is a root")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="run on an N-frame synthetic sequence instead")
    p.add_argument("--hard", action="store_true",
                   help="harder synthetic profile (with --synthetic)")
    p.add_argument("--frames", type=int, default=0, help="limit frame count")
    p.add_argument("--pose-out", default="estimated_traj.txt")
    p.add_argument("--no-ba", action="store_true")
    p.add_argument("--chunk", type=int, default=8, help="frames per chunk")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)

    import numpy as np

    from stereo_visual_slam_tpu_torch.shared import Config
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam

    base = Config()
    gt = None
    if args.synthetic:
        from stereo_visual_slam_tpu_torch.shared import synthetic

        cfg = base
        world = synthetic.make_world(
            cfg, n_frames=args.synthetic, n_points=8000,
            profile="hard" if args.hard else "default",
        )
        source = synthetic.frames(world)
        n_frames = args.synthetic
        gt = world.poses_T_c_w
    elif args.dataset:
        from stereo_visual_slam_tpu_torch.shared import kitti

        seq = kitti.open_sequence(args.dataset, args.sequence)
        cfg = kitti.config_for(seq, base)
        source = seq.frames()
        n_frames = seq.n_frames
        gt = seq.gt_T_c_w
    else:
        print("need --dataset or --synthetic", file=sys.stderr)
        return 2
    if args.frames:
        n_frames = min(n_frames, args.frames)
    if args.no_ba:
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, enable_ba=False))

    slam = ChunkedSlam(cfg, chunk=args.chunk, pose_path=args.pose_out, device=args.device)
    seen = 0
    t0 = time.perf_counter()
    for f, left, right in source:
        if f >= n_frames:
            break
        slam.process(f, left, right)
        seen = _report(slam, seen, args.quiet)
        if slam.lost:
            print("tracking LOST", file=sys.stderr)
            break
    slam.finish()
    _report(slam, seen, args.quiet)
    wall = time.perf_counter() - t0

    n_done = len(slam.stats)
    n_kf = sum(1 for s in slam.stats if s["keyframe"])
    print(f"processed {n_done} frames, {n_kf} keyframes "
          f"in {wall:.1f}s ({n_done / max(wall, 1e-9):.2f} fps on {slam.device})")
    if gt is not None and len(slam.estimates) > 2:
        from stereo_visual_slam_tpu_torch.shared import trajectory as traj_mod

        fids = sorted(k for k in slam.estimates if k < len(gt))
        est = np.stack([slam.estimates[f] for f in fids])
        t_err, r_err = traj_mod.kitti_errors(est, gt[fids])
        ate = traj_mod.ate_rmse(est, gt[fids])
        print(f"ATE RMSE {ate:.3f} m | KITTI trans {t_err:.2f} % "
              f"rot {r_err:.4f} deg/m")
    return 0


def _report(slam, seen, quiet):
    """Print newly collected frame records (every 50th frame and keyframes)."""
    for rec in slam.stats[seen:]:
        if not quiet and (rec["frame_id"] % 50 == 0 or rec["keyframe"]):
            print(
                f"frame {rec['frame_id']:5d} {rec['state']:9s} "
                f"kf={int(rec['keyframe'])} inl={rec['n_inliers']:4d}",
                flush=True,
            )
    return len(slam.stats)


if __name__ == "__main__":
    sys.exit(main())
