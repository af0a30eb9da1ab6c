"""Run the full SLAM pipeline of the PyTorch port on a synthetic sequence
and report its errors (counterpart of examples/run_synthetic.py): the
host-sequenced driver (pipeline/vo.VisualOdometry), frame by frame.

    python -m stereo_visual_slam_tpu_torch.run_synthetic [n_frames] [--no-ba]
        [--device cuda] [--params small.yaml]

Prints a line for the first frames, every 10th frame and each keyframe, then
the ATE, the KITTI errors, the mean keyframe and tracking milliseconds and
the hand kernels' launch counts. The trajectory goes to
synthetic_traj.txt in the temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_frames", nargs="?", type=int, default=60)
    p.add_argument("--no-ba", action="store_true", help="frontend only")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--params", help="YAML config overrides (needs pyyaml)")
    args = p.parse_args(argv)

    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj_mod
    from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry
    from stereo_visual_slam_tpu_torch.utils.config import Config

    cfg = Config()
    if args.params:
        from stereo_visual_slam_tpu_torch.utils import config_io

        cfg = config_io.config_from_yaml(args.params, cfg)
    n_frames = args.n_frames
    vo = VisualOdometry(cfg, pose_path=os.path.join(tempfile.gettempdir(), "synthetic_traj.txt"),
                        enable_ba=not args.no_ba, device=args.device)
    print(f"building world ({n_frames} frames)...")
    world = synthetic.make_world(cfg, n_frames=n_frames, n_points=8000, seed=0)

    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    for f, left, right in synthetic.frames(world):
        rec = vo.process(f, left, right)
        if f < 3 or f % 10 == 0 or rec.get("keyframe"):
            print(
                f"frame {f:4d} {rec['state']:9s} "
                f"kf={int(bool(rec.get('keyframe', False)))} "
                f"inl={rec.get('n_inliers', 0):4d} "
                f"match={rec.get('n_matches', 0):4d} "
                f"new={rec.get('n_new_landmarks', 0):4d} "
                f"{rec['wall_s']*1e3:7.1f} ms"
            )
        if rec["state"] == "lost":
            print("LOST — aborting")
            break
    vo.finish()
    wall = time.perf_counter() - t_start

    fids = sorted(vo.estimates.keys())
    est = np.stack([vo.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    ate = traj_mod.ate_rmse(est, gt)
    t_err, r_err = traj_mod.kitti_errors(est, gt)
    print(f"\ntracked {len(fids)}/{n_frames} frames, {vo.next_kf_id} keyframes in {wall:.1f}s "
          f"on {vo.device}")
    print(f"ATE RMSE: {ate:.3f} m")
    print(f"KITTI-style: trans {t_err:.2f} %  rot {r_err:.4f} deg/m")
    kf_recs = [r for r in vo.stats if r.get("keyframe")]
    tr_recs = [r for r in vo.stats if r["state"] == "tracked" and not r.get("keyframe")]
    if kf_recs:
        print(f"mean keyframe time: {np.mean([r['wall_s'] for r in kf_recs])*1e3:.1f} ms")
    if tr_recs:
        print(f"mean tracking time: {np.mean([r['wall_s'] for r in tr_recs])*1e3:.1f} ms")
    print(f"kernel launches: {json.dumps(kernels.launch_counts())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
