"""Command-line entry point of the PyTorch port (counterpart of
stereo_visual_slam_tpu/run_vslam.py): loops a stereo sequence through the
chunked SLAM core (default) or the host-sequenced driver, writes the
trajectory, reports errors.

Usage:
    python -m stereo_visual_slam_tpu_torch.run_vslam --synthetic 64 --device cuda
    python -m stereo_visual_slam_tpu_torch.run_vslam --dataset /path/to/seq00 \
        [--sequence 00] [--frames N] [--pose-out estimated_traj.txt]

    --device D              torch device (default cuda; cpu runs the kernels'
                            plain versions)
    --cpu                   the same as --device cpu
    --mesh-devices N        shard the BA schedule's landmarks over N ranks
                            (chunked driver; 1 without --distributed: a
                            one-rank group in this process)
    --distributed           join a torch.distributed group from torchrun's
                            environment (RANK, WORLD_SIZE, LOCAL_RANK,
                            MASTER_ADDR, MASTER_PORT) and shard over all its
                            ranks unless --mesh-devices says fewer; a CUDA
                            --device becomes cuda:LOCAL_RANK (nccl), the CPU
                            stays the CPU (gloo); only rank 0 prints and
                            writes
    --driver chunked|host   execution path (default: chunked)
    --chunk N               frames per chunk (chunked driver)
    --rolling K             chunked driver: at most K staged chunks ahead
    --lookahead N           host driver: pipeline depth
    --hard                  harder synthetic profile (with --synthetic)
    --params params.yaml    YAML config overrides (needs pyyaml)
    --no-ba                 frontend-only ("Without Optimization" row)
    --plot out.png          bird's-eye trajectory figure (needs matplotlib)
    --ply out.ply           landmark cloud export
    --record out.jsonl      per-frame structured log
    --viz-every N           chunked driver: live pose/cloud every N frames
    --snapshot out.npz      save the SLAM state at the end
    --resume in.npz         restore a state before processing
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
    p.add_argument("--params", help="YAML config overrides")
    p.add_argument("--pose-out", default="estimated_traj.txt")
    p.add_argument("--no-ba", action="store_true")
    p.add_argument("--driver", choices=("chunked", "host"), default="chunked")
    p.add_argument("--rolling", type=int, default=0, metavar="K",
                   help="chunked driver: bounded stage-ahead mode, at most K "
                        "chunks on the device (ChunkedSlam.run_rolling)")
    p.add_argument("--chunk", type=int, default=8, help="chunked driver: frames per chunk")
    p.add_argument("--lookahead", type=int, default=0, help="host driver: pipeline depth")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (= --device cpu)")
    p.add_argument("--mesh-devices", type=int, default=0, metavar="N",
                   help="shard the BA schedule over N ranks (0: off, or every "
                        "rank with --distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="initialize torch.distributed from torchrun's environment")
    p.add_argument("--plot", help="write trajectory plot PNG")
    p.add_argument("--ply", help="write landmark cloud PLY")
    p.add_argument("--record", help="write per-frame JSONL log")
    p.add_argument("--viz-every", type=int, default=0, metavar="N",
                   help="emit live viz (pose+keyframes JSONL, landmark cloud "
                        "PLY) every N frames during the run (chunked driver)")
    p.add_argument("--viz-dir", default="viz_live", help="directory for --viz-every output")
    p.add_argument("--snapshot", help="save state snapshot at the end")
    p.add_argument("--resume", help="load state snapshot before running")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if not (args.distributed or args.mesh_devices):
        return _main(args, None)
    if args.driver != "chunked":
        print("--mesh-devices and --distributed run the chunked driver", file=sys.stderr)
        return 2

    import torch
    import torch.distributed as dist

    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils

    if args.distributed and torch.device(args.device).type == "cuda":
        args.device = f"cuda:{dist_utils.local_rank()}"
    # without --distributed this process is the only rank
    ranks = {} if args.distributed else dict(world_size=1, rank=0)
    created = dist_utils.initialize_distributed(device=args.device, **ranks)
    try:
        have = dist.get_world_size()
        if args.mesh_devices > have:
            print(f"need {args.mesh_devices} devices, have {have}", file=sys.stderr)
            return 2
        mesh = dist_utils.make_landmark_mesh(args.mesh_devices)
        if mesh is None:
            return 0  # a rank beyond the mesh holds no landmarks
        return _main(args, mesh)
    finally:
        if created:
            dist_utils.shutdown()


def _main(args, mesh):
    import numpy as np

    from stereo_visual_slam_tpu_torch.pipeline import viz
    from stereo_visual_slam_tpu_torch.utils.config import Config

    base = Config()
    if args.params:
        from stereo_visual_slam_tpu_torch.utils import config_io

        base = config_io.config_from_yaml(args.params, base)
    gt = None
    if args.synthetic:
        from stereo_visual_slam_tpu_torch.data import synthetic

        cfg = base
        world = synthetic.make_world(
            cfg, n_frames=args.synthetic, n_points=8000,
            profile="hard" if args.hard else "default",
        )
        source = synthetic.frames(world)
        n_frames = args.synthetic
        gt = world.poses_T_c_w
    elif args.dataset:
        from stereo_visual_slam_tpu_torch.data import kitti

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

    # on a mesh only rank 0 prints, records and shows; ChunkedSlam withholds
    # the other ranks' pose file and snapshots itself
    args.reports = mesh is None or mesh.rank == 0
    if not args.reports:
        args.quiet, args.record, args.viz_every = True, None, 0
    recorder = viz.TrajectoryRecorder(args.record) if args.record else None
    # closing the source joins a dataset's prefetch workers, however the run
    # ended: finished, Lost or cut by --frames
    try:
        if args.driver == "chunked":
            slam, wall, n_done, n_kf = _run_chunked(args, cfg, source, n_frames, recorder, mesh)
        else:
            slam, wall, n_done, n_kf = _run_host(args, cfg, source, n_frames, recorder)
    finally:
        source.close()
    if not args.reports:
        return 0
    print(f"processed {n_done} frames, {n_kf} keyframes "
          f"in {wall:.1f}s ({n_done / max(wall, 1e-9):.2f} fps on {slam.device})")

    if gt is not None and len(slam.estimates) > 2:
        from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj_mod

        fids = sorted(k for k in slam.estimates if k < len(gt))
        est = np.stack([slam.estimates[f] for f in fids])
        t_err, r_err = traj_mod.kitti_errors(est, gt[fids])
        ate = traj_mod.ate_rmse(est, gt[fids])
        print(f"ATE RMSE {ate:.3f} m | KITTI trans {t_err:.2f} % "
              f"rot {r_err:.4f} deg/m")
    if args.plot:
        viz.plot_trajectory(slam.estimates, args.plot, gt, slam.map)
        print(f"wrote {args.plot}")
    if args.ply:
        viz.export_landmarks_ply(slam.map, args.ply)
        print(f"wrote {args.ply}")
    if args.snapshot:
        if args.driver == "chunked":
            slam.save_snapshot(args.snapshot)
        else:
            from stereo_visual_slam_tpu_torch.pipeline.snapshot import save_snapshot

            save_snapshot(slam, args.snapshot)
        print(f"wrote {args.snapshot}")
    return 0


def _bounded(source, n_frames):
    for f, left, right in source:
        if f >= n_frames:
            break
        yield f, left, right


def _run_chunked(args, cfg, source, n_frames, recorder, mesh):
    """The production path: the chunked SLAM core."""
    from stereo_visual_slam_tpu_torch.pipeline import viz
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam

    if args.no_ba:
        cfg = cfg.replace(ba=dataclasses.replace(cfg.ba, enable_ba=False))
    slam = ChunkedSlam(cfg, chunk=args.chunk, pose_path=args.pose_out, device=args.device,
                       mesh=mesh)
    if args.resume:
        slam.load_snapshot(args.resume)
    live_viz = viz.LiveViz(args.viz_dir, every=args.viz_every) if args.viz_every else None
    seen = 0
    t0 = time.perf_counter()
    if args.rolling:
        def progress():
            nonlocal seen
            seen = _report(slam.stats, seen, slam.estimates, recorder, args.quiet)
            if live_viz is not None and slam.stats:
                live_viz.tick(slam, slam.stats[-1]["frame_id"])

        slam.run_rolling(_bounded(source, n_frames), window_chunks=args.rolling,
                         on_progress=progress)
    else:
        for f, left, right in _bounded(source, n_frames):
            slam.process(f, left, right)
            seen = _report(slam.stats, seen, slam.estimates, recorder, args.quiet)
            if live_viz is not None:
                live_viz.tick(slam, f)
            if slam.lost:
                break
    if slam.lost and args.reports:
        print("tracking LOST", file=sys.stderr)
    slam.finish()
    _report(slam.stats, seen, slam.estimates, recorder, args.quiet)
    if live_viz is not None and slam.stats:
        live_viz.tick(slam, slam.stats[-1]["frame_id"], force=True)
    wall = time.perf_counter() - t0
    n_kf = sum(1 for s in slam.stats if s["keyframe"])
    return slam, wall, len(slam.stats), n_kf


def _run_host(args, cfg, source, n_frames, recorder):
    """The reference-sequenced host driver."""
    from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry

    vo = VisualOdometry(cfg, pose_path=args.pose_out, enable_ba=not args.no_ba,
                        lookahead=args.lookahead, device=args.device)
    if args.resume:
        from stereo_visual_slam_tpu_torch.pipeline.snapshot import load_snapshot

        load_snapshot(vo, args.resume)
    seen = 0
    t0 = time.perf_counter()
    for f, left, right in _bounded(source, n_frames):
        rec = vo.process(f, left, right)
        seen = _report(vo.stats, seen, vo.estimates, recorder, args.quiet)
        if rec["state"] == "lost":
            print("tracking LOST", file=sys.stderr)
            break
    vo.finish()
    _report(vo.stats, seen, vo.estimates, recorder, args.quiet)
    wall = time.perf_counter() - t0
    # this run's records only: a resumed state's frames and keyframes are
    # not counted
    done = [s for s in vo.stats if s["state"] != "pending"]
    return vo, wall, len(done), sum(1 for s in done if s.get("keyframe"))


def _report(stats, seen, estimates, recorder, quiet):
    """Stream new frame records to the recorder and, every 50th frame and
    at keyframes, to stdout. Returns the count of records seen."""
    for rec in stats[seen:]:
        if rec["state"] == "pending":
            continue
        if recorder:
            recorder.record(rec, estimates.get(rec["frame_id"]))
        if not quiet and (rec["frame_id"] % 50 == 0 or rec.get("keyframe")):
            print(
                f"frame {rec['frame_id']:5d} {rec['state']:9s} "
                f"kf={int(bool(rec.get('keyframe', False)))} "
                f"inl={rec.get('n_inliers', 0):4d}",
                flush=True,
            )
    return len(stats)


if __name__ == "__main__":
    sys.exit(main())
