"""Long-horizon soak of the PyTorch port (counterpart of tools/soak.py): a
reference-scale synthetic run (default 4,200 frames, near the 4,541-frame
KITTI seq-00 loop of the reference's run_vslam.cpp:40) through the
production ChunkedSlam on one card, fed frame by frame.

    python -m stereo_visual_slam_tpu_torch.soak [n_frames] [chunk]
        [--device cuda] [--params small.yaml] [--workers N]

Checks what thousands of evictions and kilometres of trajectory could break
and no short run can see:
  * tracking never enters Lost, and rejected frames stay rare (<= 2 %);
  * the landmark arena is not full at the end (tools/soak.py's check;
    its high water over every chunk is reported);
  * the host's resident memory grows by at most 1 MB a chunk after the
    first chunks (the upload buffer is one pinned buffer, reused);
  * KITTI translational error <= 2.5 % (binding) and <= 4.17 % (the
    reference's seq-00 result), and stable: the last third's no worse than
    twice the first third's;
  * the pace stays flat (last quarter >= 0.7x the first), when the run
    has 8 or more 512-frame marks.
Frames render ahead on a process pool (data/render_pool), so the pace is
the card's and the driver's, not the renderer's.

Prints `# soak ok|FAIL: ...` per check and a `SOAK PASS|FAIL` summary line;
SOAK_JSON=path writes the summary as JSON, SOAK_DUMP=path the per-frame
stats as CSV. Exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import resource
import sys
import time

import numpy as np

from stereo_visual_slam_tpu_torch.data import render_pool, synthetic
from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj_mod
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
from stereo_visual_slam_tpu_torch.utils.config import Config

PACE_EVERY = 512          # frames between pace marks
PACE_MIN_MARKS = 8
RSS_FROM_CHUNK = 8        # the memory baseline: after this many chunks
RSS_MB_PER_CHUNK = 1.0
REPORT_EVERY_S = 60.0


def rss_mb() -> float:
    """The current resident set (VmRSS), not the ru_maxrss peak."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def evaluate(s: dict, capacity: int) -> list:
    """[(ok, message)] of the soak's checks on the summary `s`."""
    n = s["n_frames"]
    checks = [
        (not s["lost"], f"never Lost (tracked {s['n_tracked']}/{n}, {s['n_rejected']} rejected)"),
        (s["n_rejected"] <= n * 0.02, f"rejections rare ({s['n_rejected']})"),
        (s["arena_live"] < capacity,
         f"arena not exhausted ({s['arena_live']}/{capacity} live rows at the end; high water "
         f"{s['arena_high_water']}, full after {s['arena_full_chunks']} of "
         f"{s['arena_chunks']} chunks)"),
        (s["rss_mb_per_chunk"] <= RSS_MB_PER_CHUNK,
         f"host memory bounded ({s['rss_mb_per_chunk']:.3f} MB/chunk over "
         f"{s['rss_chunks']} chunks after the first {RSS_FROM_CHUNK}; bound {RSS_MB_PER_CHUNK})"),
        (s["trans_pct"] <= 2.5, f"KITTI trans {s['trans_pct']:.2f}% <= 2.5% (binding gate)"),
        (s["trans_pct"] <= 4.17, f"KITTI trans {s['trans_pct']:.2f}% <= 4.17% (ref parity)"),
        (s["trans_last_pct"] <= max(2.0 * s["trans_first_pct"], 1.0),
         f"drift stable (first third {s['trans_first_pct']:.2f}%, last "
         f"{s['trans_last_pct']:.2f}%)"),
    ]
    pace = s["pace"]
    if pace is not None:
        checks.append((pace["fps_last"] >= 0.7 * pace["fps_first"],
                       f"per-chunk pace flat ({pace['fps_first']:.1f} -> "
                       f"{pace['fps_last']:.1f} fps)"))
    return checks


def _live_rows(slam) -> int:
    """Arena rows holding a landmark (one fetch)."""
    return int((slam.carry.mstate.obs_mask.amax(dim=1) > 0).sum())


def _pace(marks):
    """Wall frames/s of the last quarter of the marks against the first, or
    None with fewer than PACE_MIN_MARKS marks."""
    if len(marks) < PACE_MIN_MARKS:
        return None
    q = len(marks) // 4
    (f0, t0), (f1, t1) = marks[0], marks[q]
    (f2, t2), (f3, t3) = marks[-q - 1], marks[-1]
    return dict(fps_first=(f1 - f0) / max(t1 - t0, 1e-9),
                fps_last=(f3 - f2) / max(t3 - t2, 1e-9))


def run_soak(cfg: Config, n_frames: int = 4200, chunk: int = 8, *, device,
             renderer: render_pool.Renderer, log=None) -> dict:
    """The soak, its frames rendered ahead by `renderer`; returns its
    summary (the SOAK_JSON fields, `checks` and `ok`) with the run's `slam`,
    `world` and `live_rows` ({frame: arena rows live after the chunk that
    ended at it})."""
    log = log or functools.partial(print, flush=True)
    slam = ChunkedSlam(cfg, chunk=chunk, device=device)   # raises without a card
    # keep structure density constant with path length (the default world
    # spreads n_points over speed*n_frames + 80 m of corridor)
    n_points = int(8000 * (n_frames + 80) / (216 + 80))
    t0 = time.perf_counter()
    world = synthetic.make_world(cfg, n_frames=n_frames, n_points=n_points, seed=7)
    log(f"# world: {n_frames} frames, {n_points} sprites, built in "
        f"{time.perf_counter() - t0:.0f}s; rendering ahead on {renderer.workers} workers")

    L = cfg.ba.max_landmarks
    live_rows = {}
    rss0 = rss_from = None
    marks = []   # (frame, wall) every PACE_EVERY frames
    t0 = last_report = time.perf_counter()
    with contextlib.closing(renderer.frames(world)) as source:
        for f, left, right in source:
            slam.process(f, left, right)
            if slam.lost:
                break
            if f % chunk == chunk - 1:   # a chunk ran
                done = (f + 1) // chunk
                if done == RSS_FROM_CHUNK:
                    rss0, rss_from = rss_mb(), done
                live_rows[f] = _live_rows(slam)
            now = time.perf_counter()
            if f % PACE_EVERY == PACE_EVERY - 1:
                marks.append((f, now - t0))
            if now - last_report > REPORT_EVERY_S:
                rss = "" if rss0 is None else f", rss +{rss_mb() - rss0:.0f} MB"
                log(f"# frame {f}: {(f + 1) / (now - t0):.1f} fps wall, arena high water "
                    f"{max(live_rows.values(), default=0)}{rss}")
                last_report = now
    slam.finish()
    wall = time.perf_counter() - t0
    live_rows[len(slam.stats) - 1] = _live_rows(slam)
    rss_growth = 0.0 if rss0 is None else rss_mb() - rss0
    rss_chunks = 0 if rss0 is None else -(-len(slam.stats) // chunk) - rss_from

    fids = sorted(slam.estimates)
    est = np.stack([slam.estimates[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    t_all, r_all = traj_mod.kitti_errors(est, gt)
    third = len(fids) // 3
    t_first, _ = traj_mod.kitti_errors(est[:third], gt[:third])
    t_last, _ = traj_mod.kitti_errors(est[-third:], gt[-third:])
    pace = _pace(marks)
    s = dict(
        n_frames=n_frames,
        n_tracked=sum(1 for r in slam.stats if r["state"] == "tracked"),
        n_rejected=sum(1 for r in slam.stats if r["state"] == "rejected"),
        n_keyframes=sum(1 for r in slam.stats if r["keyframe"]),
        n_evictions=len(slam.evictions),
        arena_live=live_rows[len(slam.stats) - 1], arena_high_water=max(live_rows.values()),
        arena_full_chunks=sum(n >= L for n in live_rows.values()), arena_chunks=len(live_rows),
        arena_capacity=L, lost=bool(slam.lost),
        trans_pct=float(t_all), trans_first_pct=float(t_first), trans_last_pct=float(t_last),
        rot_deg_per_m=float(r_all), ate_m=float(traj_mod.ate_rmse(est, gt)),
        wall_s=wall, fps_wall=n_frames / wall, pace=pace, rss_growth_mb=rss_growth,
        rss_chunks=rss_chunks, rss_mb_per_chunk=rss_growth / max(rss_chunks, 1),
        syncs_per_frame=slam.syncs / max(len(slam.stats), 1),
        device=str(slam.device))
    s["checks"] = evaluate(s, L)
    s["ok"] = all(ok for ok, _ in s["checks"])
    return dict(s, slam=slam, world=world, live_rows=live_rows)


def _dump(path, slam, world, live_rows):
    """The per-frame stats as CSV, with each pose's distance to the truth
    and, at the end of each chunk, the arena's live rows."""
    gt_inv = {f: np.linalg.inv(world.poses_T_c_w[f]) for f in slam.estimates}
    with open(path, "w") as fh:
        fh.write("frame,state,kf,n_matches,n_inliers,n_new,twist,err_t,live\n")
        for s in slam.stats:
            f = s["frame_id"]
            err = ""
            if f in slam.estimates:
                d = np.linalg.inv(slam.estimates[f])[:3, 3] - gt_inv[f][:3, 3]
                err = f"{np.linalg.norm(d):.2f}"
            fh.write(f"{f},{s['state']},{int(s['keyframe'])},{s['n_matches']},"
                     f"{s['n_inliers']},{s['n_new_landmarks']},{s['twist']:.3f},{err},"
                     f"{live_rows.get(f, '')}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_frames", nargs="?", type=int, default=4200)
    p.add_argument("chunk", nargs="?", type=int, default=8)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--params", help="YAML config overrides (needs pyyaml)")
    p.add_argument("--workers", type=int, default=None,
                   help="render processes (default: one per CPU but one; 0: in-process)")
    args = p.parse_args(argv)
    cfg = Config()
    if args.params:
        from stereo_visual_slam_tpu_torch.utils import config_io

        cfg = config_io.config_from_yaml(args.params, cfg)
    with render_pool.Renderer(args.workers) as renderer:
        out = run_soak(cfg, args.n_frames, args.chunk, device=args.device, renderer=renderer)
    slam, world, live_rows = out.pop("slam"), out.pop("world"), out.pop("live_rows")
    for ok, msg in out["checks"]:
        print(f"# soak {'ok' if ok else 'FAIL'}: {msg}", flush=True)
    print(
        f"SOAK {'PASS' if out['ok'] else 'FAIL'}: {out['n_frames']} frames in "
        f"{out['wall_s']:.0f}s ({out['fps_wall']:.1f} fps wall on {out['device']}, frames "
        f"rendered ahead on other processes), {out['n_keyframes']} keyframes, "
        f"trans={out['trans_pct']:.2f}% rot={out['rot_deg_per_m']:.4f}deg/m "
        f"ate={out['ate_m']:.2f}m rss+{out['rss_growth_mb']:.0f}MB "
        f"arena_hw={out['arena_high_water']} evictions={out['n_evictions']}", flush=True)
    if os.environ.get("SOAK_JSON"):
        with open(os.environ["SOAK_JSON"], "w") as fh:
            json.dump({k: v for k, v in out.items() if k != "checks"}, fh, indent=1)
        print(f"# artifact written to {os.environ['SOAK_JSON']}", flush=True)
    if os.environ.get("SOAK_DUMP"):
        _dump(os.environ["SOAK_DUMP"], slam, world, live_rows)
        print(f"# stats dumped to {os.environ['SOAK_DUMP']}", flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
