"""Frames/s of the port's two SLAM drivers on one CUDA card, interleaved.

    python tools/measure_drivers.py [--frames 64] [--rounds 3] [--out DIR]

Production Config() on the default synthetic world. After one warm-up of
each driver, every round runs, in an order that rotates from round to
round: ChunkedSlam (chunk 8) streamed and staged, and VisualOdometry at
lookahead 0, 1 and 2. Each run is timed on the host clock between two
device synchronizes, and records its frames/s, syncs/frame and kernel
launches. Host-clock rates drift between and within calls, so compare the
drivers through the per-round ratios and their spread, not one run.
Prints one JSON line and writes it to --out (default build/profile/,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stereo_visual_slam_tpu_torch.data import synthetic  # noqa: E402
from stereo_visual_slam_tpu_torch.ops import kernels  # noqa: E402
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam  # noqa: E402
from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry  # noqa: E402
from stereo_visual_slam_tpu_torch.utils.config import Config  # noqa: E402

CHUNK = 8
RUNS = ("chunked_streamed", "chunked_staged", "host_la0", "host_la1", "host_la2")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def drive(name, cfg, frames):
    """One run of `name` over `frames`: (wall s, frames, syncs, launches)."""
    if name.startswith("chunked"):
        slam = ChunkedSlam(cfg, chunk=CHUNK, device="cuda")
    else:
        slam = VisualOdometry(cfg, lookahead=int(name[-1]), device="cuda")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if name.startswith("chunked"):
        slam.run(frames, stage=name.endswith("staged"))
    else:
        for f, left, right in frames:
            slam.process(f, left, right)
    slam.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sum(1 for s in slam.stats if s["state"] != "pending")
    if n != len(frames) or any(s["state"] == "lost" for s in slam.stats):
        raise AssertionError(f"{name}: {n} of {len(frames)} frames, or Lost")
    return wall, n, slam.syncs, kernels.launch_counts()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("measure_drivers: no CUDA device", file=sys.stderr)
        return 1

    cfg = Config()
    world = synthetic.make_world(cfg, n_frames=args.frames, n_points=8000, seed=0)
    frames = list(synthetic.frames(world))
    for name in ("chunked_streamed", "host_la0"):
        drive(name, cfg, frames[:CHUNK])

    runs = []
    for r in range(args.rounds):
        order = RUNS[r % len(RUNS):] + RUNS[:r % len(RUNS)]
        if r % 2:
            order = order[::-1]
        for name in order:
            wall, n, syncs, launches = drive(name, cfg, frames)
            runs.append(dict(round=r, name=name, wall_s=wall, frames_per_s=n / wall,
                             syncs_per_frame=syncs / n, launches=launches))
            print(json.dumps(runs[-1]), flush=True)

    def fps(r, name):
        return next(x["frames_per_s"] for x in runs if x["round"] == r and x["name"] == name)

    ratios = {}
    for name in RUNS[1:]:
        per_round = [fps(r, name) / fps(r, "chunked_streamed") for r in range(args.rounds)]
        ratios[f"{name}/chunked_streamed"] = dict(
            per_round=per_round, median=statistics.median(per_round),
            min=min(per_round), max=max(per_round))
    summary = dict(card=card(), frames=args.frames, rounds=args.rounds,
                   runs=runs, ratios=ratios)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "measure_drivers.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(dict(card=summary["card"], ratios=ratios)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
