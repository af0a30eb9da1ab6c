"""Where the time goes in the PyTorch port's slice, on one CUDA card.

    python tools/profile_torch_slice.py [--frames 64] [--chunk 8] [--out DIR]

Runs the production Config() on a synthetic world through
stereo_visual_slam_tpu_torch's ChunkedSlam twice after a one-chunk warm-up:
  1. plain: wall time of the run (frames/s), as chip_smoke.py measures it;
  2. trace: torch.profiler over the whole run: the device's busy share of
     the wall time (summed kernel, copy and memset time), the number of
     device launches, and device time by the torch op that launched it.
Prints one JSON summary line and writes it to --out (default
build/profile/, git-ignored). The per-kernel table comes from key_averages(); a chrome
trace of the whole run would be hundreds of MB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stereo_visual_slam_tpu_torch.data import synthetic  # noqa: E402
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam  # noqa: E402
from stereo_visual_slam_tpu_torch.utils.config import Config  # noqa: E402


def card() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def run(cfg, frames, chunk):
    slam = ChunkedSlam(cfg, chunk=chunk, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.run(frames, stage=False)
    slam.finish()
    torch.cuda.synchronize()
    return slam, time.perf_counter() - t0


def traced(cfg, frames, chunk):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        slam, wall = run(cfg, frames, chunk)
    events = prof.key_averages()

    # device-side events (kernels, copies, memsets) give the busy time; the
    # host-side ops carry the device time of what they launched, by name
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    return dict(
        wall_s=wall,
        device_busy_s=busy_us / 1e6,
        device_idle_share=1.0 - busy_us / 1e6 / wall,
        device_launches=sum(e.count for e in device),
        top_ops=[dict(name=e.key[:60], device_ms=e.self_device_time_total / 1e3,
                      count=e.count) for e in ops[:15]],
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    cfg = Config()
    world = synthetic.make_world(cfg, n_frames=args.frames, n_points=8000, seed=0)
    frames = list(synthetic.frames(world))
    run(cfg, frames[: args.chunk], args.chunk)  # warm-up

    slam, wall = run(cfg, frames, args.chunk)
    n = len(slam.stats)
    summary = dict(
        card=card(), frames=n,
        keyframes=sum(s["keyframe"] for s in slam.stats),
        ba_runs=sum(s["ba_cost"] is not None for s in slam.stats),
        wall_s=wall, frames_per_s=n / wall, syncs_per_frame=slam.syncs / n,
    )
    summary["trace"] = traced(cfg, frames, args.chunk)
    line = json.dumps(summary)
    with open(os.path.join(args.out, "profile_torch_slice.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
