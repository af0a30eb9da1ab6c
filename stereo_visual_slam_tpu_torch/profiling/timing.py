"""How the profilers time a phase: the counterpart of the JAX tools'
`loop_time` (tools/profile_production.py:44-61).

The JAX tools run a phase r and 3r times inside one jitted `fori_loop` and
take the slope, which on the TPU is device time. The port runs eagerly, so
a phase here is a Python callable run r and 3r times back to back on one
stream, and `measure` keeps per iteration:

  wall_ms    the slope between the two lengths on the host clock, each
             length the best of `best_of` runs that end in synchronize(),
             the lengths taken in turn after `WARM_S` of warm-up: what the
             driver pays for the phase;
  device_ms  the device's busy time (kernels, copies, memsets; the union
             of their intervals, so that kernels that overlap count once)
             in one torch.profiler run of r iterations, divided by r; the run is
             queued behind a spin kernel, so that the device meets the
             iterations as it does untraced, back to back where the host
             is ahead of it;
  r_run      the r used: r, or on the card more for a phase so short
             that r of it would take under `MIN_RUN_S` (at most
             `MAX_R_RUN`);
  host_ms    wall_ms - device_ms: the time the device waits on the host;
  launches   the device events of that run, divided by r;
  syncs      the host's waits on the device in that run (each operation
             torch's sync debug mode reports), divided by r, and
             `sync_sites`: the lines of Python that wait most;
  top_ops    the device ops that took the most time, by the names
             key_averages() prints, and `hand_kernels`: the launches and
             device ms of the port's CUDA kernels, by name.

On the CPU only wall_ms is measured: the other numbers are None there.
Every result carries the device it ran on and the card's `nvidia-smi` name
and power limit.

    python -m stereo_visual_slam_tpu_torch.profiling.timing [--device cuda] [--r 100]

measures the method's own floor: one tiny launch, a hundred, and one
launch with a sync, per iteration.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import subprocess
import sys
import time
import warnings
from typing import Callable, Optional

import torch

# the __global__ functions of csrc/*.cu, by the wrapper's name
HAND_KERNELS = {
    "fast_nms": "fast_nms_kernel",
    "gather_patches": "gather_patches_kernel",
    "zncc_sweep": "zncc_kernel",
}
TOP_OPS = 8
_STEP = "ProfilerStep#"   # torch.profiler's annotation of a schedule step
# idle time on each side of a step boundary: device events within ~0.3 ms
# of one were dropped from the trace on the card (13 of 100 launch + sync
# iterations)
_PAD_S = 0.01
# a device-bound phase of ~1 ms, whose wall is its device time, read
# 0.89-1.13x its wall in device time at r=2 (one slow kernel in a 2 ms
# trace moves the mean): the untraced lengths are therefore timed after
# WARM_S of back-to-back warm-up (on the card) and in turn (r, 3r, r,
# ...), a short
# phase runs at least MIN_RUN_S a length, and the traced run starts
# behind a spin of SPIN_S on the device, while the host queues the
# iterations; the spin is no work of the phase and is left out of the sums
WARM_S = 0.2
MIN_RUN_S = 0.02
MAX_R_RUN = 1000
SPIN_S = 0.02
_SPIN = "spin_kernel"       # the kernel of torch.cuda._sleep
_SPIN_CYCLES_PER_S = 2e9    # ~the card's clock; the spin need not be exact
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class NoCard(RuntimeError):
    """A CUDA device was asked for and there is none."""


def require(device) -> torch.device:
    """`device` as a torch.device; raises NoCard for a CUDA device when
    there is no card. Nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise NoCard(f"device {str(device)!r} requested, but no CUDA device (no card "
                     "found); pass --device cpu to time the plain versions on the CPU")
    return device


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_line(device: torch.device) -> Optional[str]:
    """The card's `nvidia-smi --query-gpu=name,power.limit` line, None on
    the CPU."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    lines = out.stdout.strip().splitlines()
    return lines[min(index, len(lines) - 1)]


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=torch.cuda.device_count(), card=card_line(device))
    return dict(platform="cpu", kind=platform.processor() or platform.machine(),
                count=os.cpu_count(), card=None, threads=torch.get_num_threads())


def busy_us(intervals) -> float:
    """The length of the union of (start, end) intervals: the time the
    device was busy, where kernels that overlap (a dependent launch that
    starts before its predecessor ends) count once."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def _device_events(prof):
    """(name -> [device us, count] of the profile's device events (kernels,
    copies, memsets), the device's busy us: the union of their intervals),
    summed as tools/profile_torch_slice.py sums key_averages()'s device
    rows, but read from the raw events: key_averages() takes ~0.1 ms an
    event, too long for a chunk. The profiler step's annotation, which the
    trace mirrors onto the device over the whole step, is no device work
    and is left out, as is the spin that the traced run starts behind."""
    from torch.autograd import DeviceType

    out: dict = {}
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        for e in prof.key_averages():
            if (e.device_type == DeviceType.CUDA and not e.key.startswith(_STEP)
                    and _SPIN not in e.key):
                out[e.key] = [e.self_device_time_total, e.count]
        return out, sum(us for us, _ in out.values())
    intervals = []
    for e in results.events():
        kind = str(getattr(e, "activity_type", lambda: "")())
        if (e.device_type() == DeviceType.CUDA and "annotation" not in kind
                and not e.name().startswith(_STEP) and _SPIN not in e.name()):
            acc = out.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e3
            acc[1] += 1
            intervals.append((e.start_ns() / 1e3, e.start_ns() / 1e3 + e.duration_ns() / 1e3))
    return out, busy_us(intervals)


def _trace(fn: Callable, device: torch.device, r: int) -> dict:
    """One profiled run of r iterations: device busy time, device events,
    host waits (with the lines that wait most) and the top device ops,
    each per iteration. A first profiler step of one iteration is traced
    and discarded: a trace started cold lost its first device events on the
    card (K3 at 0.5 launches a call at r=2)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []   # the active step's device events, read when its trace is ready
    sync(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: traced.append(_device_events(p))) as prof:
            fn()
            sync(device)
            time.sleep(_PAD_S)
            prof.step()
            time.sleep(_PAD_S)
            torch.cuda._sleep(int(SPIN_S * _SPIN_CYCLES_PER_S))
            del caught[:]
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(r):
                    fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            sync(device)
            time.sleep(_PAD_S)
            prof.step()
    waits = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    sites: dict = {}
    for w in waits:
        site = f"{os.path.relpath(w.filename, _ROOT)}:{w.lineno}"
        sites[site] = sites.get(site, 0) + 1
    ((events, busy),) = traced
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]
    return dict(
        device_ms=busy / 1e3 / r,
        launches=sum(n for _, n in events.values()) / r,
        syncs=len(waits) / r,
        sync_sites={k: v / r for k, v in sorted(sites.items(), key=lambda kv: -kv[1])[:TOP_OPS]},
        top_ops=[dict(name=name, device_ms=us / 1e3 / r, launches=n / r)
                 for name, (us, n) in top],
        hand_kernels={name: dict(
            launches=sum(n for key, (_, n) in events.items() if kernel in key) / r,
            device_ms=sum(us for key, (us, _) in events.items() if kernel in key) / 1e3 / r)
            for name, kernel in HAND_KERNELS.items()},
    )


def measure(fn: Callable, label: str, device, r: int, best_of: int = 3,
            per: Optional[int] = None) -> dict:
    """The row of one phase: `fn()` runs one iteration. `per`: frames per
    iteration, for a per-frame wall."""
    device = torch.device(device)
    r_asked = r
    t_start = time.perf_counter()
    fn()  # first call: allocator, library handles, the kernels' build
    sync(device)
    if device.type == "cuda":
        t0, k = time.perf_counter(), 0
        while True:  # warm-up, back to back: the card's clocks settle
            fn()
            k += 1
            if time.perf_counter() - t0 >= WARM_S:
                break
        sync(device)
        per_s = (time.perf_counter() - t0) / k
        r = max(r, min(MAX_R_RUN, math.ceil(MIN_RUN_S / per_s)))
    runs = {r: [], 3 * r: []}
    for _ in range(best_of):
        for n in runs:
            sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            sync(device)
            runs[n].append(time.perf_counter() - t0)
    best = {n: min(t) for n, t in runs.items()}
    wall_ms = (best[3 * r] - best[r]) / (2 * r) * 1e3
    row = dict(label=label, r=r_asked, r_run=r, best_of=best_of, wall_ms=wall_ms,
               device_ms=None, host_ms=None, launches=None, syncs=None, sync_sites=None,
               top_ops=None, hand_kernels=None)
    if per:
        row.update(per=per, wall_ms_per=wall_ms / per)
    t_traced = time.perf_counter()
    if device.type == "cuda":
        row.update(_trace(fn, device, r))
        row["host_ms"] = wall_ms - row["device_ms"]
    # what the measurement itself cost, on the host clock
    row.update(timed_s=t_traced - t_start, traced_s=time.perf_counter() - t_traced)
    return row


def _num(x, fmt="10.3f"):
    return f"{x:{fmt}}" if x is not None else f"{'-':>{len(format(0.0, fmt))}}"


def table(rows, title: str = "") -> str:
    """The rows as a human table: per iteration wall, device and host ms,
    launches and syncs, the per-frame wall and the top device op."""
    head = (f"{'phase':40s} {'wall ms':>10s} {'device ms':>10s} {'host ms':>10s} "
            f"{'launches':>9s} {'syncs':>6s} {'ms/frame':>9s}  top device op")
    lines = ([f"# {title}"] if title else []) + [head]
    for row in rows:
        top = row.get("top_ops") or []
        lines.append(
            f"{row['label'][:40]:40s} {_num(row['wall_ms'])} {_num(row['device_ms'])} "
            f"{_num(row['host_ms'])} {_num(row['launches'], '9.1f')} "
            f"{_num(row['syncs'], '6.2f')} {_num(row.get('wall_ms_per'), '9.3f')}  "
            + (f"{top[0]['name'][:60]} {top[0]['device_ms']:.3f} ms" if top else ""))
    return "\n".join(lines)


def header(tool: str, device: torch.device, r: int, best_of: int) -> dict:
    return dict(tool=tool, device=device_info(device), r=r, best_of=best_of,
                torch=torch.__version__)


def cli(tool: str, doc: str, run: Callable, render: Callable, default_r: Optional[int],
        argv=None) -> int:
    """The entry point every profiler shares: parse, refuse a missing card,
    run on Config() (with --params' overrides), print the table (unless
    --json), then the JSON line last (also written to
    --out/profile_<tool>.json). A tool that times nothing has no --r."""
    p = argparse.ArgumentParser(prog=f"python -m stereo_visual_slam_tpu_torch.profiling.{tool}",
                                description=doc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    if default_r is not None:
        p.add_argument("--r", type=int, default=default_r,
                       help=f"iterations of the shorter length (default {default_r})")
    p.add_argument("--params", help="YAML config overrides (needs pyyaml)")
    p.add_argument("--json", action="store_true", help="print the JSON line only")
    p.add_argument("--out", default="build/profile", help="directory of the JSON line")
    args = p.parse_args(argv)
    try:
        device = require(args.device)
    except NoCard as e:
        print(f"profiling.{tool}: {e}", file=sys.stderr)
        return 2
    from stereo_visual_slam_tpu_torch.utils.config import Config

    cfg = Config()
    if args.params:
        from stereo_visual_slam_tpu_torch.utils import config_io

        cfg = config_io.config_from_yaml(args.params, cfg)
    result = run(cfg, device, **({} if default_r is None else dict(r=args.r)))
    if not args.json:
        print(render(result), flush=True)
    line = json.dumps(result)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"profile_{tool}.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


# ------------------------------------------------------- the method's floor
def run(cfg=None, device="cuda", r: int = 100, best_of: int = 3) -> dict:
    """The floor of the method on this device: a phase of one tiny launch,
    of a hundred, and of one launch and a sync (`.item()`)."""
    device = require(device)
    x = torch.zeros((1,), dtype=torch.float32, device=device)

    def hundred():
        for _ in range(100):
            x.add_(1.0)

    rows = [
        measure(lambda: x.add_(1.0), "1 launch", device, r, best_of),
        measure(hundred, "100 launches", device, r, best_of),
        measure(lambda: x.add_(1.0).item(), "1 launch + 1 sync (.item())", device, r, best_of),
    ]
    return dict(header("timing", device, r, best_of), rows=rows)


def render(result: dict) -> str:
    d = result["device"]
    return table(result["rows"], f"the method's floor on {d['card'] or d['kind']}, "
                                 f"r={result['r']}, best of {result['best_of']}")


def main(argv=None) -> int:
    return cli("timing", __doc__, run, render, default_r=100, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
