"""Per-phase FLOP / HBM-byte / MFU table of the production program: the
counterpart of tools/roofline_report.py.

    python -m stereo_visual_slam_tpu_torch.profiling.roofline_report [--device cuda]
        [--params small.yaml] [--r 6] [--json]

Rows, under the JAX tool's labels, each built by production.phases on its
inputs (production Config() on make_world(cfg, 8, 8000, seed 0)):

  chunk_step (B=8, no-BA)    ChunkStep.__call__ from init_carry
  batch_extract (B=8)        ChunkStep.extract_chunk
  feats step (1 frame)       the feats scan row over B
  BA schedule (1 keyframe)   make_ba_schedule(cfg.ba) on the JAX tool's window

FLOPs and bytes come from one counted run of the row (utils/roofline.py:
every scan frame and LM iteration, the eager op-by-op traffic); the times
are timing.measure's (device ms: the card's busy time; wall ms: what the
driver pays), never defaults. Each row gives the MFU and HBM shares against
the device time and against the wall, MFU against the fp32 peak outside
the tensor cores (the port runs fp32, TF32 off). On the CPU the device
columns are None and the peaks GENERIC (meaningless).
"""

from __future__ import annotations

import sys
from typing import Optional

from stereo_visual_slam_tpu_torch.profiling import production, timing
from stereo_visual_slam_tpu_torch.utils import roofline

B = production.B
# (index into production.phases, the JAX tool's label, frames the row's
# cost and times are divided by)
ROWS = ((0, f"chunk_step (B={B}, no-BA)", 1), (1, f"batch_extract (B={B})", 1),
        (2, "feats step (1 frame)", B), (3, "BA schedule (1 keyframe)", 1))


def shares(cost: roofline.ProgramCost, ms: Optional[float], peaks: roofline.ChipPeaks):
    """(MFU, HBM share) of `cost` done in `ms` (None, None without a time)."""
    if ms is None:
        return None, None
    return cost.mfu(ms * 1e-3, peaks), cost.hbm_util(ms * 1e-3, peaks)


def row(label: str, cost: roofline.ProgramCost, device_ms, wall_ms, peaks, **extra) -> dict:
    mfu_d, hbm_d = shares(cost, device_ms, peaks)
    mfu_w, hbm_w = shares(cost, wall_ms, peaks)
    return dict(label=label, gflop=cost.flops / 1e9, gb=cost.bytes_accessed / 1e9,
                device_ms=device_ms, wall_ms=wall_ms, mfu_device=mfu_d, hbm_device=hbm_d,
                mfu_wall=mfu_w, hbm_wall=hbm_w, **extra)


def run(cfg, device, r: int = 6, best_of: int = 3, images=None,
        timings: Optional[dict] = None) -> dict:
    """The four rows on `device`. `timings`: production rows already
    measured on these inputs, by production label ({"wall_ms",
    "device_ms"}), used instead of timing the row again."""
    device = timing.require(device)
    peaks = roofline.chip_peaks(device)
    phases = production.phases(cfg, device, images)
    rows = []
    for index, label, per in ROWS:
        prod_label, fn, _ = phases[index]
        total = roofline.cost_of(fn)
        cost = roofline.ProgramCost(total.flops / per, total.bytes_accessed / per)
        t = (timings or {}).get(prod_label)
        if t is None:
            t = timing.measure(fn, label, device, r, best_of)
        dev = None if t["device_ms"] is None else t["device_ms"] / per
        rows.append(row(label, cost, dev, t["wall_ms"] / per, peaks,
                        timed="reused" if timings and prod_label in timings else "measured"))
    return dict(timing.header("roofline_report", device, r, best_of),
                peaks=peaks._asdict(), rows=rows)


def _num(x, fmt):
    return "-" if x is None else format(x, fmt)


def table(rows, peaks: dict, title: str) -> str:
    """GFLOP, GB, device and wall ms and the four shares, in percent."""
    lines = [f"# {title}",
             f"# shares of {peaks['name']}: {peaks['f32_flops'] / 1e12:.0f} TFLOP/s f32 outside "
             f"the tensor cores, {peaks['hbm_bytes'] / 1e9:.0f} GB/s HBM",
             f"{'phase':30s} {'GFLOP':>10s} {'GB':>9s} {'device ms':>10s} {'wall ms':>10s} "
             f"{'MFU% dev':>9s} {'HBM% dev':>9s} {'MFU% wall':>9s} {'HBM% wall':>9s}"]
    for r_ in rows:
        pct = [None if r_[k] is None else 100 * r_[k]
               for k in ("mfu_device", "hbm_device", "mfu_wall", "hbm_wall")]
        lines.append(
            f"{r_['label'][:30]:30s} {r_['gflop']:10.4f} {r_['gb']:9.4f} "
            f"{_num(r_.get('device_ms'), '10.3f'):>10s} {_num(r_.get('wall_ms'), '10.3f'):>10s} "
            + " ".join(f"{_num(p, '9.4f'):>9s}" for p in pct))
    return "\n".join(lines)


def render(result: dict) -> str:
    d = result["device"]
    return table(result["rows"], result["peaks"],
                 f"roofline of the production program on {d['card'] or d['kind']}, "
                 f"r={result['r']}, best of {result['best_of']}")


def main(argv=None) -> int:
    return timing.cli("roofline_report", __doc__, run, render, default_r=6, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
