"""The benchmark of the PyTorch and CUDA port: one cell, one run.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (`configs[].file`: the
port's Config as data) and a traffic mix (`slam_bench/traffic/<name>.json`:
the parameters of a synthetic KITTI-geometry sequence). The run

  1. sets up: imports the port, makes the world from `--seed` and renders
     its frames on a pool of spawned processes (stopped before the window),
     then runs one untimed pass over the first chunks, until the window of
     keyframes has filled and BA and an eviction have run, so that the
     kernel library is built and loaded and every path of the window is
     warm; the process then runs one intra-op thread, and what set-up
     made is frozen out of the garbage collector's scans;
  2. measures: passes over the sequence back to back, each on a fresh
     `ChunkedSlam(cfg, chunk, seed)` fed frame by frame through `process`
     from host memory (the CLI's streamed path) and ended by `finish()`,
     until `--seconds` have passed, stopping at the first chunk boundary
     after that;
  3. checks: frees the program's state, runs the plain reference
     (slam_bench/reference) over the same frames with the same seed and
     compares what the window produced with it (slam_bench/compare.py),
     each number against its limit in `slam_bench/limits/<cell>.json`;
  4. prints, as the last line of standard output, one JSON object:
     `correct`, `attempted` (frames handed in), `failed` (of those, the
     frames not tracked), `metrics`, `device` and, traced, `breakdown`,
     with the compared numbers and their limits under `checks`, last.

Untraced (`--trace 0`) the metrics are the cell's end-to-end metrics:
  frames_per_s   frames completed in the window over the time from its
                 start to the completion of its last chunk (every pass's
                 construction and finish() inside);
  chunk_ms_p95   the 95th percentile of every chunk's latency, from its
                 first frame handed to `process` to the return of the call
                 that put its records on the host;
  setup_s        process start to the window's start.
Traced (`--trace 1`) the same window runs with spans around each layer
(record_function ranges that end in a synchronize, wrapped around the
instance attributes the chunk program calls: `extract`, `track_step`,
`depth_fn`, `insert_keyframe`, `run_ba`), every host wait counted under
torch's sync debug mode, and torch.profiler over a slice of two chunks of
the first pass; the metrics are then the cell's per-layer metrics, each
read by `slam_bench/metrics/<name>.py`.

Exits 2 without a card (or with fewer than the cell asks for), 3 when JAX
or the JAX package is loaded once the window has closed (looked for just
before the result is printed), and prints no result then.
"""

from __future__ import annotations

import time

_T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "stereo_visual_slam_tpu")
SPAN = "slam_bench."
TOP = 10
NAME_CHARS = 160
WARM_MIN_CHUNKS = 3
PROFILED_CHUNKS = 2
PAD_S = 0.01


def banned_loaded() -> list:
    """The names of BANNED that sys.modules holds, compared as whole
    top-level names (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------ the data
def load_cell(root: Path, name: str) -> dict:
    """The cell `name` of root/BENCHMARK.json with everything it names:
    {bench, cell, config (the configuration file), traffic, limits,
    per_layer (the metric entries that apply to the cell)}."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    data = root / "slam_bench"
    return dict(
        bench=bench, cell=cell,
        config=json.loads((root / configs[cell["config"]]["file"]).read_text()),
        traffic=json.loads((data / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=json.loads((data / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if name in m.get("workloads", [name])],
        per_layer=[m for m in bench["per_layer"] if name in m.get("workloads", [name])],
        metrics_dir=data / "metrics",
    )


def build_config(config_cls, data: dict):
    """A Config dataclass (the port's or the reference's) from the
    configuration file's nested `config` dict; a key the dataclass does not
    have raises."""
    kw = {}
    for f in dataclasses.fields(config_cls):
        if f.name not in data:
            raise KeyError(f"the configuration lacks {f.name!r}")
        v = data[f.name]
        if isinstance(v, dict):
            sub = type(f.default_factory())
            kw[f.name] = sub(**v)
        else:
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    extra = set(data) - {f.name for f in dataclasses.fields(config_cls)}
    if extra:
        raise KeyError(f"unknown configuration keys {sorted(extra)}")
    return config_cls(**kw)


def reader(metrics_dir: Path, name: str):
    """The `read(ctx)` function of metrics_dir/<name>.py."""
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name}",
                                                  metrics_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_frames(cfg_data: dict, traffic: dict, seed: int, workers: int) -> tuple:
    """(world, frames): the traffic's world from the seed and its frames
    as (frame_id, left uint8, right uint8)."""
    from slam_bench import world as world_mod

    cam = cfg_data["camera"]
    camera = world_mod.Camera(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["baseline"],
                              tuple(cfg_data["image_hw"]))
    w = world_mod.make_world(
        camera, n_frames=traffic["n_frames"], n_points=traffic["n_points"],
        speed=traffic["speed"], yaw_rate=traffic["yaw_rate"], seed=seed % 2**63,
        profile=traffic["profile"])
    return w, world_mod.render_all(w, workers)


# ----------------------------------------------------------- tracing
class Spans:
    """Host-clock spans around the layers' calls. Each wrapped call runs in
    a record_function range named SPAN + layer and, on the card, ends in a
    synchronize, so the span covers the device work it queued."""

    LAYERS = (("extract", "extract"), ("track_step", "track"), ("depth_fn", "keyframe.depth"),
              ("insert_keyframe", "keyframe.insert"), ("run_ba", "keyframe.ba"))

    def __init__(self, device):
        self.device = device
        self.rows = []   # (layer, t0, t1)

    def attach(self, chunk_step):
        import torch

        for attr, layer in self.LAYERS:
            fn = getattr(chunk_step, attr)
            if fn is None:
                continue

            def wrapped(*a, _fn=fn, _layer=layer, **k):
                with torch.profiler.record_function(SPAN + _layer):
                    t0 = time.perf_counter()
                    out = _fn(*a, **k)
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    self.rows.append((_layer, t0, time.perf_counter()))
                return out

            setattr(chunk_step, attr, wrapped)

    def outside(self, skip):
        """The rows that start outside the interval `skip` (the profiler's:
        under it every launch costs several times its untraced host time)."""
        return [r for r in self.rows if not skip[0] <= r[1] <= skip[1]]


def read_trace(prof_events) -> dict:
    """The profiled slice from the raw kineto events: device operations
    (name, start, end in s) and the spans' ranges on the same clock."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for e in prof_events:
        name = e.name()
        t0 = e.start_ns() / 1e9
        t1 = t0 + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            kind = str(getattr(e, "activity_type", lambda: "")())
            if "annotation" in kind or name.startswith(SPAN) or name.startswith("ProfilerStep"):
                continue
            ops.append((name, t0, t1))
        elif name.startswith(SPAN):
            spans.append((name[len(SPAN):], t0, t1))
    return dict(ops=ops, spans=spans)


# ------------------------------------------------------------ the run
def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device,
             workers: int = 0, log=_log) -> dict:
    """One run of cell `name` on `device`: the result line's dict and, under
    "checks", the compared numbers with their limits."""
    import torch

    from slam_bench import compare, yardstick
    from slam_bench.reference import config as ref_config_mod
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils import config as port_config_mod

    device = torch.device(device)
    t_import = time.perf_counter()
    spec = load_cell(root, name)
    cfg_data, traffic = spec["config"]["config"], spec["traffic"]
    cfg = build_config(port_config_mod.Config, cfg_data)
    chunk = traffic["chunk"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    world, frames = make_frames(cfg_data, traffic, seed, workers)
    n = len(frames)
    n_chunks = -(-n // chunk)
    t_render = time.perf_counter()

    # warm-up: until BA and an eviction have run (every path of a pass)
    warm = ChunkedSlam(cfg, chunk=chunk, seed=seed, device=device)
    first_ba = None
    for k in range(n_chunks):
        for f in range(k * chunk, min((k + 1) * chunk, n)):
            warm.process(*frames[f])
        if first_ba is None and any(s["ba_cost"] is not None for s in warm.stats):
            first_ba = k
        if k + 1 >= WARM_MIN_CHUNKS and first_ba is not None and warm.evictions:
            break
    warm.finish()
    sync()
    del warm
    gc.collect()
    # what set-up made lives through the window: keep it out of the collector's scans
    gc.freeze()
    t_window = time.perf_counter()
    timings = dict(import_s=t_import - _T_PROCESS, render_s=t_render - t_import,
                   warm_s=t_window - t_render)

    # the profiled slice: two chunks of the first pass from the first with BA
    lo = min(max(first_ba if first_ba is not None else WARM_MIN_CHUNKS, 1),
             n_chunks - PROFILED_CHUNKS)
    profiled = range(lo, lo + PROFILED_CHUNKS) if trace else range(0)

    spans = Spans(device) if trace else None
    captured = compare.Outputs()
    chunk_s, sync_waits = [], []
    frames_done = 0
    traced = []
    prof = slice_wall = None
    profiled_s, profiled_frames = [float("inf"), float("inf")], 0
    deadline = t_window + seconds
    t_last = t_window
    if trace and device.type == "cuda":
        import warnings

        catcher = warnings.catch_warnings(record=True)
        sync_waits = catcher.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
    try:
        done = False
        while not done:
            slam = ChunkedSlam(cfg, chunk=chunk, seed=seed, device=device)
            first = not captured.passes
            cap = compare.Capture(captured)
            cap.attach(slam.chunk_step)
            if spans is not None:
                spans.attach(slam.chunk_step)
            k = -1
            for k in range(n_chunks):
                if first and len(profiled) and k == profiled.start - 1 and device.type == "cuda":
                    prof = _start_profiler(traced)
                    profiled_s[0] = time.perf_counter()
                    profiled_frames = frames_done
                if first and prof is not None and k == profiled.start:
                    _profiler_step(prof, sync)
                    t_slice = time.perf_counter()
                t0 = time.perf_counter()
                for f in range(k * chunk, min((k + 1) * chunk, n)):
                    slam.process(*frames[f])
                chunk_s.append(time.perf_counter() - t0)
                frames_done += min((k + 1) * chunk, n) - k * chunk
                if first and prof is not None and k == profiled.stop - 1:
                    sync()
                    slice_wall = time.perf_counter() - t_slice
                    _profiler_step(prof, sync)
                    prof.stop()
                    prof = None
                    profiled_s[1] = time.perf_counter()
                    profiled_frames = frames_done - profiled_frames
                if k == n_chunks - 1:
                    slam.finish()
                t_last = time.perf_counter()
                if t_last >= deadline:
                    done = True
                    break
            cap.close(slam, k + 1, k == n_chunks - 1)
            del slam, cap
    finally:
        if prof is not None:   # the window closed inside the slice: no trace
            prof.stop()
            traced.clear()
        if trace and device.type == "cuda":
            torch.cuda.set_sync_debug_mode("default")
            catcher.__exit__(None, None, None)
    window_s = t_last - t_window
    memory_peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the check: the reference over the frames the window reached
    t_check = time.perf_counter()
    ref_cfg = build_config(ref_config_mod.Config, cfg_data)
    judge = compare.Judge(ref_cfg, frames, world.poses_T_c_w, seed, chunk, device)
    numbers = compare.compare(captured, judge)
    limits = spec["limits"]
    correct = compare.verdict(numbers, limits)
    check_s = time.perf_counter() - t_check

    records = [r for p in captured.passes for r in p.records.values()]
    tracked = sum(1 for r in records if bool(r.tracked))
    keyframes = sum(1 for r in records if bool(r.is_keyframe))
    acc = _accuracy(captured.passes, world)
    before_ba = _frames_before_ba(captured.passes)
    log(f"# {name} seed {seed}: {len(captured.passes)} passes, {len(chunk_s)} chunks, "
        f"{frames_done} frames ({keyframes} keyframes, {tracked} tracked, {before_ba} before "
        f"their pass's first BA) in {window_s:.3f} s; set-up {timings}; check {check_s:.1f} s; "
        f"first pass {acc}")

    metrics = {}
    if not trace:
        values = dict(
            frames_per_s=frames_done / window_s,
            chunk_ms_p95=float(np.percentile(np.asarray(chunk_s) * 1e3, 95)),
            setup_s=t_window - _T_PROCESS,
        )
        for m in spec["end_to_end"]:
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               count=1, memory_peak_bytes=int(memory_peak))
    line = dict(correct=bool(correct), attempted=frames_done, failed=frames_done - tracked,
                metrics=metrics, device=dev)
    if trace:
        ops = traced[0]["ops"] if traced else []
        busy_s = yardstick.busy([(a, b) for _, a, b in ops])
        # what a metric reader (slam_bench/metrics/<name>.py) reads
        ctx = dict(
            ref_cfg=ref_cfg, device=device, sequence=frames, chunk=chunk,
            frames_done=frames_done, span_rows=spans.outside(profiled_s),
            span_frames=frames_done - profiled_frames,
            syncs=[w for w in sync_waits if "synchronizing CUDA operation" in str(w.message)
                   and not w.filename.startswith(str(Path(__file__).parent))],
            trace=traced[0] if traced else None, profiled=list(profiled),
            slice_wall_s=slice_wall, busy_s=busy_s, peaks=yardstick.peaks(dev["kind"]),
        )
        for m in spec["per_layer"]:
            value = reader(spec["metrics_dir"], m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        if traced and slice_wall:
            dev.update(busy_s=busy_s, window_s=slice_wall)
            line["breakdown"] = _breakdown(traced[0])
    line["checks"] = {k: dict(value=numbers[k], limit=limits[k]) for k in compare.NUMBERS}
    return line


def _start_profiler(traced: list):
    """torch.profiler over the slice: one warm-up step (a trace started
    cold loses its first device events), then the active step, whose
    events are read when its trace is ready."""
    from torch.profiler import ProfilerActivity, profile, schedule

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=lambda p: traced.append(
                       read_trace(p.profiler.kineto_results.events())))
    prof.start()
    return prof


def _profiler_step(prof, sync) -> None:
    """A profiler step boundary with the device idle on both sides: device
    events within ~0.3 ms of a tight boundary were lost from the trace on
    the card (the port's profiling/timing.py pads its boundaries alike)."""
    sync()
    time.sleep(PAD_S)
    prof.step()
    time.sleep(PAD_S)


def _breakdown(trace: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by the span the host was in."""
    by_name: dict = {}
    for name, a, b in trace["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps, end = [], None
    for _, a, b in sorted(trace["ops"], key=lambda o: o[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)

    def host_in(t):
        inside = [s for s in trace["spans"] if s[1] <= t <= s[2]]
        return min(inside, key=lambda s: s[2] - s[1])[0] if inside else "driver"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    # a kernel's name is cut to NAME_CHARS: template arguments make some
    # thousands of characters long
    return dict(device_ops=[[k[:NAME_CHARS], v] for k, v in top],
                idle_gaps=[[host_in(a), b - a] for a, b in longest])


def _frames_before_ba(passes) -> int:
    """Frames of the window that ran before BA first ran in their pass (a
    pass starts with an empty window of keyframes, and BA waits until it
    is full)."""
    n = 0
    for p in passes:
        ran = [f for f, r in p.records.items() if bool(r.ba_ran)]
        n += sum(1 for f in p.records if not ran or f < min(ran))
    return n


def _accuracy(passes, world) -> dict:
    """ATE and the KITTI translational error of the first finished pass
    against the world's ground truth (stderr only: not a metric)."""
    from slam_bench.reference import trajectory

    done = [p for p in passes if p.complete]
    if not done:
        return {}
    est = done[0].estimates
    fids = sorted(est)
    e = np.stack([est[f] for f in fids])
    gt = world.poses_T_c_w[fids]
    t_err, _ = trajectory.kitti_errors(e, gt)
    return dict(ate_m=round(trajectory.ate_rmse(e, gt), 4), trans_pct=round(t_err, 4),
                estimated=len(fids))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    spec = load_cell(ROOT, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"slam_bench: the cell needs {chips} CUDA device(s); "
             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    # one intra-op thread: the window's host work is one thread dispatching
    # launches, and more threads only compete with it for the host's cores
    torch.set_num_threads(1)
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    line = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                    "cuda", workers=workers)
    # last, so that whatever the reference or a metric reader loaded counts
    loaded = banned_loaded()
    if loaded:
        _log(f"slam_bench: loaded once the window closed: {loaded}")
        return 3
    for k, v in line["checks"].items():
        _log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
