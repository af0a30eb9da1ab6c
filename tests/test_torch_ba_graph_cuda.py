"""The per-keyframe BA schedule replayed as a CUDA graph
(`make_ba_schedule`, a utils/cuda_graph.Graphed) on the card, at the
production window (Kw = 10 keyframes, L = 4,096 landmark rows), under the
production budget and the upstream project's:

- the eager schedule waits on the host nowhere (torch's sync debug mode
  set to raise), so a graph can capture it;
- each replay equals the eager run bit for bit, on several windows in a
  row, raises nothing under the sync debug mode, and leaves the result of
  the call before it as it was (they are clones, not the graph's output
  buffers); a call under a TorchDispatchMode runs eager;
- both drivers, fed 64 frames of the production world (BA runs once the
  window holds 10 keyframes), give the same records, poses and final state
  with the graphs as with every call eager;
- two ChunkedSlam runs in one process share one capture, the tracer counts
  every BA as `ba.schedule_graph`, none as `ba.schedule_eager`, and its
  `ba.lm_iters` and `ba.lm_useful` equal the eager run's.

They need a CUDA card: marked `cuda`, they skip without one. On the card,
run them without tests/conftest.py, which imports jax, pins it to 8
virtual CPU devices and turns its compilation cache on, none of which the
port uses:
python -m pytest --noconftest tests/test_torch_ba_graph_cuda.py
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereo_visual_slam_tpu_torch.ba import schedule
from stereo_visual_slam_tpu_torch.pipeline import chunked
from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry
from stereo_visual_slam_tpu_torch.profiling import window
from stereo_visual_slam_tpu_torch.utils import config as port_config
from stereo_visual_slam_tpu_torch.utils import cuda_graph, trace

pytestmark = pytest.mark.cuda

N_FRAMES = 64
CHUNK = 8
L, KW = 4096, 10
BUDGETS = {"production": port_config.BAConfig(),
           "upstream": port_config.reference_ba_schedule()}


@pytest.fixture(scope="module")
def production():
    """Production Config() and the first N_FRAMES frames of the default
    world."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_visual_slam_tpu_torch.ops.kernels import measure

    return measure.production_frames(N_FRAMES)


def windows(seeds):
    return [window.make_window(L, KW, seed=s, device="cuda") for s in seeds]


@contextlib.contextmanager
def sync_raises():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_eager_schedule_never_waits_on_the_host(production, budget):
    (inp, K), = windows([0])
    run = schedule.eager_schedule(BUDGETS[budget])
    run(inp, K)
    torch.cuda.synchronize()
    with sync_raises():
        run(inp, K)
    torch.cuda.synchronize()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_replays_equal_eager_and_keep_their_outputs(production, budget):
    cfg = BUDGETS[budget]
    run = cuda_graph.Graphed(schedule.eager_schedule(cfg), "ba.schedule")
    calls = windows([1, 2, 3, 4])
    got = [run(*calls[0])]
    assert (run.captures, run.replays) == (1, 1)
    with sync_raises():
        got += [run(*c) for c in calls[1:]]
    assert (run.captures, run.replays) == (1, len(calls))
    eager = schedule.eager_schedule(cfg)
    for c, res in zip(calls, got):
        assert equal(res, eager(*c))
        assert int(res.inlier.sum()) > L // 2
    # the replays differ, so a result that aliased the graph's buffers
    # would have read the last one
    assert not torch.equal(got[0].T_c_w, got[-1].T_c_w)
    # a dispatch mode sees the eager run's every op, not a replay
    with _Ops() as ops:
        res = run(*calls[0])
    assert ops.n > 1000 and run.replays == len(calls)
    assert equal(res, got[0])


def run_chunked(cfg, frames):
    slam = chunked.ChunkedSlam(cfg, chunk=CHUNK, device="cuda")
    slam.run(frames, stage=False)
    slam.finish()
    return slam


def run_host(cfg, frames):
    vo = VisualOdometry(cfg, lookahead=1, device="cuda")
    for f, left, right in frames:
        vo.process(f, left, right)
    vo.finish()
    return vo


def records(stat: dict) -> dict:
    return {k: v for k, v in stat.items() if k != "wall_s"}


def all_eager(monkeypatch):
    """Drivers built inside this context run PnP and the BA schedule
    eager: each `cuda_graph.shared` stage is its bare function."""
    monkeypatch.setattr(cuda_graph, "_SHARED", {})
    monkeypatch.setattr(cuda_graph, "Graphed", lambda fn, name: fn)


def with_budget(cfg, budget):
    """`cfg` under the BA budget: the production one, or the upstream
    project's as the kitti-upstream-ba deployment runs it (no pose fixed)."""
    if budget == "production":
        return cfg
    return cfg.replace(ba=dataclasses.replace(port_config.reference_ba_schedule(cfg.ba),
                                              fix_oldest_pose=False))


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("driver", ["chunked", "host"])
def test_drivers_equal_with_graphs_and_eager(production, monkeypatch, driver, budget):
    cfg, frames = production
    cfg = with_budget(cfg, budget)
    run = {"chunked": run_chunked, "host": run_host}[driver]
    graph = run(cfg, frames)
    with monkeypatch.context() as m:
        all_eager(m)
        plain = run(cfg, frames)
    # the host driver at lookahead 1 applies a BA at a later frame
    n_ba = sum(s.get("ba_cost") is not None or bool(s.get("ba_dispatched"))
               for s in graph.stats)
    assert n_ba >= 3 and len(graph.estimates) >= 48
    assert schedule.make_ba_schedule(cfg.ba).replays >= n_ba
    # the host driver's records carry their host wall time (`wall_s`)
    assert [records(s) for s in graph.stats] == [records(s) for s in plain.stats]
    assert sorted(graph.estimates) == sorted(plain.estimates)
    for f in graph.estimates:
        assert np.array_equal(graph.estimates[f], plain.estimates[f]), f
    if driver == "chunked":
        assert chunked.differences(graph, plain) == []


def traced(fn):
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
        _, totals = trace.drain()
    return out, totals


def test_two_drivers_share_one_capture_and_count_as_eager(production, monkeypatch):
    cfg, frames = production
    cfg = with_budget(cfg, "upstream")
    monkeypatch.setattr(cuda_graph, "_SHARED", {})
    run_chunked(cfg, frames)
    slam, totals = traced(lambda: run_chunked(cfg, frames))
    n_ba = sum(s["ba_cost"] is not None for s in slam.stats)
    run = schedule.make_ba_schedule(cfg.ba)
    assert (run.captures, run.replays) == (1, 2 * n_ba)
    assert len(run.graphs) == 1
    assert totals["ba.schedule_graph"] == n_ba
    assert "ba.schedule_eager" not in totals
    with monkeypatch.context() as m:
        all_eager(m)
        plain, eager_totals = traced(lambda: run_chunked(cfg, frames))
    assert chunked.differences(slam, plain) == []
    b = cfg.ba
    per_run = b.classify_passes * b.classify_iters + b.full_iters + b.pose_only_iters
    assert totals["ba.lm_iters"] == eager_totals["ba.lm_iters"] == n_ba * per_run
    assert totals["ba.lm_useful"] == eager_totals["ba.lm_useful"]
    assert 0 < totals["ba.lm_useful"] <= totals["ba.lm_iters"]
