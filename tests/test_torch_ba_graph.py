"""The per-keyframe BA schedule as the drivers call it, on the CPU:

- `ba/schedule` builds no tensor from host data (its scalar constants are
  fills on the device), so a CUDA graph can capture it, and it stays
  bit-equal to the port's plain path as the benchmark froze it
  (slam_bench/reference, commit c627a7a) under the production budget and
  the upstream project's, on a full window and on one still filling;
- `trace.collect` gathers the counters added inside it, on or off, and
  `trace.add_counts` hands them on.

How `make_ba_schedule` hands the schedule out (one `cuda_graph.Graphed` a
config, the plain eager schedule on a mesh) is tested with PnP's in
tests/test_torch_cuda_graph.py. The card's side (graph against eager,
replays, syncs) is in tests/test_torch_ba_graph_cuda.py."""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slam_bench.reference import config as ref_config
from slam_bench.reference import schedule as ref_schedule
from stereo_visual_slam_tpu_torch.ba import schedule
from stereo_visual_slam_tpu_torch.profiling import window
from stereo_visual_slam_tpu_torch.utils import config as port_config
from stereo_visual_slam_tpu_torch.utils import trace

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

L = 512
KW = 10
BUDGETS = {"production": port_config.BAConfig(),
           "upstream": port_config.reference_ba_schedule()}


def make_input(kind: str, seed: int = 0):
    """A driving window of KW keyframes over L landmark rows: "full" as
    ChunkStep.run_ba passes it, "filling" as the host driver's window
    before its KW-th keyframe (the last slots masked, no pose fixed, a
    quarter of the rows empty and some landmarks outliers or unreliable)."""
    inp, K = window.make_window(L, KW, seed=seed)
    if kind == "filling":
        g = torch.Generator().manual_seed(seed)
        n = KW - 3
        pose_mask = (torch.arange(KW) < n).float()
        present = (torch.arange(L) < 3 * L // 4).float()
        inp = inp._replace(
            obs_mask=inp.obs_mask * pose_mask * present[:, None],
            pose_mask=pose_mask, fixed_pose=torch.zeros(KW), present=present,
            inlier=(torch.rand(L, generator=g) > 0.1).float(),
            reliable=(torch.rand(L, generator=g) > 0.2).float())
    return inp, K


@pytest.fixture
def tracer():
    """The process's tracer, empty, and off again afterwards."""
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


class _Ops(TorchDispatchMode):
    """Every aten op dispatched inside, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_schedule_builds_no_tensor_from_host_data(budget):
    inp, K = make_input("full")
    run = schedule.eager_schedule(BUDGETS[budget])
    with _Ops() as ops:
        run(inp, K)
    # torch.tensor(<python number>) dispatches lift_fresh, then a copy
    # that waits on the card: capture refuses it
    assert len(ops.names) > 1000
    assert not [n for n in ops.names if "lift_fresh" in n or "_local_scalar" in n]


@pytest.mark.parametrize("kind", ["full", "filling"])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_schedule_bit_equal_to_the_frozen_plain_path(budget, kind):
    cfg = BUDGETS[budget]
    inp, K = make_input(kind, seed=len(kind))
    want = ref_schedule.make_ba_schedule(ref_config.BAConfig(**dataclasses.asdict(cfg)))(
        ref_schedule.ScheduleInput(*inp), K)
    got = schedule.make_ba_schedule(cfg)(inp, K)
    for field in schedule.ScheduleResult._fields:
        x, y = getattr(want, field), getattr(got, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert torch.equal(x, y), field
    # the window moved and some landmarks were judged
    assert not torch.equal(got.T_c_w, inp.T_c_w)
    assert 0 < int(got.inlier.sum()) < L


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_collect_gathers_counters_and_add_counts_hands_them_on(tracer, on):
    if on:
        tracer.enable()
    assert tracer.enabled() is on
    with tracer.collect() as counts:
        assert tracer.enabled()
        tracer.add("ba.lm_iters", 3)
        tracer.add("ba.lm_useful", torch.tensor([True, False, True]))
        tracer.add("ba.lm_useful", torch.tensor(True))
        with tracer.collect() as inner:
            tracer.add("ba.lm_iters", 1)
        assert inner.host == {"ba.lm_iters": 1}
    assert tracer.enabled() is on
    assert counts.host == {"ba.lm_iters": 3}
    assert int(counts.device["ba.lm_useful"]) == 3
    # nothing reached the tracer until handed on
    assert tracer.drain() == ([], {})
    tracer.add_counts(counts)
    tracer.add_counts(counts)
    _, totals = tracer.drain()
    assert totals == ({"ba.lm_iters": 6, "ba.lm_useful": 6} if on else {})
