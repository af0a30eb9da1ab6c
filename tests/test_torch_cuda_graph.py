"""The port's one CUDA-graph mechanism (utils/cuda_graph) as its two graphed
stages use it, on the CPU: PnP-RANSAC (`pnp.graphed`) and the per-keyframe
BA schedule (`schedule.make_ba_schedule`) under the production budget and
the upstream project's.

- given CPU tensors, a `Graphed` runs its function eager, counts each call
  as `<name>_eager`, keeps no graph, and the function's own counters (the
  schedule's LM iterations) read as the eager run's;
- under a TorchDispatchMode it runs eager too: the mode sees every op of
  the eager run;
- PnP counts nothing, so capturing it under `trace.collect()` adds no op;
- `cuda_graph.shared` makes one `Graphed` a key, so two ChunkSteps share
  PnP's and the schedule's;
- with a mesh, `make_ba_schedule` returns the plain eager schedule, equal
  to the single-device one on one rank.

The card's side (a capture per TF32 setting and input shape, outputs that
survive the next replay, counters out of the graph) is in
tests/test_torch_cuda_graph_cuda.py."""

import dataclasses
import functools
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from test_torch_ba_graph import BUDGETS, _Ops, make_input
from test_torch_pnp_graph import SCENES, SETTINGS, scene
from stereo_visual_slam_tpu_torch.ba import schedule
from stereo_visual_slam_tpu_torch.models import slam_core
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import config as port_config
from stereo_visual_slam_tpu_torch.utils import cuda_graph
from stereo_visual_slam_tpu_torch.utils import dist as port_dist
from stereo_visual_slam_tpu_torch.utils import trace

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

STAGES = ["pnp", "ba-production", "ba-upstream"]


def iters_per_run(cfg) -> int:
    return cfg.classify_passes * cfg.classify_iters + cfg.full_iters + cfg.pose_only_iters


def stage(name: str, window: str = "full"):
    """A graphed stage as the drivers build it (`run`), the eager function
    it wraps (`eager`), and one call's arguments (`args`, `kwargs`)."""
    if name == "pnp":
        s = scene(**SCENES["prior_spread"])
        return SimpleNamespace(
            run=pnp.graphed(**SETTINGS), eager=functools.partial(pnp.solve_pnp_ransac, **SETTINGS),
            args=s["args"], kwargs=dict(prior_spread=s["prior_spread"]))
    cfg = BUDGETS[name.split("-")[1]]
    return SimpleNamespace(run=schedule.make_ba_schedule(cfg), eager=schedule.eager_schedule(cfg),
                           args=make_input(window), kwargs={}, cfg=cfg)


def equal(a, b) -> bool:
    return type(a) is type(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def tracer():
    """The process's tracer, empty, and off again afterwards."""
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


@pytest.mark.parametrize("name", STAGES)
def test_runs_eager_on_the_cpu(tracer, name):
    st = stage(name)
    assert isinstance(st.run, cuda_graph.Graphed)
    replays = st.run.replays
    tracer.enable()
    want = st.eager(*st.args, **st.kwargs)
    _, eager_totals = tracer.drain()
    got = [st.run(*st.args, **st.kwargs) for _ in range(2)]
    _, totals = tracer.drain()
    for res in got:
        assert equal(res, want)
    assert totals.pop(st.run.name + "_eager") == 2
    assert totals == {k: 2 * v for k, v in eager_totals.items()}
    if name == "pnp":
        assert totals == {}
    else:
        assert totals["ba.lm_iters"] == 2 * iters_per_run(st.cfg)
        assert 0 < totals["ba.lm_useful"] <= totals["ba.lm_iters"]
    assert st.run.replays == replays and not st.run.graphs and not st.run.captures


@pytest.mark.parametrize("name", ["pnp", "ba-production"])
def test_runs_eager_under_a_dispatch_mode(tracer, name):
    st = stage(name, "filling")
    tracer.enable()
    with _Ops() as plain:
        want = st.eager(*st.args, **st.kwargs)
    tracer.drain()
    with _Ops() as counted:
        got = st.run(*st.args, **st.kwargs)
    _, totals = tracer.drain()
    assert equal(got, want)
    # the mode saw every op of the eager run: nothing was replayed past it
    assert len(plain.names) > 1000 and counted.names == plain.names
    assert totals[st.run.name + "_eager"] == 1 and st.run.name + "_graph" not in totals
    assert not st.run.graphs


def test_pnp_under_collect_runs_the_same_ops():
    st = stage("pnp")
    with _Ops() as outside:
        want = st.eager(*st.args, **st.kwargs)
    with trace.collect() as counts, _Ops() as inside:
        got = st.eager(*st.args, **st.kwargs)
    # a capture runs PnP inside `collect()`: the same ops, no counter
    assert inside.names == outside.names
    assert not counts.host and not counts.device
    assert equal(got, want)


def test_shared_makes_one_graphed_a_key(monkeypatch):
    monkeypatch.setattr(cuda_graph, "_SHARED", {})
    made = []

    def make():
        made.append(cuda_graph.Graphed(torch.neg, "neg"))
        return made[-1]

    a = cuda_graph.shared("a", make)
    assert cuda_graph.shared("a", make) is a and cuda_graph.shared("b", make) is not a
    assert made == [a, cuda_graph.shared("b", make)]
    # PnP's key is its settings in any order; the schedule's its BA config
    solver = pnp.graphed(**SETTINGS)
    assert pnp.graphed(**dict(reversed(list(SETTINGS.items())))) is solver
    cfg = BUDGETS["production"]
    other = dataclasses.replace(cfg, full_iters=cfg.full_iters + 1)
    assert schedule.make_ba_schedule(cfg) is schedule.make_ba_schedule(dataclasses.replace(cfg))
    assert schedule.make_ba_schedule(other) is not schedule.make_ba_schedule(cfg)
    assert sorted(g.name for g in cuda_graph._SHARED.values()) == [
        "ba.schedule", "ba.schedule", "neg", "neg", "track.pnp"]


def test_two_chunk_steps_share_pnp_and_the_schedule(monkeypatch):
    monkeypatch.setattr(cuda_graph, "_SHARED", {})
    cfg = port_config.small_config()
    a = slam_core.ChunkStep(cfg, "cpu")
    # the number of hypotheses is an input's shape, not a PnP setting
    b = slam_core.ChunkStep(cfg.replace(pnp=dataclasses.replace(cfg.pnp, n_hypotheses=8)),
                            "cpu")
    assert sorted(g.name for g in cuda_graph._SHARED.values()) == ["ba.schedule", "track.pnp"]
    assert a.run_schedule is b.run_schedule is schedule.make_ba_schedule(cfg.ba)
    pc = cfg.pnp
    assert pnp.graphed(sample_size=pc.sample_size, inlier_px=pc.inlier_px,
                       gn_iters_hypothesis=pc.gn_iters_hypothesis,
                       gn_iters_refine=pc.gn_iters_refine,
                       huber_px=pc.huber_px) in cuda_graph._SHARED.values()
    assert len(cuda_graph._SHARED) == 2


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group in this process and its landmark mesh."""
    if dist.is_initialized():
        pytest.skip("a process group is already initialised")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield port_dist.make_landmark_mesh(1)
    finally:
        dist.destroy_process_group()


def test_a_mesh_gets_the_plain_eager_schedule(tracer, one_rank_mesh):
    cfg = BUDGETS["upstream"]
    inp, K = make_input("full")
    run = schedule.make_ba_schedule(cfg, mesh=one_rank_mesh)
    assert not isinstance(run, cuda_graph.Graphed)
    assert run.__code__ is schedule.eager_schedule(cfg, one_rank_mesh).__code__
    tracer.enable()
    got = run(inp, K)
    _, totals = tracer.drain()
    # one rank's sums are the whole window's
    assert equal(got, schedule.make_ba_schedule(cfg)(inp, K))
    assert not any(k.startswith("ba.schedule") for k in totals)
    assert totals["ba.lm_iters"] == iters_per_run(cfg)
