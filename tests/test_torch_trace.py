"""The port's tracer (utils/trace.py) on the CPU: off, a run records
nothing, creates no tensor and never calls record_function; on, the run is
bit-equal to the run with it off, the spans form the layers' tree with
their chunk and frame ids, the `driver.wait` spans are the driver's counted
waits, the rows lie on kineto's clock, and the LM counters count the
iterations dispatched and those that could still move the state."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from stereo_visual_slam_tpu_torch.ba import pose_only, schur_lm
from stereo_visual_slam_tpu_torch.data import synthetic
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.pipeline import chunked
from stereo_visual_slam_tpu_torch.utils import config as port_config
from stereo_visual_slam_tpu_torch.utils import trace

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

N_FRAMES = 16
CHUNK = 8
# the layers' tree: each span's parent
PARENTS = {
    "chunk": {None}, "extract": {"chunk"}, "extract.brief": {"extract"}, "frame": {"chunk"},
    "track": {"frame"},
    "track.match": {"track"}, "track.pnp": {"track"}, "keyframe.depth": {"frame"},
    "keyframe.insert": {"frame"}, "keyframe.ba": {"frame"},
    # the branch fetch in a frame, the record fetch in its chunk
    "driver.wait": {"frame", "chunk"},
}


@pytest.fixture
def tracer():
    """The process's tracer, empty, and off again afterwards."""
    trace.disable()
    trace.drain()
    yield trace
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def world():
    cfg = port_config.small_config()
    cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, n_levels=1),
                      camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))
    w = synthetic.make_world(cfg, n_frames=N_FRAMES, n_points=1500, seed=0)
    return cfg, list(synthetic.frames(w))


def _run(cfg, frames, mode="stream", n=N_FRAMES):
    slam = chunked.ChunkedSlam(cfg, chunk=CHUNK, device="cpu")
    if mode == "stream":
        slam.run(frames[:n], stage=False)
    else:
        slam.run_staged(slam.stage(frames[:n]))
    slam.finish()
    return slam


@pytest.fixture(scope="module")
def untraced(world):
    cfg, frames = world
    return _run(cfg, frames)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_off_creates_no_tensor_and_records_nothing(tracer):
    t = torch.zeros(())
    with _CountOps() as ops:
        with tracer.span("track", frame=3) as row:
            tracer.add("ba.lm_useful", t)
        tracer.add("ba.lm_iters", 5)
    assert ops.n == 0 and row is None
    assert tracer.span("a") is tracer.span("b", chunk=1)
    assert tracer.drain() == ([], {})


def test_off_run_never_calls_record_function(tracer, world, monkeypatch):
    cfg, frames = world
    calls = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    _run(cfg, frames, n=CHUNK)
    assert calls == []
    assert tracer.drain() == ([], {})


def test_counters_sum_and_drain_clears(tracer):
    tracer.enable()
    for v in (True, False, True):
        tracer.add("ba.lm_useful", torch.tensor(v))
    tracer.add("ba.lm_iters", 2)
    tracer.add("ba.lm_iters", 3)
    tracer.add("x", torch.tensor([0.5, 0.25]))
    with tracer.span("open"):
        rows, totals = tracer.drain()
        assert rows == [] and totals == {"ba.lm_useful": 2, "ba.lm_iters": 5, "x": 0.75}
        assert tracer.drain() == ([], {})
    rows, _ = tracer.drain()
    assert [r.name for r in rows] == ["open"] and rows[0].t1 >= rows[0].t0


@pytest.mark.parametrize("mode", ["stream", "staged"])
def test_on_is_bit_equal_and_spans_form_the_layers_tree(tracer, world, untraced, mode):
    cfg, frames = world
    tracer.enable()
    slam = _run(cfg, frames, mode)
    tracer.disable()
    rows, totals = tracer.drain()
    assert chunked.differences(untraced, slam) == []

    by_id = {r.id: r for r in rows}
    names = collections.Counter(r.name for r in rows)
    assert set(names) == set(PARENTS)
    for r in rows:
        parent = by_id.get(r.parent)
        assert (parent.name if parent else None) in PARENTS[r.name], r
        if parent:
            assert parent.t0 <= r.t0 <= r.t1 <= parent.t1, (parent, r)
            assert r.chunk == parent.chunk, (parent, r)
            if r.name != "frame":
                assert r.frame == parent.frame, (parent, r)
    chunks = [r for r in rows if r.name == "chunk"]
    assert [c.chunk for c in chunks] == list(range(0, N_FRAMES, CHUNK))
    assert all(r.chunk is not None for r in rows)
    assert names["extract"] == len(chunks)

    fids = [r.frame for r in rows if r.name == "frame"]
    assert fids == [s["frame_id"] for s in slam.stats]
    tracks = collections.Counter(by_id[r.parent].frame for r in rows if r.name == "track")
    assert tracks == collections.Counter(fids) and max(tracks.values()) == 1
    keyframes = [s["frame_id"] for s in slam.stats if s["keyframe"]]
    for name in ("keyframe.depth", "keyframe.insert"):
        assert [r.frame for r in rows if r.name == name] == keyframes
    ba = [s["frame_id"] for s in slam.stats if s["ba_cost"] is not None]
    assert ba and [r.frame for r in rows if r.name == "keyframe.ba"] == ba
    # every wait the driver counts is a span, and every span a counted wait
    assert names["driver.wait"] == slam.syncs == N_FRAMES + len(chunks)

    b = cfg.ba
    per_run = b.classify_passes * b.classify_iters + b.full_iters + b.pose_only_iters
    assert totals["ba.lm_iters"] == len(ba) * per_run
    assert 0 < totals["ba.lm_useful"] <= totals["ba.lm_iters"]


def test_rows_lie_on_kinetos_clock(tracer, world):
    cfg, frames = world
    tracer.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(cfg, frames, n=CHUNK)
    tracer.disable()
    rows, _ = tracer.drain()
    ranges = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(trace.PREFIX):
            ranges[e.name()[len(trace.PREFIX):]].append((e.start_ns(), e.end_ns()))
    spans = collections.defaultdict(list)
    for r in rows:
        spans[r.name].append((r.t0, r.t1))
    assert sorted(ranges) == sorted(spans)
    for name, got in spans.items():
        want = sorted(ranges[name])
        assert len(got) == len(want), name
        for (t0, t1), (k0, k1) in zip(got, want):
            assert abs(t0 - k0) <= 1_000_000 and abs(t1 - k1) <= 1_000_000, (name, t0 - k0, t1 - k1)


FX, FY, CX, CY = 718.856, 718.856, 607.1928, 185.2157
K = torch.tensor([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], dtype=torch.float32)


def _ba_window(seed, n_kf=5, n_lm=120):
    """A driving window: forward motion, landmarks ahead, noisy poses and
    points, the first pose fixed."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-25, 25, n_lm), rng.uniform(-6, 6, n_lm),
                    rng.uniform(15, 80, n_lm)], -1).astype(np.float32)
    T_gt = torch.stack([se3.exp(torch.tensor([0.05 * k, 0.0, -1.2 * k, 0.0, 0.01 * k, 0.0]))
                        for k in range(n_kf)])
    Xc = np.einsum("kij,lj->lki", T_gt[:, :3, :3].numpy(), pts) + T_gt[None, :, :3, 3].numpy()
    uv = np.stack([FX * Xc[..., 0] / Xc[..., 2] + CX, FY * Xc[..., 1] / Xc[..., 2] + CY], -1)
    uv = uv + rng.normal(0, 0.3, uv.shape)
    T_init = torch.stack([se3.exp(torch.tensor(rng.normal(0, 0.02, 6), dtype=torch.float32)) @ Tk
                          for Tk in T_gt])
    T_init[0] = T_gt[0]
    fixed = torch.zeros(n_kf)
    fixed[0] = 1.0
    points = pts + rng.normal(0, 0.3, pts.shape).astype(np.float32)
    return schur_lm.BAProblem(
        T_c_w=T_init, points=torch.from_numpy(points), uv=torch.from_numpy(uv.astype(np.float32)),
        obs_mask=torch.ones(n_lm, n_kf), point_mask=torch.ones(n_lm), pose_mask=torch.ones(n_kf),
        fixed_pose=fixed)


@pytest.mark.parametrize("optimize", [schur_lm.lm_optimize, pose_only.optimize_pose_only],
                         ids=["schur_lm", "pose_only"])
def test_lm_useful_counts_the_iterations_that_move_the_state(tracer, optimize):
    problem, iters = _ba_window(0), 12
    # rel_tol set so that `done` trips mid-loop
    results = [optimize(problem, K, iters=k, rel_tol=1e-3) for k in range(iters + 1)]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    settled = min(k for k in range(iters + 1) if same(results[k], results[iters]))
    assert 0 < settled < iters
    tracer.enable()
    traced = optimize(problem, K, iters=iters, rel_tol=1e-3)
    _, totals = tracer.drain()
    assert same(traced, results[iters])
    assert totals == {"ba.lm_iters": iters, "ba.lm_useful": settled}
