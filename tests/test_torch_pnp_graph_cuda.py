"""PnP-RANSAC replayed as a CUDA graph (`pnp.graphed`, a
utils/cuda_graph.Graphed) on the card, at the production shapes (N=2,048
matches, H=128 hypotheses):

- the eager `solve_pnp_ransac` waits on the host nowhere (torch's sync
  debug mode set to raise), so a graph can capture it;
- each replay runs the two hand-written kernels (`track.pnp_kernel` and
  each kernel's launch counter count one a replay), equals the eager call bit for bit and the plain
  path within 1e-5, raises nothing under the sync debug mode, and leaves
  the results of the call before it as they were (they are clones, not
  the graph's output buffers);
- both drivers, fed 24 frames of the production world, give the same
  records, poses and final state with the graph as with the eager
  function (`chunked.differences` empty);
- two ChunkedSlam runs in one process share one capture: `captures` is 1,
  `replays` the frames tracked, and the tracer counts every call as
  `track.pnp_graph`, none as `track.pnp_eager`.

They need a CUDA card: marked `cuda`, they skip without one. On the card,
run them without tests/conftest.py, which imports jax, pins it to 8
virtual CPU devices and turns its compilation cache on, none of which the
port uses:
python -m pytest --noconftest tests/test_torch_pnp_graph_cuda.py
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.ops import kernels
from stereo_visual_slam_tpu_torch.pipeline import chunked
from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import cuda_graph, trace

pytestmark = pytest.mark.cuda

N_FRAMES = 24
CHUNK = 8


@pytest.fixture(scope="module")
def production():
    """Production Config() and the first N_FRAMES frames of the default
    world."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_visual_slam_tpu_torch.ops.kernels import measure

    return measure.production_frames(N_FRAMES)


def settings(cfg) -> dict:
    pc = cfg.pnp
    return dict(sample_size=pc.sample_size, inlier_px=pc.inlier_px,
                gn_iters_hypothesis=pc.gn_iters_hypothesis,
                gn_iters_refine=pc.gn_iters_refine, huber_px=pc.huber_px)


def inputs(cfg, seed, dev):
    """PnP's arguments at the production shapes (`measure.pnp_inputs`)."""
    from stereo_visual_slam_tpu_torch.ops.kernels import measure

    return measure.pnp_inputs(cfg, seed, dev)


@contextlib.contextmanager
def sync_raises():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def equal(a: pnp.PnPResult, b: pnp.PnPResult) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_eager_pnp_never_waits_on_the_host(production):
    cfg, _ = production
    args = inputs(cfg, 0, torch.device("cuda"))
    spread = torch.tensor(0.3, device="cuda")
    pnp.solve_pnp_ransac(*args, prior_spread=spread, **settings(cfg))   # makes its constants
    torch.cuda.synchronize()
    with sync_raises():
        pnp.solve_pnp_ransac(*args, prior_spread=spread, **settings(cfg))
        se3.make(torch.eye(3, device="cuda"), torch.zeros(3, device="cuda"))
    torch.cuda.synchronize()


def test_replays_equal_eager_and_keep_their_outputs(production):
    cfg, _ = production
    dev = torch.device("cuda")
    solver = cuda_graph.Graphed(functools.partial(pnp.solve_pnp_ransac, **settings(cfg)),
                                "track.pnp")
    calls = [(inputs(cfg, seed, dev), spread)
             for seed, spread in ((1, torch.tensor(0.3, device=dev)), (2, 0.6), (3, 0.0))]
    kernels.reset_launch_counts()
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        got = [solver(*calls[0][0], prior_spread=calls[0][1])]
        assert solver.captures == 1
        with sync_raises():
            got += [solver(*args, prior_spread=spread) for args, spread in calls[1:]]
    finally:
        trace.disable()
        _, totals = trace.drain()
    assert (solver.captures, solver.replays) == (1, 3)
    # the graph holds the kernels: each replay hands on the capture's count
    assert totals["track.pnp_kernel"] == totals["track.pnp_graph"] == 3
    launched = kernels.launch_counts()
    assert launched["pnp_hypotheses"] == launched["pnp_refine"] == 3
    for (args, spread), res in zip(calls, got):
        want = pnp.solve_pnp_ransac(*args, prior_spread=spread, **settings(cfg))
        assert equal(res, want)
        plain = pnp.solve_pnp_ransac_plain(*args, prior_spread=spread, **settings(cfg))
        assert float((res.T_c_w - plain.T_c_w).abs().max()) <= 1e-5
        assert int(res.n_inliers) > 800
    # the replays differ, so a result that aliased the graph's buffers
    # would have read the last one
    assert not torch.equal(got[0].T_c_w, got[-1].T_c_w)


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


def eager(monkeypatch):
    """Trackers built inside this context call the eager function."""
    monkeypatch.setattr(pnp, "graphed",
                        lambda **kw: functools.partial(pnp.solve_pnp_ransac, **kw))


@pytest.mark.parametrize("driver", ["chunked", "host"])
def test_drivers_equal_with_graph_and_eager(production, monkeypatch, driver):
    cfg, frames = production
    run = {"chunked": run_chunked, "host": run_host}[driver]
    graph = run(cfg, frames)
    with monkeypatch.context() as m:
        eager(m)
        plain = run(cfg, frames)
    assert len(graph.estimates) >= 16
    # the host driver's records carry their host wall time (`wall_s`)
    assert [records(s) for s in graph.stats] == [records(s) for s in plain.stats]
    assert sorted(graph.estimates) == sorted(plain.estimates)
    for f in graph.estimates:
        assert np.array_equal(graph.estimates[f], plain.estimates[f]), f
    if driver == "chunked":
        assert chunked.differences(graph, plain) == []


def test_two_drivers_share_one_capture(production, monkeypatch):
    cfg, frames = production
    monkeypatch.setattr(cuda_graph, "_SHARED", {})
    run_chunked(cfg, frames)
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        run_chunked(cfg, frames)
    finally:
        trace.disable()
        _, totals = trace.drain()
    solver = pnp.graphed(**settings(cfg))
    assert (solver.captures, solver.replays) == (1, 2 * N_FRAMES)
    assert len(solver.graphs) == 1
    assert totals["track.pnp_graph"] == N_FRAMES
    assert "track.pnp_eager" not in totals
