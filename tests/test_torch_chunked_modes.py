"""The port's ChunkedSlam dataset modes and map view: `run_staged` and
`run_rolling` give the streaming run's results bit for bit on the CPU;
`run_rolling(window_chunks=1)` ends (the reference's spins forever); the
eager-depth chunk path (`frontend.lazy_depth=False`) equals the lazy one;
`map` matches the JAX package's `_MapView` on the same run."""

import dataclasses
import threading

import numpy as np
import pytest

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
from stereo_visual_slam_tpu_torch.models import slam_core
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam as TorchSlam

from test_torch_slice import assert_same_run, jax_noise, slice_configs

N_FRAMES = 14   # not a multiple of the chunk: the tail chunk is partial
CHUNK = 4


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = slice_configs(1)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=1)
    frames = list(synthetic.frames(world))
    streamed = TorchSlam(cfg, chunk=CHUNK, device="cpu")
    streamed.run(frames, stage=False)
    streamed.finish()
    return (jcfg, cfg), frames, streamed


def assert_identical(a, b):
    assert a.stats == b.stats
    assert sorted(a.estimates) == sorted(b.estimates)
    for f in a.estimates:
        np.testing.assert_array_equal(a.estimates[f], b.estimates[f])
    for x, y in zip(slam_core.carry_to_numpy(a.carry).values(),
                    slam_core.carry_to_numpy(b.carry).values()):
        np.testing.assert_array_equal(x, y)


def _rolling(slam, frames, window):
    """run_rolling on a thread, so that a hang fails the test instead of
    stalling the suite."""
    ticks, errors = [], []

    def target():
        try:
            slam.run_rolling(iter(frames), window_chunks=window,
                             on_progress=lambda: ticks.append(len(slam.stats)))
        except Exception as e:  # reported below, on the test's thread
            errors.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), f"run_rolling(window_chunks={window}) did not end"
    assert not errors, errors
    return ticks


@pytest.mark.parametrize("mode", ["staged", "rolling2", "rolling1"])
def test_dataset_modes_equal_streaming(setup, mode):
    (_, cfg), frames, streamed = setup
    slam = TorchSlam(cfg, chunk=CHUNK, device="cpu")
    if mode == "staged":
        staged = slam.stage(frames)
        assert [len(fids) for _, fids in staged] == [4, 4, 4, 2]
        slam.run_staged(staged)
    else:
        ticks = _rolling(slam, frames, int(mode[-1]))
        assert ticks[-1] == N_FRAMES and len(ticks) >= 2
    slam.finish()
    assert len(slam.stats) == N_FRAMES
    assert_identical(slam, streamed)


def test_run_rolling_pulls_frames_lazily(setup):
    """At most window_chunks chunks are staged ahead of the dispatch."""
    (_, cfg), frames, _ = setup
    slam = TorchSlam(cfg, chunk=CHUNK, device="cpu")
    pulled = []

    def source():
        for fr in frames:
            # frames pulled so far minus frames processed: the staged backlog
            pulled.append(len(pulled) - len(slam.stats))
            yield fr

    _rolling(slam, source(), 2)
    assert max(pulled) <= 2 * CHUNK
    with pytest.raises(ValueError):
        slam.run_rolling(iter(frames), window_chunks=0)


def test_close_stops_feeding(setup):
    (_, cfg), frames, _ = setup
    slam = TorchSlam(cfg, chunk=CHUNK, device="cpu")
    for f, left, right in frames[:6]:
        slam.process(f, left, right)
    slam.close()
    assert len(slam.stats) == 6      # the partial chunk ran
    with pytest.raises(RuntimeError):
        slam.process(*frames[6])


def test_eager_depth_chunk_path_equals_lazy(setup):
    (_, cfg), frames, streamed = setup
    eager_cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, lazy_depth=False))
    slam = TorchSlam(eager_cfg, chunk=CHUNK, device="cpu")
    assert slam.chunk_step.depth_fn is None
    slam.run(frames)
    slam.finish()
    assert_identical(slam, streamed)


def test_map_view_matches_jax(setup):
    (jcfg, tcfg), frames, _ = setup
    j = JaxSlam(jcfg, chunk=CHUNK)
    j.run(frames)
    j.finish()
    t = TorchSlam(tcfg, chunk=CHUNK, device="cpu", noise_fn=jax_noise(jcfg))
    t.run(frames)
    t.finish()
    assert_same_run(j, t)
    jm, tm = j.map, t.map
    np.testing.assert_array_equal(tm.alive, jm.alive)
    np.testing.assert_array_equal(tm.inlier, jm.inlier)
    np.testing.assert_allclose(tm.pos[tm.alive], jm.pos[jm.alive], atol=1e-4, rtol=1e-5)
    assert sorted(tm.keyframes) == sorted(jm.keyframes) and len(tm.keyframes) > 1
    for fid, kf in tm.keyframes.items():
        assert kf.frame_id == fid
        np.testing.assert_allclose(kf.T_c_w, jm.keyframes[fid].T_c_w, atol=1e-4)
    assert tm.alive.sum() == len(t.landmarks()) + (tm.alive & ~tm.inlier).sum()
