"""The port on the card at full size through the synthetic worlds the JAX
package checks in its slow tests: the hard profile (tests/test_hard_profile.py,
45 frames, seed 3), the highway profile (tests/test_highway_profile.py, 96
frames, seed 5) and the long run with eviction churn (tests/test_long_run.py,
120 frames, seed 11), each with the JAX test's checks, on the port's
ChunkedSlam fed frame by frame. Frames render on a process pool.

They need a CUDA card: marked `cuda`, they skip without one. On the card,
run them without tests/conftest.py, which imports jax, pins it to 8
virtual CPU devices and turns its compilation cache on, none of which
the port uses:
python -m pytest --noconftest tests/test_torch_profiles_cuda.py
"""

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch.data import render_pool, synthetic
from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj_mod
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
from stereo_visual_slam_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def renderer():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with render_pool.Renderer() as r:
        yield r


def _run(renderer, world, chunk):
    """The world's frames streamed through ChunkedSlam on the card."""
    frames = renderer.render_all(world)
    slam = ChunkedSlam(world.config, chunk=chunk, device="cuda")
    for f, left, right in frames:
        slam.process(f, left, right)
        if slam.lost:
            break
    slam.finish()
    fids = sorted(slam.estimates)
    est = np.stack([slam.estimates[f] for f in fids])
    return slam, est, world.poses_T_c_w[fids]


@pytest.fixture(scope="module")
def hard(renderer):
    world = synthetic.make_world(Config(), n_frames=45, n_points=8000, seed=3, profile="hard")
    return world, _run(renderer, world, chunk=5)


@pytest.fixture(scope="module")
def highway(renderer):
    world = synthetic.make_world(Config(), n_frames=96, n_points=8000, seed=5, profile="highway")
    return world, _run(renderer, world, chunk=6)


@pytest.fixture(scope="module")
def long_run(renderer):
    world = synthetic.make_world(Config(), n_frames=120, n_points=5500, seed=11)
    return world, _run(renderer, world, chunk=8)


def test_hard_profile_tracks_through(hard):
    world, (slam, est, gt) = hard
    assert world.noise_sigma > 0 and world.occ_pos is not None and world.sizes is not None
    assert (world.points[:, 1] > 1e5).sum() > 150   # the low-texture stretch
    assert not slam.lost, "hard profile blew the Lost fuse"
    n_tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    assert n_tracked >= 45 - 4, [(s["frame_id"], s["state"]) for s in slam.stats]
    ate = traj_mod.ate_rmse(est, gt)
    assert ate < 0.8, f"hard-profile ATE {ate}"


def test_highway_tracks_through(highway):
    world, (slam, est, gt) = highway
    step = np.linalg.norm(world.poses_T_c_w[1][:3, 3] - world.poses_T_c_w[0][:3, 3])
    assert 2.5 < step < 2.9, step
    assert not slam.lost, "highway profile blew the Lost fuse"
    n_tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    assert n_tracked >= 96 - 2, [(s["frame_id"], s["state"]) for s in slam.stats]
    t_err, _ = traj_mod.kitti_errors(est, gt)
    assert t_err <= 4.17, f"highway trans error {t_err}%"


def test_long_run_tracks_and_meets_the_kitti_gates(long_run):
    world, (slam, est, gt) = long_run
    assert not slam.lost
    n_tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    assert n_tracked >= 120 - 2, n_tracked
    assert len(est) >= 120 - 2
    t_err, r_err = traj_mod.kitti_errors(est, gt)
    assert t_err <= 1.5, f"trans {t_err}% (binding gate; parity line 4.17)"
    assert r_err <= 0.02, f"rot {r_err} deg/m (binding gate; parity 1.37)"
    ate = traj_mod.ate_rmse(est, gt)
    assert ate <= 2.0, f"ate {ate} m"


def test_long_run_eviction_churn(long_run):
    world, (slam, _, _) = long_run
    n_kf = sum(1 for s in slam.stats if s["keyframe"])
    Kw = world.config.keyframe.window_size
    assert n_kf > 2 * Kw, f"only {n_kf} keyframes - no steady-state churn"
    assert len(slam.evictions) >= n_kf - Kw
    assert int(slam.map.alive.sum()) < world.config.ba.max_landmarks
