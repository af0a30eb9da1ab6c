"""The slice as a whole: both packages' ChunkedSlam on the same synthetic
frames, the port fed the PnP noise the JAX chunk program draws
(`fold_in(key, frame_id)`, then split -> gumbel / normal).

small_config keeps the KITTI principal point (607, 185), which lies outside
its 128x256 image; there tracking is so ill-conditioned (ATE ~3.3 m in both
packages) that a rounding-level change inside the port alone moves poses by
~1e-2 m. These per-frame tests centre the principal point in the image;
test_torch_slice_levels.py holds the unmodified small_config to
trajectory-level bounds.

Cases: 1 strict (n_levels=1, 16 frames, chunk 8), 3 carry across a JAX
snapshot, 4 no jax in the port's imports. Case 2 (3 levels) is in
test_torch_slice_levels.py.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
from stereo_visual_slam_tpu.utils import config as jax_config
from stereo_visual_slam_tpu_torch.models import slam_core
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam as TorchSlam
from stereo_visual_slam_tpu_torch.utils import config as port_config

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

N_FRAMES = 16
CHUNK = 8


# Each package gets its own config: the JAX functions the JAX package's
# `Config` (jax.jit hashes it as a static argument), the port's functions the
# port's copy, both built by the same calls from their own module.
CONFIGS = (jax_config, port_config)


def slice_config(config, n_levels):
    cfg = config.small_config()
    return cfg.replace(
        frontend=dataclasses.replace(cfg.frontend, n_levels=n_levels),
        camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0),
    )


def slice_configs(n_levels):
    """(the JAX package's config, the port's) of slice_config."""
    return tuple(slice_config(c, n_levels) for c in CONFIGS)


def jax_noise(cfg, seed=0):
    """The per-frame PnP draws of the JAX chunk program, as torch tensors."""
    key = jax.random.PRNGKey(seed)
    H, N = cfg.pnp.n_hypotheses, cfg.frontend.max_raw_keypoints

    @jax.jit
    def draws(fid):
        k_sample, k_perturb = jax.random.split(jax.random.fold_in(key, fid))
        return (jax.random.gumbel(k_sample, (H, N), jnp.float32),
                jax.random.normal(k_perturb, (H, 6), jnp.float32))

    def noise(fid):
        g, t = draws(fid)
        return torch.from_numpy(np.array(g)), torch.from_numpy(np.array(t))

    return noise


def assert_same_run(j, t, first=0):
    js = [s for s in j.stats if s["frame_id"] >= first]
    ts = [s for s in t.stats if s["frame_id"] >= first]
    assert [s["frame_id"] for s in js] == [s["frame_id"] for s in ts]
    for a, b in zip(js, ts):
        assert (a["state"], a["keyframe"], a["n_matches"]) == \
            (b["state"], b["keyframe"], b["n_matches"]), (a, b)
        assert abs(a["n_inliers"] - b["n_inliers"]) <= 1, (a, b)
    assert set(t.estimates) <= set(j.estimates)
    for f in t.estimates:
        np.testing.assert_allclose(t.estimates[f], j.estimates[f], atol=1e-4, rtol=0,
                                   err_msg=f"frame {f}")


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = slice_configs(1)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=0)
    frames = list(synthetic.frames(world))
    ref = JaxSlam(jcfg, chunk=CHUNK)
    ref.run(frames)
    ref.finish()
    return (jcfg, tcfg), frames, ref


def test_strict_slice_matches_jax(setup, monkeypatch):
    (jcfg, tcfg), frames, ref = setup
    written = []
    real_set_rows = slam_core._set_rows

    def checked_set_rows(arr, rows, vals, col=None):
        r = rows[rows < arr.shape[0]]
        written.append(len(r))
        assert len(torch.unique(r)) == len(r), "duplicate rows in a scatter"
        return real_set_rows(arr, rows, vals, col)

    monkeypatch.setattr(slam_core, "_set_rows", checked_set_rows)
    t = TorchSlam(tcfg, chunk=CHUNK, device="cpu", noise_fn=jax_noise(jcfg))
    t.run(frames)
    t.finish()
    assert not t.lost and not ref.lost
    assert len(t.stats) == N_FRAMES
    assert_same_run(ref, t)
    assert sum(s["ba_cost"] is not None for s in t.stats) >= 1
    assert sum(written) > 0
    # one branch fetch per frame + one record fetch per chunk
    assert t.syncs == N_FRAMES + N_FRAMES // CHUNK


def test_carry_across_jax_snapshot(setup, tmp_path):
    (jcfg, tcfg), frames, _ = setup
    path = str(tmp_path / "state.npz")
    j = JaxSlam(jcfg, chunk=CHUNK)
    for f, left, right in frames[:8]:
        j.process(f, left, right)
    j.save_snapshot(path)
    for f, left, right in frames[8:]:
        j.process(f, left, right)
    j.finish()

    t = TorchSlam(tcfg, chunk=CHUNK, device="cpu", noise_fn=jax_noise(jcfg))
    t.load_snapshot(path)
    for f, left, right in frames[8:]:
        t.process(f, left, right)
    t.finish()
    assert_same_run(j, t, first=8)
    # and the port's own snapshot round-trips the carry exactly
    path2 = str(tmp_path / "port.npz")
    t.save_snapshot(path2)
    u = TorchSlam(tcfg, chunk=CHUNK, device="cpu")
    u.load_snapshot(path2)
    for a, b in zip(slam_core.carry_to_numpy(t.carry).values(),
                    slam_core.carry_to_numpy(u.carry).values()):
        np.testing.assert_array_equal(a, b)


def test_chunked_slam_needs_an_explicit_device():
    cfg = slice_config(port_config, 1)
    with pytest.raises(TypeError):
        TorchSlam(cfg, chunk=CHUNK)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchSlam(cfg, chunk=CHUNK, device="cuda")


def test_port_imports_no_jax():
    code = ("import sys, stereo_visual_slam_tpu_torch, "
            "stereo_visual_slam_tpu_torch.pipeline.chunked, "
            "stereo_visual_slam_tpu_torch.pipeline.vo, "
            "stereo_visual_slam_tpu_torch.pipeline.snapshot, "
            "stereo_visual_slam_tpu_torch.run_vslam; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'yaml' not in sys.modules, 'yaml imported'; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
