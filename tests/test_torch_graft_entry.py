"""The port's driver entry points (stereo_visual_slam_tpu_torch/graft_entry.py)
on the CPU: entry()'s per-frame step against the JAX __graft_entry__.entry()
step on the same example inputs at small size (the JAX package's Config
swapped for its small_config), the port fed JAX's PnP draws; and
dryrun_multichip on one in-process gloo rank and on two gloo ranks of
tests/torch_mesh_worker.py."""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from stereo_visual_slam_tpu.utils import config as jax_config
from stereo_visual_slam_tpu_torch import graft_entry
from stereo_visual_slam_tpu_torch.utils.config import small_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_FRAMES, CHUNK = 16, 8
N_POINTS = 1500   # at small_config's image size (6,000 at full size)


def _jax_entry():
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__
    finally:
        sys.path.remove(str(REPO))
    return __graft_entry__


def test_entry_step_matches_jax(monkeypatch):
    small = jax_config.small_config()
    monkeypatch.setattr(jax_config, "Config", lambda: small)
    jfn, jargs = _jax_entry().entry()
    cfg = small_config()
    fn, args = graft_entry.entry("cpu", cfg)

    # the same example inputs, drawn in the same order
    left, right, prev, T_init, gap, gumbel, twist = args
    np.testing.assert_array_equal(left.numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(right.numpy(), np.asarray(jargs[1]))
    for f in prev._fields:
        np.testing.assert_array_equal(getattr(prev, f).numpy(), np.asarray(getattr(jargs[2], f)),
                                      err_msg=f)
    np.testing.assert_array_equal(T_init.numpy(), np.asarray(jargs[3]))
    assert float(gap) == float(jargs[4])
    assert gumbel.shape == (cfg.pnp.n_hypotheses, cfg.frontend.n_features)

    # the port fed the draws the JAX step takes from its key
    k_sample, k_perturb = jax.random.split(jargs[5])
    g = np.array(jax.random.gumbel(k_sample, gumbel.shape, jnp.float32))
    tw = np.array(jax.random.normal(k_perturb, twist.shape, jnp.float32))
    jstate, jinfo = jax.jit(jfn)(*jargs)
    state, info = fn(left, right, prev, T_init, gap, torch.from_numpy(g), torch.from_numpy(tw))

    for f in ("yx", "valid", "signs", "lm_id", "lm_reliable"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), np.asarray(getattr(jstate, f)),
                                      err_msg=f)
    np.testing.assert_allclose(state.lm_pos.numpy(), np.asarray(jstate.lm_pos), atol=1e-5)
    np.testing.assert_allclose(state.T_c_w.numpy(), np.asarray(jstate.T_c_w), atol=1e-4)
    assert int(info.n_matches) == int(jinfo.n_matches)
    assert int(info.n_inliers) == int(jinfo.n_inliers)


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry("cuda", small_config())


def _dryrun_config():
    cfg = small_config()
    return cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))


@pytest.fixture(scope="module")
def one_rank():
    """dryrun_multichip(1) in this process: a one-rank gloo group."""
    return graft_entry.dryrun_multichip(1, "cpu", _dryrun_config(), n_frames=N_FRAMES,
                                        chunk=CHUNK, n_points=N_POINTS)


def test_dryrun_one_rank(one_rank, capsys):
    assert one_rank["backend"] == "gloo" and one_rank["size"] == 1
    assert one_rank["frames"] == N_FRAMES
    assert one_rank["kf_count"] > 0 and one_rank["ba_runs"] > 0
    # min_inliers_skip is forced: every tracked frame is a keyframe
    assert one_rank["keyframes"] == N_FRAMES
    assert not torch.distributed.is_initialized()   # the group it made is gone


def test_dryrun_two_gloo_ranks(one_rank, tmp_path):
    outs = worker.launch("dryrun", 2, dict(n_frames=np.int64(N_FRAMES), chunk=np.int64(CHUNK),
                                         n_points=np.int64(N_POINTS)),
                         str(tmp_path))
    for r, out in enumerate(outs):
        assert int(out["rank"]) == r and int(out["size"]) == 2
        assert str(out["backend"]) == "gloo"
        assert int(out["kf_count"]) > 0 and int(out["ba_runs"]) > 0
    # the ranks hold the same state, within the mesh's tolerance of one rank
    np.testing.assert_array_equal(outs[0]["T_c_w"], outs[1]["T_c_w"])
    np.testing.assert_allclose(outs[0]["T_c_w"], one_rank["T_c_w"], atol=5e-2)
