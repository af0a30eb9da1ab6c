"""The port's copy of the JAX package's random stream (utils/prng.py)
against jax.random itself (threefry2x32, partitionable, x64 off), and the
port's drivers with their default draws against the JAX drivers.

Keys and bits: bit-equal. Seeds 0, 7, 2**31 - 1, -1 and 2**32 + 5 (which
jax without x64 takes as the key (0, 5)); the seed's key, its fold_in of
frame ids 0, 1 and 1000 and both halves of its split; shapes of the PnP
draws at production size ((128, 2048), (128, 6)) and two odd ones.
uniform: bit-equal. gumbel and normal run torch's log / log1p where XLA
runs its own: gumbel within GUMBEL_ULPS units in the last place of
max(|x|, 1) (gumbel values cross 0, where a plain ulp count means
nothing), normal within NORMAL_ULPS ulps (measured: 2 and 3).

The drivers with no `noise_fn` (the default draws) reproduce the JAX
drivers at test_torch_slice's config and tolerance: records equal,
`n_inliers` within 1, poses atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
from stereo_visual_slam_tpu_torch.pipeline import snapshot as tsnapshot
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam as TorchSlam
from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry as TorchVO
from stereo_visual_slam_tpu_torch.utils import prng

from test_torch_slice import CHUNK, assert_same_run, jax_noise, slice_configs
from test_torch_vo import CONFIGS, assert_same_vo, jax_vo, jax_vo_noise, run, vo_config

torch.set_num_threads(1)

SEEDS = (0, 7, 2**31 - 1, -1, 2**32 + 5)
SHAPES = ((128, 2048), (128, 6), (8, 3, 5), (1,))
GUMBEL_ULPS = 4
NORMAL_ULPS = 4
N_FRAMES = 16


def keys_of(seed):
    """[(jax key, port key)] of the seed, its fold_in of 0/1/1000 and its
    split halves."""
    jk, pk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    out = [(jk, pk)]
    out += [(jax.random.fold_in(jk, f), prng.fold_in(pk, f)) for f in (0, 1, 1000)]
    out += list(zip(jax.random.split(jk), prng.split(pk)))
    return out


def as_key(jk):
    return tuple(int(v) for v in np.asarray(jk))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    for jk, pk in keys_of(seed):
        assert as_key(jk) == pk
    jk = jax.random.PRNGKey(seed)
    assert [as_key(k) for k in jax.random.split(jk, 5)] == prng.split(prng.prng_key(seed), 5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_bit_equal(seed, shape):
    for jk, pk in keys_of(seed):
        bits = prng.random_bits(pk, shape, "cpu")
        assert bits.shape == shape and bits.dtype == torch.int64
        np.testing.assert_array_equal(bits.numpy(),
                                      np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
        for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-3.0, 5.5)):
            u = prng.uniform(pk, shape, "cpu", lo, hi).numpy()
            np.testing.assert_array_equal(
                u.view(np.int32), np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, hi))
                .view(np.int32))


def _ulps(a, b, floor=0.0):
    """|a - b| in units in the last place of max(|b|, floor)."""
    return float((np.abs(a - b) / np.spacing(np.maximum(np.abs(b), floor).astype(np.float32))).max())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_normal_within_ulps(seed, shape):
    for jk, pk in keys_of(seed):
        g = prng.gumbel(pk, shape, "cpu").numpy()
        n = prng.normal(pk, shape, "cpu").numpy()
        assert g.dtype == n.dtype == np.float32 and np.isfinite(g).all() and np.isfinite(n).all()
        assert _ulps(g, np.asarray(jax.random.gumbel(jk, shape, jnp.float32)), 1.0) <= GUMBEL_ULPS
        assert _ulps(n, np.asarray(jax.random.normal(jk, shape, jnp.float32))) <= NORMAL_ULPS


def test_erfinv_edges_equal_jax():
    x = np.array([-1.0, -0.999999, -0.5, 0.0, 1e-30, 0.5, 0.9999, 1.0], np.float32)
    np.testing.assert_array_equal(prng.erfinv(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.lax.erf_inv(jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 3])
def test_chunk_draws_equal_jax_chunk_program(seed):
    """frame_draws: the JAX chunk program's fold_in(PRNGKey(seed), f) draws
    (test_torch_slice.jax_noise), all of a chunk's frames in one pass, equal
    to one key at a time."""
    jcfg, tcfg = slice_configs(1)
    H, N = tcfg.pnp.n_hypotheses, tcfg.frontend.max_raw_keypoints
    fids = [0, 1, 7, 8, 1000]
    draws = prng.frame_draws(prng.prng_key(seed), H, N, "cpu")(fids)
    ref = jax_noise(jcfg, seed)
    for f, (g, t) in zip(fids, draws):
        jg, jt = ref(f)
        assert g.shape == (H, N) and t.shape == (H, 6)
        assert _ulps(g.numpy(), jg.numpy(), 1.0) <= GUMBEL_ULPS
        assert _ulps(t.numpy(), jt.numpy()) <= NORMAL_ULPS
        g1, t1 = prng.pnp_draws(prng.fold_in(prng.prng_key(seed), f), H, N, "cpu")
        assert torch.equal(g, g1) and torch.equal(t, t1)


def test_host_chain_equals_jax_vo_noise():
    """VisualOdometry's chain: frame f (f >= 1, every frame submitted) draws
    from the f-th split of PRNGKey(0), as test_torch_vo.jax_vo_noise."""
    jcfg, tcfg = slice_configs(1)
    H, N = tcfg.pnp.n_hypotheses, tcfg.frontend.max_raw_keypoints
    ref = jax_vo_noise(jcfg, 6)
    rng = prng.prng_key(0)
    for f in range(1, 6):
        rng, key = prng.split(rng)
        g, t = prng.pnp_draws(key, H, N, "cpu")
        jg, jt = ref(f)
        assert _ulps(g.numpy(), jg.numpy(), 1.0) <= GUMBEL_ULPS
        assert _ulps(t.numpy(), jt.numpy()) <= NORMAL_ULPS


@pytest.fixture(scope="module")
def frames():
    jcfg, _ = slice_configs(1)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=0)
    return list(synthetic.frames(world))


def test_chunked_default_draws_match_jax(frames):
    jcfg, tcfg = slice_configs(1)
    j = JaxSlam(jcfg, chunk=CHUNK)
    j.run(frames)
    j.finish()
    t = TorchSlam(tcfg, chunk=CHUNK, device="cpu")
    t.run(frames)
    t.finish()
    assert not t.lost and not j.lost and len(t.stats) == N_FRAMES
    assert_same_run(j, t)


def test_chunked_snapshot_carries_the_key(frames, tmp_path):
    """A JAX snapshot of a driver seeded 5 resumes in the port with the
    JAX driver's key, and the port writes its own key back."""
    jcfg, tcfg = slice_configs(1)
    path = str(tmp_path / "state.npz")
    j = JaxSlam(jcfg, chunk=CHUNK, seed=5)
    for f, left, right in frames[:CHUNK]:
        j.process(f, left, right)
    j.save_snapshot(path)
    for f, left, right in frames[CHUNK:]:
        j.process(f, left, right)
    j.finish()
    t = TorchSlam(tcfg, chunk=CHUNK, device="cpu")
    t.load_snapshot(path)
    assert t.key == prng.prng_key(5)
    for f, left, right in frames[CHUNK:]:
        t.process(f, left, right)
    t.finish()
    assert_same_run(j, t, first=CHUNK)
    t.save_snapshot(path)
    assert tuple(int(k) for k in np.load(path)["key"]) == prng.prng_key(5)


@pytest.mark.parametrize("lookahead", [0, 1])
def test_host_default_draws_match_jax(lookahead):
    jcfg, tcfg = (vo_config(c) for c in CONFIGS)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=0)
    vo_frames = list(synthetic.frames(world))
    j = run(jax_vo(jcfg, lookahead=lookahead), vo_frames)
    t = run(TorchVO(tcfg, lookahead=lookahead, device="cpu"), vo_frames)
    assert t.state.name == "TRACK"
    assert_same_vo(j, t)


def test_host_snapshot_carries_the_chain(frames, tmp_path):
    """The port's host snapshot holds the key chain where it stood, as the
    JAX driver's does: the resumed run draws what the JAX driver draws
    after the same resume."""
    from stereo_visual_slam_tpu.pipeline import snapshot as jsnapshot

    jcfg, tcfg = (vo_config(c) for c in CONFIGS)
    t = TorchVO(tcfg, device="cpu")
    j = jax_vo(jcfg)
    for vo in (t, j):
        for f, left, right in frames[:4]:
            vo.process(f, left, right)
    assert t.rng == as_key(j.rng)
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tsnapshot.save_snapshot(t, path)
    jsnapshot.save_snapshot(j, jpath)
    assert tuple(int(k) for k in np.load(path)["rng"]) == as_key(np.load(jpath)["rng"])
    u = TorchVO(tcfg, device="cpu")
    tsnapshot.load_snapshot(u, jpath)
    assert u.rng == t.rng
