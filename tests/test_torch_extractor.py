"""The port's batched extractor and lazy depth stage against the JAX
package's on the same synthetic frames (small_config, B=4).

Level 0 involves no resize and is bit-exact. Levels >= 1 go through the
pyramid resize, which the port evaluates as two fp32 matmuls against the
weights `jax.image.resize` builds; its pixels differ by up to 6e-4 gray
levels (the weights' last bits and the two matmuls' rounding), so those rows
are compared by the share that is identical (96.4 % of the 1,232 coarse rows
measured on these frames; the bound is 95 %)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.models import frontend as jfe
from stereo_visual_slam_tpu.utils import config as jax_config
from stereo_visual_slam_tpu_torch.models import frontend as tfe
from stereo_visual_slam_tpu_torch.utils import config as port_config

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

B = 4


@pytest.fixture(scope="module")
def extracted():
    jcfg, cfg = jax_config.small_config(), port_config.small_config()
    world = synthetic.make_world(jcfg, n_frames=B, n_points=1500, seed=0)
    H, W = cfg.padded_hw
    h, w = cfg.image_hw
    imgs = np.zeros((B, 2, H, W), np.uint8)
    for i, (_, left, right) in enumerate(synthetic.frames(world)):
        imgs[i, 0, :h, :w] = left
        imgs[i, 1, :h, :w] = right
    fj = jfe.make_batch_extractor(jcfg, with_depth=False)(jnp.asarray(imgs))
    ft = tfe.make_batch_extractor(cfg, "cpu", with_depth=False)(torch.from_numpy(imgs))
    return (jcfg, cfg), imgs, jax.tree.map(np.asarray, fj), ft


def _level0_rows(cfg):
    return tfe._level_geometry(cfg)[0][3]


def test_level_geometry_identical():
    assert tfe._level_geometry(port_config.small_config()) == \
        jfe._level_geometry(jax_config.small_config())


@pytest.mark.parametrize("field", ["yx", "score", "valid", "packed", "signs", "scale"])
def test_level0_rows_bit_exact(extracted, field):
    (_, cfg), _, fj, ft = extracted
    n0 = _level0_rows(cfg)
    a = getattr(fj, field)[:, :n0]
    b = getattr(ft, field)[:, :n0].numpy()
    if field == "packed":
        b = b.astype(np.uint32)
    np.testing.assert_array_equal(b, a)
    if field == "valid":
        assert a.sum() > 100


def test_spawn_mask_exact(extracted):
    _, _, fj, ft = extracted
    np.testing.assert_array_equal(ft.spawn_mask.numpy(), fj.spawn_mask)


def test_coarse_levels_rows_identical(extracted):
    (_, cfg), _, fj, ft = extracted
    n0 = _level0_rows(cfg)
    same = np.ones(fj.score[:, n0:].shape, bool)
    for field in ("yx", "score", "valid", "packed"):
        a = getattr(fj, field)[:, n0:]
        b = getattr(ft, field)[:, n0:].numpy()
        if field == "packed":
            b = b.astype(np.uint32)
        eq = a == b
        same &= eq.reshape(eq.shape[0], eq.shape[1], -1).all(-1)
    assert same.mean() >= 0.95, same.mean()


def test_depth_stage_matches(extracted):
    (jcfg, tcfg), imgs, fj, ft = extracted
    ds_j = jfe.make_depth_stage(jcfg)
    ds_t = tfe.make_depth_stage(tcfg)
    n_valid = 0
    for i in range(B):
        dj = ds_j(jnp.asarray(imgs[i]), jax.tree.map(lambda x: jnp.asarray(x[i]), fj))
        dt = ds_t(torch.from_numpy(imgs[i]), tfe.FrameFeatures(*[x[i] for x in ft]))
        v = np.asarray(dj["depth_valid"])
        np.testing.assert_array_equal(dt["depth_valid"].numpy(), v)
        np.testing.assert_array_equal(dt["reliable"].numpy(), np.asarray(dj["reliable"]))
        np.testing.assert_allclose(dt["disparity"].numpy(), np.asarray(dj["disparity"]), atol=1e-3)
        np.testing.assert_allclose(dt["depth"].numpy()[v], np.asarray(dj["depth"])[v], atol=1e-3)
        np.testing.assert_allclose(dt["pts_cam"].numpy()[v], np.asarray(dj["pts_cam"])[v], atol=1e-3)
        n_valid += v.sum()
    assert n_valid > 20
