"""Steered rBRIEF and the single-frame extractor of the port against the JAX
package (small_config synthetic frames).

The JAX XLA patch gather rounds the image to bf16, so on blurred images the
reference computes orientations from bf16-rounded patches, while the port's
gather (K2's plain twin on the CPU) returns exact f32 values.
`orb.describe_patches` rounds before the moments; without that, 35 of the
8,000 orientation bins below differ from the reference's (measured on these
frames). With it, bins and bits are exact.

The single-frame extractor is held to the bounds of test_torch_extractor.py:
level 0 bit-exact, >= 95 % of coarse rows identical (the pyramid resize
differs by a few 1e-3 gray levels), depth fields at atol 1e-3 and the depth
gates equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.models import frontend as jfe
from stereo_visual_slam_tpu.ops import image as jimage
from stereo_visual_slam_tpu.ops import orb as jorb
from stereo_visual_slam_tpu.utils import config as jax_config
from stereo_visual_slam_tpu_torch.models import frontend as tfe
from stereo_visual_slam_tpu_torch.ops import orb as torb
from stereo_visual_slam_tpu_torch.ops.kernels import patch_kernel
from stereo_visual_slam_tpu_torch.utils import config as port_config

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

N_KP = 2000


def steer_config(config, steer):
    cfg = config.small_config()
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, steer_descriptor=steer))


@pytest.fixture(scope="module")
def images():
    """(2, 2, H, W) uint8: two padded stereo frames."""
    cfg = jax_config.small_config()
    world = synthetic.make_world(cfg, n_frames=2, n_points=1500, seed=0)
    imgs = np.zeros((2, 2, *cfg.padded_hw), np.uint8)
    h, w = cfg.image_hw
    for i, (_, left, right) in enumerate(synthetic.frames(world)):
        imgs[i, 0, :h, :w] = left
        imgs[i, 1, :h, :w] = right
    return imgs


def _bins(theta):
    return np.mod(np.round(np.asarray(theta) * (30 / (2 * np.pi))).astype(np.int64), 30)


@pytest.mark.parametrize("frame", [0, 1])
def test_steered_bits_match_jax(images, frame):
    blurred = np.array(jimage.box_blur(jnp.asarray(images[frame, 0].astype(np.float32)), 5))
    rng = np.random.default_rng(frame)
    H, W = blurred.shape
    yx = np.stack([rng.integers(0, H, N_KP), rng.integers(0, W, N_KP)], -1).astype(np.int32)
    pj = jimage.gather_patches(jnp.asarray(blurred), jnp.asarray(yx), 33)
    packed_j, signs_j, theta_j = jorb.describe_patches(pj, bits=256, steer=True)

    pt = patch_kernel.gather_patches(torch.from_numpy(blurred), torch.from_numpy(yx), 33)
    assert not torch.equal(pt, pt.to(torch.bfloat16).float())  # the trap is live
    M = torch.from_numpy(torb.brief_matrix_bf16(256, 33, True))
    packed_t, signs_t = torb.describe_patches(pt, M, steer=True)
    bins_t = _bins(torb.orientations(pt.to(torch.bfloat16).float()).numpy())
    np.testing.assert_array_equal(bins_t, _bins(theta_j))
    np.testing.assert_array_equal(signs_t.numpy(), np.asarray(signs_j))
    np.testing.assert_array_equal(packed_t.numpy().astype(np.uint32), np.asarray(packed_j))
    assert len(np.unique(bins_t)) > 20  # many orientations, not a flat image


def test_steering_needs_the_bf16_rounding(images):
    """On exact f32 patches the bins move: the reason for the rounding."""
    moved = 0
    for frame in range(2):
        blurred = np.array(jimage.box_blur(jnp.asarray(images[frame, 0].astype(np.float32)), 5))
        rng = np.random.default_rng(frame)
        H, W = blurred.shape
        yx = np.stack([rng.integers(0, H, N_KP), rng.integers(0, W, N_KP)], -1).astype(np.int32)
        theta_j = jorb.orientations(jimage.gather_patches(jnp.asarray(blurred), jnp.asarray(yx), 33))
        pt = patch_kernel.gather_patches(torch.from_numpy(blurred), torch.from_numpy(yx), 33)
        moved += int((_bins(torb.orientations(pt).numpy()) != _bins(theta_j)).sum())
    assert moved > 0


def _level0_rows(cfg):
    return tfe._level_geometry(cfg)[0][3]


@pytest.mark.parametrize("steer", [False, True])
def test_single_frame_extractor_matches_jax(images, steer):
    cfg = steer_config(port_config, steer)
    n0 = _level0_rows(cfg)
    jx = jfe.make_extractor(steer_config(jax_config, steer))
    tx = tfe.make_extractor(cfg, "cpu")
    same_rows = []
    for im in images:
        fj = jx(jnp.asarray(im[0].astype(np.float32)), jnp.asarray(im[1].astype(np.float32)))
        ft = tx(torch.from_numpy(im))
        for field in ("yx", "score", "valid", "scale", "signs", "packed"):
            a = np.asarray(getattr(fj, field))
            b = getattr(ft, field).numpy()
            if field == "packed":
                b = b.astype(np.uint32)
            np.testing.assert_array_equal(b[:n0], a[:n0], err_msg=field)
            eq = (a[n0:] == b[n0:]).reshape(len(a) - n0, -1).all(-1)
            same_rows.append(eq)
        np.testing.assert_array_equal(ft.spawn_mask.numpy(), np.asarray(fj.spawn_mask))
        v = np.asarray(fj.depth_valid)
        np.testing.assert_array_equal(ft.depth_valid.numpy(), v)
        np.testing.assert_array_equal(ft.reliable.numpy(), np.asarray(fj.reliable))
        np.testing.assert_allclose(ft.disparity.numpy(), np.asarray(fj.disparity), atol=1e-3)
        np.testing.assert_allclose(ft.depth.numpy()[v], np.asarray(fj.depth)[v], atol=1e-3)
        np.testing.assert_allclose(ft.pts_cam.numpy()[v], np.asarray(fj.pts_cam)[v], atol=1e-3)
        assert v.sum() > 20
    assert np.mean(same_rows) >= 0.95, np.mean(same_rows)


# values of padding rows (score 0) that no consumer reads
ROW_VALUES = ("signs", "packed", "disparity", "depth", "pts_cam")


def assert_same_features(x, y):
    """Equal feature tables, up to the values of padding rows: there the
    stacked sweep reads the next frame where the single-frame one reads
    zero padding (a detected keypoint lies border_margin >= the patch
    radius inside its frame), and BRIEF of a flat patch is a sum of zeros
    whose sign follows the matmul's summation order (175 bits of frame 1's
    padding rows here). Masks, gates, coords and scores are compared
    everywhere."""
    for name in tfe.FrameFeatures._fields:
        a, b = getattr(x, name), getattr(y, name)
        if name in ROW_VALUES:
            a, b = a[x.valid], b[x.valid]
        assert torch.equal(a, b), name


@pytest.mark.parametrize("steer", [False, True])
def test_eager_batch_extractor_equals_single_frame(images, steer):
    """The `lazy_depth=False` batch path == the per-frame extractor."""
    cfg = steer_config(port_config, steer)
    batch = tfe.make_batch_extractor(cfg, "cpu", with_depth=True)(torch.from_numpy(images))
    single = tfe.make_extractor(cfg, "cpu")
    for b, im in enumerate(images):
        assert_same_features(tfe.FrameFeatures(*[f[b] for f in batch]),
                             single(torch.from_numpy(im)))
    assert int(batch.depth_valid.sum()) > 40


def test_lazy_depth_stage_equals_eager(images):
    cfg = port_config.small_config()
    eager = tfe.make_batch_extractor(cfg, "cpu", with_depth=True)(torch.from_numpy(images))
    lazy = tfe.make_batch_extractor(cfg, "cpu", with_depth=False)(torch.from_numpy(images))
    stage = tfe.make_depth_stage(cfg)
    for b, im in enumerate(images):
        frame = tfe.FrameFeatures(*[f[b] for f in lazy])
        assert_same_features(frame._replace(**stage(torch.from_numpy(im), frame)),
                             tfe.FrameFeatures(*[f[b] for f in eager]))
