"""The port's front-end ops against the JAX package on the same numpy
inputs: FAST+NMS and its pooled top-k, box blur, the patch gather, BRIEF,
ANMS, the ZNCC sweep and disparity gates, the pyramid resize. Where the JAX
function is a Pallas kernel it runs in interpret mode, as the JAX package's
own tests run it on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.ops import anms as janms
from stereo_visual_slam_tpu.ops import fast as jfast
from stereo_visual_slam_tpu.ops import image as jimage
from stereo_visual_slam_tpu.ops import orb as jorb
from stereo_visual_slam_tpu.ops import stereo as jstereo
from stereo_visual_slam_tpu.ops.pallas import fast_kernel as jfast_kernel
from stereo_visual_slam_tpu.ops.pallas import patch_kernel as jpatch_kernel
from stereo_visual_slam_tpu.ops.pallas import stereo_kernel as jstereo_kernel
from stereo_visual_slam_tpu_torch.ops import anms as tanms
from stereo_visual_slam_tpu_torch.ops import fast as tfast
from stereo_visual_slam_tpu_torch.ops import image as timage
from stereo_visual_slam_tpu_torch.ops import orb as torb
from stereo_visual_slam_tpu_torch.ops import stereo as tstereo
from stereo_visual_slam_tpu_torch.ops.kernels import fast_kernel, patch_kernel, stereo_kernel

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

T = torch.from_numpy


def _corner_image(seed, h=128, w=256):
    rng = np.random.default_rng(seed)
    img = rng.integers(10, 30, (h, w)).astype(np.float32)
    for _ in range(40):
        y, x = rng.integers(3, h - 3), rng.integers(3, w - 3)
        img[y - 2: y + 3, x - 2: x + 3] = rng.integers(150, 256, (5, 5))
    return img


@pytest.fixture(scope="module")
def stacked():
    """Two frames stacked vertically, as the batched extractor feeds FAST."""
    return np.concatenate([_corner_image(0), _corner_image(1)], axis=0)


def test_fast_nms_plain_matches_xla(stacked):
    ref = jfast.nms_3x3(jfast.fast_score_map(jnp.asarray(stacked), 20.0))
    out = fast_kernel.fast_nms_score_map(T(stacked), 20.0)  # CPU -> plain
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy() > 0).sum() > 20


def test_fast_nms_plain_matches_pallas_interpret(stacked):
    ker = jfast_kernel.fast_nms_score_map(
        jnp.asarray(stacked), threshold=20.0, tile=(64, 128), interpret=True
    )
    out = fast_kernel.fast_nms_plain(T(stacked), 20.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ker))


@pytest.mark.parametrize("hw", [(64, 96), (63, 95)])
def test_nms_topk_tie_heavy_matches_lax_top_k(hw):
    """Many equal scores: the port's stable sort must pick the same index
    set, in the same order, as lax.top_k (lowest index first)."""
    rng = np.random.default_rng(2)
    score = rng.integers(0, 4, hw).astype(np.float32) * 10.0
    score = np.array(jfast.nms_3x3(jnp.asarray(score)))
    s_j, yx_j = jfast.nms_topk(jnp.asarray(score), 200)
    s_t, yx_t = tfast.nms_topk(T(score), 200)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(yx_t.numpy(), np.asarray(yx_j))
    assert len(np.unique(np.asarray(s_j))) < 10  # the ties are real


def test_top_k_stable_with_inf_ties_matches_lax():
    """The Gumbel top-k of PnP with fewer than k valid entries: -inf ties."""
    rng = np.random.default_rng(3)
    g = rng.gumbel(size=(16, 50)).astype(np.float32)
    g[:, 3:] = -np.inf
    g[5, :] = -np.inf
    v_j, i_j = jax.lax.top_k(jnp.asarray(g), 4)
    v_t, i_t = tfast.top_k_stable(T(g), 4)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_box_blur_exact():
    img = np.random.default_rng(4).uniform(0, 255, (96, 160)).astype(np.float32)
    np.testing.assert_array_equal(
        timage.box_blur(T(img), 5).numpy(), np.asarray(jimage.box_blur(jnp.asarray(img), 5))
    )


@pytest.fixture(scope="module")
def patch_image():
    # integer-valued: the JAX one-hot gather rounds through bf16
    return np.random.default_rng(7).integers(0, 256, (128, 256)).astype(np.float32)


def test_gather_matches_pallas_interpret(patch_image):
    rng = np.random.default_rng(3)
    yx = np.concatenate([
        np.stack([rng.integers(0, 128, 17), rng.integers(0, 256, 17)], -1),
        np.array([[0, 0], [127, 255], [5, 250], [120, 3]]),
    ]).astype(np.int32)
    ref = jpatch_kernel.gather_patches_aligned(
        jnp.asarray(patch_image), jnp.asarray(yx), patch=33, interpret=True
    )
    out = patch_kernel.gather_patches(T(patch_image), T(yx), 33)  # CPU -> plain
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_gather_frame_h_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    B, H, W = 3, 64, 256
    st = rng.integers(0, 256, (B * H, W)).astype(np.float32)
    yl = np.stack([rng.integers(0, H, 24), rng.integers(0, W, 24)], -1)
    yl[:6, 0] = [0, 1, 15, H - 1, H - 2, H - 16]
    b = np.arange(24) % B
    yx = np.stack([yl[:, 0] + b * H, yl[:, 1]], -1).astype(np.int32)
    ref = jpatch_kernel.gather_patches_aligned(
        jnp.asarray(st), jnp.asarray(yx), patch=33, frame_h=H, interpret=True
    )
    out = patch_kernel.gather_patches_plain(T(st), T(yx), 33, frame_h=H)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_describe_patches_bits_exact():
    rng = np.random.default_rng(5)
    blurred = np.array(jimage.box_blur(jnp.asarray(_corner_image(5)), 5))
    yx = np.stack([rng.integers(16, 112, 300), rng.integers(16, 240, 300)], -1).astype(np.int32)
    patches = np.asarray(jimage.gather_patches(jnp.asarray(blurred), jnp.asarray(yx), 33))
    p_j, s_j, _ = jorb.describe_patches(jnp.asarray(patches), bits=256, steer=False)
    M = T(torb.brief_matrix_bf16(256, 33, False))
    # the port gathers exact f32 values; BRIEF rounds them to bf16 anyway
    exact = timage.gather_patches(T(blurred), T(yx), 33)
    p_t, s_t = torb.describe_patches(exact, M)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(p_t.numpy().astype(np.uint32), np.asarray(p_j))


def test_hamming_matches_jax():
    rng = np.random.default_rng(6)
    a = np.where(rng.random((40, 256)) > 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.random((50, 256)) > 0.5, 1.0, -1.0).astype(np.float32)
    np.testing.assert_array_equal(
        torb.hamming_from_signs(T(a), T(b)).numpy(),
        np.asarray(jorb.hamming_from_signs(jnp.asarray(a), jnp.asarray(b))),
    )


def test_anms_mask_exact():
    rng = np.random.default_rng(8)
    n = 300
    yx = np.stack([rng.integers(0, 128, n), rng.integers(0, 256, n)], -1).astype(np.int32)
    score = rng.integers(0, 60, n).astype(np.float32)   # ties + zero padding
    ref = janms.anms_mask(jnp.asarray(yx), jnp.asarray(score), num=100)
    out = tanms.anms_mask(T(yx), T(score), num=100)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # batched over frames as the extractor calls it
    out_b = tanms.anms_mask(T(np.stack([yx, yx])), T(np.stack([score, score])), num=100)
    np.testing.assert_array_equal(out_b[1].numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def stereo_pair():
    rng = np.random.default_rng(2)
    left = rng.uniform(0, 255, (96, 384)).astype(np.float32)
    return left, np.roll(left, -17, axis=1)


def _stereo_kp(seed, n=16):
    rng = np.random.default_rng(seed)
    yx = np.stack([rng.integers(8, 88, n), rng.integers(40, 370, n)], -1)
    edge = np.array([[0, 0], [0, 383], [95, 0], [95, 383], [5, 33], [50, 128], [50, 127], [90, 350]])
    return np.concatenate([yx, edge]).astype(np.int32)


def test_zncc_plain_matches_xla(stereo_pair):
    left, right = stereo_pair
    yx = _stereo_kp(3)
    ref = jstereo.zncc_sweep_xla(jnp.asarray(left), jnp.asarray(right), jnp.asarray(yx),
                                 patch=11, max_disparity=32)
    out = stereo_kernel.zncc_sweep(T(left), T(right), T(yx), patch=11, max_disparity=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_zncc_plain_matches_pallas_interpret(stereo_pair):
    left, right = stereo_pair
    yx = _stereo_kp(4)
    ref = jstereo_kernel.zncc_sweep(jnp.asarray(left), jnp.asarray(right), jnp.asarray(yx),
                                    patch=11, max_disparity=32, interpret=True)
    out = stereo_kernel.zncc_sweep_plain(T(left), T(right), T(yx), patch=11, max_disparity=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_match_disparity_fields(stereo_pair):
    left, right = stereo_pair
    yx = _stereo_kp(5, n=40)
    valid = np.ones(len(yx), bool)
    valid[::7] = False
    kw = dict(fx=718.856, baseline=0.573, max_disparity=32, patch=11, min_zncc=0.6,
              min_depth=10.0, max_depth=400.0, reliable_depth=40.0)
    a = jstereo.match_disparity(jnp.asarray(left), jnp.asarray(right), jnp.asarray(yx),
                                jnp.asarray(valid), **kw)
    b = tstereo.match_disparity(T(left), T(right), T(yx), T(valid), use_kernel=True, **kw)
    np.testing.assert_array_equal(b.valid.numpy(), np.asarray(a.valid))
    np.testing.assert_array_equal(b.reliable.numpy(), np.asarray(a.reliable))
    np.testing.assert_allclose(b.disparity.numpy(), np.asarray(a.disparity), atol=1e-3)
    v = np.asarray(a.valid)
    assert v.sum() >= 10
    np.testing.assert_allclose(b.depth.numpy()[v], np.asarray(a.depth)[v], atol=1e-3)


def _production_axes():
    """(in, out) of every resize of the production pyramid (Config():
    1241 x 376 valid pixels, 8 levels at scale 1.2), both axes."""
    from stereo_visual_slam_tpu_torch.models.frontend import _level_geometry
    from stereo_visual_slam_tpu_torch.utils.config import Config

    vh, vw = Config().image_hw
    return [(n, m) for _, (h, w), _, _ in _level_geometry(Config())[1:]
            for n, m in ((vh, h), (vw, w))]


# what XLA's compiled weight code rounds differently from numpy here (its
# fused normalisation; not reproduced): 1.3e-6 at most on these sizes.
# The sample positions rounded after the multiply gave 5.1e-5 (PERF.md).
RESIZE_WEIGHT_ATOL = 3e-6


@pytest.mark.parametrize("in_out", _production_axes(), ids=lambda p: f"{p[0]}to{p[1]}")
def test_resize_weights_match_jax_at_production_sizes(in_out):
    """The weights `jax.image.resize` applies inside the JAX package's
    jitted extractor (the resize of the identity, jitted) against the
    port's, at the production pyramid's sizes."""
    n, m = in_out
    ref = jax.jit(jax.vmap(lambda c: jax.image.resize(c, (m,), method="linear")))(
        jnp.eye(n, dtype=jnp.float32))
    np.testing.assert_allclose(timage.resize_weights(n, m), np.asarray(ref),
                               atol=RESIZE_WEIGHT_ATOL, rtol=0)


def test_production_level_images_match_jax():
    """Level 1 of a production-size frame (1241 x 376 -> 1034 x 313): the
    port's pixels within 1e-3 gray levels of jax.image.resize's under jit
    (measured 7.6e-5; 9.9e-3 with the sample positions rounded after the
    multiply)."""
    img = np.random.default_rng(3).uniform(0, 255, (376, 1241)).astype(np.float32)
    ref = jax.jit(lambda x: jax.image.resize(x, (313, 1034), method="linear"))(jnp.asarray(img))
    out = timage.resize_linear(T(img), timage.resize_matrices(img.shape, (313, 1034), "cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3, rtol=0)


@pytest.mark.parametrize("out_hw", [(107, 213), (62, 123), (30, 59)])
def test_resize_matches_jax_image_resize(out_hw):
    img = _corner_image(9, 128, 256)
    ref = jax.image.resize(jnp.asarray(img), out_hw, method="linear")
    out = timage.resize_linear(T(img), timage.resize_matrices(img.shape, out_hw, "cpu"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-2, rtol=0)
