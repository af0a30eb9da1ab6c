"""The all-levels patch gather (ops/kernels/patch_kernel.gather_patches_levels,
one launch of csrc/patch_gather.cu for every pyramid level) and the
extractor's describe stage that calls it (frontend.ExtractStages.
describe_levels), on the CPU, where the wrapper takes its plain version:

  * level by level, equal to the JAX package's Pallas kernel
    (gather_patches_aligned, in interpret mode as tests/test_pallas_kernels.py
    runs it): 1, 3 and 8 levels, a level without keypoints, odd counts,
    keypoints on all four borders and across frame seams, P = 33; at P = 9
    equal to the JAX package's plain gather (ops/image.gather_patches) frame
    by frame, since the Pallas kernel is right only at P = 33 near an
    image's bottom rows (its 40-row tile starts at min(8-aligned y0, H - 40),
    which leaves a row offset above the 7 its shift selects cover once
    y0 > H - 40 + 7, as it can be when P < 33);
  * describe_levels bit-equal to the per-level describe, upright and
    steered, at 8 levels;
  * make_batch_extractor (which now describes through describe_levels)
    against the JAX extractor as tests/test_torch_extractor.py holds it,
    and bit-equal to its composition through the per-level describe;
  * the cost model counts the same FLOPs and bytes through describe_levels
    as through the per-level calls, the gather as one unit;
  * the pixels the gather's bound counts are those its windows cover;
  * the wrapper's argument checks and the launch counters.
The kernel itself runs on the card: tests/test_torch_kernels_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.models import frontend as jfe
from stereo_visual_slam_tpu.ops.pallas import patch_kernel as jpk
from stereo_visual_slam_tpu.utils import config as jax_config
from stereo_visual_slam_tpu_torch.models import frontend as tfe
from stereo_visual_slam_tpu_torch.ops import kernels
from stereo_visual_slam_tpu_torch.ops.kernels import measure, patch_kernel
from stereo_visual_slam_tpu_torch.utils import config as port_config
from stereo_visual_slam_tpu_torch.utils import roofline

torch.set_num_threads(1)

B = 2   # frames stacked in each level's image


def _level(rng, H, W, n, frame_h, offset=0.25):
    """A (B*H, W) stack of integer-valued frames plus `offset` (0.25: no
    value is a plain integer) and n keypoints: the four corners and the
    rows either side of each frame seam first, then random ones (some off
    the image on the columns; on the rows only off the stack when the
    image is not stacked, since the JAX kernel does not clamp the frame
    index)."""
    img = rng.integers(0, 256, (B * H, W)).astype(np.float32) + offset
    rows = B * H
    special = [(0, 0), (0, W - 1), (rows - 1, 0), (rows - 1, W - 1), (H - 1, W // 2),
               (H, W // 3), (H - 3, 5), (H + 2, W - 6)]
    lo, hi = (0, rows) if frame_h else (-7, rows + 7)
    rand = np.stack([rng.integers(lo, hi, n), rng.integers(-7, W + 7, n)], -1)
    yx = np.concatenate([np.array(special), rand])[:n].astype(np.int32)
    return img, yx


# (H, W, n keypoints, stacked) per level: H a multiple of 8 and >= 40, W a
# multiple of 128 and >= 256, as the Pallas kernel needs
LEVEL_SETS = {
    1: [(64, 256, 37, True)],
    3: [(96, 384, 41, True), (48, 256, 0, True), (40, 256, 9, False)],
    8: [(64, 512, 33, True), (56, 384, 27, True), (48, 384, 0, True), (48, 256, 19, False),
        (40, 256, 11, True), (40, 256, 7, True), (40, 256, 1, True), (40, 256, 5, True)],
}


def _gather_levels(levels, patch):
    out = patch_kernel.gather_patches_levels(
        [torch.from_numpy(img) for img, _, _ in levels],
        [torch.from_numpy(yx) for _, yx, _ in levels], patch,
        [fh for _, _, fh in levels])
    assert out.shape == (sum(len(yx) for _, yx, _ in levels), patch, patch)
    slices, start = [], 0
    for _, yx, _ in levels:
        slices.append(out[start:start + len(yx)].numpy())
        start += len(yx)
    return slices


@pytest.mark.parametrize("n_levels", [1, 3, 8])
def test_levels_equal_the_pallas_kernel_level_by_level(n_levels):
    rng = np.random.default_rng(n_levels)
    levels = [(*_level(rng, H, W, n, stacked), H if stacked else None)
              for H, W, n, stacked in LEVEL_SETS[n_levels]]
    for got, (img, yx, fh) in zip(_gather_levels(levels, 33), levels):
        if len(yx) == 0:
            assert got.shape == (0, 33, 33)
            continue
        ref = jpk.gather_patches_aligned(jnp.asarray(img), jnp.asarray(yx), patch=33,
                                         frame_h=fh, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(ref))


def test_small_patch_levels_equal_the_jax_gather_frame_by_frame():
    """P = 9 against ops/image.gather_patches of the JAX package (its
    one-hot matmuls are exact on these integer images), on each keypoint's
    own frame of a stack."""
    from stereo_visual_slam_tpu.ops import image as jimage

    rng = np.random.default_rng(9)
    levels = [(*_level(rng, H, W, n, stacked, offset=0.0), H if stacked else None)
              for H, W, n, stacked in LEVEL_SETS[3]]
    for got, (img, yx, fh) in zip(_gather_levels(levels, 9), levels):
        for k, (y, x) in enumerate(yx):
            frame, y_local = (img, y) if fh is None else (img[y // fh * fh:][:fh], y % fh)
            ref = jimage.gather_patches(jnp.asarray(frame), jnp.asarray([[y_local, x]]), 9)
            np.testing.assert_array_equal(got[k], np.asarray(ref[0]))


def _stages(steer, n_levels=8):
    cfg = port_config.small_config()
    cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, n_levels=n_levels,
                                                   steer_descriptor=steer))
    return tfe.ExtractStages(cfg, "cpu")


def _describe_inputs(st, seed=0):
    """Blurred (B*H_i, W_i) stacks and (B, n_i, 2) keypoints of every level,
    with the frames' corners among them."""
    rng = np.random.default_rng(seed)
    blurred, yxs = [], []
    for _, (h, w), (H, W), n in st.levels:
        blurred.append(torch.from_numpy(rng.uniform(0, 255, (B * H, W)).astype(np.float32)))
        yx = np.stack([rng.integers(0, h, (B, n)), rng.integers(0, w, (B, n))], -1)
        yx[:, :2] = [[0, 0], [h - 1, w - 1]]
        yxs.append(torch.from_numpy(yx.astype(np.int32)))
    return blurred, yxs


@pytest.mark.parametrize("steer", [False, True], ids=["upright", "steered"])
def test_describe_levels_bit_equal_to_describe(steer):
    st = _stages(steer)
    assert len(st.levels) == 8
    blurred, yxs = _describe_inputs(st)
    got = st.describe_levels(blurred, yxs)
    assert len(got) == len(st.levels)
    for i, ((packed, signs), b, yx) in enumerate(zip(got, blurred, yxs)):
        ref_packed, ref_signs = st.describe(i, b, yx)
        assert torch.equal(packed, ref_packed), i
        assert torch.equal(signs, ref_signs), i
        assert packed.shape == (B, yx.shape[1], 8) and signs.shape == (B, yx.shape[1], 256)


def test_cost_model_counts_describe_levels_as_the_per_level_calls():
    st = _stages(False)
    blurred, yxs = _describe_inputs(st, seed=1)
    with roofline.Counter() as levels:
        st.describe_levels(blurred, yxs)
    with roofline.Counter() as per_level:
        for i, (b, yx) in enumerate(zip(blurred, yxs)):
            st.describe(i, b, yx)
    assert levels.cost == per_level.cost
    calls, nbytes, ops = levels.units["gather_patches"]
    assert calls == 1 and per_level.units["gather_patches"] == [8, nbytes, ops]
    P = st.config.frontend.patch_size
    assert nbytes == sum(measure.gather_work(b, yx.shape[0] * yx.shape[1], P)[0]
                         for b, yx in zip(blurred, yxs))


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
    batch_extract = tfe.make_batch_extractor(cfg, "cpu", with_depth=False)
    ft = batch_extract(torch.from_numpy(imgs))
    return cfg, batch_extract, torch.from_numpy(imgs), jax.tree.map(np.asarray, fj), ft


def test_batch_extract_equals_the_jax_extractor(extracted):
    """Level 0 bit-exact and >= 95 % of the coarse rows identical, the
    bounds of tests/test_torch_extractor.py (the coarse levels' pyramid
    resize differs by rounding)."""
    cfg, _, _, fj, ft = extracted
    n0 = tfe._level_geometry(cfg)[0][3]
    same = np.ones(fj.score[:, n0:].shape, bool)
    for field in ("yx", "score", "valid", "packed", "signs"):
        a, b = getattr(fj, field), getattr(ft, field).numpy()
        if field == "packed":
            b = b.astype(np.uint32)
        np.testing.assert_array_equal(b[:, :n0], a[:, :n0])
        eq = a[:, n0:] == b[:, n0:]
        same &= eq.reshape(eq.shape[0], eq.shape[1], -1).all(-1)
    assert same.mean() >= 0.95, same.mean()
    np.testing.assert_array_equal(ft.spawn_mask.numpy(), fj.spawn_mask)


def test_batch_extract_equals_its_per_level_composition(extracted):
    _, batch_extract, imgs, _, ft = extracted
    st = batch_extract.stages
    left = imgs[:, 0].float()
    per_level = []
    for i in range(len(st.levels)):
        stacked, scores, yx = st.detect(i, st.level_image(left, i))
        per_level.append((scores, yx, *st.describe(i, st.blur(stacked), yx)))
    ref = st.merge(imgs, per_level, with_depth=False)
    for name, a, b in zip(tfe.FrameFeatures._fields, ft, ref):
        assert torch.equal(a, b), name


def test_levels_work_sums_the_levels():
    imgs = [torch.zeros((768, 1280)), torch.zeros((640, 1024))]
    work = measure.gather_levels_work(imgs, [2048, 1500], 33)
    assert work == (measure.gather_work(imgs[0], 2048, 33)[0]
                    + measure.gather_work(imgs[1], 1500, 33)[0], 0.0)


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("patch", [33, 9])
def test_covered_pixels_are_the_pixels_the_gather_reads(stacked, patch):
    """The gather's bound counts the image pixels under its windows: as
    many as the distinct pixels of its patches, read from an image whose
    every pixel holds its own index."""
    img, yx = _level(np.random.default_rng(7), 64, 256, 150, stacked)
    ids = torch.arange(img.size, dtype=torch.float32).reshape(img.shape)
    yx = torch.from_numpy(yx)
    fh = 64 if stacked else None
    patches = patch_kernel.gather_patches_plain(ids, yx, patch, fh)
    covered = measure.covered_pixels(ids, yx, patch, fh)
    assert covered == len(torch.unique(patches)) < img.size
    assert measure.covered_pixels(ids, yx[:0], patch, fh) == 0


def test_levels_wrapper_checks_its_arguments():
    img = torch.zeros((64, 256))
    yx = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="levels"):
        patch_kernel.gather_patches_levels_cuda([img] * 9, [yx] * 9, 33)
    with pytest.raises(ValueError, match="levels"):
        patch_kernel.gather_patches_levels_cuda([img, img], [yx], 33)
    with pytest.raises(ValueError, match="CUDA"):   # a CPU tensor never launches
        patch_kernel.gather_patches_levels_cuda([img], [yx], 33)
    assert patch_kernel.gather_patches_levels_cuda.launches == 0


def test_both_gather_launchers_count_as_gather_patches(monkeypatch):
    monkeypatch.setattr(patch_kernel.gather_patches_cuda, "launches", 3)
    monkeypatch.setattr(patch_kernel.gather_patches_levels_cuda, "launches", 2)
    assert kernels.launch_counts()["gather_patches"] == 5
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"fast_nms": 0, "gather_patches": 0, "zncc_sweep": 0,
                                       "pnp_hypotheses": 0, "pnp_refine": 0}
