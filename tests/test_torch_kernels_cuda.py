"""The CUDA kernels against their plain torch versions, at small shapes,
at the production shapes (every pyramid level, both ZNCC callers) and on
the images that stress them (borders, plateaus, flat patches, thresholds
that pass every pixel or none through FAST's early reject); and both drivers on the card against the CPU on a small slice (the host
driver also under lookahead, through its pinned upload ring).
They need a CUDA card (and nvcc to build the kernels): marked `cuda`, they
skip without one. On the card, run them without tests/conftest.py, which
imports jax, pins it to 8 virtual CPU devices and turns its compilation
cache on, none of which the port uses:
python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch.ops import stereo as stereo_ops
from stereo_visual_slam_tpu_torch.ops.kernels import (
    fast_kernel, launch_counts, patch_kernel, reset_launch_counts, stereo_kernel,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(10, 30, (h, w)).astype(np.float32)
    for _ in range(h * w // 400):
        y, x = rng.integers(3, h - 3), rng.integers(3, w - 3)
        img[y - 2: y + 3, x - 2: x + 3] = rng.integers(150, 256, (5, 5))
    return torch.from_numpy(img)


@pytest.fixture(scope="module")
def production():
    """The three kernels' inputs at the main path's shapes, from the first
    chunk of the production synthetic world."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stereo_visual_slam_tpu_torch.ops.kernels import measure

    cfg, frames = measure.production_frames()
    return cfg, measure.kernel_inputs(cfg, frames, torch.device("cuda"))


# Small images take 128 x 8 tiles, (1056, 1283) takes 128 x 16 (the
# production levels take both). (256, 256) is whole tiles; (131, 97),
# (13, 130) and (1056, 1283) are not (rows of 97, 130 and 1283 floats take
# the scalar halo load); (20, 200) has rows a multiple of 4 floats but not
# of the tile width; 8 and 13 rows are at most two tiles, one partial.
@pytest.mark.parametrize("hw", [(256, 256), (131, 97), (8, 33), (20, 200), (13, 130),
                                (1056, 1283)])
def test_fast_nms_bit_exact(dev, hw):
    img = _image(0, *hw).to(dev)
    reset_launch_counts()
    out = fast_kernel.fast_nms_score_map(img, 20.0)
    torch.cuda.synchronize()
    assert launch_counts()["fast_nms"] == 1
    assert torch.equal(out, fast_kernel.fast_nms_plain(img, 20.0))


@pytest.mark.parametrize("batch", [8, 1])
def test_fast_nms_production_levels(production, batch):
    """All 8 pyramid levels of one chunk at B=8 (the chunk path) and B=1
    (the host driver's single frame)."""
    cfg, inp = production
    H0 = cfg.padded_hw[0]
    thr = cfg.frontend.fast_threshold
    for img in inp["levels"]:
        img = img[: img.shape[0] * batch // 8].contiguous()
        assert torch.equal(fast_kernel.fast_nms_cuda(img, thr), fast_kernel.fast_nms_plain(img, thr))
    assert inp["levels"][0].shape[0] == 8 * H0


def _plateaus(seed, h, w):
    """Integer image of 4 x 4 constant blocks at 4 levels 60 apart: flat
    arcs and equal neighbouring scores, so NMS decides by raster order."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 4, (h // 4, w // 4)) * 60.0
    return torch.from_numpy(np.kron(blocks, np.ones((4, 4))).astype(np.float32))


@pytest.mark.parametrize("kind", ["zeros", "plateaus"])
def test_fast_nms_special_images(dev, kind):
    img = torch.zeros((96, 384)) if kind == "zeros" else _plateaus(6, 96, 384)
    img = img.to(dev)
    out = fast_kernel.fast_nms_cuda(img, 20.0)
    ref = fast_kernel.fast_nms_plain(img, 20.0)
    assert torch.equal(out, ref)
    if kind == "plateaus":
        assert int((ref > 0).sum()) > 10


@pytest.mark.parametrize("threshold", [0.0, 200.0])
def test_fast_nms_thresholds(dev, threshold):
    """Threshold 0 sends nearly every textured pixel to the full arc score,
    200 almost none: both ends of the early reject."""
    for img in (_image(7, 160, 512), _plateaus(8, 160, 512)):
        img = img.to(dev)
        assert torch.equal(fast_kernel.fast_nms_cuda(img, threshold),
                           fast_kernel.fast_nms_plain(img, threshold))


@pytest.mark.parametrize("frame_h", [None, 64])
def test_gather_patches_bit_exact(dev, frame_h):
    img = (_image(1, 192, 256) + 0.25).to(dev)
    rng = np.random.default_rng(2)
    yx = np.stack([rng.integers(-5, 197, 300), rng.integers(-5, 261, 300)], -1)
    yx = torch.from_numpy(yx.astype(np.int32)).to(dev)
    out = patch_kernel.gather_patches(img, yx, 33, frame_h)
    torch.cuda.synchronize()
    assert torch.equal(out, patch_kernel.gather_patches_plain(img, yx, 33, frame_h))


def test_gather_patches_levels_production(production):
    """All 8 levels of one chunk in one launch (the main path's call),
    bit-exact per level and whole; and each level alone through the
    one-level entry point."""
    cfg, inp = production
    P = cfg.frontend.patch_size
    imgs, yxs, fhs = (list(x) for x in zip(*inp["gathers"]))
    reset_launch_counts()
    out = patch_kernel.gather_patches_levels_cuda(imgs, yxs, P, fhs)
    torch.cuda.synchronize()
    assert launch_counts()["gather_patches"] == 1
    assert torch.equal(out, patch_kernel.gather_patches_levels_plain(imgs, yxs, P, fhs))
    start = 0
    for img, yx, fh in inp["gathers"]:
        ref = patch_kernel.gather_patches_plain(img, yx, P, fh)
        assert torch.equal(out[start:start + yx.shape[0]], ref)
        assert torch.equal(patch_kernel.gather_patches_cuda(img, yx, P, fh), ref)
        start += yx.shape[0]
    assert start == out.shape[0] == 8 * cfg.frontend.max_raw_keypoints


def _random_levels(seed, dev):
    """1-8 levels of random shapes (widths not a multiple of 4 included),
    stacked or not, some without keypoints, odd counts, centres off every
    border; windows whose 8-keypoint tile needs more than 48 KB of shared
    memory (P = 41) or more than the card's most (P = 90: fewer keypoints a
    block)."""
    rng = np.random.default_rng(seed)
    P = int(rng.choice([33, 7, 41, 90]))
    levels = []
    for _ in range(int(rng.integers(1, 9))):
        frames = int(rng.integers(1, 4))
        fh = int(rng.integers(P, P + 40))
        W = int(rng.integers(P, 300))
        img = (_image(int(rng.integers(1 << 30)), frames * fh, W) + 0.5).to(dev)
        n = int(rng.choice([0, 1, int(rng.integers(2, 400)) | 1]))
        yx = np.stack([rng.integers(-40, frames * fh + 40, n), rng.integers(-40, W + 40, n)], -1)
        levels.append((img, torch.from_numpy(yx.astype(np.int32)).to(dev),
                       fh if rng.random() < 0.7 else None))
    return levels, P


@pytest.mark.parametrize("seed", range(12))
def test_gather_patches_levels_random(dev, seed):
    levels, P = _random_levels(seed, dev)
    imgs, yxs, fhs = (list(x) for x in zip(*levels))
    out = patch_kernel.gather_patches_levels_cuda(imgs, yxs, P, fhs)
    torch.cuda.synchronize()
    assert torch.equal(out, patch_kernel.gather_patches_levels_plain(imgs, yxs, P, fhs))


@pytest.mark.parametrize("batch", [8, 1])
def test_one_gather_launch_per_batch_extract(dev, batch):
    """batch_extract at B=8 (the chunk path) and B=1 (the host driver):
    FAST+NMS once a level and the patch gather once for every level, and
    the features bit-equal to the per-level describe's composition."""
    from stereo_visual_slam_tpu_torch.models import frontend
    from stereo_visual_slam_tpu_torch.profiling import production
    from stereo_visual_slam_tpu_torch.utils.config import Config

    cfg = Config()
    images = production.chunk_images(cfg, dev)[:batch]
    batch_extract = frontend.make_batch_extractor(cfg, dev, with_depth=True)
    st = batch_extract.stages
    reset_launch_counts()
    got = batch_extract(images)
    torch.cuda.synchronize()
    assert launch_counts() == {"fast_nms": cfg.frontend.n_levels, "gather_patches": 1,
                               "zncc_sweep": 1, "pnp_hypotheses": 0, "pnp_refine": 0}
    left = images[:, 0].float()
    per_level = []
    for i in range(len(st.levels)):
        stacked, scores, yx = st.detect(i, st.level_image(left, i))
        per_level.append((scores, yx, *st.describe(i, st.blur(stacked), yx)))
    ref = st.merge(images, per_level, True)
    for name, a, b in zip(frontend.FrameFeatures._fields, got, ref):
        assert torch.equal(a, b), name


def test_zncc_sweep_matches_plain(dev):
    rng = np.random.default_rng(3)
    left = torch.from_numpy(rng.uniform(0, 255, (96, 384)).astype(np.float32))
    right = torch.roll(left, -17, dims=1)
    yx = np.stack([rng.integers(0, 96, 256), rng.integers(0, 384, 256)], -1)
    yx = torch.from_numpy(yx.astype(np.int32))
    left, right, yx = left.to(dev), right.to(dev), yx.to(dev)
    for D in (32, 96):
        out = stereo_kernel.zncc_sweep(left, right, yx, patch=11, max_disparity=D)
        ref = stereo_kernel.zncc_sweep_plain(left, right, yx, patch=11, max_disparity=D)
        torch.cuda.synchronize()
        assert float((out - ref).abs().max()) <= 2e-5
    kw = dict(fx=718.856, baseline=0.573, max_disparity=32, patch=11)
    valid = torch.ones(yx.shape[0], dtype=torch.bool, device=dev)
    a = stereo_ops.match_disparity(left, right, yx, valid, use_kernel=True, **kw)
    b = stereo_ops.match_disparity(left, right, yx, valid, use_kernel=False, **kw)
    assert torch.equal(a.valid, b.valid) and torch.equal(a.reliable, b.reliable)


def _zncc_equal(left, right, yx, D, P=11):
    out = stereo_kernel.zncc_sweep(left, right, yx, patch=P, max_disparity=D)
    ref = stereo_kernel.zncc_sweep_plain(left, right, yx, patch=P, max_disparity=D)
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (yx.shape[0], D)
    if yx.shape[0]:
        assert float((out - ref).abs().max()) <= 2e-5
    kw = dict(fx=718.856, baseline=0.573, max_disparity=D, patch=P)
    valid = torch.ones(yx.shape[0], dtype=torch.bool, device=left.device)
    a = stereo_ops.match_disparity(left, right, yx, valid, use_kernel=True, **kw)
    b = stereo_ops.match_disparity(left, right, yx, valid, use_kernel=False, **kw)
    assert torch.equal(a.valid, b.valid) and torch.equal(a.reliable, b.reliable)
    return ref


@pytest.mark.parametrize("n", [0, 1, 2048, 16384])
def test_zncc_sweep_production_sizes(production, n):
    """N=2,048 on one (384, 1280) pair (keyframe branch, host driver) and
    N=16,384 on the stacked (3072, 1280) pair with per-frame row offsets
    (the eager chunk path); N=0 and 1 at the edges."""
    cfg, inp = production
    l, r, yx = inp["zncc"]["stacked" if n == 16384 else "single"]
    reset_launch_counts()
    _zncc_equal(l, r, yx[:n].contiguous(), cfg.frontend.max_disparity)
    assert launch_counts()["zncc_sweep"] == (1 if n else 0) * 2


@pytest.mark.parametrize("D", [32, 96])
def test_zncc_sweep_borders(dev, D):
    """Keypoints within D and the patch radius of every border, and beyond
    it (clamped to the image)."""
    H, W = 96, 384
    left = _image(9, H, W)
    right = torch.roll(left, -9, dims=1)
    ys = [-2, 0, 1, 4, 5, 6, H // 2, H - 7, H - 6, H - 2, H - 1, H + 3]
    xs = [-4, 0, 1, 5, 6, D - 2, D - 1, D, D + 5, W // 2, W - 7, W - 6, W - 2, W - 1, W + 2]
    yx = torch.tensor([[y, x] for y in ys for x in xs], dtype=torch.int32)
    _zncc_equal(left.to(dev), right.to(dev), yx.to(dev), D)


@pytest.mark.parametrize("D", [32, 96])
def test_zncc_sweep_flat_patches(dev, D):
    """8-bit images with flat and near-flat regions (one gray level; one
    gray level with +-1 noise) beside a strong edge: windows of zero and
    tiny variance, whose statistics cancel worst. The noise makes every
    near-flat window unique, so that the best disparity is not a tie that
    rounding decides."""
    rng = np.random.default_rng(10)
    H, W = 64, 384
    left = np.full((H, W), 128.0, np.float32)
    left[:, 200:] = 20.0                                   # an edge
    left[:, :200] += rng.integers(-1, 2, (H, 200))         # near-flat
    left[:, 300:] = rng.integers(0, 256, (H, W - 300))     # texture
    left[:16, :150] = 77.0                                 # exactly flat
    left = torch.from_numpy(left)
    right = torch.roll(left, -11, dims=1)
    yx = np.stack([rng.integers(0, H, 600), rng.integers(0, W, 600)], -1)
    yx = torch.from_numpy(yx.astype(np.int32))
    ref = _zncc_equal(left.to(dev), right.to(dev), yx.to(dev), D)
    assert bool((ref == 0).any())   # exactly flat windows score 0


def test_wrappers_refuse_bad_inputs(dev):
    img = torch.zeros((64, 64), device=dev)
    with pytest.raises(TypeError):
        fast_kernel.fast_nms_cuda(img.double(), 20.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_nms_cuda(img.t(), 20.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_nms_cuda(img.cpu(), 20.0)


def test_inv3x3_card_equals_cpu(dev):
    """The fused multiply-adds of the closed-form 3x3 inverse round the same
    on the card as on the CPU, on BA's near-rank-2 landmark blocks."""
    from stereo_visual_slam_tpu_torch.geom import linalg

    rng = np.random.default_rng(8)
    J = rng.normal(0, 50, (4096, 2, 3)).astype(np.float32)
    V = np.einsum("nri,nrj->nij", J, J).astype(np.float32)
    damp = 1e-4 * np.maximum(np.trace(V, axis1=1, axis2=2) / 3, 1.0)
    V = torch.from_numpy((V + (damp[:, None, None] + 1e-6) * np.eye(3)).astype(np.float32))
    assert torch.equal(linalg.inv3x3(V.to(dev)).cpu(), linalg.inv3x3(V))


def test_small_slice_card_equals_cpu(dev):
    """The port on the card (kernels) against the port on the CPU (plain
    versions), per frame, on a small well-conditioned synthetic input with
    the same PnP draws."""
    import dataclasses

    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.utils.config import small_config
    from stereo_visual_slam_tpu_torch.utils import prng

    cfg = small_config()
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))
    world = synthetic.make_world(cfg, n_frames=8, n_points=1500, seed=0)
    frames = list(synthetic.frames(world))
    # the same draws, made on the CPU, for both devices
    H, N = cfg.pnp.n_hypotheses, cfg.frontend.max_raw_keypoints
    noise = {f: prng.pnp_draws(prng.fold_in(prng.prng_key(0), f), H, N, "cpu")
             for f, _, _ in frames}
    runs = {}
    for d in ("cpu", dev):
        slam = ChunkedSlam(cfg, chunk=8, device=d,
                           noise_fn=lambda f, d=d: tuple(t.to(d) for t in noise[f]))
        slam.run(frames, stage=False)
        slam.finish()
        runs[str(d)] = slam
    cpu, card = runs["cpu"], runs[str(dev)]
    keys = ("state", "keyframe", "n_matches")
    assert [[s[k] for k in keys] for s in cpu.stats] == [[s[k] for k in keys] for s in card.stats]
    assert sorted(cpu.estimates) == sorted(card.estimates)
    for f in cpu.estimates:
        np.testing.assert_allclose(card.estimates[f], cpu.estimates[f], atol=1e-4, rtol=0)
    # the staged path on the card gives the streamed path's results
    staged = ChunkedSlam(cfg, chunk=8, device=dev,
                         noise_fn=lambda f: tuple(t.to(dev) for t in noise[f]))
    staged.run(frames, stage=True)
    staged.finish()
    assert [[s[k] for k in keys] for s in staged.stats] == \
        [[s[k] for k in keys] for s in card.stats]
    assert sorted(staged.estimates) == sorted(card.estimates)
    for f in card.estimates:
        np.testing.assert_allclose(staged.estimates[f], card.estimates[f], atol=1e-4, rtol=0)


def _small_slice(n_frames, **keyframe):
    import dataclasses

    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    cfg = small_config()
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0),
                      keyframe=dataclasses.replace(cfg.keyframe, **keyframe))
    world = synthetic.make_world(cfg, n_frames=n_frames, n_points=1500, seed=0)
    return cfg, list(synthetic.frames(world))


def _records(vo):
    return [{k: v for k, v in s.items() if k not in ("wall_s", "ba_cost", "pose_only_cost")}
            for s in vo.stats if s["state"] != "pending"]


def test_host_driver_card_equals_cpu(dev):
    """The host driver on the card (kernels, pinned ring, event waits)
    against the CPU, per frame, on the same PnP draws, with fewer keyframes
    (none at frame 1, as in the CPU parity tests against the reference) and
    a window of 4 for BA to run."""
    cpu = _host_card_vs_cpu(dev, min_inliers_skip=40, window_size=4)
    assert not cpu.stats[1]["keyframe"]


def test_host_driver_card_equals_cpu_keyframe_at_frame_1(dev):
    """The same under the default keyframe rule, which makes frame 1 a
    keyframe: its landmarks have ids of their own (the reference would reuse
    frame 0's there and BA on that map moved poses by up to 2e-2 between
    card and CPU)."""
    cpu = _host_card_vs_cpu(dev, window_size=4)
    assert cpu.stats[1]["keyframe"]


def _host_card_vs_cpu(dev, **keyframe):
    from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry
    from stereo_visual_slam_tpu_torch.utils import prng

    cfg, frames = _small_slice(14, **keyframe)
    # the same draws, made on the CPU, for both devices
    H, N = cfg.pnp.n_hypotheses, cfg.frontend.max_raw_keypoints
    noise = {f: prng.pnp_draws(prng.fold_in(prng.prng_key(0), f), H, N, "cpu")
             for f, _, _ in frames}
    runs = {}
    for d in ("cpu", dev):
        vo = VisualOdometry(cfg, device=d,
                            noise_fn=lambda f, d=d: tuple(t.to(d) for t in noise[f]))
        for f, left, right in frames:
            vo.process(f, left, right)
        vo.finish()
        runs[str(d)] = vo
    cpu, card = runs["cpu"], runs[str(dev)]
    keys = ("state", "keyframe", "n_matches")
    assert [[s.get(k) for k in keys] for s in _records(cpu)] == \
        [[s.get(k) for k in keys] for s in _records(card)]
    assert any("ba_cost" in s for s in card.stats)
    assert sorted(cpu.estimates) == sorted(card.estimates)
    for f in cpu.estimates:
        np.testing.assert_allclose(card.estimates[f], cpu.estimates[f], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(card.map.row_id, cpu.map.row_id)
    return cpu


def test_upload_ring_under_lookahead(dev):
    """lookahead=2 keeps three frames' uploads in flight through a ring of
    four pinned buffers; a slot rewritten before its copy ended would
    change a frame. Without BA, lookahead changes no result."""
    from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry

    cfg, frames = _small_slice(12)
    runs = {}
    for lookahead in (0, 2):
        vo = VisualOdometry(cfg, lookahead=lookahead, enable_ba=False, device=dev)
        for f, left, right in frames:
            vo.process(f, left, right)
        vo.finish()
        runs[lookahead] = vo
    assert len(runs[2]._ring) == 4
    assert _records(runs[0]) == _records(runs[2])
    for f in runs[0].estimates:
        np.testing.assert_array_equal(runs[2].estimates[f], runs[0].estimates[f])


def test_steered_bits_card_equals_cpu(dev):
    """Steered BRIEF from the kernel's patches on the card against the same
    patches on the CPU: orientation bins and bits equal."""
    from stereo_visual_slam_tpu_torch.ops import image as im_ops
    from stereo_visual_slam_tpu_torch.ops import orb

    blurred = im_ops.box_blur(_image(4, 192, 256), 5).to(dev)
    rng = np.random.default_rng(5)
    yx = np.stack([rng.integers(0, 192, 3000), rng.integers(0, 256, 3000)], -1)
    yx = torch.from_numpy(yx.astype(np.int32)).to(dev)
    reset_launch_counts()
    patches = patch_kernel.gather_patches(blurred, yx, 33)
    assert launch_counts()["gather_patches"] == 1
    M = torch.from_numpy(orb.brief_matrix_bf16(256, 33, True))
    packed_card, signs_card = orb.describe_patches(patches, M.to(dev), steer=True)
    packed_cpu, signs_cpu = orb.describe_patches(patches.cpu(), M, steer=True)
    assert torch.equal(signs_card.cpu(), signs_cpu)
    assert torch.equal(packed_card.cpu(), packed_cpu)
