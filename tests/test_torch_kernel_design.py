"""On the CPU, the arithmetic the redesigned CUDA kernels rely on, written
out in torch, against the plain versions; and the Python the kernels'
shapes and bounds depend on (ops/kernels/measure.py).

  * FAST+NMS (csrc/fast_nms.cu): the compass early reject drops no pixel
    with a nonzero score (so skipping the arc evaluation there is exact),
    and the doubling network of arc minima and maxima gives the plain
    score bit for bit.
  * ZNCC (csrc/zncc_sweep.cu): window means from column box sums, the
    square sum two-pass and the mean subtracted in the dot product give
    the plain sweep within atol 2e-5, flat and near-flat windows included.
  * measure.kernel_inputs builds the kernels' inputs at the shapes the
    frontend gives them, and the bounds count what the docstrings say.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereo_visual_slam_tpu_torch.data import synthetic
from stereo_visual_slam_tpu_torch.models import frontend
from stereo_visual_slam_tpu_torch.ops import fast, stereo
from stereo_visual_slam_tpu_torch.ops.kernels import measure
from stereo_visual_slam_tpu_torch.utils.config import small_config

torch.set_num_threads(1)


def _textured(seed, h=96, w=160):
    rng = np.random.default_rng(seed)
    img = rng.integers(10, 30, (h, w)).astype(np.float32)
    for _ in range(h * w // 300):
        y, x = rng.integers(3, h - 3), rng.integers(3, w - 3)
        img[y - 2: y + 3, x - 2: x + 3] = rng.integers(120, 256, (5, 5))
    return torch.from_numpy(img)


def _plateaus(seed, h=96, w=160):
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 4, (h // 4, w // 4)) * 60.0
    return torch.from_numpy(np.kron(blocks, np.ones((4, 4))).astype(np.float32))


def _synthetic_frame():
    world = synthetic.make_world(small_config(), n_frames=1, n_points=1500, seed=0)
    _, left, _ = next(synthetic.frames(world))
    return torch.from_numpy(left.astype(np.float32))


IMAGES = {"textured": lambda: _textured(0), "plateaus": lambda: _plateaus(1),
          "uniform": lambda: torch.from_numpy(
              np.random.default_rng(2).uniform(0, 255, (64, 96)).astype(np.float32)),
          "synthetic": _synthetic_frame}


@pytest.mark.parametrize("threshold", [0.0, 20.0, 200.0])
@pytest.mark.parametrize("image", sorted(IMAGES))
def test_compass_reject_keeps_every_corner(image, threshold):
    img = IMAGES[image]()
    score = fast.fast_score_map(img, threshold)
    candidates = measure.compass_pass(img, threshold)
    assert not bool(((score > 0) & ~candidates).any())
    if threshold == 20.0:
        assert int((score > 0).sum()) > 0


def _doubling_score(img, threshold):
    """The kernel's arc score: min/max over each 9-arc by pairs, quads and
    octets, then max / min over the 16 arcs."""
    d = list(fast._shifted_views(img) - img[None])
    ring = lambda v, k: v[k % 16]
    n2 = [torch.minimum(d[k], ring(d, k + 1)) for k in range(16)]
    x2 = [torch.maximum(d[k], ring(d, k + 1)) for k in range(16)]
    n4 = [torch.minimum(n2[k], ring(n2, k + 2)) for k in range(16)]
    x4 = [torch.maximum(x2[k], ring(x2, k + 2)) for k in range(16)]
    bright = torch.full_like(img, -float("inf"))
    dark = torch.full_like(img, float("inf"))
    for k in range(16):
        bright = torch.maximum(bright, torch.minimum(torch.minimum(n4[k], ring(n4, k + 4)), ring(d, k + 8)))
        dark = torch.minimum(dark, torch.maximum(torch.maximum(x4[k], ring(x4, k + 4)), ring(d, k + 8)))
    sb = torch.where(bright > threshold, bright, 0.0)
    sd = torch.where(-dark > threshold, -dark, 0.0)
    return torch.maximum(sb, sd)


@pytest.mark.parametrize("threshold", [0.0, 20.0, 200.0])
@pytest.mark.parametrize("image", sorted(IMAGES))
def test_doubling_network_bit_exact(image, threshold):
    img = IMAGES[image]()
    assert torch.equal(_doubling_score(img, threshold), fast.fast_score_map(img, threshold))


def _zncc_kernel_math(left, right, yx, patch, D):
    """The kernel's statistics in torch: window means from column sums of
    the strip, (w - mean) squared and dotted with the normalised patch."""
    p, r = patch, patch // 2
    H, W = left.shape
    y = yx[:, 0].long().clamp(0, H - 1)
    x = yx[:, 1].long().clamp(0, W - 1)
    lpad = F.pad(left, (r, r, r, r))
    rpad = F.pad(right, (D + r, r, r, r))
    rows = (y[:, None] + torch.arange(p))[:, :, None]
    lp = lpad[rows, (x[:, None] + torch.arange(p))[:, None, :]]
    strip = rpad[rows, (x[:, None] + 1 + torch.arange(p + D - 1))[:, None, :]]
    n = torch.full((), float(p * p))
    mean = lp.sum((1, 2), keepdim=True) / n
    lm = lp - mean
    lp_n = lm / (torch.sqrt((lm * lm).sum((1, 2), keepdim=True)) + 1e-6)
    colsum = strip.sum(1)                                     # (N, p + D - 1)
    out = torch.empty((len(yx), D))
    for d in range(D):
        t = D - 1 - d
        wmean = colsum[:, t:t + p].sum(1) / n                 # box sum of p columns
        w = strip[:, :, t:t + p] - wmean[:, None, None]
        out[:, d] = (lp_n * w).sum((1, 2)) / (torch.sqrt((w * w).sum((1, 2))) + 1e-6)
    return out


@pytest.mark.parametrize("D", [32, 96])
def test_zncc_window_statistics_within_atol(D):
    rng = np.random.default_rng(11)
    H, W = 48, 256
    left = np.full((H, W), 128.0, np.float32)
    left[:, 120:] = 20.0                                   # an edge
    left[:, :120] += rng.integers(-1, 2, (H, 120))         # near-flat: +-1 gray level
    left[:, 190:] = rng.integers(0, 256, (H, W - 190))     # texture
    left[:12, :90] = 77.0                                  # exactly flat
    left = torch.from_numpy(left)
    right = torch.roll(left, -9, dims=1)
    yx = torch.from_numpy(np.stack([rng.integers(-2, H + 2, 300),
                                    rng.integers(-2, W + 2, 300)], -1).astype(np.int32))
    ref = stereo.zncc_sweep(left, right, yx, patch=11, max_disparity=D)
    got = _zncc_kernel_math(left, right, yx, 11, D)
    assert float((got - ref).abs().max()) <= 2e-5
    assert bool((ref == 0).any())


def test_zncc_plain_mean_is_true_division():
    """Two flat patches score 0 in the plain sweep (a mean taken as a
    multiplication by 1/121 would leave an offset that scores ~0.98)."""
    img = torch.full((32, 64), 53.0)   # 53 * 121 * fl(1/121) != 53 in f32
    assert np.float32(53 * 121) * (np.float32(1) / np.float32(121)) != np.float32(53)
    yx = torch.tensor([[16, 40], [10, 45]], dtype=torch.int32)
    assert torch.equal(stereo.zncc_sweep(img, img, yx, patch=11, max_disparity=32),
                       torch.zeros((2, 32)))


def test_kernel_inputs_follow_the_level_geometry():
    cfg = small_config()
    world = synthetic.make_world(cfg, n_frames=2, n_points=800, seed=0)
    inp = measure.kernel_inputs(cfg, list(synthetic.frames(world)), "cpu")
    levels = frontend._level_geometry(cfg)
    assert len(inp["levels"]) == len(inp["gathers"]) == len(levels) == cfg.frontend.n_levels
    for img, (blurred, yx, fh), (_, _, (H_i, W_i), budget) in zip(
            inp["levels"], inp["gathers"], levels):
        assert tuple(img.shape) == tuple(blurred.shape) == (2 * H_i, W_i)
        assert img.is_contiguous() and fh == H_i
        assert tuple(yx.shape) == (2 * budget, 2) and yx.dtype == torch.int32
        assert int(yx[:budget, 0].max()) < H_i <= int(yx[budget:, 0].min())
    H, W = cfg.padded_hw
    N = cfg.frontend.max_raw_keypoints
    l, r, yx = inp["zncc"]["single"]
    assert tuple(l.shape) == tuple(r.shape) == (H, W) and tuple(yx.shape) == (N, 2)
    l, r, yx = inp["zncc"]["stacked"]
    assert tuple(l.shape) == (2 * H, W) and tuple(yx.shape) == (2 * N, 2)
    assert int(yx[N:, 0].min()) >= H


def test_bounds_count_bytes_and_operations():
    img = torch.zeros((384, 1280))
    ms, by = measure.fast_bound(img, 20.0)   # flat: no candidate, bytes bound
    assert by == "bytes" and ms == pytest.approx(1e3 * 8 * 384 * 1280 / measure.PEAK_BYTES)
    ms, by = measure.zncc_bound(img, 2048, 11, 96)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 5 * 2048 * 96 * 121 / measure.PEAK_F32)
    ms, by = measure.gather_bound(img, 1000, 33)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (4 * 384 * 1280 + 8 * 1000 + 4 * 1000 * 33 * 33)
                               / measure.PEAK_BYTES)
    # the all-levels gather: the levels' bytes summed, no operations
    small = torch.zeros((320, 1024))
    ms, by = measure.bound(*measure.gather_levels_work([img, small], [1000, 0], 33))
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (4 * 384 * 1280 + 8 * 1000 + 4 * 1000 * 33 * 33
                                      + 4 * 320 * 1024) / measure.PEAK_BYTES)
    # the bound reads only the pixels under the windows: two keypoints
    # whose windows overlap by 3 columns, and one clamped into the corner
    yx = torch.tensor([[100, 100], [100, 130], [-5, -5]], dtype=torch.int32)
    assert measure.covered_pixels(img, yx, 33) == 33 * 63 + 33 * 33
    ms, by = measure.bound(*measure.gather_work(img, 3, 33, covered=33 * 63 + 33 * 33))
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * (4 * (33 * 63 + 33 * 33) + 8 * 3 + 4 * 3 * 33 * 33)
                               / measure.PEAK_BYTES)
    b = measure.gather_levels_bound([(img, yx, None), (small, yx[:0], None)], 33)
    assert b["covered_pixels"] == 33 * 63 + 33 * 33
    assert b["image_pixels"] == 384 * 1280 + 320 * 1024
    assert b["bound_ms"] == pytest.approx(ms)
    assert b["whole_image_bound_ms"] == pytest.approx(
        measure.bound(*measure.gather_levels_work([img, small], [3, 0], 33))[0])
