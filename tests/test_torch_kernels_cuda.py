"""The CUDA kernels against their plain torch versions at small shapes.
They need a CUDA card (and nvcc to build the kernels): marked `cuda`, they
skip without one. On the card, where jax is not installed (tests/conftest.py
imports it): python -m pytest --noconftest tests/test_torch_kernels_cuda.py
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


@pytest.mark.parametrize("hw", [(256, 256), (131, 97), (8, 33)])
def test_fast_nms_bit_exact(dev, hw):
    img = _image(0, *hw).to(dev)
    reset_launch_counts()
    out = fast_kernel.fast_nms_score_map(img, 20.0)
    torch.cuda.synchronize()
    assert launch_counts()["fast_nms"] == 1
    assert torch.equal(out, fast_kernel.fast_nms_plain(img, 20.0))


@pytest.mark.parametrize("frame_h", [None, 64])
def test_gather_patches_bit_exact(dev, frame_h):
    img = (_image(1, 192, 256) + 0.25).to(dev)
    rng = np.random.default_rng(2)
    yx = np.stack([rng.integers(-5, 197, 300), rng.integers(-5, 261, 300)], -1)
    yx = torch.from_numpy(yx.astype(np.int32)).to(dev)
    out = patch_kernel.gather_patches(img, yx, 33, frame_h)
    torch.cuda.synchronize()
    assert torch.equal(out, patch_kernel.gather_patches_plain(img, yx, 33, frame_h))


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
    from stereo_visual_slam_tpu_torch.shared import small_config, synthetic
    from stereo_visual_slam_tpu_torch.tracking.pnp import draw_noise

    cfg = small_config()
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))
    world = synthetic.make_world(cfg, n_frames=8, n_points=1500, seed=0)
    frames = list(synthetic.frames(world))
    gen = torch.Generator().manual_seed(0)
    H, N = cfg.pnp.n_hypotheses, cfg.frontend.max_raw_keypoints
    noise = {f: draw_noise(gen, H, N, "cpu") for f, _, _ in frames}
    runs = {}
    for d in ("cpu", dev):
        slam = ChunkedSlam(cfg, chunk=8, device=d,
                           noise_fn=lambda f, d=d: tuple(t.to(d) for t in noise[f]))
        slam.run(frames)
        slam.finish()
        runs[str(d)] = slam
    cpu, card = runs["cpu"], runs[str(dev)]
    keys = ("state", "keyframe", "n_matches")
    assert [[s[k] for k in keys] for s in cpu.stats] == [[s[k] for k in keys] for s in card.stats]
    assert sorted(cpu.estimates) == sorted(card.estimates)
    for f in cpu.estimates:
        np.testing.assert_allclose(card.estimates[f], cpu.estimates[f], atol=1e-4, rtol=0)
