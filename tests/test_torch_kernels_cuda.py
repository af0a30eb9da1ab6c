"""The CUDA kernels against their plain torch versions at small shapes,
and both drivers on the card against the CPU on a small slice (the host
driver also under lookahead, through its pinned upload ring).
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

    from stereo_visual_slam_tpu_torch.shared import small_config, synthetic

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
    from stereo_visual_slam_tpu_torch.tracking.pnp import draw_noise

    cfg, frames = _small_slice(14, **keyframe)
    gen = torch.Generator().manual_seed(0)
    H, N = cfg.pnp.n_hypotheses, cfg.frontend.max_raw_keypoints
    noise = {f: draw_noise(gen, H, N, "cpu") for f, _, _ in frames}
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
