"""The slice held to trajectory-level bounds: both packages' ChunkedSlam on
the same frames and the same PnP noise, neither Lost, keyframe counts
within 1, per-frame camera centres within 0.05 m, the port's ATE bounded
by the reference's.

Case 2, production-shaped: small_config with its 3 pyramid levels, 24
frames. The coarse levels go through the pyramid resize, whose pixels
differ by up to 6e-4 gray levels, so per-frame equality is not expected.

small_config exactly as the package defines it: its KITTI principal point
(607, 185) lies outside the 128x256 image, so every observation sits in
one corner of the view and the pose is ill-conditioned (ATE ~3.3 m in both
packages). A rounding-level change anywhere moves the trajectory by ~1e-2 m
there, where the centred slices of test_torch_slice.py agree to ~2e-5 m."""

import dataclasses

import numpy as np

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.pipeline import trajectory as traj
from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam as TorchSlam
from test_torch_slice import CONFIGS, jax_noise, slice_configs


def _centres(est):
    return {f: -T[:3, :3].T @ T[:3, 3] for f, T in est.items()}


def assert_tracks_jax(configs, n_frames):
    jcfg, tcfg = configs
    world = synthetic.make_world(jcfg, n_frames=n_frames, n_points=1500, seed=0)
    frames = list(synthetic.frames(world))
    j = JaxSlam(jcfg, chunk=8)
    j.run(frames)
    j.finish()
    t = TorchSlam(tcfg, chunk=8, device="cpu", noise_fn=jax_noise(jcfg))
    t.run(frames)
    t.finish()

    assert not j.lost and not t.lost
    assert len(t.stats) == len(j.stats) == n_frames
    assert sum(s["ba_cost"] is not None for s in t.stats) >= 1
    kf_j = sum(s["keyframe"] for s in j.stats)
    kf_t = sum(s["keyframe"] for s in t.stats)
    assert abs(kf_j - kf_t) <= 1
    cj, ct = _centres(j.estimates), _centres(t.estimates)
    assert sorted(ct) == sorted(cj)
    worst = max(np.linalg.norm(cj[f] - ct[f]) for f in cj)
    assert worst <= 0.05, worst

    def ate(s):
        fids = sorted(s.estimates)
        return traj.ate_rmse(np.stack([s.estimates[f] for f in fids]),
                             world.poses_T_c_w[fids])

    ate_j, ate_t = ate(j), ate(t)
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.05), (ate_t, ate_j)
    return len(cj)


def test_three_level_slice_tracks_jax():
    assert assert_tracks_jax(slice_configs(3), 24) >= 0.9 * 24


def _one_level_small_config(config):
    cfg = config.small_config()
    return cfg.replace(frontend=dataclasses.replace(cfg.frontend, n_levels=1))


def test_small_config_slice_tracks_jax():
    # 12 of its 16 frames are tracked, in both packages
    assert_tracks_jax(tuple(_one_level_small_config(c) for c in CONFIGS), 16)
