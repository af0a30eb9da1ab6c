"""The port's matcher, PnP-RANSAC and bundle adjustment against the JAX
package on the same inputs. PnP is fed the very numbers `jax.random`
draws inside the JAX solver (split -> gumbel / normal), so both fit the
same hypotheses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.ba import pose_only as jpo
from stereo_visual_slam_tpu.ba import schedule as jsched
from stereo_visual_slam_tpu.ba import schur_lm as jlm
from stereo_visual_slam_tpu.geom import se3 as jse3
from stereo_visual_slam_tpu.ops import matcher as jmatcher
from stereo_visual_slam_tpu.tracking import pnp as jpnp
from stereo_visual_slam_tpu.utils.config import BAConfig as JaxBAConfig
from stereo_visual_slam_tpu_torch.ba import pose_only as tpo
from stereo_visual_slam_tpu_torch.ba import schedule as tsched
from stereo_visual_slam_tpu_torch.ba import schur_lm as tlm
from stereo_visual_slam_tpu_torch.ops import matcher as tmatcher
from stereo_visual_slam_tpu_torch.tracking import pnp as tpnp
from stereo_visual_slam_tpu_torch.utils.config import BAConfig as PortBAConfig

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

FX, FY, CX, CY = 718.856, 718.856, 607.1928, 185.2157
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
T = torch.from_numpy


def _project(T_c_w, pts):
    Xc = pts @ T_c_w[:3, :3].T + T_c_w[:3, 3]
    return np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)


def test_match_exact():
    rng = np.random.default_rng(0)
    n_last, n_curr = 120, 140
    base = np.where(rng.random((n_last, 256)) > 0.5, 1.0, -1.0).astype(np.float32)
    curr = np.where(rng.random((n_curr, 256)) > 0.5, 1.0, -1.0).astype(np.float32)
    curr[:100] = base[:100] * np.where(rng.random((100, 256)) > 0.05, 1.0, -1.0)
    valid_last = rng.random(n_last) > 0.1
    valid_curr = rng.random(n_curr) > 0.1
    curr_yx = rng.uniform(0, 300, (n_curr, 2)).astype(np.float32)
    pred_yx = np.concatenate([curr_yx[:100] + rng.normal(0, 20, (100, 2)),
                              rng.uniform(0, 300, (20, 2))]).astype(np.float32)
    gap = np.float32(2.0)
    kw = dict(base_gate=45.0, min_dist_factor=2.0, margin=0.0)
    a = jmatcher.match(jnp.asarray(base), jnp.asarray(valid_last), jnp.asarray(curr),
                       jnp.asarray(valid_curr), jnp.asarray(gap), jnp.asarray(pred_yx),
                       jnp.asarray(curr_yx), jnp.asarray(60.0 * gap), **kw)
    b = tmatcher.match(T(base), T(valid_last), T(curr), T(valid_curr), torch.tensor(gap),
                       T(pred_yx), T(curr_yx), torch.tensor(60.0 * gap), **kw)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                      err_msg=name)
    assert np.asarray(a.mask).sum() > 30


def _pnp_scene(seed, n=200, n_valid=None, outliers=60):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                    rng.uniform(8, 60, n)], -1).astype(np.float32)
    tau = np.array([0.3, -0.1, 0.8, 0.01, 0.03, -0.005], np.float32)
    T_gt = np.array(jse3.exp(jnp.asarray(tau)))
    uv = _project(T_gt, pts) + rng.normal(0, 0.5, (n, 2))
    uv[:outliers] += rng.uniform(30, 200, (outliers, 2)) * rng.choice([-1, 1], (outliers, 2))
    valid = np.ones(n, bool)
    if n_valid is not None:
        valid[n_valid:] = False
    return pts, uv.astype(np.float32), valid


@pytest.mark.parametrize("case", ["outliers", "few_valid"])
def test_pnp_ransac_same_noise(case):
    """Pose atol 1e-4 and equal inlier masks when fed JAX's own draws,
    including the -inf Gumbel ties of a set with fewer than 4 valid points."""
    pts, uv, valid = _pnp_scene(1, n_valid=None if case == "outliers" else 3)
    H, N = 128, len(pts)
    key = jax.random.PRNGKey(7)
    k_sample, k_perturb = jax.random.split(key)
    g = np.array(jax.random.gumbel(k_sample, (H, N), jnp.float32))
    tw = np.array(jax.random.normal(k_perturb, (H, 6), jnp.float32))
    T_init = np.array(jse3.exp(jnp.asarray([0.25, -0.05, 0.7, 0.0, 0.02, 0.0], jnp.float32)))
    a = jpnp.solve_pnp_ransac(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid),
                              jnp.asarray(K), jnp.asarray(T_init), key,
                              n_hypotheses=H, prior_spread=0.3)
    b = tpnp.solve_pnp_ransac(T(pts), T(uv), T(valid), T(K), T(T_init), T(g), T(tw),
                              prior_spread=0.3)
    np.testing.assert_allclose(b.T_c_w.numpy(), np.asarray(a.T_c_w), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(b.inlier_mask.numpy(), np.asarray(a.inlier_mask))
    assert int(b.n_inliers) == int(a.n_inliers)
    assert int(b.best_score) == int(a.best_score)
    if case == "outliers":
        assert int(a.n_inliers) > 100


def _ba_window(seed, n_kf=6, n_lm=150, n_outlier=10):
    """A driving window like tests/test_ba.py's: forward motion, landmarks
    ahead, noisy init, per-observation outliers, two anchored poses."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-25, 25, n_lm), rng.uniform(-6, 6, n_lm),
                    rng.uniform(15, 80, n_lm)], -1).astype(np.float32)
    T_gt = np.stack([np.array(jse3.exp(jnp.asarray(
        [0.05 * k, 0.0, -1.2 * k, 0.0, 0.01 * k, 0.0], jnp.float32))) for k in range(n_kf)])
    uv = np.stack([_project(Tk, pts) for Tk in T_gt], axis=1)
    Xz = np.einsum("kj,lj->lk", T_gt[:, 2, :3], pts) + T_gt[:, 2, 3][None]
    obs = ((Xz > 1.0) & (uv[..., 0] > 0) & (uv[..., 0] < 1241)
           & (uv[..., 1] > 0) & (uv[..., 1] < 376)).astype(np.float32)
    uv = uv + rng.normal(0, 0.3, uv.shape)
    out = rng.choice(n_lm, n_outlier, replace=False)
    uv[out] += rng.uniform(40, 120, (n_outlier, n_kf, 2)) * rng.choice([-1, 1], (n_outlier, n_kf, 2))
    T_init = np.stack([np.array(jse3.exp(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32)))
                       @ Tk for Tk in T_gt]).astype(np.float32)
    T_init[:2] = T_gt[:2]
    fixed = np.zeros(n_kf, np.float32)
    fixed[:2] = 1.0
    pts_init = (pts + rng.normal(0, 0.3, pts.shape)).astype(np.float32)
    arrays = dict(T_c_w=T_init, points=pts_init, uv=uv.astype(np.float32), obs_mask=obs,
                  point_mask=np.ones(n_lm, np.float32), pose_mask=np.ones(n_kf, np.float32),
                  fixed_pose=fixed)
    return (jlm.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            tlm.BAProblem(**{k: T(v) for k, v in arrays.items()}))


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_optimize_matches(seed):
    jp, tp = _ba_window(seed)
    for iters in (2, 5):
        a = jlm.lm_optimize(jp, jnp.asarray(K), iters=iters)
        b = tlm.lm_optimize(tp, T(K), iters=iters)
        np.testing.assert_allclose(b.T_c_w.numpy(), np.asarray(a.T_c_w), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(b.landmark_inlier.numpy(), np.asarray(a.landmark_inlier))
        np.testing.assert_allclose(float(b.cost), float(a.cost), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_pose_only_matches(seed):
    jp, tp = _ba_window(seed)
    a = jpo.optimize_pose_only(jp, jnp.asarray(K), iters=3)
    b = tpo.optimize_pose_only(tp, T(K), iters=3)
    np.testing.assert_allclose(b.T_c_w.numpy(), np.asarray(a.T_c_w), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(b.landmark_inlier.numpy(), np.asarray(a.landmark_inlier))


def test_ba_schedule_matches():
    jp, tp = _ba_window(2)
    L, Kw = jp.points.shape[0], jp.T_c_w.shape[0]
    rng = np.random.default_rng(3)
    masks = dict(
        inlier=(rng.random(L) > 0.05).astype(np.float32),
        reliable=(rng.random(L) > 0.3).astype(np.float32),
        present=np.ones(L, np.float32),
    )
    common = dict(T_c_w=jp.T_c_w, points=jp.points, uv=jp.uv, obs_mask=jp.obs_mask,
                  pose_mask=jp.pose_mask, fixed_pose=jp.fixed_pose)
    ji = jsched.ScheduleInput(**common, **{k: jnp.asarray(v) for k, v in masks.items()})
    ti = tsched.ScheduleInput(**{k: T(np.array(v)) for k, v in common.items()},
                              **{k: T(v) for k, v in masks.items()})
    a = jsched.make_ba_schedule(JaxBAConfig())(ji, jnp.asarray(K))
    b = tsched.make_ba_schedule(PortBAConfig())(ti, T(K))
    np.testing.assert_allclose(b.T_c_w.numpy(), np.asarray(a.T_c_w), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(b.inlier.numpy(), np.asarray(a.inlier))
    np.testing.assert_allclose(float(b.cost_full), float(a.cost_full), rtol=1e-4)
    assert Kw == 6 and not np.asarray(a.inlier).all()
