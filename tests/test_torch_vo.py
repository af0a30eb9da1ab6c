"""The host-sequenced driver of the port against the JAX package's: the
tracker's keyframe update and full frame step, then `VisualOdometry` per
frame at lookahead 0 and 1, its map, and its snapshots in both directions.

The port takes the PnP draws the JAX driver splits off its key chain (one
split per submitted frame, `jax_vo_noise`). Small config with n_levels=1
and the centred principal point, as in test_torch_slice.py, with fewer
keyframes (skip at 40 inliers) and a window of 4 so that BA runs: frame 1
must not be a keyframe, because the reference host driver would reuse the
first keyframe's landmark ids there (ROADMAP Queue C), and BA on that map
is ill-posed: it moves poses by 2e-4 to 9e-3 with the CPU's thread count
alone (torch at 1 thread against 8, measured).

Tolerances: state, keyframe flag and match count equal; inliers within 1;
poses atol 1e-4; MapStore alive / row ids / observation counts / inlier
flags equal. Landmark positions: atol 1e-4 plus rtol 1e-5, because a
landmark is the keyframe pose applied to a stereo depth of up to 400 m (the
largest gap measured here is 2.3e-4 m on a landmark 50 m away, 4.6e-6
relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.models import vslam as jvslam
from stereo_visual_slam_tpu.pipeline import snapshot as jsnapshot
from stereo_visual_slam_tpu.pipeline.vo import VisualOdometry as JaxVO
from stereo_visual_slam_tpu_torch.models import frontend as tfe
from stereo_visual_slam_tpu_torch.models import vslam as tvslam
from stereo_visual_slam_tpu_torch.pipeline import snapshot as tsnapshot
from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry as TorchVO

from test_torch_slice import CONFIGS, slice_config, slice_configs

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

N_FRAMES = 16
SPLIT_AT = 8


def vo_config(config):
    cfg = slice_config(config, 1)
    return cfg.replace(keyframe=dataclasses.replace(cfg.keyframe, min_inliers_skip=40,
                                                    window_size=4))


def jax_vo_noise(cfg, n_frames, seed=0):
    """frame_id -> the PnP draws of a JAX VisualOdometry that initialises on
    frame 0 and submits every later frame: frame f uses the f-th split of
    PRNGKey(seed), then split -> gumbel / normal as tracking/pnp.py does."""
    H, N = cfg.pnp.n_hypotheses, cfg.frontend.max_raw_keypoints

    @jax.jit
    def draws(key):
        k_sample, k_perturb = jax.random.split(key)
        return (jax.random.gumbel(k_sample, (H, N), jnp.float32),
                jax.random.normal(k_perturb, (H, 6), jnp.float32))

    rng = jax.random.PRNGKey(seed)
    out = {}
    for f in range(1, n_frames):
        rng, key = jax.random.split(rng)
        g, t = draws(key)
        out[f] = (torch.from_numpy(np.array(g)), torch.from_numpy(np.array(t)))
    return out.__getitem__


def jax_vo(cfg, like=None, **kw):
    """A JAX VisualOdometry; `like` lends its compiled programs."""
    vo = JaxVO(cfg, **kw)
    if like is not None:
        vo.extract, vo.full_step = like.extract, like.full_step
        vo.keyframe_update, vo.run_schedule = like.keyframe_update, like.run_schedule
    return vo


def run(vo, frames):
    for f, left, right in frames:
        vo.process(f, left, right)
    vo.finish()
    return vo


def port_ids(cfg, jax_ids):
    """The landmark ids the port gives where the reference gave `jax_ids`.
    The port reserves the id range of its first frame, the reference does
    not, so every id spawned after frame 0 is n_features higher in the port.
    (Without a keyframe at frame 1, the reference's ids below n_features are
    all frame 0's.)"""
    nf = cfg.frontend.n_features
    return np.where(jax_ids >= nf, jax_ids + nf, jax_ids)


def assert_same_vo(j, t, first=0, from_start=True):
    """`from_start`: both drivers initialised themselves (and not from one
    snapshot), so their landmark ids differ as `port_ids` says."""
    js = [s for s in j.stats if s["frame_id"] >= first and s["state"] != "pending"]
    ts = [s for s in t.stats if s["frame_id"] >= first and s["state"] != "pending"]
    assert [s["frame_id"] for s in js] == [s["frame_id"] for s in ts]
    for a, b in zip(js, ts):
        assert (a["state"], a.get("keyframe"), a.get("n_matches")) == \
            (b["state"], b.get("keyframe"), b.get("n_matches")), (a, b)
        assert abs(a.get("n_inliers", 0) - b.get("n_inliers", 0)) <= 1, (a, b)
        assert ("ba_cost" in a) == ("ba_cost" in b)
    assert sorted(j.estimates) == sorted(t.estimates)
    for f in t.estimates:
        np.testing.assert_allclose(t.estimates[f], j.estimates[f], atol=1e-4, rtol=0,
                                   err_msg=f"frame {f}")
    jm, tm = j.map, t.map
    for name in ("alive", "obs_count", "inlier", "reliable"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    ids = (lambda a: port_ids(t.config, a)) if from_start else (lambda a: a)
    np.testing.assert_array_equal(tm.row_id, ids(jm.row_id), err_msg="row_id")
    np.testing.assert_allclose(tm.pos[tm.alive], jm.pos[jm.alive], atol=1e-4, rtol=1e-5)
    assert sorted(tm.keyframes) == sorted(jm.keyframes)
    assert (j.next_kf_id, int(ids(np.int64(j.next_lm_id))), j.num_lost) == \
        (t.next_kf_id, t.next_lm_id, t.num_lost)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = (vo_config(c) for c in CONFIGS)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=0)
    frames = list(synthetic.frames(world))
    ref = run(jax_vo(jcfg), frames)
    return (jcfg, tcfg), frames, ref, jax_vo_noise(jcfg, N_FRAMES)


def _features(cfg, frames, i):
    H, W = cfg.padded_hw
    h, w = cfg.image_hw
    img = np.zeros((2, H, W), np.uint8)
    img[0, :h, :w] = frames[i][1]
    img[1, :h, :w] = frames[i][2]
    return img


def test_keyframe_update_matches_jax(setup):
    (jcfg, tcfg), frames, ref, _ = setup
    img = _features(tcfg, frames, 0)
    fj = ref.extract(jnp.asarray(img[0], jnp.float32), jnp.asarray(img[1], jnp.float32))
    ft = tfe.make_extractor(tcfg, "cpu")(torch.from_numpy(img))
    n = tcfg.frontend.max_raw_keypoints
    rng = np.random.default_rng(0)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.3, -0.1, 2.0]
    state = dict(
        yx=np.asarray(fj.yx), signs=np.asarray(fj.signs),
        valid=rng.random(n) < 0.5,
        lm_id=rng.integers(0, 5000, n).astype(np.int32),
        lm_pos=rng.normal(0, 20, (n, 3)).astype(np.float32),
        lm_reliable=rng.random(n) < 0.5,
        T_c_w=T, T_c_l=np.eye(4, dtype=np.float32),
    )
    _, kfu_t = tvslam.make_tracker(tcfg, "cpu")
    sj, nj, uj = ref.keyframe_update(
        jvslam.TrackState(**{k: jnp.asarray(v) for k, v in state.items()}), fj,
        jnp.asarray(777, jnp.int32))
    st, nt, ut = kfu_t(
        tvslam.TrackState(**{k: torch.from_numpy(v) for k, v in state.items()}), ft, 777)
    assert int(nt) == int(nj) > 10
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert ut.any()
    for name in ("valid", "lm_id", "lm_reliable", "yx", "signs", "T_c_w"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)))
    np.testing.assert_allclose(st.lm_pos.numpy(), np.asarray(sj.lm_pos), atol=1e-4, rtol=1e-6)


def test_full_step_matches_jax(setup):
    """One step from frame 0 to frame 1 under the default keyframe rule,
    which makes frame 1 a keyframe."""
    _, frames, ref, noise = setup
    jcfg, tcfg = slice_configs(1)
    img0, img1 = _features(tcfg, frames, 0), _features(tcfg, frames, 1)
    # the JAX driver's state after initialising on frame 0
    fj0 = ref.extract(jnp.asarray(img0[0], jnp.float32), jnp.asarray(img0[1], jnp.float32))
    sj0, _, _ = ref.keyframe_update(
        jvslam.empty_state(jcfg)._replace(yx=fj0.yx, signs=fj0.signs), fj0,
        jnp.asarray(0, jnp.int32))
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    sj, ij, uj = jvslam.make_full_step(jcfg, ref.extract)(jnp.asarray(img1), sj0, jnp.asarray(1.0, jnp.float32), key,
                               jnp.asarray(128, jnp.int32))

    extract = tfe.make_extractor(tcfg, "cpu")
    full_step = tvslam.make_full_step(tcfg, extract, "cpu")
    _, kfu = tvslam.make_tracker(tcfg, "cpu")
    f0 = extract(torch.from_numpy(img0))
    st0, _, _ = kfu(tvslam.empty_state(tcfg, "cpu")._replace(yx=f0.yx, signs=f0.signs), f0, 0)
    g, tw = noise(1)
    st, it, ut = full_step(torch.from_numpy(img1), st0, torch.tensor(1.0), g, tw, 128)

    for name in ("ok", "is_keyframe", "n_matches", "n_new"):
        assert int(getattr(it, name)) == int(getattr(ij, name)), name
    assert bool(it.ok) and int(it.n_new) > 0
    assert abs(int(it.n_inliers) - int(ij.n_inliers)) <= 1
    np.testing.assert_allclose(it.T_c_w.numpy(), np.asarray(ij.T_c_w), atol=1e-4)
    np.testing.assert_allclose(float(it.twist_norm), float(ij.twist_norm), atol=1e-4)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    for name in ("valid", "lm_id", "lm_reliable"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)))
    np.testing.assert_allclose(st.lm_pos.numpy(), np.asarray(sj.lm_pos), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("lookahead", [0, 1])
def test_visual_odometry_matches_jax(setup, lookahead):
    (jcfg, tcfg), frames, ref, noise = setup
    j = ref if lookahead == 0 else run(jax_vo(jcfg, like=ref, lookahead=lookahead), frames)
    t = run(TorchVO(tcfg, lookahead=lookahead, device="cpu", noise_fn=noise), frames)
    assert t.state.name == "TRACK"
    assert_same_vo(j, t)
    # one wait per collected frame, per BA result and for the first frame
    n_ba = sum(1 for s in t.stats if "ba_cost" in s or "ba_dispatched" in s)
    assert n_ba >= 1
    assert t.syncs == N_FRAMES + n_ba


def test_snapshot_resume_equals_uninterrupted(setup, tmp_path):
    (_, cfg), frames, _, _ = setup
    whole = run(TorchVO(cfg, device="cpu"), frames)
    a = TorchVO(cfg, device="cpu")
    for f, left, right in frames[:SPLIT_AT]:
        a.process(f, left, right)
    path = str(tmp_path / "vo.npz")
    tsnapshot.save_snapshot(a, path)
    b = TorchVO(cfg, device="cpu")
    tsnapshot.load_snapshot(b, path)
    run(b, frames[SPLIT_AT:])

    def records(vo):
        return [{k: v for k, v in s.items() if k != "wall_s"}
                for s in vo.stats if s["frame_id"] >= SPLIT_AT]

    assert records(b) == records(whole)
    for f in b.estimates:
        np.testing.assert_array_equal(b.estimates[f], whole.estimates[f])
    for name in ("pos", "alive", "row_id", "obs_count", "inlier"):
        np.testing.assert_array_equal(getattr(b.map, name), getattr(whole.map, name))


def test_jax_snapshot_loads_into_port(setup, tmp_path):
    (jcfg, tcfg), frames, ref, noise = setup
    j = jax_vo(jcfg, like=ref)
    for f, left, right in frames[:SPLIT_AT]:
        j.process(f, left, right)
    path = str(tmp_path / "jax_vo.npz")
    jsnapshot.save_snapshot(j, path)
    j = jax_vo(jcfg, like=ref)
    jsnapshot.load_snapshot(j, path)
    run(j, frames[SPLIT_AT:])

    t = TorchVO(tcfg, device="cpu", noise_fn=noise)
    tsnapshot.load_snapshot(t, path)
    assert t.next_kf_id == int(np.load(path)["next_kf_id"]) and t.map.n_keyframes() > 1
    run(t, frames[SPLIT_AT:])
    assert_same_vo(j, t, first=SPLIT_AT, from_start=False)


def test_keyframe_at_frame_1_keeps_landmarks_apart(setup):
    """Under the default keyframe rule frame 1 is a keyframe. The port
    reserves frame 0's landmark ids, so frame 1's spawns are new landmarks;
    the reference reuses frame 0's ids there and merges them into old ones
    (a deliberate divergence, ROADMAP Queue C)."""
    _, frames, _, _ = setup
    jcfg, tcfg = slice_configs(1)
    t = TorchVO(tcfg, device="cpu", enable_ba=False)
    j = JaxVO(jcfg, enable_ba=False)
    for vo in (t, j):
        for f, left, right in frames[:2]:
            vo.process(f, left, right)
        vo.finish()
    for vo in (t, j):
        assert vo.stats[1]["keyframe"] and vo.stats[1]["n_new_landmarks"] > 0
    spawned = t.stats[0]["n_landmarks"] + t.stats[1]["n_new_landmarks"]
    ids = t.map.row_id[t.map.alive]
    assert int(t.map.alive.sum()) == spawned and len(np.unique(ids)) == spawned
    # frame 1 sees its new landmarks at their own rows, apart from frame 0's
    kf0, kf1 = (t.map.keyframes[k] for k in sorted(t.map.keyframes))
    fresh = np.setdiff1d(kf1.rows[kf1.valid], kf0.rows[kf0.valid])
    assert len(fresh) == t.stats[1]["n_new_landmarks"]
    # the reference, for contrast, keeps fewer rows than it spawned
    assert int(j.map.alive.sum()) < j.stats[0]["n_landmarks"] + j.stats[1]["n_new_landmarks"]
