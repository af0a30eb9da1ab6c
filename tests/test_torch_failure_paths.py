"""The tracking-failure machinery of both port drivers against the JAX
package's (the scenarios of test_failure_paths.py, at small size):

  * a garbage frame is rejected, the pose is held, tracking recovers;
  * three rejections grow the frame gap, and the re-acquisition frame
    passes the motion gate scaled by the gap;
  * the Lost fuse blows at frame 4 + max_lost, and frames after Lost are a
    no-op;
  * the port's host driver and chunked driver agree through a rejection.

Garbage frames are uniform noise from a seed. Per frame, every accept /
reject / lost decision of the port's ChunkedSlam equals the JAX
ChunkedSlam's, and the port's VisualOdometry's equals the JAX one's, on the
same PnP draws. small_config with the centred principal point and a 2,048-row
landmark arena: at small_config's 512 rows the arena fills by frame 8 and
the chunked drivers (both packages alike) reject good frames for want of
landmarks.
"""

import dataclasses

import numpy as np
import pytest

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam as TorchSlam
from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry as TorchVO

from test_torch_slice import CONFIGS, jax_noise, slice_config
from test_torch_vo import jax_vo, jax_vo_noise

N_FRAMES = 16
GARBAGE_AT = 8
GAP_SPAN = (6, 7, 8)


def failure_config(config):
    cfg = slice_config(config, 3)
    return cfg.replace(ba=dataclasses.replace(cfg.ba, max_landmarks=2048))


def _garbage_like(img, seed):
    return np.random.default_rng(seed).uniform(0, 255, img.shape).astype(np.float32)


def sequence(frames, kind, max_lost):
    if kind == "reject":
        return [(f, _garbage_like(l, 7), _garbage_like(r, 8)) if f == GARBAGE_AT else (f, l, r)
                for f, l, r in frames]
    if kind == "gap":
        return [(f, _garbage_like(l, 100 + f), _garbage_like(r, 200 + f)) if f in GAP_SPAN
                else (f, l, r) for f, l, r in frames]
    _, l0, r0 = frames[0]
    return list(frames[:4]) + [
        (4 + i, _garbage_like(l0, 300 + i), _garbage_like(r0, 400 + i))
        for i in range(max_lost + 2)
    ]


@pytest.fixture(scope="module")
def runs():
    """kind -> {driver: finished driver}, each sequence run once per driver."""
    jcfg, cfg = (failure_config(c) for c in CONFIGS)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=0)
    frames = list(synthetic.frames(world))
    noise_chunked, noise_host = jax_noise(jcfg), jax_vo_noise(jcfg, N_FRAMES)
    out, jax_host = {}, None
    for kind in ("reject", "gap", "lost"):
        seq = sequence(frames, kind, cfg.keyframe.max_lost)
        jax_host = jax_vo(jcfg, like=jax_host)
        drivers = dict(
            jax_chunked=JaxSlam(jcfg, chunk=4),
            torch_chunked=TorchSlam(cfg, chunk=4, device="cpu", noise_fn=noise_chunked),
            jax_host=jax_host,
            torch_host=TorchVO(cfg, device="cpu", noise_fn=noise_host),
        )
        for d in drivers.values():
            for f, left, right in seq:
                d.process(f, left, right)
            d.finish()
        out[kind] = drivers
    return cfg, world, out


def decisions(driver):
    # the host driver labels frame 0 "init"
    return {s["frame_id"]: s["state"].replace("init", "tracked")
            for s in driver.stats if s["state"] != "pending"}


@pytest.mark.parametrize("kind", ["reject", "gap", "lost"])
@pytest.mark.parametrize("driver", ["chunked", "host"])
def test_decisions_equal_jax(runs, kind, driver):
    _, _, out = runs
    d = out[kind]
    assert decisions(d[f"torch_{driver}"]) == decisions(d[f"jax_{driver}"])


@pytest.mark.parametrize("driver", ["torch_chunked", "torch_host"])
def test_rejection_and_recovery(runs, driver):
    _, _, out = runs
    d = out["reject"][driver]
    states = decisions(d)
    assert states[GARBAGE_AT] == "rejected"
    assert GARBAGE_AT not in d.estimates
    assert all(states[f] == "tracked" for f in range(N_FRAMES) if f != GARBAGE_AT), states


@pytest.mark.parametrize("driver", ["torch_chunked", "torch_host"])
def test_frame_gap_gate_growth(runs, driver):
    cfg, _, out = runs
    d = out["gap"][driver]
    states = decisions(d)
    assert [states[f] for f in GAP_SPAN] == ["rejected"] * len(GAP_SPAN)
    recovery = [s for s in d.stats if s["frame_id"] == GAP_SPAN[-1] + 1][0]
    assert recovery["state"] == "tracked"
    if driver == "torch_chunked":
        # the gap counts from the last ACCEPTED frame: the recovery's motion
        # spans four frames, beyond half the single-frame twist gate
        assert recovery["twist"] > cfg.pnp.max_twist * 0.5, recovery


@pytest.mark.parametrize("driver", ["torch_chunked", "torch_host"])
def test_lost_fuse(runs, driver):
    cfg, world, out = runs
    d = out["lost"][driver]
    lost = sorted(f for f, s in decisions(d).items() if s == "lost")
    assert lost and lost[0] == 4 + cfg.keyframe.max_lost
    n_stats = len(d.stats)
    frames = list(synthetic.frames(world))
    rec = d.process(99, frames[0][1], frames[0][2])
    d.finish()
    if driver == "torch_host":
        assert rec["state"] == "lost"
        assert [s["frame_id"] for s in d.stats[n_stats:]] == []
    else:
        assert len(d.stats) == n_stats


def test_host_and_chunked_agree_through_a_rejection(runs):
    """Same decisions; camera centres within 0.2 m on every common frame,
    frame 1 included. The reference host driver does not reserve the
    landmark ids of its first keyframe (pipeline/vo.py:186 against
    :211-215), so there a keyframe at frame 1 reuses ids 0.. and BA pulls
    that keyframe's pose 2.68 m away; the port reserves them."""
    _, _, out = runs
    ch, ho = out["reject"]["torch_chunked"], out["reject"]["torch_host"]
    assert decisions(ch) == decisions(ho)
    common = sorted(set(ch.estimates) & set(ho.estimates))
    assert len(common) >= N_FRAMES - 3
    for f in common:
        d = np.linalg.norm(np.linalg.inv(ch.estimates[f])[:3, 3]
                           - np.linalg.inv(ho.estimates[f])[:3, 3])
        assert d < 0.2, f"frame {f}: drivers diverge by {d} m"
