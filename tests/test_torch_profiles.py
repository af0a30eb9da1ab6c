"""The hard and highway synthetic worlds through both packages' ChunkedSlam
at small size, the port fed the JAX chunk program's PnP draws: per-frame
records and poses at test_torch_slice's strict tolerance, and the evicted
keyframes (frame id and pose) equal to the JAX driver's `_evictions`.

The hard world brings sensor noise, exposure drift, moving occluders, a
low-texture stretch and a sharp turn; the highway world 2.7 m a frame and
sparse structure. A window of 4 keyframes makes the window turn over
within 16 frames. The full-size checks of these worlds are the card tests
of test_torch_profiles_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam as TorchSlam
from test_torch_slice import CONFIGS, assert_same_run, jax_noise, slice_config, slice_configs

torch.set_num_threads(1)

N_FRAMES, CHUNK, WINDOW = 16, 8, 4


def profile_configs():
    """(the JAX package's config, the port's): test_torch_slice's strict
    slice config with a 4-keyframe window."""
    out = []
    for c in CONFIGS:
        cfg = slice_config(c, 1)
        out.append(cfg.replace(keyframe=dataclasses.replace(cfg.keyframe, window_size=WINDOW)))
    return tuple(out)


@pytest.mark.parametrize("profile, seed", [("hard", 1), ("highway", 5)])
def test_profile_matches_jax(profile, seed):
    jcfg, tcfg = profile_configs()
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=seed,
                                 profile=profile)
    assert world.noise_sigma > 0   # both profiles add sensor noise
    frames = list(synthetic.frames(world))
    ref = JaxSlam(jcfg, chunk=CHUNK)
    ref.run(frames)
    ref.finish()
    t = TorchSlam(tcfg, chunk=CHUNK, device="cpu", noise_fn=jax_noise(jcfg))
    t.run(frames)
    t.finish()
    assert t.lost == ref.lost
    assert len(t.stats) == N_FRAMES
    assert_same_run(ref, t)
    assert sum(s["ba_cost"] is not None for s in t.stats) >= 1
    assert len(ref._evictions) >= 2
    assert [f for f, _ in t.evictions] == [f for f, _ in ref._evictions]
    for (f, a), (_, b) in zip(t.evictions, ref._evictions):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=f"evicted frame {f}")


def test_soak_world_exhausts_the_arena_as_jax_does():
    """The soak's world (seed 7) at small size, its sprites at half the
    soak's density: the 512-row arena runs out of free rows within 16
    frames, and from the seventh keyframe on no landmark spawns - in the
    JAX package exactly as in the port (the same records and arena rows).
    With 2,048 rows every keyframe spawns, so it is the arena that ran out:
    the system's own, which tools/soak.py's end-of-run live-row check does
    not see (ROADMAP Queue C)."""
    jcfg, tcfg = slice_configs(3)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=8000 * (N_FRAMES + 80) // 296 // 2,
                                 seed=7)
    frames = list(synthetic.frames(world))
    ref = JaxSlam(jcfg, chunk=CHUNK)
    ref.run(frames)
    ref.finish()
    t = TorchSlam(tcfg, chunk=CHUNK, device="cpu", noise_fn=jax_noise(jcfg))
    t.run(frames)
    t.finish()
    assert_same_run(ref, t)
    np.testing.assert_array_equal(t.map.alive, ref.map.alive)
    spawned = [s["n_new_landmarks"] for s in t.stats if s["keyframe"]]
    assert min(spawned[:6]) > 0 and spawned[6:] and max(spawned[6:]) == 0, spawned

    roomy = TorchSlam(tcfg.replace(ba=dataclasses.replace(tcfg.ba, max_landmarks=2048)),
                      chunk=CHUNK, device="cpu", noise_fn=jax_noise(jcfg))
    roomy.run(frames)
    roomy.finish()
    assert min(s["n_new_landmarks"] for s in roomy.stats if s["keyframe"]) > 0
