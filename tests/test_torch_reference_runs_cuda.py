"""The port on the card over all 64 frames of the JAX package's reference
runs (stereo_visual_slam_tpu_torch/data/reference_runs.json), held to the
bound of pipeline/reference_runs.py: the chunked driver (streamed, chunk 8)
and the host driver (lookahead 1), both with their default draws (the JAX
stream); the port on the card against the port on the CPU with the same
draws (what rounding alone does); and the bench's degraded PnP
(BENCH_DEGRADE: 8 hypotheses, no refinement sweep, 16 px inliers), which
the bound must refuse. Each prints its gaps as a JSON line
(`reference gaps ...`).

They need a CUDA card: marked `cuda`, they skip without one. On the card
run them without tests/conftest.py, which imports jax, pins it to 8
virtual CPU devices and turns its compilation cache on, none of which
the port uses:
python -m pytest --noconftest -s tests/test_torch_reference_runs_cuda.py
"""

import json

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch.bench import degraded
from stereo_visual_slam_tpu_torch.data import synthetic
from stereo_visual_slam_tpu_torch.pipeline import reference_runs
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry
from stereo_visual_slam_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda

CHUNK = 8
LOOKAHEAD = 1


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref = reference_runs.load()
    w = ref["world"]
    world = synthetic.make_world(Config(), n_frames=w["n_frames"], n_points=w["n_points"],
                                 seed=w["seed"])
    return ref, world, list(synthetic.frames(world))


def chunked(cfg, frames, device):
    slam = ChunkedSlam(cfg, chunk=CHUNK, device=device)
    slam.run(frames, stage=False)
    slam.finish()
    return reference_runs.records(slam.stats, slam.estimates)


def host(cfg, frames, device):
    vo = VisualOdometry(cfg, lookahead=LOOKAHEAD, device=device)
    for f, left, right in frames:
        vo.process(f, left, right)
    vo.finish()
    return reference_runs.records(vo.stats, vo.estimates)


def report(label, gaps):
    print(f"reference gaps {label}: {json.dumps(gaps)}")
    print(f"{label}: {reference_runs.summary(gaps)}")


@pytest.mark.parametrize("driver", ["chunked", "host"])
def test_card_held_to_the_reference(world, driver):
    ref, w, frames = world
    recs = (chunked if driver == "chunked" else host)(Config(), frames, "cuda")
    gaps = reference_runs.compare(recs, ref["runs"][driver], w.poses_T_c_w)
    report(f"{driver}, card against JAX", gaps)
    assert not reference_runs.misses(gaps)


def test_rounding_alone(world):
    """The port on the CPU and on the card, same draws: both within the
    bound of the JAX run, and their gap to each other."""
    ref, w, frames = world
    cpu, card = chunked(Config(), frames, "cpu"), chunked(Config(), frames, "cuda")
    as_ref = dict(frames=cpu, ate_m=reference_runs.accuracy(cpu, w.poses_T_c_w)["ate_m"])
    between = reference_runs.compare(card, as_ref, w.poses_T_c_w)
    report("chunked, card against the port's CPU", between)
    gaps = reference_runs.compare(cpu, ref["runs"]["chunked"], w.poses_T_c_w)
    report("chunked, the port's CPU against JAX", gaps)
    assert not reference_runs.misses(gaps)
    assert not reference_runs.misses(between)


def test_degraded_pnp_fails_the_bound(world):
    ref, w, frames = world
    recs = chunked(degraded(Config()), frames, "cuda")
    gaps = reference_runs.compare(recs, ref["runs"]["chunked"], w.poses_T_c_w)
    report("chunked, degraded PnP on the card against JAX", gaps)
    missed = reference_runs.misses(gaps)
    print(f"degraded run misses: {missed}")
    assert missed
    assert np.isfinite(gaps["ate_m"])
