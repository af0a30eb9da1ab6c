"""The upstream deployment `kitti-upstream` at full size on the card: one
128-frame pass of the `urban` traffic (slam_bench/traffic/urban.json)
through the streamed ChunkedSlam, as the benchmark drives it:

- no frame goes Lost and every frame gets a record;
- PnP-RANSAC is captured once for (N = 3,000, H = 128) and replayed once a
  frame;
- the first chunk's extraction, steered BRIEF included, equals the plain
  reference's (slam_bench/reference) field for field.

It needs a CUDA card: marked `cuda`, it skips without one. On the card,
run it without tests/conftest.py, which imports jax:
python -m pytest --noconftest tests/test_torch_upstream_config_cuda.py
"""

import os

import pytest
import torch

from slam_bench import compare, run
from stereo_visual_slam_tpu_torch.pipeline import chunked
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import config as port_config

pytestmark = pytest.mark.cuda

SEED = 2**31 + 18


@pytest.fixture(scope="module")
def upstream():
    """(the cell's spec, the port's Config, the world, its frames)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = run.load_cell(run.ROOT, "upstream-urban")
    data = spec["config"]["config"]
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    w, frames = run.make_frames(data, spec["traffic"], SEED, workers)
    return spec, run.build_config(port_config.Config, data), w, frames


def test_a_full_size_pass_tracks_with_one_capture_and_reference_bits(upstream):
    spec, cfg, w, frames = upstream
    assert cfg.frontend.steer_descriptor and cfg.frontend.max_raw_keypoints == 3000
    chunk = spec["traffic"]["chunk"]
    pc = cfg.pnp
    solver = pnp.graphed(sample_size=pc.sample_size, inlier_px=pc.inlier_px,
                         gn_iters_hypothesis=pc.gn_iters_hypothesis,
                         gn_iters_refine=pc.gn_iters_refine, huber_px=pc.huber_px)
    captures, replays = solver.captures, solver.replays
    side = compare.Outputs()
    compare.stream(lambda: chunked.ChunkedSlam(cfg, chunk=chunk, seed=SEED, device="cuda"),
                   frames, chunk, side)
    records = side.passes[0].records
    assert sorted(records) == list(range(len(frames))) == list(range(128))
    assert not any(bool(r.lost) for r in records.values())
    # one capture at N = 3,000 keypoints: gumbel, the sixth input, is (H, N)
    keys = [g for g in solver.graphs.values() if g.inputs[5].shape == (pc.n_hypotheses, 3000)]
    assert len(keys) == 1
    assert solver.captures - captures <= 1 and solver.replays - replays == len(frames)

    from slam_bench.reference import config as ref_config

    judge = compare.Judge(run.build_config(ref_config.Config, spec["config"]["config"]),
                          frames, w.poses_T_c_w, SEED, chunk, "cuda")
    mine, theirs = side.extract[0], judge.extraction(0)
    for name, a, b in zip(compare.EXTRACT_FIELDS, mine, theirs):
        assert a.shape == b.shape and torch.equal(a, b.to(a.device)), name
    assert mine[0].shape[:2] == (chunk, 3000)
