"""The upstream deployment `kitti-upstream` (slam_bench/configs/
kitti-upstream.json: steered rBRIEF on 3,000 ORB keypoints, the Hamming
gate of 30 with no search window, the upstream BA budget) on the CPU,
against the benchmark's plain reference (slam_bench/reference, plain
torch, no JAX):

- the file builds the port's Config and the reference's, equal field for
  field, and differs from kitti-upstream-ba.json in four keys alone;
- steered BRIEF of 3,000 rows, a chunk's steered extraction and the
  unwindowed matcher are bit-equal to the reference's;
- a small-size ChunkedSlam under the configuration makes the reference's
  decisions frame for frame with the same PnP draws;
- the tracer's `extract.brief` span and `track.matches` / `track.inliers`
  counters: one span an extraction, the counters equal to the mask and
  inlier sums, and the run bit-equal to the run with the tracer off.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_bench import compare, run, world
from slam_bench.reference import chunked as ref_chunked
from slam_bench.reference import config as ref_config
from slam_bench.reference import frontend as ref_frontend
from slam_bench.reference import matcher as ref_matcher
from slam_bench.reference import orb as ref_orb
from stereo_visual_slam_tpu_torch.models import frontend
from stereo_visual_slam_tpu_torch.ops import matcher, orb
from stereo_visual_slam_tpu_torch.pipeline import chunked
from stereo_visual_slam_tpu_torch.utils import config as port_config
from stereo_visual_slam_tpu_torch.utils import trace

torch.set_num_threads(1)

CONFIGS = Path(__file__).resolve().parents[1] / "slam_bench" / "configs"
# the four constants of visual_odometry.cpp that kitti-upstream-ba lacks
UPSTREAM_KEYS = {("frontend", "max_raw_keypoints"): 3000, ("frontend", "steer_descriptor"): True,
                 ("matcher", "base_gate"): 30.0, ("matcher", "search_radius"): 1e6}
N_FRAMES = 14
CHUNK = 7
SEED = 2**31 + 7


def _data(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())["config"]


def _small_data() -> dict:
    """kitti-upstream cut to the CPU's size as test_torch_reference_config
    cuts the reference-faithful configuration: small_config()'s shapes
    (3 levels), the principal point centred, a window of 4 keyframes; the
    upstream constants as the file has them."""
    d = _data("kitti-upstream")
    small = dataclasses.asdict(port_config.small_config())
    for group, key in (("frontend", "max_raw_keypoints"), ("frontend", "n_features"),
                       ("frontend", "max_disparity"), ("frontend", "n_levels"),
                       ("ba", "max_landmarks"), ("pnp", "n_hypotheses")):
        d[group][key] = small[group][key]
    d["image_hw"] = list(small["image_hw"])
    d["camera"].update(cx=128.0, cy=64.0)
    d["keyframe"]["window_size"] = 4
    return d


def test_the_file_builds_both_configs_and_differs_in_four_keys():
    data = _data("kitti-upstream")
    port = run.build_config(port_config.Config, data)
    ref = run.build_config(ref_config.Config, data)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    base = _data("kitti-upstream-ba")
    differ = {(g, k): v for g, group in data.items() if isinstance(group, dict)
              for k, v in group.items() if base[g][k] != v}
    assert differ == UPSTREAM_KEYS
    assert {g: v for g, v in data.items() if not isinstance(v, dict)} == {
        g: v for g, v in base.items() if not isinstance(v, dict)}
    assert port.matcher.margin == 0.0 and port.frontend.n_features == 500
    assert (port.frontend.n_levels, port.frontend.scale_factor,
            port.frontend.fast_threshold) == (8, 1.2, 20)
    assert (port.ba.classify_passes, port.ba.classify_iters, port.ba.full_iters,
            port.ba.pose_only_iters, port.ba.fix_oldest_pose) == (2, 5, 10, 10, False)


def test_steered_brief_of_3000_rows_equals_the_reference():
    g = torch.Generator().manual_seed(18)
    # box-blurred random patches, so the centroid angles spread over the bins
    raw = torch.rand((3000, 1, 37, 37), generator=g) * 255.0
    patches = torch.nn.functional.avg_pool2d(raw, 5, stride=1)[:, 0]
    assert patches.shape == (3000, 33, 33)
    M = torch.from_numpy(orb.brief_matrix_bf16(256, 33, True))
    M_ref = torch.from_numpy(ref_orb.brief_matrix_bf16(256, 33, True))
    assert M.shape == (33 * 33, 30 * 256) and torch.equal(M, M_ref)
    packed, signs = orb.describe_patches(patches, M, steer=True)
    packed_ref, signs_ref = ref_orb.describe_patches(patches, M_ref, steer=True)
    assert torch.equal(packed, packed_ref) and torch.equal(signs, signs_ref)
    theta = orb.orientations(patches.to(torch.bfloat16).float())
    bins = torch.remainder(torch.round(theta * 30 / (2 * np.pi)).long(), 30)
    assert len(bins.unique()) == 30
    # steering picks other columns than the upright descriptor's
    upright, _ = orb.describe_patches(patches, M[:, :256], steer=False)
    assert not torch.equal(upright[bins != 0], packed[bins != 0])


def test_the_unwindowed_matcher_equals_the_reference():
    g = torch.Generator().manual_seed(30)
    n = 3000
    last = torch.where(torch.rand((n, 256), generator=g) < 0.5, 1.0, -1.0)
    perm = torch.randperm(n, generator=g)
    # a true partner for each last row, 0-40 of its bits flipped
    flips = torch.rand((n, 256), generator=g) < torch.rand((n, 1), generator=g) * 0.16
    curr = torch.where(flips, -last, last)[perm]
    valid_last = torch.rand(n, generator=g) < 0.95
    valid_curr = torch.rand(n, generator=g) < 0.95
    pred = torch.rand((n, 2), generator=g) * torch.tensor([376.0, 1241.0])
    yx = torch.rand((n, 2), generator=g) * torch.tensor([376.0, 1241.0])
    gap = torch.tensor(1.0)
    kw = dict(base_gate=30.0, min_dist_factor=2.0, margin=0.0)
    got = matcher.match(last, valid_last, curr, valid_curr, gap, pred_yx=pred, curr_yx=yx,
                        search_radius=1e6 * gap, **kw)
    want = ref_matcher.match(last, valid_last, curr, valid_curr, gap, pred_yx=pred,
                             curr_yx=yx, search_radius=1e6 * gap, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # a radius of 1e6 px masks nothing: the same as no window at all
    free = matcher.match(last, valid_last, curr, valid_curr, gap, **kw)
    for a, b in zip(got, free):
        assert torch.equal(a, b)
    # the gate of 30: every accepted match within it, and some rejected by it
    assert bool((got.dist[got.mask] <= 30.0).all()) and 0 < int(got.mask.sum()) < n
    assert int(((got.dist > 30.0) & (got.dist < 1e9)).sum()) > 0


@pytest.fixture(scope="module")
def frames():
    d = _small_data()
    cam = d["camera"]
    w = world.make_world(world.Camera(cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                                      cam["baseline"], tuple(d["image_hw"])),
                         n_frames=N_FRAMES, n_points=1500, seed=1)
    return w, world.render_all(w, 0)


def test_steered_extraction_of_a_chunk_equals_the_reference(frames):
    data = _small_data()
    port_cfg = run.build_config(port_config.Config, data)
    images = compare.upload(port_cfg, frames[1][:CHUNK], "cpu")
    mine = frontend.make_batch_extractor(port_cfg, "cpu", with_depth=False)(images)
    theirs = ref_frontend.make_batch_extractor(run.build_config(ref_config.Config, data), "cpu",
                                               with_depth=False)(images)
    for name in mine._fields:
        assert torch.equal(getattr(mine, name), getattr(theirs, name)), name
    assert mine.packed.shape == (CHUNK, 512, 8) and int(mine.valid.sum()) > 0


def _port_run(frames):
    slam = chunked.ChunkedSlam(run.build_config(port_config.Config, _small_data()),
                               chunk=CHUNK, seed=SEED, device="cpu")
    for f in frames:
        slam.process(*f)
    slam.finish()
    return slam


@pytest.fixture(scope="module")
def untraced(frames):
    return _port_run(frames[1])


def test_small_chunked_slam_makes_the_references_decisions(frames, untraced):
    ref = ref_chunked.ChunkedSlam(run.build_config(ref_config.Config, _small_data()),
                                  chunk=CHUNK, seed=SEED, device="cpu")
    for f in frames[1]:
        ref.process(*f)
    ref.finish()
    keys = ("frame_id", "state", "keyframe", "n_matches", "n_inliers", "n_new_landmarks")
    assert [[s[k] for k in keys] for s in untraced.stats] == [[s[k] for k in keys]
                                                              for s in ref.stats]
    assert untraced.stats == ref.stats
    assert sorted(untraced.estimates) == sorted(ref.estimates)
    for f, T in untraced.estimates.items():
        np.testing.assert_array_equal(T, ref.estimates[f])
    assert not untraced.lost
    assert sum(s["state"] == "tracked" for s in untraced.stats) >= N_FRAMES // 2
    assert sum(s["ba_cost"] is not None for s in untraced.stats) >= 1


def test_tracer_spans_and_counters_of_the_upstream_run(frames, untraced, monkeypatch):
    trace.disable()
    trace.drain()
    masks = []
    real = matcher.match

    def counted(*a, **k):
        m = real(*a, **k)
        masks.append(int(m.mask.sum()))
        return m
    monkeypatch.setattr(matcher, "match", counted)
    # off: nothing recorded, the matcher called once a frame
    off = _port_run(frames[1])
    assert trace.drain() == ([], {}) and len(masks) == N_FRAMES
    assert chunked.differences(untraced, off) == []
    masks.clear()
    trace.enable()
    try:
        on = _port_run(frames[1])
    finally:
        trace.disable()
    rows, totals = trace.drain()
    assert chunked.differences(untraced, on) == []
    extracts = [r for r in rows if r.name == "extract"]
    briefs = [r for r in rows if r.name == "extract.brief"]
    assert len(extracts) == len(briefs) == -(-N_FRAMES // CHUNK)
    by_id = {r.id: r for r in rows}
    for b in briefs:
        parent = by_id[b.parent]
        assert parent.name == "extract" and parent.t0 <= b.t0 <= b.t1 <= parent.t1
    assert totals["track.matches"] == sum(masks) > 0
    assert totals["track.inliers"] == sum(s["n_inliers"] for s in on.stats) > 0
