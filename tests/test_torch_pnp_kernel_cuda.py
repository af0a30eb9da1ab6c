"""PnP-RANSAC's two CUDA kernels (ops/kernels/pnp_kernel,
csrc/pnp_ransac.cu) against the plain path they replace
(`pnp.hypotheses_plain`, `pnp.solve_pnp_ransac_plain`) on the card, on
random inputs at the production shapes (N=2,048 points, H=128), at the
small config's (N=512, H=64), with rows of fewer valid entries than a
minimal set, with equal Gumbel values, and on the tracking inputs of the
bench's two worlds (urban, highway):

- the minimal sets are the plain path's, bit for bit (-inf ties included);
- at H=128 every hypothesis's pose and score are the plain path's bit
  for bit (the small config's H=64 is left out: the plain path's batched
  products sum in another order there);
- the final pose is within 1e-5, its inlier set equal off the line;
- under 4 winning inliers the prior pose stays and no entry is an inlier;
- a graph replay equals a direct call bit for bit, and so do two calls;
- over a driver run every replay launched the kernels: `track.pnp_kernel`
  equals `track.pnp_graph`, no call ran the plain path, and the kernels'
  launch counters read one launch each a frame.

They need a CUDA card: marked `cuda`, they skip without one. On the card,
run them without tests/conftest.py, which imports jax:
python -m pytest --noconftest tests/test_torch_pnp_kernel_cuda.py
"""

import functools
import json
from pathlib import Path

import pytest
import torch

from stereo_visual_slam_tpu_torch.ops import kernels
from stereo_visual_slam_tpu_torch.ops.fast import top_k_stable
from stereo_visual_slam_tpu_torch.ops.kernels import pnp_kernel
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import cuda_graph, trace
from stereo_visual_slam_tpu_torch.utils.config import Config, small_config

from test_torch_pnp_graph_cuda import equal, inputs, run_chunked, settings

pytestmark = pytest.mark.cuda

LINE_PX = 1e-3      # a point this close to the inlier line may flip on rounding
POSE_ATOL = 1e-5
PRODUCTION_H = Config().pnp.n_hypotheses
TRAFFIC = Path(__file__).resolve().parents[1] / "slam_bench" / "traffic"
WORLD_FRAMES = 16


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def case(cfg, seed, dev, spread=0.3, n_valid=None, ties=False):
    """(args, keywords) of one PnP call: `inputs`' scene, the first n_valid
    entries valid (all of its valid ones if None), Gumbel values rounded to
    a tenth (many equal) if `ties`."""
    args = list(inputs(cfg, seed, dev))
    if n_valid is not None:
        args[2] = torch.arange(args[2].shape[0], device=dev) < n_valid
    if ties:
        args[5] = torch.round(args[5] * 10) / 10
        args[5][:4] = 0.5   # whole rows of one value
    return tuple(args), dict(prior_spread=torch.tensor(spread, device=dev), **settings(cfg))


CASES = {
    "production_1": lambda dev: case(Config(), 1, dev),
    "production_2_no_spread": lambda dev: case(Config(), 2, dev, spread=0.0),
    "production_3_wide_spread": lambda dev: case(Config(), 3, dev, spread=0.9),
    "small_config": lambda dev: case(small_config(), 4, dev),
    "three_valid": lambda dev: case(Config(), 5, dev, n_valid=3),
    "six_valid": lambda dev: case(Config(), 6, dev, n_valid=6),
    "gumbel_ties": lambda dev: case(Config(), 7, dev, ties=True),
}


@pytest.fixture(scope="module")
def world_calls(dev):
    """Every PnP call of ChunkedSlam over the first WORLD_FRAMES frames of
    the bench's urban and highway worlds (slam_bench/traffic), recorded."""
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam

    cfg = Config()
    calls = []

    def recorder(**kw):
        def solve(*args, **call_kw):
            calls.append((tuple(a.clone() for a in args),
                          dict(kw, **{k: v.clone() if torch.is_tensor(v) else v
                                      for k, v in call_kw.items()})))
            return pnp.solve_pnp_ransac(*args, **kw, **call_kw)
        return solve

    with pytest.MonkeyPatch.context() as m:
        m.setattr(pnp, "graphed", recorder)
        for traffic in ("urban", "highway"):
            t = json.loads((TRAFFIC / f"{traffic}.json").read_text())
            world = synthetic.make_world(cfg, n_frames=WORLD_FRAMES, n_points=t["n_points"],
                                         speed=t["speed"], yaw_rate=t["yaw_rate"], seed=11,
                                         profile=t["profile"])
            slam = ChunkedSlam(cfg, chunk=8, device="cuda")
            slam.run(list(synthetic.frames(world)), stage=False)
            slam.finish()
    assert len(calls) >= 2 * (WORLD_FRAMES - 1)
    return calls


def all_cases(dev, world_calls):
    yield from ((name, make(dev)) for name, make in CASES.items())
    yield from ((f"world_{i}", call) for i, call in enumerate(world_calls))


def hyp_keywords(kw: dict) -> dict:
    return {k: kw[k] for k in ("sample_size", "inlier_px", "gn_iters_hypothesis", "prior_spread")}


def kernel_hypotheses(args, kw) -> pnp_kernel.Hypotheses:
    half, rot_w = pnp._start_weights(args[5].shape[0], torch.float32, args[0].device)
    return pnp_kernel.pnp_hypotheses(*args, half, rot_w, kw["prior_spread"],
                                     sample_size=kw["sample_size"], inlier_px=kw["inlier_px"],
                                     gn_iters_hypothesis=kw["gn_iters_hypothesis"])


def errors(T, args) -> torch.Tensor:
    """(..., N) reprojection errors of the points at the poses T (..., 4, 4),
    by the plain path's ops; not in front of the camera or invalid: inf."""
    from stereo_visual_slam_tpu_torch.ba import residuals as res

    pts_w, uv, valid, K = args[:4]
    r, _, depth_ok = res.reprojection_residual_jac(T[..., None, :, :], pts_w, uv, K)
    err = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(valid & depth_ok.bool(), err, float("inf"))


def on_line(err: torch.Tensor, px: float) -> torch.Tensor:
    return (err - px).abs() < LINE_PX


def test_minimal_sets_bit_equal_to_the_plain_path(dev, world_calls):
    for name, (args, kw) in all_cases(dev, world_calls):
        got = kernel_hypotheses(args, kw).sample_idx
        g = torch.where(args[2][None, :], args[5], float("-inf"))
        want = top_k_stable(g, kw["sample_size"])[1]
        assert got.dtype == want.dtype and torch.equal(got, want), name
        assert torch.equal(want, pnp.hypotheses_plain(*args, **hyp_keywords(kw))[0]), name


def test_hypotheses_bit_equal_to_the_plain_path(dev, world_calls):
    """At the tracker's H = 128 the kernel sums and multiplies in the order
    the plain path's ops take on the card, so every hypothesis's pose and
    score is the plain path's bit for bit (NaN where it has NaN), however
    far a degenerate minimal set throws it. The small config's H = 64 is
    left out: there cuBLAS picks other kernels for the plain path's
    batched products, whose sums take another order."""
    report = {}
    for name, (args, kw) in all_cases(dev, world_calls):
        if args[5].shape[0] != PRODUCTION_H:
            continue
        got = kernel_hypotheses(args, kw)
        idx, T_hyp, scores, _ = pnp.hypotheses_plain(*args, **hyp_keywords(kw))
        same = (got.T_hyp == T_hyp) | (torch.isnan(got.T_hyp) & torch.isnan(T_hyp))
        report[name] = int(same.all(dim=(1, 2)).sum())
        assert torch.equal(got.sample_idx, idx), name
        assert bool(same.all()), (name, float((got.T_hyp - T_hyp).abs().nan_to_num().max()))
        assert got.scores.dtype == scores.dtype and torch.equal(got.scores, scores), name
    print(f"hypotheses bit-equal of {PRODUCTION_H}: {report}")
    assert len(report) == len(CASES) - 1 + len(world_calls)


def test_final_result_near_the_plain_path(dev, world_calls):
    worst, off_line_differ, differ = 0.0, 0, 0
    for name, (args, kw) in all_cases(dev, world_calls):
        got = pnp.solve_pnp_ransac(*args, **kw)
        want = pnp.solve_pnp_ransac_plain(*args, **kw)
        assert all(x.dtype == y.dtype and x.shape == y.shape for x, y in zip(got, want)), name
        gap = float((got.T_c_w - want.T_c_w).abs().max())
        worst = max(worst, gap)
        assert gap <= POSE_ATOL, (name, gap)
        line = on_line(errors(want.T_c_w, args), kw["inlier_px"])
        off_line_differ += int(((got.inlier_mask != want.inlier_mask) & ~line).sum())
        differ += int(got.n_inliers != want.n_inliers)
        assert int(got.n_inliers) == int(got.inlier_mask.sum()), name
        assert abs(int(got.best_score) - int(want.best_score)) <= 1, name
    print(f"final: largest pose gap {worst:.3e}, calls whose inlier count differs {differ}")
    assert off_line_differ == 0


@pytest.mark.parametrize("name", ["three_valid", "six_valid"])
def test_no_consensus_keeps_the_prior(dev, name):
    args, kw = CASES[name](dev)
    got = pnp.solve_pnp_ransac(*args, **kw)
    want = pnp.solve_pnp_ransac_plain(*args, **kw)
    if name == "three_valid":
        assert int(got.best_score) < 4
    assert int(got.best_score) == int(want.best_score)
    if int(got.best_score) < 4:
        assert torch.equal(got.T_c_w, args[4])
        assert not bool(got.inlier_mask.any()) and int(got.n_inliers) == 0
        assert equal(got, want)


def test_replays_and_calls_bit_equal(dev):
    args, kw = CASES["production_1"](dev)
    other, other_kw = CASES["production_3_wide_spread"](dev)
    spread, other_spread = kw.pop("prior_spread"), other_kw.pop("prior_spread")
    solver = cuda_graph.Graphed(functools.partial(pnp.solve_pnp_ransac, **kw), "track.pnp")
    first = solver(*args, prior_spread=spread)
    mid = solver(*other, prior_spread=other_spread)
    again = solver(*args, prior_spread=spread)
    assert (solver.captures, solver.replays) == (1, 3)
    direct = [pnp.solve_pnp_ransac(*args, prior_spread=spread, **kw) for _ in range(2)]
    assert equal(direct[0], direct[1])
    assert equal(first, direct[0]) and equal(again, direct[0])
    assert equal(mid, pnp.solve_pnp_ransac(*other, prior_spread=other_spread, **kw))
    assert not torch.equal(first.T_c_w, mid.T_c_w)


def test_every_replay_launches_the_kernels(dev, monkeypatch):
    from stereo_visual_slam_tpu_torch.ops.kernels import measure

    cfg, frames = measure.production_frames(WORLD_FRAMES)
    monkeypatch.setattr(cuda_graph, "_SHARED", {})
    kernels.reset_launch_counts()
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        run_chunked(cfg, frames)
    finally:
        trace.disable()
        _, totals = trace.drain()
    assert totals["track.pnp_graph"] == WORLD_FRAMES
    assert totals["track.pnp_kernel"] == totals["track.pnp_graph"]
    assert "track.pnp_eager" not in totals
    launched = kernels.launch_counts()
    assert launched["pnp_hypotheses"] == launched["pnp_refine"] == WORLD_FRAMES


def test_the_wrapper_refuses_what_the_kernels_cannot_take(dev):
    args, kw = CASES["production_1"](dev)
    half, rot_w = pnp._start_weights(args[5].shape[0], torch.float32, dev)
    with pytest.raises(ValueError, match="minimal sets"):
        pnp_kernel.pnp_hypotheses(*args, half, rot_w, 0.3, sample_size=5)
    with pytest.raises(TypeError):
        pnp_kernel.pnp_hypotheses(args[0].double(), *args[1:], half, rot_w, 0.3)
    with pytest.raises(ValueError, match="CUDA"):
        pnp_kernel.pnp_hypotheses(args[0].cpu(), *args[1:], half, rot_w, 0.3)
    with pytest.raises(ValueError, match="prior_spread"):
        pnp_kernel.pnp_hypotheses(*args, half, rot_w, torch.tensor(0.3))
