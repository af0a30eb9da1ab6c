"""The port's benchmark (stereo_visual_slam_tpu_torch/bench.py) on the CPU:
its gate verdicts against the JAX bench's on the same accuracy dicts, the
degraded config, the vs_baseline arithmetic, the render pool, and the
whole bench at small size (one JSON line with exactly the four keys), with
a profile run that equals a direct ChunkedSlam run. The timed numbers come
from the card only."""

import dataclasses
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch import bench
from stereo_visual_slam_tpu_torch.data import render_pool, synthetic
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
from stereo_visual_slam_tpu_torch.utils.config import Config, small_config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _jax_bench():
    sys.path.insert(0, str(REPO))
    try:
        import bench as jax_bench
    finally:
        sys.path.remove(str(REPO))
    return jax_bench


def bench_config():
    cfg = small_config()
    return cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))


ACCS = [
    dict(trans=0.93, ate=1.21, lost=False),
    dict(trans=1.5, ate=2.0, lost=False),     # on the line: passes
    dict(trans=1.51, ate=0.5, lost=False),
    dict(trans=0.5, ate=2.01, lost=False),
    dict(trans=0.5, ate=0.5, lost=True),
    dict(trans=4.17, ate=4.0, lost=False),
    dict(trans=4.2, ate=0.1, lost=False),
    dict(trans=0.99, ate=0.99, lost=False),
    dict(trans=1.2, ate=4.5, lost=False),
]


@pytest.mark.parametrize("profile", ["default", "hard", "highway"])
def test_gate_verdicts_match_the_jax_bench(profile):
    jax_bench = _jax_bench()
    assert bench.GATES == jax_bench.GATES
    assert bench.REF_PARITY_TRANS == jax_bench.REF_PARITY_TRANS
    assert (bench.REF_TRACK_S, bench.REF_KEYFRAME_S) == (jax_bench.REF_TRACK_S,
                                                         jax_bench.REF_KEYFRAME_S)
    for acc in ACCS:
        verdict = bench.gate_verdict(profile, acc)
        assert verdict == jax_bench.gate_verdict(profile, acc), acc
        assert bench.binding_gate(profile, acc) == (": PASS (" in verdict)


def test_degraded_config_cripples_pnp_only():
    cfg = Config()
    bad = bench.degraded(cfg)
    assert (bad.pnp.n_hypotheses, bad.pnp.gn_iters_refine, bad.pnp.inlier_px) == (8, 0, 16.0)
    assert dataclasses.replace(bad.pnp, n_hypotheses=cfg.pnp.n_hypotheses,
                               gn_iters_refine=cfg.pnp.gn_iters_refine,
                               inlier_px=cfg.pnp.inlier_px) == cfg.pnp
    assert {k: v for k, v in dataclasses.asdict(bad).items() if k != "pnp"} == \
        {k: v for k, v in dataclasses.asdict(cfg).items() if k != "pnp"}


def test_reference_time_of_a_keyframe_mix():
    # 192 timed frames, 54 of them keyframes: 138 * 0.04 + 54 * 0.18
    assert bench.reference_s(192, 54) == pytest.approx(15.24)
    assert bench.reference_s(10, 0) == pytest.approx(0.4)
    assert bench.reference_s(10, 10) == pytest.approx(1.8)


def test_render_pool_is_in_order_and_independent_of_workers():
    cfg = bench_config()
    world = synthetic.make_world(cfg, n_frames=6, n_points=800, seed=1, profile="hard")
    ref = [(f, l.astype(np.uint8), r.astype(np.uint8)) for f, l, r in synthetic.frames(world)]
    alone = render_pool.Renderer(0).render_all(world)
    with render_pool.Renderer(2) as renderer:
        pool = renderer.frames(world, depth=2)
        pooled = [next(pool) for _ in range(4)]
        pool.close()   # an early stop
        again = renderer.render_all(world, 3)   # the same workers, the world sent anew
        other = synthetic.make_world(cfg, n_frames=2, n_points=800, seed=2)
        second = renderer.render_all(other)
    for got in (alone, pooled, again):
        assert [f for f, _, _ in got] == list(range(len(got)))
        for (_, l0, r0), (_, l1, r1) in zip(ref, got):
            assert l1.dtype == np.uint8
            np.testing.assert_array_equal(l0, l1)
            np.testing.assert_array_equal(r0, r1)
    assert len(alone) == 6
    for (_, l0, r0), (_, l1, r1) in zip(synthetic.frames(other), second):
        np.testing.assert_array_equal(l0.astype(np.uint8), l1)
        np.testing.assert_array_equal(r0.astype(np.uint8), r1)


def test_run_sequence_equals_a_direct_run():
    """The bench's uint8 frames give the run of the float frames."""
    cfg = bench_config()
    world = synthetic.make_world(cfg, n_frames=8, n_points=1500, seed=5, profile="highway")
    frames = render_pool.Renderer(0).render_all(world)
    slam, acc = bench.run_sequence(cfg, world, frames, 4, "cpu")
    direct = ChunkedSlam(cfg, chunk=4, device="cpu")
    direct.run(synthetic.frames(world))
    direct.finish()
    assert slam.stats == direct.stats
    assert sorted(slam.estimates) == sorted(direct.estimates)
    for f in slam.estimates:
        np.testing.assert_array_equal(slam.estimates[f], direct.estimates[f])
    assert acc["tracked"] == sum(s["state"] == "tracked" for s in direct.stats)
    assert acc["lost"] == direct.lost


def test_run_bench_small(capsys):
    out = bench.run_bench(bench_config(), device="cpu", renderer=render_pool.Renderer(0),
                          chunk=2, n_chunks=1, runs=1, hard_frames=8, highway_frames=8)
    line = out["line"]
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert (line["metric"], line["unit"]) == ("frames_per_s", "frames/s")
    t = out["timed"]
    assert t["frames"] == 2 and t["peak_bytes"] is None
    assert line["value"] == round(t["frames"] / t["wall_s"], 3)
    assert line["vs_baseline"] == round(bench.reference_s(t["frames"], t["keyframes"])
                                        / t["wall_s"], 3)
    assert set(out["profiles"]) == {"default", "hard", "highway"}
    for name, p in out["profiles"].items():
        assert p["verdict"] == bench.gate_verdict(name, p)
        assert p["launches"] == {"fast_nms": 0, "gather_patches": 0, "zncc_sweep": 0,
                                 "pnp_hypotheses": 0, "pnp_refine": 0}
    # default: the staged run, the streaming and the rolling pass, 8 frames each
    assert out["profiles"]["default"]["frames"] == 3 * 8
    assert out["profiles"]["hard"]["frames"] == 8
    err = capsys.readouterr().err
    for what in ("run 0 (staged)", "streaming", "rolling", "default profile", "per-chunk wall",
                 "hard profile (8 frames)", "highway profile (8 frames)"):
        assert what in err, what
    # the counted pass: bit-equal to the timed run (roofline_pass raises
    # otherwise), its cost a chunk over the timed wall a chunk, on stderr
    roof = out["roofline"]
    assert roof["chunks"] == 1 and roof["peaks"] == "generic"
    assert roof["flops_per_chunk"] > 0 and roof["bytes_per_chunk"] > 0
    assert roof["wall_chunk_s"] == pytest.approx(t["wall_s"])
    # FAST+NMS once a level, the patch gather once for every level
    assert roof["units"]["fast_nms"] == 3 and roof["units"]["gather_patches"] == 1
    line = next(ln for ln in err.splitlines() if ln.startswith("# roofline "))
    assert line.startswith("# roofline chunk program (B=2; every scan frame and LM iteration "
                           "counted): ")
    assert f"{roof['flops_per_chunk'] / 1e9:.3f} GFLOP" in line and "% MFU / " in line


def test_main_prints_one_json_line(monkeypatch, tmp_path):
    from stereo_visual_slam_tpu_torch.utils import config_io

    params = tmp_path / "small.yaml"
    config_io.save_yaml(bench_config(), str(params))
    for k, v in dict(BENCH_CHUNKS="1", BENCH_RUNS="1", BENCH_HARD_FRAMES="0",
                     BENCH_HIGHWAY_FRAMES="0", BENCH_DEGRADE="1").items():
        monkeypatch.setenv(k, v)
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench.main(["2", "--device", "cpu", "--params", str(params), "--workers", "0"]) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    assert list(json.loads(lines[0])) == ["metric", "value", "unit", "vs_baseline"]


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench(bench_config(), device="cuda", renderer=render_pool.Renderer(0),
                        n_chunks=1, hard_frames=0, highway_frames=0)
