"""The port's profilers (stereo_visual_slam_tpu_torch/profiling/) on the CPU
at small_config: the extractor's stage rows compose to batch_extract bit
for bit, the tracking rows compute what feats_step computes, the BA window
and schedule equal the JAX tools', two gloo ranks of the scaling table
match the JAX package's schedule, the rows carry the JAX tools' labels,
each entry point refuses a missing card, and the CPU reports no device
numbers. The timed numbers come from the card only."""

import importlib.util
import io
import json
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.linalg import expm

# where jax is missing this file skips (tests/test_torch_profiling_cuda.py
# holds the card's checks); where it is present, the JAX side runs on the
# CPU, as tests/conftest.py sets it (on a card, jax's GPU matmuls would
# round through TF32)
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

from stereo_visual_slam_tpu.ba import schedule as jax_schedule  # noqa: E402
from stereo_visual_slam_tpu.utils.config import BAConfig as JaxBAConfig  # noqa: E402
from stereo_visual_slam_tpu_torch.ba import schedule as port_schedule  # noqa: E402
from stereo_visual_slam_tpu_torch.models import frontend, vslam  # noqa: E402
from stereo_visual_slam_tpu_torch.profiling import (  # noqa: E402
    production, scan_split, timing, window,
)
from stereo_visual_slam_tpu_torch.utils.config import (  # noqa: E402
    BAConfig, Config, small_config,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MODULES = ("timing", "production", "scan_split", "window")


def _jax_tool(name):
    """A JAX tool loaded by file path: nothing of it runs but its imports."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_labels(name):
    src = (REPO / "tools" / f"{name}.py").read_text()
    return [lab.replace("{B}", "8") for lab in re.findall(r'loop_time\(\s*\w+,\s*f?"([^"]*)"', src)]


@pytest.fixture(scope="module")
def images():
    return production.chunk_images(small_config(), "cpu", n_world=production.B + 1)


@pytest.mark.parametrize("with_depth", [False, True])
def test_stages_compose_to_batch_extract(images, with_depth):
    """(a) The stage rows' calls, stage by stage, give batch_extract's
    FrameFeatures bit for bit: the rows time the production path."""
    cfg = small_config()
    batch_extract = frontend.make_batch_extractor(cfg, "cpu", with_depth=with_depth)
    ref = batch_extract(images)
    got = production.extract_by_stages(batch_extract.stages, images, with_depth)
    for name, a, b in zip(frontend.FrameFeatures._fields, ref, got):
        assert torch.equal(a, b), name
    assert int(ref.valid.sum()) > 100
    if with_depth:
        assert int(ref.depth_valid.sum()) > 10


def test_rows_carry_the_jax_tools_labels():
    assert production.labels(Config()) == _jax_labels("profile_production")
    assert list(scan_split.LABELS) == _jax_labels("profile_scan_split")


def test_production_rows_run_on_the_cpu(images):
    cfg = small_config()
    rows = production.phases(cfg, "cpu", images[:production.B])
    assert [label for label, _, _ in rows] == production.labels(cfg)
    out = {label: fn() for label, fn, _ in rows}
    carry, records = out[production.labels(cfg)[0]]
    assert len(records) == production.B and bool(records[0].is_keyframe)
    ba = out["BA schedule (per keyframe)"]
    assert torch.isfinite(ba.T_c_w).all() and torch.isfinite(ba.cost_full)
    assert out["  anms"].sum(dim=1).tolist() == [cfg.frontend.n_features] * production.B


@pytest.mark.parametrize("nK,seed", [(10, 0), (10, 1), (20, 0), (20, 1)])
def test_make_window_equals_the_jax_tools(nK, seed):
    """(b) The draws and masks are bit-equal. The poses come from each
    package's se3.exp in float32, each within 1e-5 of the float64
    exponential, so they differ by up to 2e-5; the observed projections
    inherit that through the lever arm (rtol 1e-4). Unobserved ones (points
    near the camera plane, up to 1.6e5 px) never enter the BA."""
    a, Ka = _jax_tool("scaling_bench").make_window(256, nK=nK, seed=seed)
    b, Kb = window.make_window(256, nK=nK, seed=seed)
    a = {f: np.asarray(v) for f, v in a._asdict().items()}
    b = {f: v.numpy() for f, v in b._asdict().items()}
    for f in a:
        if f not in ("T_c_w", "uv"):
            np.testing.assert_array_equal(b[f], a[f], err_msg=f)
    np.testing.assert_array_equal(Kb.numpy(), np.asarray(Ka))
    for k in range(nK):
        xi = np.array([0.02 * k, 0.0, -1.0 * k, 0.0, 0.004 * k, 0.0])
        hat = np.zeros((4, 4))
        hat[:3, :3] = [[0, 0, xi[4]], [0, 0, 0], [-xi[4], 0, 0]]
        hat[:3, 3] = xi[:3]
        np.testing.assert_allclose(b["T_c_w"][k], expm(hat), atol=1e-5, rtol=0)
    np.testing.assert_allclose(b["T_c_w"], a["T_c_w"], atol=2e-5, rtol=0)
    seen = a["obs_mask"] > 0   # the only projections the BA reads
    np.testing.assert_allclose(b["uv"][seen], a["uv"][seen], rtol=1e-4, atol=1e-3)
    assert seen.mean() > 0.5 and np.isfinite(b["uv"]).all()


@pytest.mark.parametrize("nK,seed", [(10, 0), (20, 1)])
def test_schedule_on_the_window_equals_jax(nK, seed):
    """(c) Each package's rel_tol=0 schedule on its own tool's window, at
    tests/test_torch_tracking_ba.py's tolerances."""
    ja, Ka = _jax_tool("scaling_bench").make_window(256, nK=nK, seed=seed)
    a = jax.jit(jax_schedule.make_ba_schedule(JaxBAConfig(rel_tol=0.0)))(ja, Ka)
    tb, Kb = window.make_window(256, nK=nK, seed=seed)
    b = port_schedule.make_ba_schedule(window.fixed_budget(Config()))(tb, Kb)
    np.testing.assert_allclose(b.T_c_w.numpy(), np.asarray(a.T_c_w), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(b.inlier.numpy(), np.asarray(a.inlier))
    np.testing.assert_allclose(float(b.cost_full), float(a.cost_full), rtol=1e-4)


def test_tracking_rows_compute_what_feats_step_computes(images, monkeypatch):
    """(d) The track_step and matcher rows give, bit for bit, what the
    tracker and the matcher return inside feats_step on the same carry and
    features."""
    cfg = small_config()
    s = scan_split.setup(cfg, "cpu", images[:scan_split.B])
    calls = scan_split.calls(cfg, s)
    seen = {}
    step = s["step"]
    track, match = step.track_step, vslam.matcher_ops.match

    def spy_track(*a, **k):
        seen["track"] = track(*a, **k)
        return seen["track"]

    def spy_match(*a, **k):
        seen["match"] = match(*a, **k)
        return seen["match"]

    monkeypatch.setattr(step, "track_step", spy_track)
    monkeypatch.setattr(vslam.matcher_ops, "match", spy_match)
    _, record = calls[scan_split.LABELS[0]]()
    monkeypatch.undo()
    state, info = calls[scan_split.LABELS[1]]()
    m = calls[scan_split.LABELS[2]]()
    for a, b in zip(seen["track"][0] + seen["track"][1], state + info):
        assert torch.equal(a, b)
    for name, a, b in zip(m._fields, seen["match"], m):
        assert torch.equal(a, b), name
    assert int(record.n_matches) == int(info.n_matches) > 0
    res = calls[scan_split.LABELS[3]]()
    assert torch.isfinite(res.T_c_w).all()


def test_two_gloo_ranks_match_the_jax_schedule():
    """(e) The scaling table's CPU ranks: two gloo ranks of the sharded
    schedule against the JAX package's unsharded schedule on the JAX
    tool's window, at tests/test_torch_dist_ba.py's tolerances."""
    ja, Ka = _jax_tool("scaling_bench").make_window(512, nK=10, seed=0)
    a = jax.jit(jax_schedule.make_ba_schedule(JaxBAConfig(rel_tol=0.0)))(ja, Ka)
    rows = window.cpu_ranks(BAConfig(rel_tol=0.0), 2, [("scaling", 512, 10, 0)], threads=1,
                            timeout=240)
    (row,) = rows
    assert (row["n"], row["backend"], row["L"], row["Kw"]) == (2, "gloo", 512, 10)
    np.testing.assert_allclose(row["T_c_w"], np.asarray(a.T_c_w), atol=2e-4, rtol=0)
    np.testing.assert_allclose(row["cost_full"], float(a.cost_full), rtol=1e-4)
    assert row["wall_ms"] > 0 and row["device_ms"] is None


@pytest.fixture(scope="module")
def entry_points():
    """Each module's entry point with its default device, all four run
    together: name -> the finished process."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"stereo_visual_slam_tpu_torch.profiling.{name}"], cwd=str(REPO),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for name in MODULES}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


@pytest.mark.parametrize("name", MODULES)
def test_entry_point_refuses_a_missing_card(entry_points, name):
    """(f) With its default device and no card: a non-zero exit, a message
    that names the missing card, no table."""
    rc, stdout, stderr = entry_points[name]
    assert rc != 0
    assert "no CUDA device" in stderr and "cuda" in stderr
    assert stdout == ""


def test_cpu_reports_no_device_numbers(tmp_path):
    """(g) On the CPU the JSON line (printed last and written to --out)
    has wall times and null device times, launches and syncs."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert timing.main(["--device", "cpu", "--r", "4", "--out", str(tmp_path)]) == 0
    last = buf.getvalue().splitlines()[-1]
    assert (tmp_path / "profile_timing.json").read_text().strip() == last
    line = json.loads(last)
    assert line["device"]["platform"] == "cpu" and line["device"]["card"] is None
    assert len(line["rows"]) == 3
    for row in line["rows"]:
        assert isinstance(row["wall_ms"], float)
        for key in ("device_ms", "host_ms", "launches", "syncs", "sync_sites", "top_ops",
                    "hand_kernels"):
            assert row[key] is None, key
    row = timing.measure(lambda: None, "nothing", "cpu", r=2, best_of=1, per=8)
    assert row["device_ms"] is None and row["launches"] is None and row["per"] == 8


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 2), (3, 4)], 3.0),                  # apart: the sum
    ([(0, 2), (1, 4)], 4.0),                  # a dependent launch starting early
    ([(3, 4), (0, 10), (2, 5)], 10.0),        # nested, out of order
    ([(0, 1), (1, 2), (1.5, 2.5)], 2.5),      # touching, then overlapping
])
def test_device_busy_time_counts_overlapping_kernels_once(intervals, busy):
    assert timing.busy_us(intervals) == busy
