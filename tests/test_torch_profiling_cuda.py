"""The port's profilers on the card at full size (production Config()):
the extractor's stage rows compose to batch_extract bit for bit with the
kernels, the profiler sees the port's CUDA kernels in the rows that launch
them and no row's device time exceeds its wall, the tracking rows compute
what feats_step computes, one NCCL rank's schedule equals no mesh, and an
entry point prints the card's JSON line.

They need a CUDA card: marked `cuda`, they skip without one. On the card,
run them without tests/conftest.py, which imports jax, pins it to 8
virtual CPU devices and turns its compilation cache on, none of which
the port uses:
python -m pytest --noconftest tests/test_torch_profiling_cuda.py
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from stereo_visual_slam_tpu_torch.models import frontend, vslam
from stereo_visual_slam_tpu_torch.profiling import production, scan_split, timing, window
from stereo_visual_slam_tpu_torch.utils.config import Config

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
R = 2


@pytest.fixture(scope="module")
def images():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return production.chunk_images(Config(), "cuda", n_world=production.B + 1)


def test_stages_compose_to_batch_extract_on_the_card(images):
    batch_extract = frontend.make_batch_extractor(Config(), "cuda", with_depth=False)
    ref = batch_extract(images)
    got = production.extract_by_stages(batch_extract.stages, images)
    for name, a, b in zip(frontend.FrameFeatures._fields, ref, got):
        assert torch.equal(a, b), name


def test_profiler_sees_the_kernels(images):
    cfg = Config()
    rows = {label.strip(): (fn, per) for label, fn, per in production.phases(cfg, "cuda", images)}
    n = cfg.frontend.n_levels
    for label, kernel, calls in (("detect: score maps + nms_topk", "fast_nms", n),
                                 (f"describe ({n} levels)", "gather_patches", 1),
                                 ("stereo zncc sweep", "zncc_sweep", 1)):
        fn, per = rows[label]
        row = timing.measure(fn, label, "cuda", R, per=per)
        # every launch of the traced iterations is in the trace, none more
        assert row["hand_kernels"][kernel]["launches"] == calls, row["top_ops"]
        assert row["hand_kernels"][kernel]["device_ms"] > 0
        assert not any(op["name"].startswith("ProfilerStep") for op in row["top_ops"])
        assert 0 < row["device_ms"] <= row["wall_ms"] * 1.05, row
        assert row["syncs"] == 0, row["sync_sites"]


def test_tracking_rows_compute_what_feats_step_computes(images, monkeypatch):
    cfg = Config()
    s = scan_split.setup(cfg, "cuda", images[:scan_split.B])
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
    calls[scan_split.LABELS[0]]()
    monkeypatch.undo()
    state, info = calls[scan_split.LABELS[1]]()
    m = calls[scan_split.LABELS[2]]()
    for a, b in zip(seen["track"][0] + seen["track"][1], state + info):
        assert torch.equal(a, b)
    for name, a, b in zip(m._fields, seen["match"], m):
        assert torch.equal(a, b), name


def test_one_nccl_rank_equals_no_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rows = window.nccl_one_rank(window.fixed_budget(Config()), torch.device("cuda"),
                                [("Kw=10 L=4096", 4096, 10, 1)], R, 1)
    assert rows[0]["backend"] == "nccl" and rows[0]["bit_equal_no_mesh"]
    assert rows[0]["device_ms"] > 0


def test_entry_point_prints_the_cards_line(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-m", "stereo_visual_slam_tpu_torch.profiling.timing",
                          "--r", "10", "--out", str(tmp_path)], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and "W" in line["device"]["card"]
    assert all(row["device_ms"] > 0 for row in line["rows"])
    # every event of the traced iterations, none more: kernels, and the copy
    assert [row["launches"] for row in line["rows"]] == [1.0, 100.0, 2.0]
