"""The port's soak (stereo_visual_slam_tpu_torch/soak.py) on the CPU: its
checks on summaries built to pass and to fail each one, the pace rule, and
a short run through main() at small_config (frames rendered ahead on a
worker process) with its summary line, SOAK_JSON and SOAK_DUMP."""

import csv
import dataclasses
import json

import pytest
import torch

from stereo_visual_slam_tpu_torch import soak
from stereo_visual_slam_tpu_torch.utils import config_io
from stereo_visual_slam_tpu_torch.utils.config import small_config

torch.set_num_threads(1)

N_FRAMES, CHUNK = 40, 2
PASSING = dict(n_frames=4541, n_tracked=4541, n_rejected=0, lost=False, arena_live=3883,
               arena_high_water=4096, arena_full_chunks=3, arena_chunks=568,
               rss_mb_per_chunk=0.01, rss_chunks=560, trans_pct=1.526, trans_first_pct=1.2,
               trans_last_pct=1.6, pace=dict(fps_first=8.0, fps_last=7.5))


def test_checks_pass_the_reference_soak():
    checks = soak.evaluate(PASSING, 4096)
    assert len(checks) == 8 and all(ok for ok, _ in checks), checks


@pytest.mark.parametrize("change, failing", [
    (dict(lost=True), "never Lost"),
    (dict(n_rejected=91), "rejections rare"),
    (dict(arena_live=4096), "arena not exhausted"),
    (dict(rss_mb_per_chunk=1.01), "host memory bounded"),
    (dict(trans_pct=2.6), "(binding gate)"),
    (dict(trans_pct=4.2), "KITTI trans 4.20%"),   # misses both lines
    (dict(trans_first_pct=0.4, trans_last_pct=1.01), "drift stable"),
    (dict(pace=dict(fps_first=8.0, fps_last=5.5)), "pace flat"),
])
def test_each_check_fails_alone(change, failing):
    checks = soak.evaluate(dict(PASSING, **change), 4096)
    failed = [msg for ok, msg in checks if not ok]
    assert failed and all(failing in msg for msg in failed), failed


def test_pace_needs_eight_marks():
    marks = [(511 + 512 * i, 60.0 * (i + 1)) for i in range(7)]
    assert soak._pace(marks) is None
    assert len(soak.evaluate(dict(PASSING, pace=None), 4096)) == 7
    marks.append((511 + 512 * 7, 480.0 + 120.0))   # the last stretch at half pace
    pace = soak._pace(marks)
    assert pace["fps_first"] == pytest.approx(512 / 60.0)
    assert pace["fps_last"] == pytest.approx(512 / 120.0)


def test_short_soak_through_main(tmp_path, monkeypatch, capsys):
    """At small_config the soak's sprite density (the full-size world's per
    metre of path) is too dense for 128x256 images and the run may go Lost
    before its end: the summary and the checks must say so consistently."""
    cfg = small_config()
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0),
                      ba=dataclasses.replace(cfg.ba, max_landmarks=2048))
    params = tmp_path / "small.yaml"
    config_io.save_yaml(cfg, str(params))
    monkeypatch.setenv("SOAK_JSON", str(tmp_path / "soak.json"))
    monkeypatch.setenv("SOAK_DUMP", str(tmp_path / "soak.csv"))
    rc = soak.main([str(N_FRAMES), str(CHUNK), "--device", "cpu", "--params", str(params),
                    "--workers", "1"])
    out = capsys.readouterr().out
    s = json.load(open(tmp_path / "soak.json"))
    rows = list(csv.DictReader(open(tmp_path / "soak.csv")))

    assert rc == (0 if s["ok"] else 1)
    assert f"SOAK {'PASS' if s['ok'] else 'FAIL'}: {N_FRAMES} frames" in out
    assert "rendered ahead on other processes" in out
    assert out.count("# soak ") == 7   # no pace check below 8 marks
    assert f"# soak {'FAIL' if s['lost'] else 'ok'}: never Lost" in out
    states = [r["state"] for r in rows]
    assert [int(r["frame"]) for r in rows] == list(range(len(rows)))
    assert (states.count("tracked"), states.count("rejected")) == (s["n_tracked"], s["n_rejected"])
    assert len(rows) == (N_FRAMES if not s["lost"] else len(rows)) >= 8 * CHUNK + CHUNK
    n_kf = sum(int(r["kf"]) for r in rows)
    assert s["n_keyframes"] == n_kf > cfg.keyframe.window_size
    # every keyframe beyond the window evicted one, and the run reported it
    assert s["n_evictions"] == n_kf - cfg.keyframe.window_size
    assert f"evictions={s['n_evictions']}" in out
    assert 0 < s["arena_live"] <= s["arena_high_water"] < s["arena_capacity"] == 2048
    lives = [int(r["live"]) for r in rows if r["live"]]
    assert len(lives) == s["arena_chunks"] and max(lives) == s["arena_high_water"]
    # the memory baseline is taken after the first 8 chunks
    assert s["rss_chunks"] == -(-len(rows) // CHUNK) - soak.RSS_FROM_CHUNK
    assert s["pace"] is None and s["device"] == "cpu"
