"""The cost tools' command lines on the CPU at small_config
(`--device cpu --params small.yaml`): the per-phase roofline report and the
extractor's stage costs print their table and one JSON line, which they
also write to --out, and each refuses a missing card. The times and
shares come from the card only."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from stereo_visual_slam_tpu_torch.profiling import extract_cost, roofline_report, timing
from stereo_visual_slam_tpu_torch.utils import config_io
from stereo_visual_slam_tpu_torch.utils.config import small_config

torch.set_num_threads(1)
TOOLS = {"roofline_report": roofline_report, "extract_cost": extract_cost}
measure = timing.measure


@pytest.mark.parametrize("tool", ["roofline_report", "extract_cost"])
def test_cli_on_the_cpu(tmp_path, monkeypatch, tool):
    params = tmp_path / "small.yaml"
    config_io.save_yaml(small_config(), str(params))
    mod = TOOLS[tool]
    argv = ["--device", "cpu", "--params", str(params), "--out", str(tmp_path)]
    if tool == "roofline_report":
        argv += ["--r", "1"]
        # one run of each length: the method is tests/test_torch_profiling.py's
        monkeypatch.setattr(roofline_report.timing, "measure",
                            lambda fn, label, device, r, best_of, **kw:
                            measure(fn, label, device, r, 1, **kw))
    out = io.StringIO()
    with redirect_stdout(out):
        assert mod.main(argv) == 0
    lines = out.getvalue().splitlines()
    result = json.loads(lines[-1])
    assert result["tool"] == tool and result["device"]["platform"] == "cpu"
    assert json.loads((tmp_path / f"profile_{tool}.json").read_text()) == result
    if tool == "roofline_report":
        assert all(r["device_ms"] is None and r["wall_ms"] > 0 for r in result["rows"])
        assert result["peaks"]["name"] == "generic"
        assert any("MFU% wall" in ln for ln in lines)
    else:
        assert lines[1].startswith("batch_extract TOTAL: ")


@pytest.mark.parametrize("tool", ["roofline_report", "extract_cost"])
def test_cli_refuses_a_missing_card(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert TOOLS[tool].main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_json_prints_the_line_only(tmp_path, capsys):
    params = tmp_path / "small.yaml"
    config_io.save_yaml(small_config(), str(params))
    assert extract_cost.main(["--device", "cpu", "--params", str(params), "--json",
                              "--out", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["rows"][0]["label"] == "batch_extract TOTAL"
