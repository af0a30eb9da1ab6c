"""Fixtures of the benchmark's tests: a copy of the benchmark's files in a
temporary root, with a tiny cell (the port's small test configuration and
a 40-frame sequence) that the CPU runs in seconds. The card's tests decide
inside a fixture whether there is a card."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
TINY_TRAFFIC = dict(profile="default", n_frames=40, speed=1.0, yaw_rate=0.004,
                    n_points=1500, chunk=8)
TINY_TRANS_PCT = 30.0


def small_config_data() -> dict:
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    d = dataclasses.asdict(small_config())
    d["image_hw"] = list(d["image_hw"])
    # small_config keeps KITTI's principal point, outside its 256 x 128
    # image; centred, the tiny world tracks every frame
    d["camera"].update(cx=128.0, cy=64.0)
    return d


def make_root(tmp: Path, limits_of: str = "prod-urban") -> Path:
    """A root holding BENCHMARK.json and a copy of slam_bench/'s data, with
    the cell "tiny" added as files (its limits those of `limits_of`, but
    for the trajectory's)."""
    shutil.copytree(REPO / "slam_bench", tmp / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "slam_bench/configs/tiny.json").write_text(json.dumps(
        dict(source="the port's small_config()", reduced=[], config=small_config_data())))
    (tmp / "slam_bench/traffic/tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    limits = json.loads((tmp / f"slam_bench/limits/{limits_of}.json").read_text())
    # the limit on the trajectory is KITTI's deployment's; the tiny world's
    # 256 x 128 frames and 24-40 m read 3-8 % on sound runs
    limits["trans_pct"] = TINY_TRANS_PCT
    (tmp / "slam_bench/limits/tiny.json").write_text(json.dumps(limits))
    bench["configs"].append(dict(name="tiny", source="https://example.org/tiny",
                                 file="slam_bench/configs/tiny.json", reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny", config="tiny", traffic="tiny", chips=1,
                                   why="test"))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    torch.set_num_threads(1)
    return make_root(tmp_path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
