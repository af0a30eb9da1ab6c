"""CPU tests of what the upstream cells add to the benchmark: the two
device-time readers (`extract.device_ms_per_frame`,
`track.device_ms_per_frame`) on a hand-made traced context with known
operation intervals and spans, and the cells `upstream-urban` and
`upstream-ba-urban` resolving their configuration, traffic and limits.

    python -m pytest slam_bench/tests -q
"""

from __future__ import annotations

import json

import pytest

from slam_bench import compare, run
from slam_bench.tests.conftest import REPO


def _device_ms_ctx():
    """A hand-made traced context: two chunks of 8 frames; extraction spans
    over [0, 10] and [100, 110] s, tracking spans over [20, 30], [40, 50]
    and [120, 130] s; device operations inside and outside them."""
    spans = [("extract", 0.0, 10.0), ("extract", 100.0, 110.0), ("track", 20.0, 30.0),
             ("track", 40.0, 50.0), ("track", 120.0, 130.0), ("keyframe.ba", 60.0, 70.0)]
    ops = [("a", 1.0, 3.0), ("b", 2.0, 4.0),            # extract: union 3 s
           ("c", 9.0, 12.0),                           # starts inside extract: 3 s
           ("d", 101.0, 102.0),                        # extract: 1 s
           ("e", 21.0, 25.0), ("f", 22.0, 23.0),       # track: union 4 s
           ("g", 45.0, 46.0), ("h", 125.0, 127.0),     # track: 1 + 2 s
           ("i", 19.0, 21.0),                          # starts before a span: not counted
           ("j", 61.0, 69.0)]                          # keyframe.ba only
    return dict(trace=dict(ops=ops, spans=spans), profiled=[5, 6], chunk=8,
                sequence=[None] * 128)


@pytest.mark.parametrize("name, expected", [("extract.device_ms_per_frame", 7e3 / 16),
                                            ("track.device_ms_per_frame", 7e3 / 3)])
def test_device_ms_readers_on_hand_made_spans(name, expected):
    read = run.reader(REPO / "slam_bench/metrics", name)
    assert read(_device_ms_ctx()) == pytest.approx(expected, rel=1e-12)
    ctx = _device_ms_ctx()
    ctx["trace"]["spans"] = [s for s in ctx["trace"]["spans"] if s[0] == "keyframe.ba"]
    assert read(ctx) is None
    assert read(dict(_device_ms_ctx(), trace=None)) is None


def test_extract_device_ms_counts_a_short_last_chunk():
    """A profiled slice that ends on a partial chunk: 124 frames, chunks
    of 8, the last holding 4."""
    read = run.reader(REPO / "slam_bench/metrics", "extract.device_ms_per_frame")
    ctx = dict(_device_ms_ctx(), profiled=[14, 15], sequence=[None] * 124)
    assert read(ctx) == pytest.approx(7e3 / 12, rel=1e-12)


@pytest.mark.parametrize("cell, config", [("upstream-urban", "kitti-upstream"),
                                          ("upstream-ba-urban", "kitti-upstream-ba")])
def test_the_upstream_cells_resolve_their_files(cell, config):
    spec = run.load_cell(REPO, cell)
    assert spec["cell"]["config"] == config and spec["cell"]["chips"] == 1
    assert spec["traffic"] == json.loads((REPO / "slam_bench/traffic/urban.json").read_text())
    assert set(compare.NUMBERS) <= set(spec["limits"]) and spec["limits"]["trans_pct"] == 4.17
    names = {m["name"] for m in spec["per_layer"]}
    assert {"extract.device_ms_per_frame", "track.device_ms_per_frame"} <= names
    assert {m["name"] for m in spec["end_to_end"]} == {"frames_per_s", "chunk_ms_p95", "setup_s"}
    from slam_bench.reference import config as ref_config
    from stereo_visual_slam_tpu_torch.utils import config as port_config

    for cls in (port_config.Config, ref_config.Config):
        run.build_config(cls, spec["config"]["config"])
