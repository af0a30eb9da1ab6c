"""CPU tests of the benchmark's harness: the frozen copies, the data the
harness finds by name, the last line, the imports, and the comparison that
decides `correct` with the program broken underneath.

    python -m pytest slam_bench/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from slam_bench import compare, run, world, yardstick
from slam_bench.tests.conftest import REPO, small_config_data

SEED = 2**31 + 11


def _camera(cfg):
    c = cfg.camera
    return world.Camera(c.fx, c.fy, c.cx, c.cy, c.baseline, cfg.image_hw)


@pytest.mark.parametrize("profile", ["default", "highway", "hard"])
def test_generator_copy_renders_byte_equal(profile):
    from stereo_visual_slam_tpu_torch.data import render_pool, synthetic
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    cfg = small_config()
    ours = world.make_world(_camera(cfg), n_frames=5, n_points=700, seed=SEED, profile=profile)
    theirs = synthetic.make_world(cfg, n_frames=5, n_points=700, seed=SEED, profile=profile)
    np.testing.assert_array_equal(ours.poses_T_c_w, theirs.poses_T_c_w)
    with render_pool.Renderer(0) as r:
        expected = r.render_all(theirs)
    for (f, l, rt), (g, l2, r2) in zip(world.render_all(ours, 0), expected):
        assert f == g and l.dtype == np.uint8
        np.testing.assert_array_equal(l, l2)
        np.testing.assert_array_equal(rt, r2)


def test_render_pool_equals_in_process():
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    w = world.make_world(_camera(small_config()), n_frames=3, n_points=300, seed=3)
    for a, b in zip(world.render_all(w, 2), world.render_all(w, 0)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])


def test_busy_union_of_hand_made_intervals():
    assert yardstick.busy([]) == 0.0
    assert yardstick.busy([(0, 1), (2, 3)]) == 2.0
    assert yardstick.busy([(0, 2), (1, 3)]) == 3.0          # overlap counts once
    assert yardstick.busy([(1, 3), (0, 4), (5, 6)]) == 5.0  # nested, unsorted


def test_work_arithmetic_on_hand_made_inputs():
    peak = dict(flops_f32=1e3, bytes_per_s=1e2)
    assert yardstick.bound(300.0, 1000.0, peak) == (3.0, "bytes")
    assert yardstick.bound(100.0, 5000.0, peak) == (5.0, "operations")
    img = torch.zeros((16, 16))
    img[8, 8] = 100.0          # one bright pixel: its 4 compass neighbours pass
    passed = yardstick.compass_pass(img, 20.0)
    assert int(passed.sum()) == 1 and bool(passed[8, 8])
    assert yardstick.fast_work(img, 20.0) == (8.0 * 256, float(256 * 20 + 177))
    # two 3x3 windows that overlap in one column: 15 pixels under them
    yx = torch.tensor([[5, 5], [5, 7]], dtype=torch.int32)
    assert yardstick.covered_pixels(img, yx, 3) == 15
    assert yardstick.gather_work(img, 2, 3, covered=15) == (4.0 * 15 + 16 + 4.0 * 2 * 9, 0.0)
    assert yardstick.gather_levels_work([img, img], [2, 1], 3, [15, 9]) == (
        (60 + 16 + 72) + (36 + 8 + 36), 0.0)
    assert yardstick.zncc_work(img, 4, 3, 10) == (8.0 * 256 + 32 + 160, 5.0 * 4 * 10 * 9)


def test_work_arithmetic_equals_the_ports():
    from stereo_visual_slam_tpu_torch.ops.kernels import measure

    g = torch.Generator().manual_seed(5)
    img = torch.randint(0, 255, (64, 96), generator=g).float()
    yx = torch.randint(0, 64, (40, 2), generator=g).to(torch.int32)
    assert yardstick.fast_work(img, 20.0) == measure.fast_work(img, 20.0)
    assert yardstick.covered_pixels(img, yx, 9, 32) == measure.covered_pixels(img, yx, 9, 32)
    assert yardstick.zncc_work(img, 40, 11, 32) == measure.zncc_work(img, 40, 11, 32)
    from stereo_visual_slam_tpu_torch.profiling import timing

    iv = [(float(a), float(a + b)) for a, b in torch.rand(50, 2, generator=g).tolist()]
    assert yardstick.busy(iv) == pytest.approx(timing.busy_us(iv), abs=0)


def test_harness_finds_a_cell_added_as_files(tiny_root):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files alone: the harness finds each by its name."""
    (tiny_root / "slam_bench/metrics/test.frames_seen.py").write_text(textwrap.dedent('''
        def read(ctx):
            return float(ctx["frames_done"])
    '''))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(name="test.frames_seen", unit="frames", better="higher",
                                   source="program_counter", layer="driver",
                                   moves="frames_per_s", workloads=["tiny"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_cell(tiny_root, "tiny")
    assert spec["traffic"]["n_frames"] == 40 and spec["config"]["config"] == small_config_data()
    assert "test.frames_seen" in [m["name"] for m in spec["per_layer"]]
    line = run.run_cell(tiny_root, "tiny", SEED, 1.0, True, "cpu")
    assert line["metrics"]["test.frames_seen"] == dict(value=float(line["attempted"]),
                                                       unit="frames")
    assert line["correct"] is True


def test_last_line_schema(tiny_root):
    line = run.run_cell(tiny_root, "tiny", SEED, 1.0, False, "cpu")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["attempted"] >= 8
    assert 0 <= line["failed"] <= line["attempted"]
    assert set(line["metrics"]) == {"frames_per_s", "chunk_ms_p95", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["checks"]) == list(compare.NUMBERS)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_no_card_exits_nonzero_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "prod-urban", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_command_imports_no_jax():
    """Every module the command imports, on the CPU as far as it goes
    without a card: the harness, the comparison, the reference, the port's
    driver and every metric reader. Names are compared whole."""
    code = textwrap.dedent('''
        import importlib.util, pathlib
        import slam_bench.run as run
        from slam_bench import compare, world, yardstick
        import slam_bench.reference.chunked
        import stereo_visual_slam_tpu_torch.pipeline.chunked
        from stereo_visual_slam_tpu_torch.utils import config
        for p in pathlib.Path("slam_bench/metrics").glob("*.py"):
            run.reader(p.parent, p.stem)
    ''')
    top = _modules_after(code)
    assert "stereo_visual_slam_tpu_torch" in top
    assert not top & set(run.BANNED)


def test_the_reference_imports_nothing_of_the_port():
    code = textwrap.dedent('''
        import importlib, pathlib
        for p in sorted(pathlib.Path("slam_bench/reference").glob("*.py")):
            importlib.import_module("slam_bench.reference" + ("" if p.stem == "__init__"
                                                              else "." + p.stem))
    ''')
    top = _modules_after(code)
    assert not top & {"stereo_visual_slam_tpu_torch", *run.BANNED}


def test_reference_equals_the_port_at_small_size():
    """The reference's free run equals the port's on the CPU record for
    record and pose for pose, and following the port step by step it finds
    nothing to count."""
    torch.set_num_threads(1)
    from slam_bench.reference import chunked as ref_chunked
    from slam_bench.reference import config as ref_config
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils import config as port_config
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    w = world.make_world(_camera(small_config()), n_frames=24, n_points=1500, seed=SEED)
    frames = world.render_all(w, 0)
    data = small_config_data()
    port = ChunkedSlam(run.build_config(port_config.Config, data), chunk=8, seed=SEED,
                       device="cpu")
    ref_cfg = run.build_config(ref_config.Config, data)
    ref = ref_chunked.ChunkedSlam(ref_cfg, chunk=8, seed=SEED, device="cpu")
    side = compare.Outputs()
    cap = compare.Capture(side)
    cap.attach(port.chunk_step)
    for f in frames:
        port.process(*f)
        ref.process(*f)
    port.finish()
    ref.finish()
    cap.close(port, 3, True)
    assert port.stats == ref.stats
    assert sorted(port.estimates) == sorted(ref.estimates)
    for f, T in port.estimates.items():
        np.testing.assert_array_equal(T, ref.estimates[f])
    assert any(s["keyframe"] for s in port.stats[1:]) and len(side.depth) > 1
    judge = compare.Judge(ref_cfg, frames, w.poses_T_c_w, SEED, 8, "cpu")
    numbers = compare.compare(side, judge)
    assert {k: v for k, v in numbers.items() if k != "trans_pct"} == dict.fromkeys(
        set(compare.NUMBERS) - {"trans_pct"}, 0.0)
    # the same estimates against the world's truth: both sides read alike
    assert numbers["trans_pct"] == compare.trans_pct(ref.estimates, w.poses_T_c_w)
    assert 0.0 < numbers["trans_pct"] < 100.0


# the faults of the contract that a one-card streamed SLAM run can have; the
# exchange between chips does not exist on one card
def _state_unchanged(monkeypatch):
    from stereo_visual_slam_tpu_torch.models import slam_core

    orig = slam_core.ChunkStep.__call__

    def broken(self, carry, images, frame_ids, noise):
        return carry, orig(self, carry, images, frame_ids, noise)[1]
    monkeypatch.setattr(slam_core.ChunkStep, "__call__", broken)


def _half_the_batch(monkeypatch):
    from stereo_visual_slam_tpu_torch.models import slam_core

    orig = slam_core.ChunkStep.__call__

    def broken(self, carry, images, frame_ids, noise):
        h = max(1, len(frame_ids) // 2)
        return orig(self, carry, images[:h], frame_ids[:h], noise)
    monkeypatch.setattr(slam_core.ChunkStep, "__call__", broken)


def _answer_altered(monkeypatch):
    """One descriptor word of every frame's first keypoint flipped where
    the extraction produces it."""
    from stereo_visual_slam_tpu_torch.models import frontend

    orig = frontend.make_batch_extractor

    def make(config, device, with_depth=True):
        extract = orig(config, device, with_depth)

        def altered(images):
            feats = extract(images)
            packed = feats.packed.clone()
            packed[:, 0, 0] ^= 1
            return feats._replace(packed=packed)
        return altered
    monkeypatch.setattr(frontend, "make_batch_extractor", make)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered])
def test_a_broken_program_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    # a window of several chunks: a state left unchanged shows from the second
    line = run.run_cell(tiny_root, "tiny", SEED, 5.0, False, "cpu")
    assert line["correct"] is False, line["checks"]
    # caught by a step, not by the trajectory alone
    assert any(not c["value"] <= c["limit"] for k, c in line["checks"].items()
               if k != "trans_pct"), line["checks"]


def test_a_trajectory_that_drifts_is_not_correct():
    """Every step of 1 m short by 5 cm: the trajectory reads 5 %, over the
    deployment's limit; a single pose reads nothing."""
    limits = json.loads((REPO / "slam_bench/limits/prod-urban.json").read_text())
    truth = np.tile(np.eye(4), (40, 1, 1))
    truth[:, 2, 3] = -np.arange(40.0)          # T_c_w of a camera moving 1 m a frame
    est = truth.copy()
    est[:, 2, 3] *= 0.95
    assert compare.trans_pct(dict(enumerate(truth)), truth) == 0.0
    assert compare.trans_pct(dict(enumerate(est)), truth) == pytest.approx(5.0)
    assert limits["trans_pct"] < 5.0
    assert np.isnan(compare.trans_pct({0: truth[0]}, truth))

@pytest.mark.cuda
def test_the_control_is_not_correct_on_the_card(card):
    """The control at a size a test run holds: the reference with TF32 on,
    in the program's place, against the reference in float32."""
    from slam_bench.reference import config as ref_config
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    from slam_bench.reference import chunked as ref_chunked
    from slam_bench.reference import precision

    limits = json.loads((REPO / "slam_bench/limits/prod-urban.json").read_text())
    w = world.make_world(_camera(small_config()), n_frames=40, n_points=1500, seed=SEED)
    frames = world.render_all(w, 0)
    cfg = run.build_config(ref_config.Config, small_config_data())
    side = compare.Outputs()
    with precision(True):
        compare.stream(lambda: ref_chunked.ChunkedSlam(cfg, chunk=8, seed=SEED, device=card),
                       frames, 8, side)
    numbers = compare.compare(side, compare.Judge(cfg, frames, w.poses_T_c_w, SEED, 8, card))
    assert not compare.verdict(numbers, limits), numbers


@pytest.mark.cuda
def test_a_tiny_cell_runs_correct_on_the_card(tiny_root, card):
    # long enough for the profiled slice to close: the profiler starts in it
    line = run.run_cell(tiny_root, "tiny", SEED, 15.0, True, card)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0


def test_a_module_loaded_after_the_window_stops_the_result(monkeypatch, capsys):
    """JAX loaded by the check or a metric reader, after the window: the
    command prints no result and exits 3. Names are compared whole."""
    import types

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def run_cell(*a, **k):
        monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
        return dict(correct=True, checks={})
    monkeypatch.setattr(run, "run_cell", run_cell)
    assert run.main(["--workload", "prod-urban", "--seed", "1", "--seconds", "1"]) == 3
    captured = capsys.readouterr()
    assert captured.out == "" and "jax" in captured.err
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "stereo_visual_slam_tpu_torchx", types.ModuleType("x"))
    assert run.banned_loaded() == []
