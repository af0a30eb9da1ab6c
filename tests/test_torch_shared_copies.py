"""The port's copies of the JAX package's numpy-only host modules, held to
their originals: the config (field for field), the synthetic worlds (byte
for byte), the trajectory tools, the map store, the visualisation writers,
the YAML round trip and the KITTI reader. And the import guard: no module
of the port, nor `chip_smoke.py`, brings in the JAX package or jax.

The port keeps its own copies because it must run where neither the JAX
package nor jax is installed; these tests keep the copies from drifting.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stereo_visual_slam_tpu.data import kitti as jax_kitti
from stereo_visual_slam_tpu.data import synthetic as jax_synthetic
from stereo_visual_slam_tpu.mapping import store as jax_store
from stereo_visual_slam_tpu.pipeline import trajectory as jax_traj
from stereo_visual_slam_tpu.pipeline import viz as jax_viz
from stereo_visual_slam_tpu.utils import config as jax_config
from stereo_visual_slam_tpu_torch.data import kitti as port_kitti
from stereo_visual_slam_tpu_torch.data import synthetic as port_synthetic
from stereo_visual_slam_tpu_torch.mapping import store as port_store
from stereo_visual_slam_tpu_torch.pipeline import trajectory as port_traj
from stereo_visual_slam_tpu_torch.pipeline import viz as port_viz
from stereo_visual_slam_tpu_torch.utils import config as port_config

import test_reference_config

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


CONFIGS = {
    "Config": lambda c: c.Config(),
    "small_config": lambda c: c.small_config(),
    "small_config_odd": lambda c: c.small_config(96, 200),
    "reference_ba_schedule": lambda c: c.reference_ba_schedule(c.BAConfig()),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_equal(name):
    j, t = CONFIGS[name](jax_config), CONFIGS[name](port_config)
    assert type(t).__module__.startswith("stereo_visual_slam_tpu_torch.")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if hasattr(t, "padded_hw"):
        assert t.padded_hw == j.padded_hw


def test_reference_faithful_config_equal():
    """chip_smoke.py's reference-faithful config (the port's Config) equals
    the JAX package's own (tests/test_reference_config.py)."""
    t = _chip_smoke().reference_faithful(port_config.Config())
    j = test_reference_config.reference_faithful(jax_config.Config())
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _assert_same_world(jw, tw):
    for f in dataclasses.fields(jw):
        a, b = getattr(jw, f.name), getattr(tw, f.name)
        if f.name == "config":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("seed,profile", [(0, "default"), (1, "default"), (2, "default"),
                                          (0, "hard")])
def test_synthetic_worlds_byte_equal(seed, profile):
    kw = dict(n_frames=4, n_points=600, seed=seed, profile=profile)
    jw = jax_synthetic.make_world(jax_config.small_config(), **kw)
    tw = port_synthetic.make_world(port_config.small_config(), **kw)
    _assert_same_world(jw, tw)
    for (fa, la, ra), (fb, lb, rb) in zip(jax_synthetic.frames(jw), port_synthetic.frames(tw),
                                          strict=True):
        assert fa == fb
        assert la.dtype == lb.dtype and la.tobytes() == lb.tobytes()
        assert ra.dtype == rb.dtype and ra.tobytes() == rb.tobytes()


def test_wall_world_byte_equal():
    kw = dict(n_frames=3, n_points=500, seed=4)
    jw = jax_synthetic.make_wall_world(jax_config.small_config(), **kw)
    tw = port_synthetic.make_wall_world(port_config.small_config(), **kw)
    _assert_same_world(jw, tw)


def _poses(rng, n):
    """n world->camera poses along a noisy forward path."""
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = rng.normal(0, 0.05, 3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(a)
        R = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * K @ K
        T_w_c = np.eye(4)
        T_w_c[:3, :3] = R
        T_w_c[:3, 3] = [rng.normal(0, 0.3), rng.normal(0, 0.1), 1.5 * i]
        out[i] = np.linalg.inv(T_w_c)
    return out


def test_trajectory_metrics_equal(tmp_path):
    rng = np.random.default_rng(5)
    gt = _poses(rng, 120)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.2, (120, 3))
    assert port_traj.ate_rmse(est, gt) == jax_traj.ate_rmse(est, gt)
    assert port_traj.kitti_errors(est, gt) == jax_traj.kitti_errors(est, gt)
    paths = {}
    for name, mod in (("jax", jax_traj), ("port", port_traj)):
        paths[name] = tmp_path / f"{name}.txt"
        w = mod.TrajectoryWriter(str(paths[name]))
        for f in range(0, 120, 7):
            w.write(f, est[f])
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    a, b = jax_traj.read_trajectory(str(paths["jax"])), port_traj.read_trajectory(str(paths["port"]))
    assert sorted(a) == sorted(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f])


def _drive_store(store_mod, cfg, seed):
    """A seeded sequence of spawns, upgrades and keyframe inserts (with the
    evictions and landmark GC they trigger) on a fresh MapStore."""
    rng = np.random.default_rng(seed)
    m = store_mod.MapStore(cfg)
    n, next_id = 64, 0
    rng_poses = _poses(rng, 16)
    for k in range(16):
        ids = np.arange(next_id, next_id + 40, dtype=np.int64)
        next_id += 40
        m.spawn(ids, rng.normal(0, 10, (40, 3)).astype(np.float32), rng.random(40) < 0.5)
        known = rng.integers(0, next_id, n)
        rows = m.rows_of(known)
        up = rows[(rows >= 0) & (rng.random(n) < 0.2)]
        m.upgrade(up, rng.normal(0, 10, (len(up), 3)).astype(np.float32))
        m.insert_keyframe(store_mod.Keyframe(
            keyframe_id=k, frame_id=2 * k, T_c_w=rng_poses[k], rows=rows,
            uv=rng.uniform(0, 256, (n, 2)).astype(np.float32), valid=rng.random(n) < 0.8))
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_map_store_same_state(seed):
    cfg_j = jax_config.small_config()
    cfg_t = port_config.small_config()
    j, t = _drive_store(jax_store, cfg_j, seed), _drive_store(port_store, cfg_t, seed)
    for name in ("pos", "reliable", "inlier", "obs_count", "row_id", "alive", "id_to_row"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert t._free == j._free
    assert sorted(t.keyframes) == sorted(j.keyframes)
    assert [kf.keyframe_id for kf in t.evicted] == [kf.keyframe_id for kf in j.evicted]
    assert len(t.evicted) > 0 and (~t.alive[: 16 * 40]).any()
    a, b = j.assemble_schedule_input(), t.assemble_schedule_input()
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(y, x)
    assert sorted(a[0]) == sorted(b[0])
    for k in a[0]:
        np.testing.assert_array_equal(np.asarray(b[0][k]), np.asarray(a[0][k]), err_msg=k)


class _Run:
    """The attributes LiveViz reads from a driver."""

    def __init__(self, store, estimates):
        self.map, self.estimates = store, estimates


def test_viz_writers_same_bytes(tmp_path):
    rng = np.random.default_rng(6)
    poses = _poses(rng, 12)
    estimates = {f: poses[f] for f in range(12)}
    out = {}
    for name, viz, store_mod, cfg in (
            ("jax", jax_viz, jax_store, jax_config.small_config()),
            ("port", port_viz, port_store, port_config.small_config())):
        d = tmp_path / name
        d.mkdir()
        store = _drive_store(store_mod, cfg, 3)
        viz.export_landmarks_ply(store, str(d / "map.ply"))
        rec = viz.TrajectoryRecorder(str(d / "frames.jsonl"))
        for f in range(12):
            rec.record({"frame_id": f, "state": "tracked", "wall_s": 0.1 * f}, poses[f])
        live = viz.LiveViz(str(d / "live"), every=4)
        for f in range(12):
            live.tick(_Run(store, estimates), f)
        out[name] = {p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}
    assert out["jax"] == out["port"]
    assert len(out["port"]) >= 5


def test_yaml_round_trip_equal(tmp_path):
    pytest.importorskip("yaml")
    from stereo_visual_slam_tpu.utils import config_io as jax_io
    from stereo_visual_slam_tpu_torch.utils import config_io as port_io

    cfg_j = jax_config.small_config()
    cfg_t = port_config.small_config()
    cfg_j = cfg_j.replace(frontend=dataclasses.replace(cfg_j.frontend, fast_threshold=17))
    cfg_t = cfg_t.replace(frontend=dataclasses.replace(cfg_t.frontend, fast_threshold=17))
    jax_io.save_yaml(cfg_j, str(tmp_path / "jax.yaml"))
    port_io.save_yaml(cfg_t, str(tmp_path / "port.yaml"))
    assert (tmp_path / "jax.yaml").read_bytes() == (tmp_path / "port.yaml").read_bytes()
    back_j = jax_io.config_from_yaml(str(tmp_path / "port.yaml"))
    back_t = port_io.config_from_yaml(str(tmp_path / "jax.yaml"))
    assert dataclasses.asdict(back_t) == dataclasses.asdict(back_j) == dataclasses.asdict(cfg_t)
    with pytest.raises(KeyError):
        port_io.config_from_dict({"frontend": {"no_such_key": 1}})


def _kitti_tree(tmp_path):
    """A 3-frame sequence in the KITTI layout, with calib and poses."""
    from PIL import Image

    rng = np.random.default_rng(7)
    seq = tmp_path / "sequences" / "03"
    for side in ("image_0", "image_1"):
        (seq / side).mkdir(parents=True)
        for f in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 72), dtype=np.uint8)).save(
                seq / side / f"{f:06d}.png")
    (seq / "calib.txt").write_text(
        "P0: 700.5 0 35.25 0 0 701.25 19.5 0 0 0 1 0\n"
        "P1: 700.5 0 35.25 -380.1 0 701.25 19.5 0 0 0 1 0\n")
    (tmp_path / "poses").mkdir()
    gt = _poses(rng, 3)
    (tmp_path / "poses" / "03.txt").write_text("\n".join(
        " ".join(f"{v:.17g}" for v in np.linalg.inv(T)[:3, :4].reshape(-1)) for T in gt) + "\n")
    return seq


def test_kitti_reader_same_arrays(tmp_path):
    """The sequence read by both readers, each through its native runtime
    where that builds (the port's: utils/native.py)."""
    _assert_kitti_readers_agree(tmp_path, _kitti_tree(tmp_path))


def test_kitti_reader_pil_route_same_arrays(tmp_path, monkeypatch):
    """The port's fallback where its native runtime cannot be built (PIL,
    frame by frame) gives the same arrays."""
    from stereo_visual_slam_tpu_torch.utils import native as port_native

    monkeypatch.setattr(port_native, "available", lambda: False)
    monkeypatch.setattr(port_native, "StereoPrefetcher", None)
    monkeypatch.setattr(port_native, "read_image_gray", None)
    _assert_kitti_readers_agree(tmp_path, _kitti_tree(tmp_path))


def _assert_kitti_readers_agree(tmp_path, seq):
    for root, sequence in ((str(tmp_path), "03"), (str(seq), None)):
        j = jax_kitti.open_sequence(root, sequence)
        t = port_kitti.open_sequence(root, sequence)
        assert t.n_frames == j.n_frames == 3
        assert dataclasses.asdict(t.camera) == dataclasses.asdict(j.camera)
        if sequence is None:
            assert t.gt_T_c_w is None and j.gt_T_c_w is None
        else:
            np.testing.assert_array_equal(t.gt_T_c_w, j.gt_T_c_w)
        for (fa, la, ra), (fb, lb, rb) in zip(j.frames(), t.frames(), strict=True):
            assert fa == fb
            np.testing.assert_array_equal(lb, la)
            np.testing.assert_array_equal(rb, ra)
        cj = jax_kitti.config_for(j, jax_config.small_config())
        ct = port_kitti.config_for(t, port_config.small_config())
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)


def test_port_imports_nothing_of_the_jax_package():
    """Every module of the port, and chip_smoke.py as a module, imported in
    a fresh interpreter: no `stereo_visual_slam_tpu` module and no jax. (A
    subprocess: this test process imports both packages.)"""
    code = """
import importlib, pkgutil, sys
import stereo_visual_slam_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k in ("jax", "stereo_visual_slam_tpu")
             or k.startswith(("jax.", "stereo_visual_slam_tpu.")))
assert not bad, bad
assert len(names) > 40, names
new = {port.__name__ + m for m in (".utils.roofline", ".profiling.roofline_report",
                                   ".profiling.extract_cost", ".profiling.micro_topk")}
assert new <= set(names), sorted(new - set(names))
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-2000:]
