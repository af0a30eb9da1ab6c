"""The port's command line (`stereo_visual_slam_tpu_torch.run_vslam`) on
the CPU: both drivers, the rolling dataset mode, YAML overrides, the
record / PLY / plot outputs, snapshots and resume, and a KITTI-layout
dataset; and the synthetic example (`run_synthetic`). Every run takes
small_config through `--params`."""

import dataclasses
import json
import os

import numpy as np
import pytest

from stereo_visual_slam_tpu_torch import run_synthetic, run_vslam
from stereo_visual_slam_tpu_torch.data import synthetic
from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj_mod
from stereo_visual_slam_tpu_torch.utils import config_io
from stereo_visual_slam_tpu_torch.utils.config import small_config

N = 8


def cli_config():
    cfg = small_config()
    return cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("params") / "small.yaml")
    config_io.save_yaml(cli_config(), path)
    return path


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """A 6-frame synthetic sequence in the KITTI layout
    (tests/test_io_and_tools.py), at small size."""
    from PIL import Image

    root = tmp_path_factory.mktemp("kitti")
    seq = root / "sequences" / "07"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir(parents=True)
    cfg = cli_config()
    world = synthetic.make_world(cfg, n_frames=6, n_points=1500, seed=3)
    for f, left, right in synthetic.frames(world):
        Image.fromarray(left.astype(np.uint8)).save(seq / "image_0" / f"{f:06d}.png")
        Image.fromarray(right.astype(np.uint8)).save(seq / "image_1" / f"{f:06d}.png")
    cam = cfg.camera
    (seq / "calib.txt").write_text(
        f"P0: {cam.fx} 0 {cam.cx} 0 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
        f"P1: {cam.fx} 0 {cam.cx} {-cam.fx * cam.baseline} 0 {cam.fy} {cam.cy} 0 0 0 1 0\n"
    )
    (root / "poses").mkdir()
    rows = [" ".join(str(v) for v in np.linalg.inv(T)[:3, :4].reshape(-1))
            for T in world.poses_T_c_w]
    (root / "poses" / "07.txt").write_text("\n".join(rows) + "\n")
    return str(root)


def cli(*args):
    return run_vslam.main(["--device", "cpu", "--quiet", *args])


@pytest.fixture(scope="module")
def host_run(params, tmp_path_factory):
    d = tmp_path_factory.mktemp("host")
    out = {k: str(d / name) for k, name in (
        ("pose", "traj.txt"), ("record", "frames.jsonl"), ("ply", "map.ply"),
        ("plot", "traj.png"), ("snapshot", "state.npz"))}
    rc = cli("--driver", "host", "--synthetic", str(N), "--params", params,
             "--pose-out", out["pose"], "--record", out["record"], "--ply", out["ply"],
             "--plot", out["plot"], "--snapshot", out["snapshot"], "--lookahead", "1")
    return rc, out


def test_host_driver_runs(host_run):
    rc, out = host_run
    assert rc == 0
    rows = traj_mod.read_trajectory(out["pose"])
    assert len(rows) >= 4
    for T_w_c in rows.values():
        assert np.isfinite(T_w_c).all()


def test_host_driver_outputs(host_run):
    _, out = host_run
    recs = [json.loads(line) for line in open(out["record"])]
    assert [r["frame_id"] for r in recs] == list(range(N))
    assert recs[0]["state"] == "init" and all(r["state"] == "tracked" for r in recs[1:])
    with open(out["ply"]) as f:
        assert f.readline().strip() == "ply"
    assert os.path.getsize(out["plot"]) > 1000
    z = np.load(out["snapshot"])
    assert int(z["version"]) == 1 and int(z["vo_state"]) == 1
    assert z["dstate_yx"].shape == (cli_config().frontend.max_raw_keypoints, 2)


def test_host_driver_resume(host_run, params, tmp_path, capsys):
    _, out = host_run
    rec = str(tmp_path / "frames.jsonl")
    capsys.readouterr()
    rc = cli("--driver", "host", "--synthetic", "4", "--params", params,
             "--resume", out["snapshot"], "--record", rec,
             "--pose-out", str(tmp_path / "traj.txt"))
    assert rc == 0
    recs = [json.loads(line) for line in open(rec)]
    # the restored driver tracks from the snapshot: no initialisation
    assert len(recs) == 4 and recs[0]["state"] != "init"
    # the summary counts this run's frames and keyframes, not the snapshot's
    n_kf = sum(1 for r in recs if r.get("keyframe"))
    assert f"processed 4 frames, {n_kf} keyframes" in capsys.readouterr().out


def test_rolling_equals_streaming(params, tmp_path):
    poses = {}
    for name, extra in (("stream", ()), ("rolling", ("--rolling", "1"))):
        poses[name] = str(tmp_path / f"{name}.txt")
        rc = cli("--synthetic", str(N), "--params", params, "--chunk", "3",
                 "--pose-out", poses[name], *extra)
        assert rc == 0
    a, b = (traj_mod.read_trajectory(poses[k]) for k in ("stream", "rolling"))
    assert sorted(a) == sorted(b) and len(a) >= 4
    for fid in a:
        np.testing.assert_array_equal(a[fid], b[fid])


def test_chunked_snapshot_resume_and_viz(params, tmp_path):
    snap = str(tmp_path / "carry.npz")
    viz_dir = str(tmp_path / "live")
    rc = cli("--synthetic", str(N), "--params", params, "--chunk", "4",
             "--pose-out", str(tmp_path / "a.txt"), "--snapshot", snap,
             "--viz-every", "4", "--viz-dir", viz_dir)
    assert rc == 0 and int(np.load(snap)["mstate_kf_count"]) > 0
    live = [json.loads(line) for line in open(os.path.join(viz_dir, "live.jsonl"))]
    assert len(live) >= 2 and live[-1]["n_landmarks"] > 0
    rec = str(tmp_path / "b.jsonl")
    rc = cli("--synthetic", "4", "--params", params, "--chunk", "4", "--resume", snap,
             "--record", rec, "--pose-out", str(tmp_path / "b.txt"))
    assert rc == 0
    assert len([json.loads(line) for line in open(rec)]) == 4


@pytest.mark.parametrize("driver", ["chunked", "host"])
def test_dataset_mini_kitti(mini_kitti, params, tmp_path, capsys, driver):
    pose = str(tmp_path / "traj.txt")
    rc = cli("--dataset", mini_kitti, "--sequence", "07", "--params", params,
             "--driver", driver, "--chunk", "2", "--pose-out", pose)
    assert rc == 0
    assert len(traj_mod.read_trajectory(pose)) >= 3
    out = capsys.readouterr().out
    assert "processed 6 frames" in out and "ATE RMSE" in out


def test_cli_needs_a_source():
    assert cli() == 2


def test_run_synthetic_example(params, tmp_path, monkeypatch, capsys):
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert run_synthetic.main(["6", "--device", "cpu", "--params", params]) == 0
    out = capsys.readouterr().out
    assert "frame    0 init" in out and "frame    1 tracked" in out
    for what in ("tracked 6/6 frames", "ATE RMSE: ", "KITTI-style: trans ",
                 "mean keyframe time: ",
                 'kernel launches: {"fast_nms": 0, "gather_patches": 0, "zncc_sweep": 0, '
                 '"pnp_hypotheses": 0, "pnp_refine": 0}'):
        assert what in out, what
    rows = traj_mod.read_trajectory(str(tmp_path / "synthetic_traj.txt"))
    assert 0 in rows and len(rows) >= 4


def test_run_synthetic_needs_a_card_unless_asked_for_the_cpu(params):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_synthetic.main(["2", "--params", params])
