"""ChunkedSlam on a landmark mesh of gloo ranks on the CPU
(tests/torch_mesh_worker.py, one process per rank), and the CLI's mesh
flags.

The scenario is tests/test_parallel.py::test_chunked_core_sharded_matches_single:
small_config(128, 256), 18 frames, chunks of 6, every frame fed the PnP
draws of the JAX chunk program. Two ranks are held to the single-device
port and to the JAX package's sharded ChunkedSlam at 5e-2 m per frame, as
that test holds JAX's; one rank is held bit-equal to no mesh.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.data import synthetic
from stereo_visual_slam_tpu.parallel import dist_ba as jax_dist_ba
from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
from stereo_visual_slam_tpu.utils import config as jax_config
from stereo_visual_slam_tpu_torch import run_vslam
from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj_mod
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam as TorchSlam
from stereo_visual_slam_tpu_torch.utils import config_io
from stereo_visual_slam_tpu_torch.utils import config as port_config

import torch_mesh_worker
from test_torch_slice import jax_noise

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N_FRAMES, CHUNK = 18, 6
BOUND_M = 5e-2


def _position_gap(T_a, T_b):
    return float(np.linalg.norm(np.linalg.inv(T_a)[:3, 3] - np.linalg.inv(T_b)[:3, 3]))


@pytest.fixture(scope="module")
def scenario():
    """The worker's inputs, JAX's sharded run and the single-device port's
    estimates."""
    jcfg = jax_config.small_config(128, 256)
    world = synthetic.make_world(jcfg, n_frames=N_FRAMES, n_points=1500, seed=0)
    frames = list(synthetic.frames(world))
    noise = jax_noise(jcfg)
    draws = [noise(f) for f, _, _ in frames]
    inputs = dict(
        fids=np.array([f for f, _, _ in frames]), chunk=np.int64(CHUNK),
        left=np.stack([lf for _, lf, _ in frames]), right=np.stack([r for _, _, r in frames]),
        gumbel=np.stack([g.numpy() for g, _ in draws]), twist=np.stack([t.numpy() for _, t in draws]))

    j = JaxSlam(jcfg, chunk=CHUNK, mesh=jax_dist_ba.make_mesh(jax.devices()[:8]))
    t = TorchSlam(port_config.small_config(128, 256), chunk=CHUNK, device="cpu",
                  noise_fn=lambda fid: draws[fid])
    for slam in (j, t):
        for f, left, right in frames:
            slam.process(f, left, right)
        slam.finish()
        assert not slam.lost
    assert any(s["ba_cost"] is not None for s in j.stats)
    return inputs, {"jax_sharded": j.estimates, "port_single": t.estimates}


@pytest.fixture(scope="module")
def mesh_run(scenario, tmp_path_factory):
    inputs, _ = scenario
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = torch_mesh_worker.launch(
                "chunked", n, inputs, str(tmp_path_factory.mktemp(f"chunked_{n}_ranks")))
        return runs[n]

    return get


@pytest.mark.parametrize("reference", ["port_single", "jax_sharded"])
def test_two_ranks_track_within_the_bound(scenario, mesh_run, reference):
    _, refs = scenario
    o = mesh_run(2)[0]
    assert not o["mesh_lost"]
    cfg = port_config.small_config(128, 256)
    assert o["mesh_keyframe"].sum() > cfg.keyframe.window_size
    assert o["mesh_ba_ran"].any(), "the sharded BA schedule must have run"
    ref = refs[reference]
    common = [(i, f) for i, f in enumerate(o["mesh_est_fids"]) if int(f) in ref]
    assert len(common) >= 10
    for i, f in common:
        d = _position_gap(o["mesh_est_T"][i], ref[int(f)])
        assert d < BOUND_M, f"frame {f}: {d} m from {reference}"


def test_two_ranks_hold_equal_carries(mesh_run):
    r0, r1 = mesh_run(2)
    keys = [k for k in r0 if k.startswith("mesh_")]
    assert sum(k.startswith("mesh_carry_") for k in keys) > 10
    for k in keys:
        np.testing.assert_array_equal(r1[k], r0[k], err_msg=k)


def test_one_rank_is_bit_equal_to_no_mesh(mesh_run):
    o = mesh_run(1)[0]
    assert o["mesh_ba_ran"].any()
    # one branch fetch per frame and one record fetch per chunk, as without a mesh
    assert int(o["mesh_syncs"]) == N_FRAMES + N_FRAMES // CHUNK
    for k in [k for k in o if k.startswith("mesh_")]:
        np.testing.assert_array_equal(o[k], o["none_" + k[len("mesh_"):]], err_msg=k)


def test_data_parallel_extraction_equals_one_rank(mesh_run):
    """Each rank extracts 3 of the 6 frames; the assembled tables equal one
    rank's extraction of all 6 on every keypoint row that is read. Padding
    rows (score 0) may differ."""
    for o in mesh_run(2):
        valid = o["alone_valid"]
        np.testing.assert_array_equal(o["dp_valid"], valid)
        assert valid.sum() > 100
        for f in [k[len("alone_"):] for k in o if k.startswith("alone_")]:
            np.testing.assert_array_equal(o[f"dp_{f}"][valid], o[f"alone_{f}"][valid], err_msg=f)


# ---------------------------------------------------------------------------
# the CLI's mesh flags
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params(tmp_path_factory):
    """small_config with the principal point in the image and a window of 4
    keyframes, so that BA runs within the CLI runs' 10 frames."""
    cfg = port_config.small_config()
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0),
                      keyframe=dataclasses.replace(cfg.keyframe, window_size=4))
    path = str(tmp_path_factory.mktemp("params") / "mesh.yaml")
    config_io.save_yaml(cfg, path)
    return path


def _cli_args(params, pose_out):
    return ["--synthetic", "10", "--params", params, "--chunk", "4", "--quiet",
            "--pose-out", pose_out]


@pytest.fixture(scope="module")
def single_run(params, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("single") / "traj.txt")
    assert run_vslam.main(["--cpu", *_cli_args(params, path)]) == 0
    return traj_mod.read_trajectory(path)


def test_mesh_devices_needs_that_many_ranks(params, tmp_path, capsys):
    rc = run_vslam.main(["--cpu", "--mesh-devices", "2", *_cli_args(params, str(tmp_path / "t.txt"))])
    assert rc == 2
    assert "need 2 devices, have 1" in capsys.readouterr().err
    assert not (tmp_path / "t.txt").exists()


def test_cpu_flag_equals_device_cpu(params, single_run, tmp_path):
    path = str(tmp_path / "traj.txt")
    assert run_vslam.main(["--device", "cpu", *_cli_args(params, path)]) == 0
    same = traj_mod.read_trajectory(path)
    assert sorted(same) == sorted(single_run) and len(same) >= 4
    for fid, T in same.items():
        np.testing.assert_array_equal(T, single_run[fid])


def test_mesh_flags_refuse_the_host_driver(params, tmp_path, capsys):
    rc = run_vslam.main(["--cpu", "--mesh-devices", "1", "--driver", "host",
                         *_cli_args(params, str(tmp_path / "t.txt"))])
    assert rc == 2
    assert "run the chunked driver" in capsys.readouterr().err
    assert not (tmp_path / "t.txt").exists()


def test_distributed_device_cpu_stays_on_the_cpu(params, single_run, tmp_path, monkeypatch, capsys):
    """`--distributed --device cpu` on one rank: gloo and the CPU, never the
    card, and a one-rank mesh gives the same bits as no mesh."""
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(torch_mesh_worker.free_port())).items():
        monkeypatch.setenv(k, v)
    backends = []
    init = torch.distributed.init_process_group

    def spy(*a, **kw):
        backends.append(kw.get("backend"))
        return init(*a, **kw)

    monkeypatch.setattr(torch.distributed, "init_process_group", spy)
    path = str(tmp_path / "traj.txt")
    assert run_vslam.main(["--distributed", "--device", "cpu", *_cli_args(params, path)]) == 0
    assert backends == ["gloo"] and not torch.distributed.is_initialized()
    assert "fps on cpu)" in capsys.readouterr().out
    same = traj_mod.read_trajectory(path)
    assert sorted(same) == sorted(single_run)
    for fid, T in same.items():
        np.testing.assert_array_equal(T, single_run[fid])


def test_distributed_cli_writes_one_pose_file(params, single_run, tmp_path):
    """Two `--distributed --cpu --mesh-devices 2` processes with torchrun's
    environment: rank 0 writes the trajectory, rank 1 writes nothing."""
    outs = [tmp_path / f"rank{r}" / "traj.txt" for r in range(2)]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1",
               MASTER_PORT=str(torch_mesh_worker.free_port()),
               PYTHONPATH=os.pathsep.join([str(REPO)] + [
                   p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = []
    for r, out in enumerate(outs):
        out.parent.mkdir()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "stereo_visual_slam_tpu_torch.run_vslam", "--distributed",
             "--cpu", "--mesh-devices", "2", "--record", str(out.parent / "frames.jsonl"),
             *_cli_args(params, str(out))],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = torch_mesh_worker.wait_all(procs, timeout=180)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
    assert "processed 10 frames" in logs[0] and "processed" not in logs[1]
    assert not outs[1].parent.joinpath("frames.jsonl").exists() and not outs[1].exists()
    recs = [json.loads(line) for line in open(outs[0].parent / "frames.jsonl")]
    assert len(recs) == 10 and any(r["ba_cost"] is not None for r in recs)
    mesh = traj_mod.read_trajectory(str(outs[0]))
    assert sorted(mesh) == sorted(single_run) and len(mesh) >= 4
    for fid, T in mesh.items():
        assert _position_gap(T, single_run[fid]) < BOUND_M, fid
