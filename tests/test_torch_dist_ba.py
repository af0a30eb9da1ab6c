"""The port's landmark-sharded BA (parallel/dist_ba.py, the `mesh=` paths
of ba/schur_lm.py, ba/pose_only.py and ba/schedule.py) against the JAX
package's sharded BA on the 8-device virtual mesh of tests/conftest.py.

The port runs on 1, 2 and 4 gloo ranks on the CPU (tests/torch_mesh_worker.py,
one process per rank) on the same numpy inputs, at the tolerances of
tests/test_parallel.py: poses atol 2e-4, points atol 2e-3, inliers equal,
the full-BA cost rtol 1e-4. Sharded sums round differently from unsharded
ones, so only one rank is held bit-equal to `mesh=None`.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.ba import schedule as jax_schedule
from stereo_visual_slam_tpu.parallel import dist_ba as jax_dist_ba
from stereo_visual_slam_tpu.utils.config import BAConfig as JaxBAConfig
from stereo_visual_slam_tpu_torch.ba import schedule as port_schedule
from stereo_visual_slam_tpu_torch.ba import schur_lm as port_lm
from stereo_visual_slam_tpu_torch.parallel import dist_ba as port_dist_ba
from stereo_visual_slam_tpu_torch.utils.config import BAConfig as PortBAConfig
from stereo_visual_slam_tpu_torch.utils.dist import LandmarkMesh

import torch_mesh_worker
from test_ba import K, make_ba_problem
from test_parallel import pad_problem_L

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RANKS = (1, 2, 4)
SCHEDULES = torch_mesh_worker.SCHEDULES


def _schedule_input(p, L):
    present = (jnp.arange(L) < 152).astype(jnp.float32)
    return jax_schedule.ScheduleInput(
        T_c_w=p.T_c_w, points=p.points, uv=p.uv, obs_mask=p.obs_mask, inlier=present,
        reliable=present, present=present, pose_mask=p.pose_mask, fixed_pose=p.fixed_pose)


@pytest.fixture(scope="module")
def jax_side():
    """The inputs (numpy, by the worker's names) and JAX's sharded results."""
    mesh = jax_dist_ba.make_mesh(jax.devices()[:8])
    lm, _, _, _ = make_ba_problem(np.random.default_rng(0), n_lm=152, px_noise=0.3)
    lm = pad_problem_L(lm, 160)
    po, _, pts_gt, _ = make_ba_problem(np.random.default_rng(1), n_lm=152,
                                       point_noise=0.0, px_noise=0.0)
    po = pad_problem_L(po._replace(points=jnp.asarray(pts_gt)), 160)
    sched, _, _, _ = make_ba_problem(np.random.default_rng(2), n_lm=152, px_noise=0.3)
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from scaling_bench import make_window
    finally:
        sys.path.remove(str(REPO / "tools"))
    windows = {"L512": (_schedule_input(pad_problem_L(sched, 512), 512), K),
               "Kw20_L8192": make_window(8192, nK=20, seed=3)}

    inputs = {"K": np.asarray(K)}
    for prefix, p in (("lm", lm), ("po", po)):
        inputs.update({f"{prefix}_{f}": np.asarray(v) for f, v in p._asdict().items()})
    out = {}
    r = jax_dist_ba.distributed_lm_optimize(jax_dist_ba.shard_problem(lm, mesh), K, mesh, iters=8)
    out.update(lm_T=r.T_c_w, lm_points=r.points, lm_inlier=r.landmark_inlier)
    r = jax_dist_ba.distributed_pose_only(jax_dist_ba.shard_problem(po, mesh), K, mesh, iters=10)
    out.update(po_T=r.T_c_w, po_inlier=r.landmark_inlier)
    run = jax.jit(jax_schedule.make_ba_schedule(JaxBAConfig(), mesh=mesh))
    for name, (inp, Kw) in windows.items():
        inputs.update({f"{name}_{f}": np.asarray(v) for f, v in inp._asdict().items()})
        inputs[f"{name}_K"] = np.asarray(Kw)
        r = run(inp, Kw)
        out.update({f"{name}_T_c_w": r.T_c_w, f"{name}_inlier": r.inlier,
                    f"{name}_cost_full": r.cost_full})
    return inputs, {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    """port(n): every rank's outputs of the worker's `ba` job on n ranks."""
    inputs, _ = jax_side
    runs = {}

    def get(n):
        if n not in runs:
            runs[n] = torch_mesh_worker.launch(
                "ba", n, inputs, str(tmp_path_factory.mktemp(f"ba_{n}_ranks")))
        return runs[n]

    return get


@pytest.mark.parametrize("n", RANKS)
def test_lm_matches_jax_sharded(jax_side, port, n):
    _, j = jax_side
    t = port(n)[0]
    np.testing.assert_allclose(t["mesh_lm_T"], j["lm_T"], atol=2e-4, rtol=0)
    np.testing.assert_allclose(t["mesh_lm_points"], j["lm_points"], atol=2e-3, rtol=0)
    np.testing.assert_array_equal(t["mesh_lm_inlier"], j["lm_inlier"])
    assert t["mesh_lm_points"].shape == (160, 3)


@pytest.mark.parametrize("n", RANKS)
def test_pose_only_matches_jax_sharded(jax_side, port, n):
    _, j = jax_side
    t = port(n)[0]
    np.testing.assert_allclose(t["mesh_po_T"], j["po_T"], atol=2e-4, rtol=0)
    np.testing.assert_array_equal(t["mesh_po_inlier"], j["po_inlier"])


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("n", RANKS)
def test_schedule_matches_jax_sharded(jax_side, port, n, name):
    _, j = jax_side
    t = port(n)[0]
    np.testing.assert_allclose(t[f"mesh_{name}_T_c_w"], j[f"{name}_T_c_w"], atol=2e-4, rtol=0)
    np.testing.assert_array_equal(t[f"mesh_{name}_inlier"], j[f"{name}_inlier"])
    np.testing.assert_allclose(float(t[f"mesh_{name}_cost_full"]),
                               float(j[f"{name}_cost_full"]), rtol=1e-4)


@pytest.mark.parametrize("n", (2, 4))
def test_ranks_hold_equal_replicas(port, n):
    """Every rank ends with the same bits: poses, costs and the assembled
    landmark-axis results."""
    outs = port(n)
    for r, o in enumerate(outs[1:], 1):
        for k in [k for k in outs[0] if k.startswith("mesh_")]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"rank {r}: {k}")


def test_one_rank_is_bit_equal_to_no_mesh(port):
    o = port(1)[0]
    keys = [k for k in o if k.startswith("mesh_")]
    assert len(keys) == 6 + 5 * len(SCHEDULES)
    for k in keys:
        np.testing.assert_array_equal(o[k], o["none_" + k[len("mesh_"):]], err_msg=k)


@pytest.mark.parametrize("n", (2, 4))
def test_a_mesh_over_the_first_ranks(port, n):
    """make_landmark_mesh(n // 2): the first n // 2 ranks sum over their
    own group, the others hold no mesh."""
    half = n // 2
    got = [tuple(o["sub_mesh"]) for o in port(n)]
    assert got == [(r, half) for r in range(half)] + [(-1, -1)] * (n - half)


def test_initialize_distributed_once(monkeypatch):
    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="2 ranks need MASTER_ADDR"):
        dist_utils.initialize_distributed(world_size=2, rank=0, device="cpu")
    assert dist_utils.initialize_distributed(world_size=1, rank=0, device="cpu")
    try:
        assert not dist_utils.initialize_distributed(world_size=1, rank=0, device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        mesh = dist_utils.make_landmark_mesh()
        assert (mesh.rank, mesh.size) == (0, 1)
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            dist_utils.make_landmark_mesh(2)
    finally:
        dist_utils.shutdown()
    assert not torch.distributed.is_initialized()


def test_initialize_distributed_needs_a_device():
    """No default device (a caller naming none got the CPU and gloo): the
    call raises before it touches the process group."""
    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils

    with pytest.raises(TypeError, match="device"):
        dist_utils.initialize_distributed(world_size=1, rank=0)
    assert not torch.distributed.is_initialized()


def _cut(arrays, fields, n):
    return {f: torch.tensor(v[:n] if f in fields else v) for f, v in arrays.items()}


def test_landmarks_that_do_not_divide_are_refused(jax_side):
    inputs, _ = jax_side
    mesh = LandmarkMesh(group=None, rank=0, size=4)
    lm = {f: inputs[f"lm_{f}"] for f in port_lm.BAProblem._fields}
    problem = port_lm.BAProblem(**_cut(lm, port_dist_ba.LANDMARK_FIELDS, 150))
    with pytest.raises(ValueError, match="150 landmark rows do not divide over a mesh of 4"):
        port_dist_ba.shard_problem(problem, mesh)
    win = {f: inputs[f"L512_{f}"] for f in port_schedule.ScheduleInput._fields}
    inp = port_schedule.ScheduleInput(**_cut(win, port_schedule.LANDMARK_FIELDS, 150))
    with pytest.raises(ValueError, match="150 landmark rows do not divide"):
        port_schedule.make_ba_schedule(PortBAConfig(), mesh=mesh)(inp, torch.tensor(inputs["K"]))


def test_importing_the_mesh_modules_starts_nothing():
    code = ("import sys, torch.distributed as dist; "
            "import stereo_visual_slam_tpu_torch.utils.dist, "
            "stereo_visual_slam_tpu_torch.parallel.dist_ba; "
            "assert not dist.is_initialized(); "
            "assert not any(k == 'jax' or k.startswith(('jax.', 'stereo_visual_slam_tpu.')) "
            "for k in sys.modules)")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, env=env, cwd=str(REPO))
