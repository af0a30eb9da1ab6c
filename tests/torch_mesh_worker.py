"""One rank of the port's landmark mesh on the CPU, for the mesh tests
(tests/test_torch_dist_ba.py, tests/test_torch_chunked_mesh.py).

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_mesh_worker.py {ba|chunked|dryrun} in.npz out_dir

Joins an n-rank gloo group from torchrun's environment, runs the job on
the inputs the test wrote, and saves what it computed to
out_dir/rank{r}.npz. On one rank it also runs the same job without a mesh,
for the bit-equality checks. Imports the port only, never jax.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from stereo_visual_slam_tpu_torch import graft_entry  # noqa: E402
from stereo_visual_slam_tpu_torch.ba import pose_only, schedule, schur_lm  # noqa: E402
from stereo_visual_slam_tpu_torch.models import slam_core  # noqa: E402
from stereo_visual_slam_tpu_torch.parallel import dist_ba  # noqa: E402
from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam  # noqa: E402
from stereo_visual_slam_tpu_torch.utils import dist as dist_utils  # noqa: E402
from stereo_visual_slam_tpu_torch.utils.config import BAConfig, small_config  # noqa: E402

SCHEDULES = ("L512", "Kw20_L8192")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _problem(z, prefix):
    return schur_lm.BAProblem(**{f: _t(z[f"{prefix}_{f}"]) for f in schur_lm.BAProblem._fields})


def ba_job(z, mesh):
    K = _t(z["K"])
    out = {}
    lm_p, po_p = _problem(z, "lm"), _problem(z, "po")
    runs = {"mesh": mesh} if mesh.size > 1 else {"mesh": mesh, "none": None}
    for tag, m in runs.items():
        if m is None:
            lm = schur_lm.lm_optimize(lm_p, K, iters=8)
            po = pose_only.optimize_pose_only(po_p, K, iters=10)
        else:
            lm = dist_ba.distributed_lm_optimize(dist_ba.shard_problem(lm_p, m), K, m, iters=8)
            po = dist_ba.distributed_pose_only(dist_ba.shard_problem(po_p, m), K, m, iters=10)
        out.update({f"{tag}_lm_T": lm.T_c_w, f"{tag}_lm_points": lm.points,
                    f"{tag}_lm_inlier": lm.landmark_inlier, f"{tag}_lm_cost": lm.cost,
                    f"{tag}_po_T": po.T_c_w, f"{tag}_po_inlier": po.landmark_inlier})
        for name in SCHEDULES:
            inp = schedule.ScheduleInput(**{f: _t(z[f"{name}_{f}"])
                                            for f in schedule.ScheduleInput._fields})
            r = schedule.make_ba_schedule(BAConfig(), mesh=m)(inp, _t(z[f"{name}_K"]))
            for f in ("T_c_w", "inlier", "cost_full", "cost_pose", "threshold"):
                out[f"{tag}_{name}_{f}"] = r[schedule.ScheduleResult._fields.index(f)]
    return out


def _run_chunked(z, mesh):
    cfg = small_config(128, 256)
    noise = {int(f): (_t(g), _t(t)) for f, g, t in zip(z["fids"], z["gumbel"], z["twist"])}
    slam = ChunkedSlam(cfg, chunk=int(z["chunk"]), device="cpu", mesh=mesh,
                       noise_fn=lambda fid: noise[fid])
    for f, left, right in zip(z["fids"], z["left"], z["right"]):
        slam.process(int(f), left, right)
    slam.finish()
    fids = sorted(slam.estimates)
    out = {"lost": np.bool_(slam.lost), "est_fids": np.array(fids),
           "est_T": np.stack([slam.estimates[f] for f in fids]),
           "ba_ran": np.array([s["ba_cost"] is not None for s in slam.stats]),
           "keyframe": np.array([s["keyframe"] for s in slam.stats]),
           "syncs": np.int64(slam.syncs)}
    out.update({f"carry_{k}": v for k, v in slam_core.carry_to_numpy(slam.carry).items()})
    return out


def chunked_job(z, mesh):
    out = {f"mesh_{k}": v for k, v in _run_chunked(z, mesh).items()}
    if mesh.size == 1:
        out.update({f"none_{k}": v for k, v in _run_chunked(z, None).items()})
    # the first chunk's tables, data-parallel and on this rank alone
    cfg = small_config(128, 256)
    B = int(z["chunk"])
    H, W = cfg.padded_hw
    images = torch.zeros((B, 2, H, W), dtype=torch.uint8)
    for b in range(B):
        h, w = z["left"][b].shape
        images[b, 0, :h, :w] = _t(z["left"][b])
        images[b, 1, :h, :w] = _t(z["right"][b])
    step = slam_core.ChunkStep(cfg, "cpu", mesh)
    parallel, alone = step.extract_chunk(images), step.extract(images)
    for f in parallel._fields:
        out[f"dp_{f}"] = getattr(parallel, f)
        out[f"alone_{f}"] = getattr(alone, f)
    return out


def dryrun_job(z, mesh):
    """graft_entry.dryrun_multichip on this mesh, at small_config with the
    principal point at the image centre."""
    import dataclasses

    cfg = small_config(128, 256)
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))
    out = graft_entry.dryrun_multichip(mesh.size, "cpu", cfg, n_frames=int(z["n_frames"]),
                                       chunk=int(z["chunk"]), n_points=int(z["n_points"]))
    return {k: np.asarray(v) for k, v in out.items()}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_all(procs, timeout):
    """Each process's output; any still running at the deadline is killed."""
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return logs


def launch(job, n, inputs, out_dir, timeout=240):
    """Run `job` on n ranks (this file, one process each, with torchrun's
    environment) on `inputs`; every rank's outputs, in rank order."""
    inp = os.path.join(out_dir, "in.npz")
    np.savez(inp, **inputs)
    env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, inp, out_dir],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = wait_all(procs, timeout)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {n} exited {p.returncode}:\n{log[-3000:]}"
    outs = []
    for r in range(n):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as f:
            outs.append(dict(f))
    return outs


def main():
    job, inp, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    created = dist_utils.initialize_distributed(device="cpu")
    try:
        mesh = dist_utils.make_landmark_mesh()
        with np.load(inp) as f:
            z = dict(f)
        out = {"ba": ba_job, "chunked": chunked_job, "dryrun": dryrun_job}[job](z, mesh)
        # a mesh over the first half of the ranks; the others hold none
        sub = dist_utils.make_landmark_mesh(max(1, mesh.size // 2))
        out["sub_mesh"] = np.array([-1, -1] if sub is None else
                                   [sub.rank, int(sub.all_reduce(torch.ones(()))[0])])
        out = {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}
        np.savez(os.path.join(out_dir, f"rank{mesh.rank}.npz"), **out)
    finally:
        if created:
            dist_utils.shutdown()


if __name__ == "__main__":
    main()
