"""The BA schedule as the window grows, and sharded over ranks: the
counterparts of tools/window_growth.py and tools/scaling_bench.py.

    python -m stereo_visual_slam_tpu_torch.profiling.window [--device cuda] [--r 6]

`make_window` is tools/scaling_bench.make_window: L landmarks ahead of nK
keyframes on a straight road, the observations with 0.5 px noise, the
points with 5 cm, from default_rng(seed). Every schedule runs with
rel_tol=0 (a fixed iteration budget: comparable work), as both tools do.

  growth       ms per schedule (= per keyframe) at (Kw, L) = (10, 4,096),
               (20, 8,192), (40, 16,384), window seed 1, and the ratio to
               Kw=10 (window_growth.py's first table);
  shard-local  the schedule at L/n, n = 1, 2, 4, 8, at Kw=20 and Kw=40: the
               per-rank work of an n-way landmark shard, beside the KB of
               the (6Kw)^2 camera system summed over the ranks per LM
               iteration (its second table);
  scaling      the landmark-sharded schedule (utils/dist.make_landmark_mesh,
               make_ba_schedule(mesh=...)) over n ranks at L=32,768, Kw=10,
               seed 0: ms, speedup and cost_full per n, then 1 rank against
               the most ranks at the three growth windows (scaling_bench.py's
               two tables).

The growth and shard-local rows are timing.measure rows (wall, device busy
time, launches, syncs) on the device asked for. Scaling on "cuda" runs one
NCCL rank in this process (NCCL takes one card per rank and the machine
has one), held bit-equal to no mesh; every n, 1 included, also runs as CPU
ranks over gloo (the JAX tool's own setting, a virtual CPU mesh), one
process each with torchrun's environment, the host's cores split between
them. Those rows are labelled cpu: they are not the card's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.ba import schedule as ba_schedule
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.profiling import timing
from stereo_visual_slam_tpu_torch.utils.config import BAConfig, CameraConfig

GROWTH = ((10, 4096), (20, 8192), (40, 16384))
SHARD_WINDOWS = ((20, 8192), (40, 16384))
RANKS = (1, 2, 4, 8)
SCALING_L = 32768
GROWTH_SEED = 1    # window_growth.schedule_time
SCALING_SEED = 0   # scaling_bench.main
RANK_TIMEOUT_S = 1800.0
REPO = Path(__file__).resolve().parents[2]


def make_window(L: int, nK: int = 10, seed: int = 0, device="cpu",
                camera: Optional[CameraConfig] = None):
    """(ScheduleInput, K) of the driving window of tools/scaling_bench.py
    on `device`; `camera` defaults to that tool's (the KITTI rig)."""
    cam = camera or CameraConfig()
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-20, 20, L), rng.uniform(-5, 5, L),
                    rng.uniform(10, 80 + nK, L)], axis=-1).astype(np.float32)
    T = se3.exp(torch.tensor([[0.02 * k, 0.0, -1.0 * k, 0.0, 0.004 * k, 0.0]
                              for k in range(nK)], dtype=torch.float32)).numpy()
    Xc = np.einsum("kij,lj->lki", T[:, :3, :3], pts) + T[:, :3, 3][None]
    z = np.maximum(Xc[..., 2], 1e-3)
    uv = np.stack([cam.fx * Xc[..., 0] / z + cam.cx, cam.fy * Xc[..., 1] / z + cam.cy],
                  axis=-1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    ones = np.ones(L, np.float32)
    fixed = np.zeros(nK, np.float32)
    fixed[0] = 1.0
    arrays = dict(T_c_w=T, points=pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
                  uv=uv, obs_mask=(Xc[..., 2] > 1.0).astype(np.float32), inlier=ones,
                  reliable=ones, present=ones, pose_mask=np.ones(nK, np.float32),
                  fixed_pose=fixed)
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], dtype=torch.float32)
    inp = ba_schedule.ScheduleInput(**{k: torch.from_numpy(v).to(device)
                                       for k, v in arrays.items()})
    return inp, K.to(device)


def fixed_budget(cfg) -> BAConfig:
    """The config's BA with rel_tol=0, as both JAX tools run it."""
    return dataclasses.replace(cfg.ba, rel_tol=0.0)


def psum_kb(Kw: int) -> float:
    return (6 * Kw) ** 2 * 4 / 1024


def schedule_row(ba_cfg, device, Kw, L, label, r, best_of, seed=GROWTH_SEED, camera=None):
    inp, K = make_window(L, nK=Kw, seed=seed, device=device, camera=camera)
    run = ba_schedule.make_ba_schedule(ba_cfg)
    return dict(timing.measure(lambda: run(inp, K), label, device, r, best_of), Kw=Kw, L=L)


def growth(ba_cfg, device, r, best_of, windows=GROWTH, camera=None):
    rows = [schedule_row(ba_cfg, device, Kw, L, f"Kw={Kw} L={L}", r, best_of, camera=camera)
            for Kw, L in windows]
    for row in rows:
        row["ratio"] = row["wall_ms"] / rows[0]["wall_ms"]
    return rows


def shard_local(ba_cfg, device, r, best_of, windows=SHARD_WINDOWS, camera=None):
    rows = []
    for Kw, L in windows:
        for n in RANKS:
            rows.append(dict(schedule_row(ba_cfg, device, Kw, L // n,
                                          f"Kw={Kw} L={L} sharded x{n}", r, best_of,
                                          camera=camera),
                             L_full=L, n=n, psum_kb=psum_kb(Kw)))
    return rows


# ------------------------------------------------------------------ scaling
def nccl_one_rank(ba_cfg, device, jobs, r, best_of, camera=None):
    """The sharded schedule on a one-rank NCCL mesh in this process, per
    job (label, L, Kw, seed): its row, cost_full and bit-equality to the
    schedule with no mesh."""
    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils

    created = dist_utils.initialize_distributed(world_size=1, rank=0, device=device)
    try:
        mesh = dist_utils.make_landmark_mesh(1)
        single = ba_schedule.make_ba_schedule(ba_cfg)
        sharded = ba_schedule.make_ba_schedule(ba_cfg, mesh=mesh)
        rows = []
        for label, L, Kw, seed in jobs:
            inp, K = make_window(L, nK=Kw, seed=seed, device=device, camera=camera)
            a, b = single(inp, K), sharded(inp, K)
            row = timing.measure(lambda: sharded(inp, K), f"{label} nccl x1", device, r, best_of)
            rows.append(dict(row, L=L, Kw=Kw, n=1, backend=torch.distributed.get_backend(),
                             cost_full=float(b.cost_full),
                             bit_equal_no_mesh=all(torch.equal(x, y) for x, y in zip(a, b))))
        return rows
    finally:
        if created:
            dist_utils.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cpu_ranks(ba_cfg, n: int, jobs, threads: Optional[int] = None, camera=None,
              timeout: float = RANK_TIMEOUT_S):
    """The sharded schedule on n CPU ranks over gloo, one process each
    (this module with --rank-worker and torchrun's environment), per job
    (label, L, Kw, seed), timed at r=1, best of 1 (a schedule takes
    seconds there). `threads` per rank: the host's cores split between the
    ranks by default. Returns rank 0's rows, each with its T_c_w and
    cost_full."""
    threads = threads or max(1, (os.cpu_count() or 1) // n)
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump(dict(ba=dataclasses.asdict(ba_cfg), jobs=[list(j) for j in jobs],
                           threads=threads, camera=dataclasses.asdict(camera or CameraConfig())),
                      f)
        env = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(_free_port()), PYTHONPATH=os.pathsep.join(
                       [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                                      if p]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "stereo_visual_slam_tpu_torch.profiling.window",
             "--rank-worker", spec, tmp],
            env=dict(env, RANK=str(k), LOCAL_RANK=str(k)), cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(n)]
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
        for k, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise RuntimeError(f"window: CPU rank {k} of {n} exited {p.returncode}:\n"
                                   f"{log[-3000:]}")
        with open(os.path.join(tmp, "rank0.json")) as f:
            rows = json.load(f)
        with np.load(os.path.join(tmp, "rank0.npz")) as z:
            for i, row in enumerate(rows):
                row["T_c_w"] = z[f"T_c_w_{i}"]
    return rows


def rank_worker(spec_path: str, out_dir: str) -> None:
    """One CPU rank of `cpu_ranks`: joins the gloo group from the
    environment, runs the spec's jobs on the landmark mesh and, on rank 0,
    writes the rows and poses to out_dir."""
    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    ba_cfg = BAConfig(**spec["ba"])
    camera = CameraConfig(**spec["camera"])
    dist_utils.initialize_distributed(device="cpu")
    try:
        mesh = dist_utils.make_landmark_mesh()
        run = ba_schedule.make_ba_schedule(ba_cfg, mesh=mesh)
        rows, poses = [], {}
        for i, (label, L, Kw, seed) in enumerate(spec["jobs"]):
            inp, K = make_window(L, nK=Kw, seed=seed, device="cpu", camera=camera)
            row = timing.measure(lambda: run(inp, K), f"{label} cpu gloo x{mesh.size}", "cpu",
                                 r=1, best_of=1)
            out = run(inp, K)
            rows.append(dict(row, L=L, Kw=Kw, n=mesh.size, backend="gloo",
                             threads=spec["threads"], cost_full=float(out.cost_full)))
            poses[f"T_c_w_{i}"] = out.T_c_w.numpy()
        if mesh.rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **poses)
            with open(os.path.join(out_dir, "rank0.json"), "w") as f:
                json.dump(rows, f)
    finally:
        dist_utils.shutdown()


def scaling(ba_cfg, device, r, best_of, L=SCALING_L,
            windows: Sequence[Tuple[int, int]] = GROWTH, cpu: bool = True, camera=None) -> dict:
    """scaling_bench.py's two tables: the schedule at L over 1, 2, 4 and 8
    ranks, then 1 rank against 8 at `windows`. On "cuda" the one NCCL rank
    comes first; `cpu=False` leaves out the CPU ranks."""
    device = torch.device(device)
    base = ("scaling", L, 10, SCALING_SEED)
    grown = [(f"Kw={Kw} L={Lw}", Lw, Kw, SCALING_SEED) for Kw, Lw in windows]
    out = dict(L=L, nccl=[], cpu=[], growth=[])
    if device.type == "cuda":
        out["nccl"] = nccl_one_rank(ba_cfg, device, [base] + grown, r, best_of, camera)
    if not cpu:
        return out
    most = RANKS[-1]
    by_n = {}
    for n in RANKS:
        by_n[n] = cpu_ranks(ba_cfg, n, [base] + (grown if n in (1, most) else []), camera=camera)
        for row in by_n[n]:
            row.pop("T_c_w")
        out["cpu"].append(dict(by_n[n][0], speedup=by_n[1][0]["wall_ms"] / by_n[n][0]["wall_ms"]))
    for one, many in zip(by_n[1][1:], by_n[most][1:]):
        out["growth"].append(dict(label=one["label"].rsplit(" cpu", 1)[0], Kw=one["Kw"],
                                  L=one["L"], n=most, ms_1=one["wall_ms"],
                                  ms_n=many["wall_ms"], speedup=one["wall_ms"] / many["wall_ms"],
                                  cost_full_1=one["cost_full"], cost_full_n=many["cost_full"]))
    return out


def run(cfg, device, r: int = 6, best_of: int = 3, growth_windows=GROWTH,
        shard_windows=SHARD_WINDOWS, scaling_L: int = SCALING_L, scaling_windows=GROWTH,
        cpu: bool = True) -> dict:
    """The three tables on `device` (scaling's CPU ranks unless cpu=False)."""
    device = timing.require(device)
    ba_cfg = fixed_budget(cfg)
    cam = cfg.camera
    return dict(
        timing.header("window", device, r, best_of),
        growth=growth(ba_cfg, device, r, best_of, growth_windows, cam),
        shard_local=shard_local(ba_cfg, device, r, best_of, shard_windows, cam),
        scaling=scaling(ba_cfg, device, r, best_of, scaling_L, scaling_windows, cpu, cam))


def render(result: dict) -> str:
    d = result["device"]
    where = d["card"] or d["kind"]
    out = [timing.table(result["growth"], f"window growth on {where}: ms per BA schedule "
                                          f"(= per keyframe), rel_tol 0")]
    out.append("ratio to Kw=10: " + ", ".join(f"{g['label']} {g['ratio']:.2f}x"
                                              for g in result["growth"]))
    out.append(timing.table(result["shard_local"], f"shard-local schedule at L/n on {where} "
                                                   f"(+ one sum of (6Kw)^2 f32 per LM iteration)"))
    out.append("psum per LM iteration: " + ", ".join(
        f"Kw={Kw} {psum_kb(Kw):.0f} KB" for Kw in sorted({s['Kw'] for s in result['shard_local']})))
    sc = result["scaling"]
    if sc["nccl"]:
        out.append(timing.table(sc["nccl"], f"landmark-sharded schedule, one NCCL rank on {where}"))
        out.append("bit-equal to no mesh: " + ", ".join(
            f"{x['label']} {x['bit_equal_no_mesh']}" for x in sc["nccl"]))
    if sc["cpu"]:
        out.append(f"# landmark-sharded schedule at L={sc['L']} on CPU ranks over gloo "
                   f"(not the card)")
        out += [f"ranks={x['n']}: {x['wall_ms']:10.1f} ms/schedule  speedup "
                f"{x['speedup']:4.2f}x  cost {x['cost_full']:.1f}  ({x['threads']} threads each)"
                for x in sc["cpu"]]
        out.append("# window growth, CPU ranks: 1 rank against the most")
        out += [f"{x['label']}: 1 rank {x['ms_1']:10.1f} ms  {x['n']} ranks {x['ms_n']:10.1f} ms"
                f"  speedup {x['speedup']:4.2f}x  cost {x['cost_full_n']:.1f}"
                for x in sc["growth"]]
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--rank-worker"]:
        rank_worker(*argv[1:3])
        return 0
    return timing.cli("window", __doc__, run, render, default_r=6, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
