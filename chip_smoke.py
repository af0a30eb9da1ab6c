"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure raises):
  1. device: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from stereo_visual_slam_tpu_torch/csrc;
  3. each kernel against its plain torch version at the main path's shapes
     (FAST+NMS on all 8 pyramid levels and the patch gather at every
     level's keypoint budget, bit-exact; ZNCC at N=2,048 and at the stacked
     N=16,384, atol 2e-5 with match_disparity's gates equal), with the
     device times of the kernel, the plain version and, for the gather, one
     PyTorch indexing call; each kernel's bound (ops/kernels/measure.py);
     the BRIEF bit-flip rate against the CPU;
  4. the slice: production Config(), a 64-frame synthetic world, ChunkedSlam
     with chunk 8 on the card, streamed frame by frame (process/flush, the
     CLI's default path); not Lost, >= 90 % tracked, BA ran, the
     default-profile accuracy gates, and every kernel launched in the run;
  5. the host-sequenced driver (VisualOdometry, lookahead 1) on the same
     frames and Config(): the same gates, and the ZNCC kernel launched at
     least once per frame (eager depth); frames/s and syncs/frame;
  6. the reference-faithful configuration (steered BRIEF, the reference's
     matcher gates and BA schedule) on ChunkedSlam over the first 24
     frames, staged (stage/run_staged: every chunk on the card first):
     not Lost, >= 23 tracked, BA ran, every kernel launched.
Each path's kernel launches are counted from 0 just before it runs.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's `nvidia-smi` name and power limit, before that a JSON line with the
kernels' measurements and per-path launch counts.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 64
CHUNK = 8
LOOKAHEAD = 1
REF_FRAMES = 24
ZNCC_ATOL = 2e-5
# the default profile's accuracy gates of the JAX benchmark (bench.py:45-49)
DEFAULT_GATES = dict(trans=1.5, ate=2.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_kernels(cfg, frames, dev):
    """Phase 3: each kernel against its plain version at the main path's
    shapes (ops/kernels/measure.py builds them: every pyramid level for
    FAST+NMS and the patch gather, N=2,048 and the stacked N=16,384 for
    ZNCC), with device times of the kernel, the plain version and, for the
    gather, one PyTorch indexing call; and each kernel's bound."""
    from stereo_visual_slam_tpu_torch.ops import image as im_ops
    from stereo_visual_slam_tpu_torch.ops import orb as orb_ops
    from stereo_visual_slam_tpu_torch.ops import stereo as stereo_ops
    from stereo_visual_slam_tpu_torch.ops.kernels import (
        fast_kernel, measure, patch_kernel, stereo_kernel,
    )

    fe, cam = cfg.frontend, cfg.camera
    inp = measure.kernel_inputs(cfg, frames[:CHUNK], dev)
    ms = measure.device_ms
    results = {}

    # K1: every level's (8*H_i, W_i) stack, bit-exact
    levels = []
    for i, img in enumerate(inp["levels"]):
        k = fast_kernel.fast_nms_cuda(img, fe.fast_threshold)
        p = fast_kernel.fast_nms_plain(img, fe.fast_threshold)
        sync()
        if not torch.equal(k, p):
            raise AssertionError(f"fast_nms differs from plain at L{i} {tuple(img.shape)}: "
                                 f"{int((k != p).sum())} pixels")
        bms, by = measure.fast_bound(img, fe.fast_threshold)
        levels.append(dict(
            shape=list(img.shape), max_abs_err=float((k - p).abs().max()),
            ms=ms(lambda: fast_kernel.fast_nms_cuda(img, fe.fast_threshold)),
            plain_ms=ms(lambda: fast_kernel.fast_nms_plain(img, fe.fast_threshold), reps=5),
            bound_ms=bms, bound_by=by))
    results["fast_nms"] = dict(levels[0], library_ms=None, levels=levels,
                               sum_ms=sum(lv["ms"] for lv in levels),
                               sum_bound_ms=sum(lv["bound_ms"] for lv in levels))
    log("fast_nms: bit-exact at " + ", ".join(
        f"L{i} {tuple(lv['shape'])} {lv['ms']:.4f} ms" for i, lv in enumerate(levels)))

    # K2: every level's 8 x budget_i keypoints on the blurred stack,
    # bit-exact; the yardstick is one flat-index gather, its index built
    # outside the timed call
    P = fe.patch_size
    gathers = []
    for i, (blurred, yx, fh) in enumerate(inp["gathers"]):
        pk = patch_kernel.gather_patches_cuda(blurred, yx, P, fh)
        pp = patch_kernel.gather_patches_plain(blurred, yx, P, fh)
        y0, x0 = im_ops.patch_origins(yx, blurred.shape, P, fh)
        ar = torch.arange(P, device=dev)
        idx = ((y0[:, None, None] + ar[None, :, None]) * blurred.shape[1]
               + x0[:, None, None] + ar[None, None, :])
        flat = blurred.view(-1)
        sync()
        if not (torch.equal(pk, pp) and torch.equal(flat[idx], pp)):
            raise AssertionError(f"gather_patches differs from plain at L{i}: "
                                 f"{int((pk != pp).sum())}")
        bms, by = measure.gather_bound(blurred, yx.shape[0], P)
        gathers.append(dict(
            shape=[int(yx.shape[0]), P, P], max_abs_err=float((pk - pp).abs().max()),
            ms=ms(lambda: patch_kernel.gather_patches_cuda(blurred, yx, P, fh)),
            plain_ms=ms(lambda: patch_kernel.gather_patches_plain(blurred, yx, P, fh), reps=10),
            library_ms=ms(lambda: flat[idx]), bound_ms=bms, bound_by=by))
        if i == 0:
            patches0 = pk
    results["gather_patches"] = dict(gathers[0], levels=gathers,
                                     sum_ms=sum(g["ms"] for g in gathers),
                                     sum_library_ms=sum(g["library_ms"] for g in gathers),
                                     sum_bound_ms=sum(g["bound_ms"] for g in gathers))
    # BRIEF bits, upright and steered, from the kernel's level-0 patches on
    # the card vs the same patches on the CPU
    flips = {}
    for steer in (False, True):
        M = torch.from_numpy(orb_ops.brief_matrix_bf16(fe.descriptor_bits, P, steer))
        _, signs_gpu = orb_ops.describe_patches(patches0, M.to(dev), steer)
        _, signs_cpu = orb_ops.describe_patches(patches0.cpu(), M, steer)
        flips[steer] = int((signs_gpu.cpu() != signs_cpu).sum())
    results["gather_patches"].update(
        brief_bit_flips=flips[False], steered_bit_flips=flips[True],
        brief_bits=int(signs_cpu.numel()))
    log("gather_patches: bit-exact at " + ", ".join(
        f"L{i} {g['shape'][0]} {g['ms']:.4f} ms" for i, g in enumerate(gathers))
        + f"; BRIEF bit flips card vs CPU: upright {flips[False]}, steered "
        f"{flips[True]} of {signs_cpu.numel()}")

    # K3: N=2,048 on frame 0's pair and the stacked N=16,384, atol 2e-5,
    # match_disparity's gates equal
    D, Pz = fe.max_disparity, fe.stereo_patch
    kw = dict(fx=cam.fx, baseline=cam.baseline, max_disparity=D, patch=Pz,
              min_zncc=fe.min_zncc, min_depth=fe.min_depth,
              max_depth=fe.max_depth, reliable_depth=fe.reliable_depth)
    shapes = []
    for label, (l, r, yx) in inp["zncc"].items():
        zk = stereo_kernel.zncc_sweep_cuda(l, r, yx, patch=Pz, max_disparity=D)
        zp = stereo_kernel.zncc_sweep_plain(l, r, yx, patch=Pz, max_disparity=D)
        sync()
        zerr = float((zk - zp).abs().max())
        if not zerr <= ZNCC_ATOL:
            raise AssertionError(f"zncc_sweep {label}: max |err| {zerr} > {ZNCC_ATOL}")
        valid = torch.ones(yx.shape[0], dtype=torch.bool, device=dev)
        a = stereo_ops.match_disparity(l, r, yx, valid, use_kernel=True, **kw)
        b = stereo_ops.match_disparity(l, r, yx, valid, use_kernel=False, **kw)
        if not (torch.equal(a.valid, b.valid) and torch.equal(a.reliable, b.reliable)):
            raise AssertionError(f"match_disparity gates differ between kernel and plain ({label})")
        bms, by = measure.zncc_bound(l, yx.shape[0], Pz, D)
        shapes.append(dict(
            shape=[int(yx.shape[0]), D], image=list(l.shape), max_abs_err=zerr,
            ms=ms(lambda: stereo_kernel.zncc_sweep_cuda(l, r, yx, patch=Pz, max_disparity=D)),
            plain_ms=ms(lambda: stereo_kernel.zncc_sweep_plain(l, r, yx, patch=Pz, max_disparity=D),
                        reps=5),
            bound_ms=bms, bound_by=by))
    results["zncc_sweep"] = dict(shapes[0], library_ms=None, shapes=shapes,
                                 max_abs_err=max(z["max_abs_err"] for z in shapes))
    log("zncc_sweep: " + ", ".join(
        f"N={z['shape'][0]} max |err| {z['max_abs_err']:.3g} {z['ms']:.4f} ms" for z in shapes)
        + f" (atol {ZNCC_ATOL}); valid/reliable equal")
    sync()
    return results


def accuracy(estimates, world, label):
    """(ATE m, KITTI trans %) of the estimates against the world's poses,
    after checking they are finite 4x4 poses."""
    from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj

    fids = sorted(estimates)
    est = np.stack([estimates[f] for f in fids])
    if not np.isfinite(est).all() or est.shape[1:] != (4, 4):
        raise AssertionError(f"{label}: non-finite or mis-shaped pose estimates")
    t_err, r_err = traj.kitti_errors(est, world.poses_T_c_w[fids])
    ate = traj.ate_rmse(est, world.poses_T_c_w[fids])
    log(f"{label}: ATE {ate:.3f} m (gate {DEFAULT_GATES['ate']}), KITTI trans "
        f"{t_err:.3f} % (gate {DEFAULT_GATES['trans']}), rot {r_err:.4f} deg/m [for information]")
    return ate, t_err


def check_launches(launches, label):
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")


def run_slice(frames, world, cfg):
    """Phase 4: the production slice on the card."""
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam

    # warm-up on one chunk (cuBLAS/cuSOLVER handles, allocator), not counted
    warm = ChunkedSlam(cfg, chunk=CHUNK, device="cuda")
    warm.run(frames[:CHUNK], stage=False)
    warm.finish()
    sync()

    slam = ChunkedSlam(cfg, chunk=CHUNK, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    slam.run(frames, stage=False)   # streamed, as run_vslam's default
    slam.finish()
    sync()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    n = len(slam.stats)
    tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    n_kf = sum(1 for s in slam.stats if s["keyframe"])
    n_ba = sum(1 for s in slam.stats if s["ba_cost"] is not None)
    log(f"slice: {n} frames in {wall:.3f} s = {n / wall:.2f} frames/s; "
        f"tracked {tracked}, keyframes {n_kf}, BA runs {n_ba}, lost {slam.lost}")
    ate, t_err = accuracy(slam.estimates, world, "slice")
    log(f"slice: syncs/frame {slam.syncs / n:.3f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches {launches}")
    if slam.lost:
        raise AssertionError("the slice went Lost")
    if n != FRAMES or tracked < 0.9 * n:
        raise AssertionError(f"tracked {tracked} of {n} frames")
    if n_ba < 1:
        raise AssertionError("BA never ran")
    if ate > DEFAULT_GATES["ate"] or t_err > DEFAULT_GATES["trans"]:
        raise AssertionError("the slice misses the accuracy gates")
    check_launches(launches, "slice")
    return launches


def run_host(frames, world, cfg):
    """Phase 5: the host-sequenced driver on the card."""
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry

    warm = VisualOdometry(cfg, lookahead=LOOKAHEAD, device="cuda")
    for f, left, right in frames[:CHUNK]:
        warm.process(f, left, right)
    warm.finish()
    sync()

    vo = VisualOdometry(cfg, lookahead=LOOKAHEAD, device="cuda")
    kernels.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    for f, left, right in frames:
        vo.process(f, left, right)
    vo.finish()
    sync()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()

    recs = [s for s in vo.stats if s["state"] != "pending"]
    n = len(recs)
    tracked = sum(1 for s in recs if s["state"] in ("init", "tracked"))
    n_kf = sum(1 for s in recs if s.get("keyframe"))
    n_ba = sum(1 for s in recs if "ba_cost" in s or s.get("ba_dispatched"))
    lost = vo.state.name == "LOST"
    log(f"host: {n} frames in {wall:.3f} s = {n / wall:.2f} frames/s (lookahead "
        f"{LOOKAHEAD}); tracked {tracked}, keyframes {n_kf}, BA runs {n_ba}, lost {lost}")
    ate, t_err = accuracy(vo.estimates, world, "host")
    log(f"host: syncs/frame {vo.syncs / n:.3f}; ZNCC launches/frame "
        f"{launches['zncc_sweep'] / n:.3f}; launches {launches}")
    if lost:
        raise AssertionError("the host driver went Lost")
    if n != FRAMES or tracked < 0.9 * n:
        raise AssertionError(f"host: tracked {tracked} of {n} frames")
    if n_ba < 1:
        raise AssertionError("host: BA never ran")
    if ate > DEFAULT_GATES["ate"] or t_err > DEFAULT_GATES["trans"]:
        raise AssertionError("host: misses the accuracy gates")
    check_launches(launches, "host")
    if launches["zncc_sweep"] < n:
        raise AssertionError(f"host: ZNCC launched {launches['zncc_sweep']} times for {n} frames")
    return launches, dict(frames_per_s=n / wall, syncs_per_frame=vo.syncs / n)


def reference_faithful(cfg):
    """The reference's published constants: steered rBRIEF, base gate 30, no
    search-radius gate, no margin, the 2x5/10/10 BA schedule, no gauge
    anchor (tests/test_reference_config.py)."""
    import dataclasses

    from stereo_visual_slam_tpu_torch.utils.config import reference_ba_schedule

    return cfg.replace(
        frontend=dataclasses.replace(cfg.frontend, steer_descriptor=True),
        matcher=dataclasses.replace(cfg.matcher, base_gate=30.0, margin=0.0, search_radius=1e6),
        ba=dataclasses.replace(reference_ba_schedule(cfg.ba), fix_oldest_pose=False),
    )


def run_reference(frames, world, cfg):
    """Phase 6: the reference-faithful configuration on ChunkedSlam."""
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam

    cfg_ref = reference_faithful(cfg)
    slam = ChunkedSlam(cfg_ref, chunk=CHUNK, device="cuda")
    kernels.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    slam.run(frames[:REF_FRAMES])   # staged: every chunk uploaded first
    slam.finish()
    sync()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n = len(slam.stats)
    tracked = sum(1 for s in slam.stats if s["state"] == "tracked")
    n_kf = sum(1 for s in slam.stats if s["keyframe"])
    n_ba = sum(1 for s in slam.stats if s["ba_cost"] is not None)
    log(f"reference config: {n} frames in {wall:.3f} s (staged); tracked {tracked}, "
        f"keyframes {n_kf}, BA runs {n_ba}, lost {slam.lost}; syncs/frame "
        f"{slam.syncs / n:.3f}; launches {launches}")
    accuracy(slam.estimates, world, "reference config")
    if slam.lost:
        raise AssertionError("the reference-faithful config went Lost")
    if n != REF_FRAMES or tracked < n - 1:
        raise AssertionError(f"reference config: tracked {tracked} of {n} frames")
    if n_ba < 1:
        raise AssertionError("reference config: BA never ran")
    check_launches(launches, "reference config")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.ops.kernels import _build
    from stereo_visual_slam_tpu_torch.utils.config import Config

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path()}")

    cfg = Config()
    t0 = time.perf_counter()
    world = synthetic.make_world(cfg, n_frames=FRAMES, n_points=8000, seed=0)
    frames = list(synthetic.frames(world))
    log(f"render: {FRAMES} frames in {time.perf_counter() - t0:.1f} s")

    measured = check_kernels(cfg, frames, dev)
    launches = {"chunked": run_slice(frames, world, cfg)}
    launches["host"], host_rates = run_host(frames, world, cfg)
    launches["reference_config"] = run_reference(frames, world, cfg)

    src = {"fast_nms": ("stereo_visual_slam_tpu_torch/csrc/fast_nms.cu",
                        "stereo_visual_slam_tpu/ops/pallas/fast_kernel.py:96"),
           "gather_patches": ("stereo_visual_slam_tpu_torch/csrc/patch_gather.cu",
                              "stereo_visual_slam_tpu/ops/pallas/patch_kernel.py:82"),
           "zncc_sweep": ("stereo_visual_slam_tpu_torch/csrc/zncc_sweep.cu",
                          "stereo_visual_slam_tpu/ops/pallas/stereo_kernel.py:126")}
    rows = []
    for name, (source, replaces) in src.items():
        m = measured[name]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches["chunked"][name],
                         launches_by_path={p: c[name] for p, c in launches.items()},
                         **{k: v for k, v in m.items() if k not in (
                             "brief_bit_flips", "steered_bit_flips", "brief_bits")}))
    g = measured["gather_patches"]
    print(json.dumps({"kernels": rows, "host_driver": host_rates,
                      "brief_bit_flips": [g["brief_bit_flips"], g["brief_bits"]],
                      "steered_bit_flips": [g["steered_bit_flips"], g["brief_bits"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
