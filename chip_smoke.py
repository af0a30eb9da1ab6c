"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(); any failure raises):
  1. device: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from stereo_visual_slam_tpu_torch/csrc;
  3. each kernel against its plain torch version at the main path's shapes
     (FAST+NMS on all 8 pyramid levels and the patch gather at every
     level's keypoint budget, bit-exact, the gather also over all 8 levels
     in one launch, the main path's call, per level and whole; ZNCC at
     N=2,048 and at the stacked N=16,384, atol 2e-5 with match_disparity's
     gates equal), with the device times of the kernel, the plain version
     and, for the gather, one PyTorch indexing call (the all-levels gather
     also L2-cold); each kernel's bound (ops/kernels/measure.py; the
     gather's counts the image pixels under its windows); the BRIEF bit-flip rate against the CPU;
     batch_extract on the first chunk (B=8) and its first frame (B=1)
     bit-equal to its composition through the per-level
     ExtractStages.describe, with one patch-gather launch a call;
     PnP-RANSAC's two kernels at the tracker's shapes (H=128, N=2,048) on
     three scenes: minimal sets, hypotheses and scores bit-equal to the
     plain path's, the final pose within 1e-5, each kernel's time and
     bound beside the plain path's;
  4. the slice: production Config(), a 64-frame synthetic world, ChunkedSlam
     with chunk 8 on the card, streamed frame by frame (process/flush, the
     CLI's default path); not Lost, >= 90 % tracked, BA ran, the
     default-profile accuracy gates, and every kernel launched in the run;
     held to the JAX package's own run of that world (data/
     reference_runs.json, pipeline/reference_runs.py): frames with equal
     records, the first frame where the runs part, the camera-centre and
     frame-to-frame motion gaps, and the bound (same frames, neither Lost,
     keyframe counts within 1, ATE <= max(1.5 x, + 0.05 m) the JAX run's,
     every camera centre and every frame-to-frame motion within 1e-3 m of
     the JAX run's: reference_runs.CENTRE_BOUND_M, MOTION_BOUND_M);
  5. the host-sequenced driver (VisualOdometry, lookahead 1) on the same
     frames and Config(): the same gates, and the ZNCC kernel launched at
     least once per frame (eager depth); frames/s and syncs/frame; held to
     the JAX host driver's run as phase 4 is to the chunked one;
  6. the reference-faithful configuration (steered BRIEF, the reference's
     matcher gates and BA schedule) on ChunkedSlam over the first 24
     frames, staged (stage/run_staged: every chunk on the card first):
     not Lost, >= 23 tracked, BA ran, every kernel launched;
  7. mesh BA (utils/dist, parallel/dist_ba, the `mesh=` paths):
     (a) phase 4's slice on a one-rank NCCL mesh (run_vslam
         --mesh-devices 1's path): records, poses and the whole carry
         bit-equal to phase 4's run;
     (b) two ranks spawned on the one card over gloo (NCCL refuses two
         ranks on one GPU): the BA schedule at the production window
         (Kw=10, L=4,096) and the window-growth shapes (Kw=20, L=8,192)
         against the card's single-device schedule (poses atol 2e-4,
         inliers equal, full-BA cost rtol 1e-4), then the 64-frame slice
         on both ranks: phase 4's gates, BA on the mesh, every frame within
         5e-2 m of phase 4's, both ranks' carries bit-equal;
     with the ms per BA run sharded and unsharded and each run's wall;
  8. the KITTI entry point: phase 4's frames written as 8-bit gray PNGs in
     the KITTI layout (the writer below, standard library and numpy only,
     cycles each image's rows through the five PNG filters), and again in a
     second tree in six kinds that carry 8-bit gray losslessly (RGB, RGBA,
     a gray palette, Adam7, gray+alpha, 16-bit; left and right of a frame
     in different kinds), then read through the port's native runtime
     (utils/native.py, built from the checkout):
     (a) 64 frames in order, byte-equal to the rendered ones, and
         config_for giving Config();
     (a2) the same from the mixed tree;
     (b) frames/s of the prefetcher at 1 and 4 workers, of
         read_image_gray frame by frame and of PIL (median of 3), and of
         the prefetcher on the mixed tree;
     (c) ChunkedSlam.run_rolling (window 4) fed by seq.frames(): records,
         poses and the whole carry bit-equal to phase 4's run;
     (c2) the same from the mixed tree;
     (d) run_vslam --dataset ... --device cuda --rolling 4: exit 0, a pose
         file byte-equal to (c)'s, the ATE and KITTI line printed;
     (e) 8- and 16-bit RGB with unequal channels decoded byte-equal to
         gray_of_rgb, the numpy model of the conversion;
  9. the port's bench (bench.run_bench) at a reduced length: 3 warm-up and
     3 timed chunks, one staged run, the streaming and rolling passes, the
     hard (45 frames) and highway (96 frames) profiles: the JSON line's four
     keys, every profile's binding gate PASS with no Lost; then the full
     bench's default world (216 frames) on the degraded config, whose
     binding gate must FAIL;
 10. the entry points: graft_entry.entry()'s step once,
     graft_entry.dryrun_multichip(1) on a one-rank NCCL mesh at production
     shapes (BA on the mesh), and `python -m
     stereo_visual_slam_tpu_torch.run_synthetic 16 --device cuda` as a
     process (exit 0, every frame tracked; it prints its launch counts);
 11. a 512-frame soak (soak.run_soak): every check passes (the pace check
     needs 8 marks of 512 frames and skips), keyframes were evicted;
 12. the profilers (stereo_visual_slam_tpu_torch/profiling/), short: the
     method's floor, the production table on phase 4's first chunk, the
     tracking scan split, the window growth and shard-local tables at one
     window each and the sharded schedule on one NCCL rank. Every row's
     device time is > 0 and <= its wall x 1.05; the FAST+NMS, patch
     gather and ZNCC kernels appear, by the names the profiler prints, in
     the detect, describe and stereo rows; the extractor's stages' device
     ms sum to <= batch_extract's x 1.25, matcher + PnP <= track_step x
     1.25 (device ms: host-clock walls spread up to 2.1x between rows of
     identical work, device ms do not); the one-rank schedule is
     bit-equal to no mesh;
 13. the roofline (the cost model, utils/roofline.py, and the tools that
     read it), on phase 4's first chunk at Config(): (a) the per-phase
     report's four rows (profiling/roofline_report.py; phase 12's
     production times, not measured again); (b) the extractor's stage
     costs (profiling/extract_cost.py: the disjoint stages must sum to the
     TOTAL, exactly); (c) the top-k study (profiling/micro_topk.py) at a
     short r, every strategy that claims the production result equal to
     it; (d) one chunk counted: records, poses and carry bit-equal to the
     same chunk uncounted. No MFU or HBM share may exceed 1.05 (no card
     gives that: it would be a wrong count or time), here or in phase 9's
     `# roofline` line.
Each path's kernel launches are counted from 0 just before it runs; on the
driver paths of phases 4-11 every batch_extract call (one a chunk on the
chunked paths, one a frame on the host driver) launches FAST+NMS once a
pyramid level and the patch gather exactly once, and ZNCC launches at least
once a keyframe (phases 9-11) or a frame (phase 5); PnP's two kernels
launch as often as each other (a graph's replays count its launches).
Each phase's wall is logged.
The last line is {"ok": true, "device": {...}}; the line before it is the
card's `nvidia-smi` name and power limit, before that a JSON line with the
kernels' measurements and per-path launch counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

FRAMES = 64
N_POINTS = 8000
SEED = 0
CHUNK = 8
LOOKAHEAD = 1
REF_FRAMES = 24
ZNCC_ATOL = 2e-5
PNP_POSE_ATOL = 1e-5       # phase 3: the kernels' final pose against the plain path's
PNP_SCENES = ((1, 0.3), (2, 0.0), (3, 0.9))   # (seed, prior_spread) of phase 3's PnP calls
# the default profile's accuracy gates of the JAX benchmark (bench.py:45-49)
DEFAULT_GATES = dict(trans=1.5, ate=2.0)
MESH_RANKS = 2
# the schedule's windows in phase 7: (Kw, L) of production and of the
# window-growth test (tests/test_parallel.py::test_sharded_schedule_large_window)
MESH_WINDOWS = ((10, 4096), (20, 8192))
SCHEDULE_REPS = 5
WINDOW_SEED = 3             # phase 7's windows (profiling/window.make_window)
MESH_POSE_BOUND_M = 5e-2   # per frame, as tests/test_parallel.py
MESH_TIMEOUT_S = 480       # phase 7(b) as a whole, both ranks
DATASET_WINDOW = 4         # phase 8's run_rolling window, as `run_vslam --rolling 4`
DECODE_REPS = 3
# phase 9's bench: 3 timed chunks after the 3 warm-up ones, and the hard and
# highway profiles at the JAX package's slow tests' lengths
BENCH_CHUNKS = 3
BENCH_HARD_FRAMES = 45
BENCH_HIGHWAY_FRAMES = 96
DEGRADE_CHUNKS = 24        # the full bench's timed chunks, for phase 9's degraded run
SYNTHETIC_FRAMES = 16      # phase 10's run_synthetic
SOAK_FRAMES = 512          # phase 11
# phase 12: the profilers' lengths (the full tables run at the JAX tools' r)
PROFILE_R = 2
PROFILE_BEST_OF = 3          # the rows the checks compare; a single run's wall can double
PROFILE_WINDOW_BEST_OF = 1   # the BA rows: only their device time is checked
PROFILE_COMPOSED_R = 1       # chunk_step and the feats scan, ~1 s an iteration
PROFILE_FLOOR_R = 20
DEVICE_OVER_WALL = 1.05      # a row's device time may exceed its wall by this
STAGES_OVER_WHOLE = 1.25     # sub-stage device ms against the composed row's
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
TOPK_R = 2                   # phase 13(c)'s r
SHARE_BOUND = 1.05           # a roofline share above it is a wrong count or time


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
        gathers.append(dict(
            shape=[int(yx.shape[0]), P, P], max_abs_err=float((pk - pp).abs().max()),
            ms=ms(lambda: patch_kernel.gather_patches_cuda(blurred, yx, P, fh)),
            plain_ms=ms(lambda: patch_kernel.gather_patches_plain(blurred, yx, P, fh), reps=10),
            library_ms=ms(lambda: flat[idx]),
            **measure.gather_levels_bound([(blurred, yx, fh)], P)))
        if i == 0:
            patches0 = pk
    # the main path's call: every level in one launch, bit-exact against
    # its plain version as a whole and level by level, L2-warm (back to
    # back) and L2-cold; the yardstick is one flat-index gather over the
    # levels' images, joined outside the timed call
    blurred_all = [b for b, _, _ in inp["gathers"]]
    yx_all = [yx for _, yx, _ in inp["gathers"]]
    fh_all = [fh for _, _, fh in inp["gathers"]]
    ak = patch_kernel.gather_patches_levels_cuda(blurred_all, yx_all, P, fh_all)
    ap = patch_kernel.gather_patches_levels_plain(blurred_all, yx_all, P, fh_all)
    joined = torch.cat([b.view(-1) for b in blurred_all])
    idx_all, base = [], 0
    for blurred, yx, fh in inp["gathers"]:
        y0, x0 = im_ops.patch_origins(yx, blurred.shape, P, fh)
        ar = torch.arange(P, device=dev)
        idx_all.append(base + (y0[:, None, None] + ar[None, :, None]) * blurred.shape[1]
                       + x0[:, None, None] + ar[None, None, :])
        base += blurred.numel()
    idx_all = torch.cat(idx_all)
    sync()
    start = 0
    for i, g in enumerate(gathers):
        rows = slice(start, start + g["shape"][0])
        if not torch.equal(ak[rows], ap[rows]):
            raise AssertionError(f"gather_patches_levels differs from plain at L{i}")
        start = rows.stop
    if not (torch.equal(ak, ap) and torch.equal(joined[idx_all], ap)):
        raise AssertionError("gather_patches_levels differs from plain over all levels")
    whole = measure.gather_levels_bound(inp["gathers"], P)

    def one():
        return patch_kernel.gather_patches_levels_cuda(blurred_all, yx_all, P, fh_all)

    # the row's keys of one level (L0) and its per-level sums keep their
    # meaning; the all-levels launch has keys of its own
    results["gather_patches"] = dict(
        gathers[0], levels=gathers, sum_ms=sum(g["ms"] for g in gathers),
        sum_library_ms=sum(g["library_ms"] for g in gathers),
        sum_bound_ms=sum(g["bound_ms"] for g in gathers),
        all_levels_shape=[int(ak.shape[0]), P, P],
        all_levels_max_abs_err=float((ak - ap).abs().max()),
        all_levels_ms=ms(one), all_levels_ms_l2_cold=measure.device_ms_cold(one),
        all_levels_plain_ms=ms(lambda: patch_kernel.gather_patches_levels_plain(
            blurred_all, yx_all, P, fh_all), reps=10),
        all_levels_library_ms=ms(lambda: joined[idx_all]),
        **{"all_levels_" + k: v for k, v in whole.items()})
    # the first chunk through batch_extract (one gather launch) equals its
    # composition through the per-level describe, bit for bit, at B=8 (the
    # chunk path) and B=1 (the host driver)
    results["gather_patches"]["extract_bit_equal"] = check_extract_composition(cfg, frames, dev)
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
    a = results["gather_patches"]
    log("gather_patches: bit-exact at " + ", ".join(
        f"L{i} {g['shape'][0]} {g['ms']:.4f} ms" for i, g in enumerate(gathers))
        + f" (sum {a['sum_ms']:.4f} ms); all levels in one launch, bit-exact per level and "
        f"whole: {a['all_levels_shape'][0]} patches in {a['all_levels_ms']:.4f} ms L2-warm, "
        f"{a['all_levels_ms_l2_cold']:.4f} ms L2-cold, bound {a['all_levels_bound_ms']:.4f} ms "
        f"({a['all_levels_covered_pixels']} of {a['all_levels_image_pixels']} pixels under the "
        f"windows; {a['all_levels_whole_image_bound_ms']:.4f} ms reading whole images), plain "
        f"{a['all_levels_plain_ms']:.4f} ms, joined[idx] {a['all_levels_library_ms']:.4f} ms; "
        f"batch_extract bit-equal to the per-level composition at B={CHUNK} and B=1; "
        f"BRIEF bit flips card vs CPU: upright {flips[False]}, steered "
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
    results.update(check_pnp(cfg, dev))
    sync()
    return results


def check_pnp(cfg, dev):
    """K4, K5: PnP-RANSAC's kernels (ops/kernels/pnp_kernel) at the
    tracker's shapes on PNP_SCENES (measure.pnp_inputs), against the plain
    path: the minimal sets, T_hyp and scores bit-equal (NaN where the
    plain path has NaN), the final pose within PNP_POSE_ATOL; the device
    times of each kernel, of the plain hypothesis stage and of the plain
    path whole, and each kernel's bound."""
    from stereo_visual_slam_tpu_torch.ops.kernels import measure, pnp_kernel
    from stereo_visual_slam_tpu_torch.tracking import pnp

    pc = cfg.pnp
    hkw = dict(sample_size=pc.sample_size, inlier_px=pc.inlier_px,
               gn_iters_hypothesis=pc.gn_iters_hypothesis)
    rkw = dict(inlier_px=pc.inlier_px, gn_iters_refine=pc.gn_iters_refine, huber_px=pc.huber_px)
    kw = dict(hkw, **rkw)
    ms = measure.device_ms
    gaps, scenes = [], []
    for seed, spread in PNP_SCENES:
        args = measure.pnp_inputs(cfg, seed, dev)
        H, N = args[5].shape
        spread = torch.tensor(spread, device=dev)
        half, rot_w = pnp._start_weights(H, torch.float32, dev)
        hyp = pnp_kernel.pnp_hypotheses(*args, half, rot_w, spread, **hkw)
        got = pnp_kernel.pnp_refine(*args[:5], hyp.T_hyp, hyp.scores, **rkw)
        idx, T_hyp, scores, _ = pnp.hypotheses_plain(*args, prior_spread=spread, **hkw)
        want = pnp.solve_pnp_ransac_plain(*args, prior_spread=spread, **kw)
        sync()
        same_T = (hyp.T_hyp == T_hyp) | (torch.isnan(hyp.T_hyp) & torch.isnan(T_hyp))
        if not (torch.equal(hyp.sample_idx, idx) and bool(same_T.all())
                and torch.equal(hyp.scores, scores)):
            raise AssertionError(
                f"pnp_hypotheses differs from plain (seed {seed}): minimal sets "
                f"{int((hyp.sample_idx != idx).any(dim=1).sum())}, poses "
                f"{int((~same_T).any(dim=(1, 2)).sum())}, scores "
                f"{int((hyp.scores != scores).sum())} of {H} hypotheses")
        gap = float((got[0] - want.T_c_w).abs().max())
        if not gap <= PNP_POSE_ATOL:
            raise AssertionError(f"pnp_refine: pose {gap} from plain (seed {seed}) > "
                                 f"{PNP_POSE_ATOL}")
        gaps.append(gap)
        scenes.append((args, spread, half, rot_w, hyp))
    args, spread, half, rot_w, hyp = scenes[0]
    rows = {}
    for name, work, kernel, plain in (
            ("pnp_hypotheses", measure.pnp_hypotheses_work(H, N, pc.sample_size,
                                                           pc.gn_iters_hypothesis),
             lambda: pnp_kernel.pnp_hypotheses(*args, half, rot_w, spread, **hkw),
             lambda: pnp.hypotheses_plain(*args, prior_spread=spread, **hkw)),
            ("pnp_refine", measure.pnp_refine_work(H, N, pc.gn_iters_refine),
             lambda: pnp_kernel.pnp_refine(*args[:5], hyp.T_hyp, hyp.scores, **rkw), None)):
        bms, by = measure.bound(*work)
        rows[name] = dict(shape=[H, N], max_abs_err=0.0 if name == "pnp_hypotheses" else max(gaps),
                          ms=ms(kernel), plain_ms=None if plain is None else ms(plain, reps=5),
                          bound_ms=bms, bound_by=by, library_ms=None)
    rows["pnp_refine"]["plain_both_ms"] = ms(
        lambda: pnp.solve_pnp_ransac_plain(*args, prior_spread=spread, **kw), reps=5)
    a, b = rows["pnp_hypotheses"], rows["pnp_refine"]
    log(f"pnp: H={H} N={N}, {len(PNP_SCENES)} scenes: minimal sets, hypotheses and scores "
        f"bit-equal to plain, final pose within {max(gaps):.3g} (atol {PNP_POSE_ATOL}); "
        f"pnp_hypotheses {a['ms']:.4f} ms (bound {a['bound_ms']:.6f}, plain stage "
        f"{a['plain_ms']:.3f}), pnp_refine {b['ms']:.4f} ms (bound {b['bound_ms']:.6f}); the "
        f"plain path whole {b['plain_both_ms']:.3f} ms")
    return rows


def check_extract_composition(cfg, frames, dev):
    """batch_extract's FrameFeatures on the first chunk (B=CHUNK) and on
    its first frame (B=1), each bit-equal to the same extraction composed
    through the per-level ExtractStages.describe, and one patch-gather
    launch a batch_extract call."""
    from stereo_visual_slam_tpu_torch.models import frontend
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.profiling import production

    images = production.pack(cfg, frames[:CHUNK], dev)
    batch_extract = frontend.make_batch_extractor(cfg, dev, with_depth=True)
    st = batch_extract.stages
    for imgs in (images, images[:1]):
        kernels.reset_launch_counts()
        got = batch_extract(imgs)
        sync()
        launched = kernels.launch_counts()
        left = imgs[:, 0].float()
        per_level = []
        for i in range(len(st.levels)):
            stacked, scores, yx = st.detect(i, st.level_image(left, i))
            per_level.append((scores, yx, *st.describe(i, st.blur(stacked), yx)))
        ref = st.merge(imgs, per_level, True)
        sync()
        differ = [k for k, a, b in zip(frontend.FrameFeatures._fields, got, ref)
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"batch_extract at B={imgs.shape[0]} differs from the per-level "
                                 f"composition in {differ}")
        if launched["gather_patches"] != 1 or launched["fast_nms"] != len(st.levels):
            raise AssertionError(f"batch_extract at B={imgs.shape[0]} launched {launched}")
    return True


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


def held_to_reference(stats, estimates, world, run, label):
    """Phases 4-5: the run against the JAX package's run of the same world
    by the same driver; a miss of the bound raises."""
    from stereo_visual_slam_tpu_torch.pipeline import reference_runs

    ref = reference_runs.load()
    if ref["world"] != dict(config="Config()", n_frames=FRAMES, n_points=N_POINTS, seed=SEED):
        raise AssertionError(f"{label}: the reference runs are of another world: {ref['world']}")
    gaps = reference_runs.compare(reference_runs.records(stats, estimates), ref["runs"][run],
                                  world.poses_T_c_w)
    log(f"{label} against the JAX package's run ({ref['runs'][run]['driver']}, jax "
        f"{ref['jax_version']} on the CPU): {reference_runs.summary(gaps)}")
    missed = reference_runs.misses(gaps)
    if missed:
        raise AssertionError(f"{label}: outside the bound of the JAX package's run: {missed}")
    return gaps


def check_launches(launches, label):
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched: {missing}")
    if launches["pnp_hypotheses"] != launches["pnp_refine"]:
        raise AssertionError(f"{label}: PnP's kernels launched unequally: {launches}")


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
    check_extracts(launches, FRAMES // CHUNK, cfg.frontend.n_levels, "slice")
    slam.reference_gaps = held_to_reference(slam.stats, slam.estimates, world, "chunked",
                                           "slice")
    return launches, slam, wall


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
    check_extracts(launches, FRAMES, cfg.frontend.n_levels, "host")
    if launches["zncc_sweep"] < n:
        raise AssertionError(f"host: ZNCC launched {launches['zncc_sweep']} times for {n} frames")
    gaps = held_to_reference(vo.stats, vo.estimates, world, "host", "host")
    return launches, dict(frames_per_s=n / wall, syncs_per_frame=vo.syncs / n,
                          reference_gaps=gaps)


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
    check_extracts(launches, REF_FRAMES // CHUNK, cfg_ref.frontend.n_levels, "reference config")
    return launches


def compare_schedules(cfg, mesh, dev, exact):
    """The BA schedule on `mesh` against the single-device schedule at each
    window of MESH_WINDOWS: the gap, and each one's median ms per run over
    SCHEDULE_REPS runs taken in turns. `exact`: bit-equal required."""
    from stereo_visual_slam_tpu_torch.ba import schedule as ba_schedule
    from stereo_visual_slam_tpu_torch.profiling import window

    single = ba_schedule.make_ba_schedule(cfg.ba)
    sharded = ba_schedule.make_ba_schedule(cfg.ba, mesh=mesh)
    out = {}
    for nK, L in MESH_WINDOWS:
        inp, K = window.make_window(L, nK, seed=WINDOW_SEED, device=dev, camera=cfg.camera)
        a, b = single(inp, K), sharded(inp, K)   # also the warm-up
        sync()
        t_err = float((a.T_c_w - b.T_c_w).abs().max())
        same_inlier = bool(torch.equal(a.inlier, b.inlier))
        cost_rel = abs(float(a.cost_full) - float(b.cost_full)) / abs(float(a.cost_full))
        if exact:
            ok = all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            ok = t_err <= 2e-4 and same_inlier and cost_rel <= 1e-4
        times = {"single": [], "sharded": []}
        for i in range(SCHEDULE_REPS):
            for name in (("single", "sharded") if i % 2 == 0 else ("sharded", "single")):
                run = single if name == "single" else sharded
                sync()
                t0 = time.perf_counter()
                run(inp, K)
                sync()
                times[name].append(1e3 * (time.perf_counter() - t0))
        out[f"Kw{nK}_L{L}"] = dict(
            ok=ok, pose_max_abs_err=t_err, inlier_equal=same_inlier, cost_full_rel_err=cost_rel,
            n_inlier=int(a.inlier.sum()), ms_single=float(np.median(times["single"])),
            ms_sharded=float(np.median(times["sharded"])))
    return out


def same_run(a, b):
    """What differs between two ChunkedSlam runs: the per-frame records,
    the poses or any array of the final carry (empty: bit-equal)."""
    from stereo_visual_slam_tpu_torch.pipeline import chunked

    return chunked.differences(a, b)


def run_mesh_one_rank(frames, cfg, ref, dev):
    """Phase 7(a): phase 4's slice on a one-rank NCCL mesh, bit-equal to
    phase 4's run (`ref`)."""
    import torch.distributed as dist

    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils

    dist_utils.initialize_distributed(world_size=1, rank=0, device=dev)
    try:
        if dist.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"phase 7(a): backend {dist.get_backend()}, not nccl")
        mesh = dist_utils.make_landmark_mesh(1)
        schedules = compare_schedules(cfg, mesh, dev, exact=True)
        slam = ChunkedSlam(cfg, chunk=CHUNK, device=dev, mesh=mesh)
        kernels.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        slam.run(frames, stage=False)
        slam.finish()
        sync()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        dist_utils.shutdown()
    n_ba = sum(1 for s in slam.stats if s["ba_cost"] is not None)
    diff = same_run(slam, ref)
    for name, r in schedules.items():
        log(f"mesh (a) NCCL, 1 rank: schedule {name}: {r['ms_sharded']:.3f} ms per BA run "
            f"on the mesh, {r['ms_single']:.3f} ms unsharded; bit-equal {r['ok']}")
    log(f"mesh (a) NCCL, 1 rank: {len(slam.stats)} frames in {wall:.3f} s, BA runs {n_ba}, "
        f"syncs/frame {slam.syncs / len(slam.stats):.3f}; differs from phase 4 in: "
        f"{diff or 'nothing'}; launches {launches}")
    if diff or not all(r["ok"] for r in schedules.values()):
        raise AssertionError("phase 7(a): the one-rank mesh is not bit-equal to no mesh")
    if n_ba < 1:
        raise AssertionError("phase 7(a): BA never ran")
    check_extracts(launches, FRAMES // CHUNK, cfg.frontend.n_levels, "mesh (a)")
    return launches, dict(wall_s=wall, schedules=schedules)


def mesh_rank(rank, n, port, tmp, cfg, dev):
    """One rank of phase 7(b), in a spawned process (which imports this
    file as __mp_main__: nothing runs at import)."""
    from stereo_visual_slam_tpu_torch.models import slam_core
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline import trajectory as traj
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils import dist as dist_utils

    dist_utils.initialize_distributed("127.0.0.1", n, rank, master_port=port, device=dev,
                                      backend="gloo")
    try:
        mesh = dist_utils.make_landmark_mesh(n)
        out = {"schedules": compare_schedules(cfg, mesh, dev, exact=False)}
        with np.load(os.path.join(tmp, "inputs.npz")) as z:
            z = dict(z)
        frames = list(zip(z["fids"].tolist(), z["left"], z["right"]))
        warm = ChunkedSlam(cfg, chunk=CHUNK, device=dev, mesh=mesh)
        warm.run(frames[:CHUNK], stage=False)
        slam = ChunkedSlam(cfg, chunk=CHUNK, device=dev, mesh=mesh)
        kernels.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        slam.run(frames, stage=False)
        slam.finish()
        sync()
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = kernels.launch_counts()
        fids = sorted(slam.estimates)
        est = np.stack([slam.estimates[f] for f in fids])
        ref = dict(zip(z["ref_fids"].tolist(), z["ref_T"]))
        gaps = [float(np.linalg.norm(np.linalg.inv(slam.estimates[f])[:3, 3]
                                     - np.linalg.inv(ref[f])[:3, 3])) for f in fids if f in ref]
        out.update(
            n=len(slam.stats), lost=slam.lost, syncs=slam.syncs, n_compared=len(gaps),
            tracked=sum(1 for s in slam.stats if s["state"] == "tracked"),
            n_ba=sum(1 for s in slam.stats if s["ba_cost"] is not None),
            max_gap_m=max(gaps), finite=bool(np.isfinite(est).all()),
            ate=traj.ate_rmse(est, z["gt"][fids]),
            trans=traj.kitti_errors(est, z["gt"][fids])[0])
        np.savez(os.path.join(tmp, f"carry{rank}.npz"), **slam_core.carry_to_numpy(slam.carry))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist_utils.shutdown()


def run_mesh_two_ranks(frames, world, cfg, ref, dev):
    """Phase 7(b): MESH_RANKS ranks spawned on the one card over gloo."""
    import multiprocessing

    with tempfile.TemporaryDirectory() as tmp:
        fids = sorted(ref.estimates)
        np.savez(os.path.join(tmp, "inputs.npz"), fids=np.array([f for f, _, _ in frames]),
                 left=np.stack([lf for _, lf, _ in frames]), right=np.stack([r for _, _, r in frames]),
                 gt=world.poses_T_c_w, ref_fids=np.array(fids),
                 ref_T=np.stack([ref.estimates[f] for f in fids]))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=mesh_rank, args=(r, MESH_RANKS, port, tmp, cfg, dev))
                 for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            while any(p.is_alive() for p in procs):
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.perf_counter() - t0 > MESH_TIMEOUT_S:
                    raise AssertionError(f"phase 7(b): rank exit codes {[p.exitcode for p in procs]} "
                                         f"after {time.perf_counter() - t0:.0f} s")
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"phase 7(b): rank exit codes {[p.exitcode for p in procs]}")
        results = []
        carries = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
            with np.load(os.path.join(tmp, f"carry{r}.npz")) as z:
                carries.append(dict(z))
    unequal = [k for k in carries[0] if any(not np.array_equal(c[k], carries[0][k])
                                            for c in carries[1:])]
    for r, res in enumerate(results):
        for name, sc in res["schedules"].items():
            log(f"mesh (b) gloo, rank {r} of {MESH_RANKS} on one card: schedule {name}: "
                f"{sc['ms_sharded']:.3f} ms per BA run on the mesh, {sc['ms_single']:.3f} ms "
                f"unsharded; pose max |err| {sc['pose_max_abs_err']:.3g}, inliers equal "
                f"{sc['inlier_equal']} ({sc['n_inlier']}), cost rel err {sc['cost_full_rel_err']:.3g}")
        log(f"mesh (b) gloo, rank {r}: {res['n']} frames in {res['wall_s']:.3f} s; tracked "
            f"{res['tracked']}, BA runs {res['n_ba']}, lost {res['lost']}; ATE {res['ate']:.3f} m, "
            f"KITTI trans {res['trans']:.3f} %; max gap to phase 4 {res['max_gap_m']:.3g} m over "
            f"{res['n_compared']} frames; syncs/frame {res['syncs'] / res['n']:.3f}; "
            f"launches {res['launches']}")
    log(f"mesh (b): ranks' final carries differ in: {unequal or 'nothing'}")
    for r, res in enumerate(results):
        if not all(sc["ok"] for sc in res["schedules"].values()):
            raise AssertionError(f"phase 7(b) rank {r}: the sharded schedule misses its tolerances")
        if res["lost"] or res["n"] != FRAMES or res["tracked"] < 0.9 * res["n"]:
            raise AssertionError(f"phase 7(b) rank {r}: lost or tracked {res['tracked']} of {res['n']}")
        if res["n_ba"] < 1:
            raise AssertionError(f"phase 7(b) rank {r}: BA never ran on the mesh")
        if not res["finite"] or res["ate"] > DEFAULT_GATES["ate"] or res["trans"] > DEFAULT_GATES["trans"]:
            raise AssertionError(f"phase 7(b) rank {r}: misses the accuracy gates")
        if res["n_compared"] < 0.9 * FRAMES or res["max_gap_m"] > MESH_POSE_BOUND_M:
            raise AssertionError(f"phase 7(b) rank {r}: {res['max_gap_m']} m from phase 4")
        check_extracts(res["launches"], FRAMES // CHUNK, cfg.frontend.n_levels,
                       f"mesh (b) rank {r}")
    if unequal:
        raise AssertionError(f"phase 7(b): the ranks' carries differ in {unequal}")
    return results


# Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by colour type


def png_chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def png_scanlines(img: np.ndarray, depth: int, first: int) -> bytes:
    """`img`'s rows (h, w, channels) of samples as PNG scanlines: packed
    (1/2/4 bits MSB first, 16 bits big-endian), each behind its filter type
    (first + r) % 5 for row r: None, Sub, Up, Average, Paeth in turn. The
    predictors read the original samples, so numpy filters every row at
    once."""
    h, w, ch = img.shape
    if depth < 8:
        per = 8 // depth
        x = np.zeros((h, -(-w // per) * per), np.uint8)
        x[:, :w] = img[:, :, 0]
        x = x.reshape(h, -1, per) << (8 - depth * (1 + np.arange(per, dtype=np.uint8)))
        x = np.bitwise_or.reduce(x, axis=2)
    else:
        x = np.ascontiguousarray(img, dtype=">u2" if depth == 16 else np.uint8)
        x = x.view(np.uint8).reshape(h, -1)
    x = x.astype(np.int16)
    bpp = max(1, ch * depth // 8)
    a = np.zeros_like(x)   # left: the same row, one pixel back
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)   # up
    b[1:] = x[:-1]
    c = np.zeros_like(x)   # up-left
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    predictors = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth])
    kind = (first + np.arange(h)) % 5
    rows = ((x - predictors[kind, np.arange(h)]) & 0xFF).astype(np.uint8)
    return np.concatenate([kind[:, None].astype(np.uint8), rows], axis=1).tobytes()


def png_bytes(img: np.ndarray, level: int = 6, first: int = 0, *, color: int = 0,
              depth: int | None = None, interlace: int = 0, palette=None, trns=None,
              gamma: int | None = None, srgb: int | None = None, chrm=None) -> bytes:
    """A PNG of `img` built on the standard library and numpy alone (the
    card's machine need not have Pillow). `img` holds the samples: (h, w)
    for gray and palette indices, (h, w, channels) for the other colour
    types; `depth` is 8 for uint8 and 16 for uint16 unless given (1, 2 and 4
    for gray and palette). `interlace=1` writes Adam7. Optional chunks:
    `palette` (n, 3) -> PLTE, `trns` -> tRNS (the gray sample, the RGB
    triple or the palette's alphas), `gamma` -> gAMA (x 100000), `srgb` ->
    sRGB (its rendering intent), `chrm` -> cHRM (8 values x 100000). Rows
    cycle through the five filter types from `first` (across the passes at
    Adam7)."""
    img = np.asarray(img)
    if depth is None:
        depth = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}[img.dtype]
    samples = img.reshape(img.shape[0], img.shape[1], PNG_CHANNELS[color])
    h, w = samples.shape[:2]
    if interlace:
        raw, row = [], first
        for x0, y0, dx, dy in ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw.append(png_scanlines(sub, depth, row))
                row += sub.shape[0]
        raw = b"".join(raw)
    else:
        raw = png_scanlines(samples, depth, first)
    chunks = [png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))]
    if gamma is not None:
        chunks.append(png_chunk(b"gAMA", struct.pack(">I", gamma)))
    if chrm is not None:
        chunks.append(png_chunk(b"cHRM", struct.pack(">8I", *chrm)))
    if srgb is not None:
        chunks.append(png_chunk(b"sRGB", bytes([srgb])))
    if palette is not None:
        chunks.append(png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        fmt = "B" if color == 3 else "H"
        chunks.append(png_chunk(b"tRNS", struct.pack(f">{len(trns)}{fmt}", *trns)))
    chunks += [png_chunk(b"IDAT", zlib.compress(raw, level)), png_chunk(b"IEND", b"")]
    return PNG_SIGNATURE + b"".join(chunks)


# phase 8(a2)'s PNG kinds, each carrying an 8-bit gray image losslessly
MIXED_KINDS = ("rgb", "rgba", "palette", "adam7", "gray_alpha", "gray16")


def lossless_png(img: np.ndarray, kind: str, first: int = 0) -> bytes:
    """An 8-bit gray image as a PNG of `kind` that decodes back to it: RGB
    with three equal channels, RGBA with equal channels and varying alpha,
    a 256-entry gray palette, Adam7 gray, gray+alpha, or 16-bit gray whose
    high byte is the pixel. No kind takes a gamma chunk."""
    h, w = img.shape
    vary = (np.add.outer(np.arange(h), 3 * np.arange(w)) % 256).astype(np.uint8)
    if kind == "rgb":
        return png_bytes(np.repeat(img[..., None], 3, axis=2), first=first, color=2)
    if kind == "rgba":
        return png_bytes(np.dstack([img, img, img, vary]), first=first, color=6)
    if kind == "palette":
        ramp = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
        return png_bytes(img, first=first, color=3, palette=ramp)
    if kind == "adam7":
        return png_bytes(img, first=first, interlace=1)
    if kind == "gray_alpha":
        return png_bytes(np.dstack([img, vary]), first=first, color=4)
    if kind == "gray16":
        return png_bytes((img.astype(np.uint16) << 8) | vary, first=first)
    raise ValueError(f"unknown PNG kind {kind!r}")


def write_kitti(root, frames, world, cam, kinds=None):
    """The frames as sequence 00 of a KITTI odometry tree under `root`:
    8-bit gray PNGs of what the slice reads (the pixels cast to uint8, as
    ChunkedSlam's upload does) or, with `kinds`, frame f's left image as
    kind f and its right image as kind f + 3 of them in turn
    (lossless_png); calib.txt and the ground-truth poses, each number
    written with repr so that it parses back exactly."""
    seq = os.path.join(root, "sequences", "00")
    for side in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, side))
    for f, left, right in frames:
        for side, img, shift in (("image_0", left, 0), ("image_1", right, 3)):
            img = img.astype(np.uint8)
            data = (png_bytes(img, first=f) if kinds is None
                    else lossless_png(img, kinds[(f + shift) % len(kinds)], first=f))
            with open(os.path.join(seq, side, f"{f:06d}.png"), "wb") as fh:
                fh.write(data)
    fx, fy, cx, cy = (float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    tx = -fx * float(cam.baseline)
    with open(os.path.join(seq, "calib.txt"), "w") as fh:
        fh.write(f"P0: {fx!r} 0 {cx!r} 0 0 {fy!r} {cy!r} 0 0 0 1 0\n"
                 f"P1: {fx!r} 0 {cx!r} {tx!r} 0 {fy!r} {cy!r} 0 0 0 1 0\n")
    os.makedirs(os.path.join(root, "poses"))
    with open(os.path.join(root, "poses", "00.txt"), "w") as fh:
        for T in world.poses_T_c_w:
            fh.write(" ".join(repr(float(v)) for v in np.linalg.inv(T)[:3, :4].reshape(-1)) + "\n")


def check_decoded(seq, frames, label):
    """Every frame of `seq`, in order, byte-equal to the rendered ones."""
    with contextlib.closing(seq.frames()) as decoded:
        for (i, left, right), (f, l0, r0) in zip(decoded, frames, strict=True):
            if i != f or not (np.array_equal(left, l0.astype(np.uint8))
                              and np.array_equal(right, r0.astype(np.uint8))):
                raise AssertionError(f"{label}: frame {i} (expected {f}) differs")


def gray_of_rgb(rgb: np.ndarray) -> np.ndarray:
    """8-bit gray of RGB samples (h, w, 3), uint8 or uint16, with no gamma
    or colour chunk, as libpng's rgb_to_gray and strip_16 give it: weights
    6968 / 23434 / 2366 of 32768; at 8 bits truncated, and R itself where
    the three are equal; at 16 bits rounded, then the high byte."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    dot = 6968 * r + 23434 * g + 2366 * b
    if rgb.dtype == np.uint8:
        return np.where((r == g) & (r == b), r, dot >> 15).astype(np.uint8)
    return (((dot + 16384) >> 15) >> 8).astype(np.uint8)


def check_rgb_model(root):
    """Phase 8(e): small 8- and 16-bit RGB images with unequal channels
    decode to gray_of_rgb's bytes."""
    from stereo_visual_slam_tpu_torch.utils import native

    rng = np.random.default_rng(8)
    for dtype in (np.uint8, np.uint16):
        rgb = rng.integers(0, np.iinfo(dtype).max + 1, size=(37, 53, 3)).astype(dtype)
        path = os.path.join(root, f"rgb{rgb.itemsize * 8}.png")
        with open(path, "wb") as fh:
            fh.write(png_bytes(rgb, color=2))
        if not np.array_equal(native.read_image_gray(path), gray_of_rgb(rgb)):
            raise AssertionError(f"phase 8(e): {rgb.itemsize * 8}-bit RGB differs from the model")
    return "8- and 16-bit RGB, 37x53, byte-equal to gray_of_rgb"


def decode_rates(seq, every_way=True):
    """Phase 8(b): frames/s of four ways of reading the sequence (each
    stereo pair decoded once), or of the prefetcher's two alone, median of
    DECODE_REPS runs taken in turns."""
    from stereo_visual_slam_tpu_torch.utils import native

    dirs = [os.path.join(seq.seq_dir, side) for side in ("image_0", "image_1")]
    paths = [os.path.join(d, f"{i:06d}.png") for i in range(seq.n_frames) for d in dirs]
    hw = seq.frame_hw()

    def prefetch(workers):
        def run():
            with native.StereoPrefetcher(*dirs, count=seq.n_frames, hw=hw, depth=8,
                                         workers=workers) as pf:
                for _ in pf:
                    pass
        return run

    def by_frame():
        for p in paths:
            native.read_image_gray(p)

    ways = {"prefetch_workers1": prefetch(1), "prefetch_workers4": prefetch(4)}
    if every_way:
        ways["read_image_gray"] = by_frame
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if every_way and Image is not None:
        def pil():
            for p in paths:
                with Image.open(p) as im:
                    np.asarray(im.convert("L"), dtype=np.uint8)
        ways["pil"] = pil
    times = {k: [] for k in ways}
    names = list(ways)
    for rep in range(DECODE_REPS):
        for k in names[rep % len(names):] + names[:rep % len(names)]:
            t0 = time.perf_counter()
            ways[k]()
            times[k].append(time.perf_counter() - t0)
    rates = {k: seq.n_frames / float(np.median(v)) for k, v in times.items()}
    if every_way:
        rates.setdefault("pil", "absent")
    return rates


def rolling_from(seq, cfg, pose_path):
    """ChunkedSlam.run_rolling (window DATASET_WINDOW) fed by seq.frames();
    the ChunkedSlam, its wall and the kernels' launches in the run."""
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam

    slam = ChunkedSlam(cfg, chunk=CHUNK, device="cuda", pose_path=pose_path)
    kernels.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    with contextlib.closing(seq.frames()) as source:
        slam.run_rolling(source, window_chunks=DATASET_WINDOW)
    slam.finish()
    sync()
    return slam, time.perf_counter() - t0, kernels.launch_counts()


def run_dataset(frames, world, cfg, ref, ref_wall):
    """Phase 8: the KITTI entry point, from PNG files through the port's
    native runtime to the card; `ref` and `ref_wall` are phase 4's run."""
    from stereo_visual_slam_tpu_torch import run_vslam
    from stereo_visual_slam_tpu_torch.data import kitti
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.utils import native

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"phase 8: the native runtime is not available:\n{native.load_error()}")
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        mixed_root = os.path.join(root, "mixed")
        t0 = time.perf_counter()
        write_kitti(root, frames, world, cfg.camera)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_kitti(mixed_root, frames, world, cfg.camera, kinds=MIXED_KINDS)
        write_mixed_s = time.perf_counter() - t0
        log(f"dataset: native runtime {native.library_path()} ({build_s:.1f} s); "
            f"{len(frames)} stereo PNG pairs written in {write_s:.1f} s, in the kinds "
            f"{MIXED_KINDS} in {write_mixed_s:.1f} s")

        # (a) decode: every frame in order, byte-equal; the config back
        seq = kitti.open_sequence(root, "00")
        if seq.n_frames != FRAMES:
            raise AssertionError(f"phase 8(a): found {seq.n_frames} frames, wrote {FRAMES}")
        cfg_seq = kitti.config_for(seq, cfg)
        if dataclasses.asdict(cfg_seq) != dataclasses.asdict(cfg):
            raise AssertionError("phase 8(a): config_for(seq, Config()) differs from Config()")
        check_decoded(seq, frames, "phase 8(a)")
        log(f"dataset (a): {FRAMES} frames decoded in order, byte-equal; config_for == Config()")

        # (a2) the same frames from the tree of mixed PNG kinds
        mixed = kitti.open_sequence(mixed_root, "00")
        if mixed.n_frames != FRAMES:
            raise AssertionError(f"phase 8(a2): found {mixed.n_frames} frames, wrote {FRAMES}")
        check_decoded(mixed, frames, "phase 8(a2)")
        log(f"dataset (a2): {FRAMES} frames of the kinds {MIXED_KINDS} decoded in order, "
            "byte-equal")

        # (b) decode rates on the card's host
        rates = decode_rates(seq)
        rates_mixed = decode_rates(mixed, every_way=False)
        for label, r in (("gray", rates), ("mixed", rates_mixed)):
            log("dataset (b): %s tree, frames/s, median of %d: %s; os.cpu_count() %d" % (
                label, DECODE_REPS, ", ".join(f"{k} {v if isinstance(v, str) else f'{v:.1f}'}"
                                              for k, v in r.items()), os.cpu_count()))

        # (c) the slice fed from the files, (c2) from the mixed kinds
        runs = {}
        for label, tree in (("c", seq), ("c2", mixed)):
            pose = os.path.join(root, f"rolling_{label}.txt")
            slam, wall, launches = rolling_from(tree, cfg_seq, pose)
            diff = same_run(slam, ref)
            log(f"dataset ({label}): {len(slam.stats)} frames from files, run_rolling window "
                f"{DATASET_WINDOW}, in {wall:.3f} s (phase 4 streamed from memory: "
                f"{ref_wall:.3f} s); syncs/frame {slam.syncs / len(slam.stats):.3f}; differs "
                f"from phase 4 in: {diff or 'nothing'}; launches {launches}")
            if diff:
                raise AssertionError(f"phase 8({label}): the file-fed run differs from phase 4 "
                                     f"in {diff}")
            check_extracts(launches, FRAMES // CHUNK, cfg.frontend.n_levels, f"dataset ({label})")
            runs[label] = dict(pose=pose, wall=wall, launches=launches)
        pose_c = runs["c"]["pose"]

        # (d) the CLI on the gray tree
        pose_d = os.path.join(root, "cli.txt")
        out = io.StringIO()
        kernels.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run_vslam.main(["--dataset", root, "--sequence", "00", "--device", "cuda",
                                 "--rolling", str(DATASET_WINDOW), "--pose-out", pose_d,
                                 "--quiet"])
        sync()
        wall_d = time.perf_counter() - t0
        cli_launches = kernels.launch_counts()
        printed = out.getvalue()
        with open(pose_c, "rb") as a, open(pose_d, "rb") as b:
            same_poses = a.read() == b.read()
        log(f"dataset (d): run_vslam --dataset ... --rolling {DATASET_WINDOW} returned {rc} in "
            f"{wall_d:.3f} s; pose file byte-equal to (c)'s: {same_poses}; launches "
            f"{cli_launches}; it printed: " + " | ".join(printed.strip().splitlines()))
        if rc != 0 or not same_poses:
            raise AssertionError(f"phase 8(d): exit {rc}, pose file equal {same_poses}")
        if "ATE RMSE" not in printed or "KITTI trans" not in printed:
            raise AssertionError("phase 8(d): the CLI printed no ATE and KITTI line")
        check_extracts(cli_launches, FRAMES // CHUNK, cfg.frontend.n_levels, "dataset (d)")

        # (e) unequal channels against the numpy model of the conversion
        rgb_model = check_rgb_model(root)
        log(f"dataset (e): {rgb_model}")
    return dict(decode_frames_per_s=rates, mixed_decode_frames_per_s=rates_mixed,
                cpu_count=os.cpu_count(), write_s=write_s, write_mixed_s=write_mixed_s,
                rolling_wall_s=runs["c"]["wall"], mixed_rolling_wall_s=runs["c2"]["wall"],
                cli_wall_s=wall_d, phase4_wall_s=ref_wall, rgb_model=rgb_model,
                launches=runs["c"]["launches"], mixed_launches=runs["c2"]["launches"],
                cli_launches=cli_launches)


def check_extracts(launches, extracts, n_levels, label):
    """`extracts` batch_extract calls of an `n_levels` pyramid: every kernel
    launched, FAST+NMS once a level a call and the patch gather exactly
    once a call (its one launch for every level)."""
    check_launches(launches, label)
    want = {"fast_nms": n_levels * extracts, "gather_patches": extracts}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{label}: {extracts} batch_extract calls launch {want}, this run "
                             f"launched {got}")


def check_per_frame(launches, frames, keyframes, n_levels, label, per_call=CHUNK):
    """ZNCC at least once per keyframe, and one batch_extract call a chunk
    of `per_call` frames (the last one may be short): `check_extracts`."""
    check_extracts(launches, -(-frames // per_call), n_levels, label)
    if launches["zncc_sweep"] < keyframes:
        raise AssertionError(f"{label}: ZNCC launched fewer times than the {keyframes} "
                             f"keyframes: {launches}")


def run_bench_phase(cfg, renderer):
    """Phase 9: the port's bench in this process at a reduced length, then
    the bench's whole default world on the degraded config."""
    from stereo_visual_slam_tpu_torch import bench
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    sync()
    out = bench.run_bench(cfg, device="cuda", renderer=renderer, chunk=CHUNK,
                          n_chunks=BENCH_CHUNKS, runs=1, hard_frames=BENCH_HARD_FRAMES,
                          highway_frames=BENCH_HIGHWAY_FRAMES, log=log)
    log(f"bench: {json.dumps(out['line'])}")
    if list(out["line"]) != ["metric", "value", "unit", "vs_baseline"]:
        raise AssertionError(f"phase 9: the JSON line's keys are {list(out['line'])}")
    launches = {}
    for name, p in out["profiles"].items():
        if p["lost"] or not p["gate"]:
            raise AssertionError(f"phase 9: the {name} profile: lost {p['lost']}, {p['verdict']}")
        check_per_frame(p["launches"], p["frames"], p["keyframes"], cfg.frontend.n_levels,
                        f"bench {name}")
        launches[f"bench_{name}"] = p["launches"]
    if set(launches) != {"bench_default", "bench_hard", "bench_highway"}:
        raise AssertionError(f"phase 9: profiles run: {sorted(launches)}")
    roof = out["roofline"]   # run_bench raises unless the counted pass is bit-equal
    if not (0 < roof["mfu"] <= SHARE_BOUND and 0 < roof["hbm_util"] <= SHARE_BOUND):
        raise AssertionError(f"phase 9: the roofline pass: {roof}")
    # the gate self-test on the full bench's default world: over a few
    # chunks the degraded run's error can sit on the gate's line
    n = CHUNK * (bench.WARMUP_CHUNKS + DEGRADE_CHUNKS)
    world = synthetic.make_world(cfg, n_frames=n, n_points=8000, seed=0)
    t0 = time.perf_counter()
    _, bad = bench.run_sequence(bench.degraded(cfg), world, renderer.render_all(world), CHUNK,
                                "cuda")
    sync()
    bad["verdict"] = bench.gate_verdict("default", bad)
    log(f"bench, degraded PnP: default world, {n} frames in {time.perf_counter() - t0:.1f} s "
        f"(render included): tracked {bad['tracked']}/{n} ate={bad['ate']:.3f}m "
        f"trans={bad['trans']:.2f}% lost={bad['lost']} | {bad['verdict']}")
    if bench.binding_gate("default", bad):
        raise AssertionError("phase 9: the degraded run passes the binding gate")
    profiles = {k: {f: p[f] for f in ("ate", "trans", "rot", "tracked", "lost", "verdict",
                                      "frames", "keyframes")}
                for k, p in out["profiles"].items()}
    return launches, dict(bench=dict(out, profiles=profiles), degraded=bad)


def run_entry_points(cfg):
    """Phase 10: graft_entry's step once, its dry run on a one-rank NCCL
    mesh at production shapes, and the synthetic example as a process."""
    from stereo_visual_slam_tpu_torch import graft_entry
    from stereo_visual_slam_tpu_torch.ops import kernels

    launches = {}
    fn, args = graft_entry.entry("cuda", cfg)
    kernels.reset_launch_counts()
    sync()
    state, info = fn(*args)
    sync()
    launches["graft_entry"] = kernels.launch_counts()
    if not (torch.isfinite(state.T_c_w).all()
            and state.yx.shape == (cfg.frontend.max_raw_keypoints, 2)):
        raise AssertionError("phase 10: entry()'s step gave a bad state")
    check_per_frame(launches["graft_entry"], 1, 1, cfg.frontend.n_levels, "graft_entry", per_call=1)
    log(f"entry: step ran, {int(info.n_matches)} matches, {int(info.n_inliers)} inliers; "
        f"launches {launches['graft_entry']}")

    kernels.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(1, "cuda", cfg)
    sync()
    launches["dryrun_nccl_1"] = kernels.launch_counts()
    if dry["backend"] != "nccl" or dry["ba_runs"] < 1:
        raise AssertionError(f"phase 10: dryrun on {dry['backend']}, {dry['ba_runs']} BA runs")
    check_per_frame(launches["dryrun_nccl_1"], dry["frames"], dry["keyframes"],
                    cfg.frontend.n_levels, "dryrun_nccl_1")
    log(f"dryrun_multichip(1): NCCL, {dry['frames']} frames, {dry['keyframes']} keyframes, "
        f"{dry['ba_runs']} BA runs on the mesh in {time.perf_counter() - t0:.1f} s; launches "
        f"{launches['dryrun_nccl_1']}")

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "stereo_visual_slam_tpu_torch.run_synthetic",
                           str(SYNTHETIC_FRAMES), "--device", "cuda"], cwd=here, env=env,
                          capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    log(f"run_synthetic {SYNTHETIC_FRAMES} --device cuda: exit {proc.returncode} in {wall:.1f} s; "
        + " | ".join(line for line in lines if line and not line.startswith("frame ")))
    if proc.returncode != 0:
        raise AssertionError(f"phase 10: run_synthetic exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    launches["run_synthetic"] = json.loads(
        next(line for line in lines if line.startswith("kernel launches: "))[17:])
    tracked = next(line for line in lines if line.startswith("tracked "))
    n_kf = int(tracked.split(", ")[1].split()[0])
    if not tracked.startswith(f"tracked {SYNTHETIC_FRAMES}/{SYNTHETIC_FRAMES} "):
        raise AssertionError(f"phase 10: run_synthetic: {tracked}")
    check_per_frame(launches["run_synthetic"], SYNTHETIC_FRAMES, n_kf, cfg.frontend.n_levels,
                    "run_synthetic", per_call=1)
    return launches, dict(dryrun={k: v for k, v in dry.items() if k != "T_c_w"},
                          run_synthetic_wall_s=wall)


def run_short_soak(cfg, renderer):
    """Phase 11: the soak's run and checks at SOAK_FRAMES frames."""
    from stereo_visual_slam_tpu_torch import soak
    from stereo_visual_slam_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    sync()
    out = soak.run_soak(cfg, SOAK_FRAMES, CHUNK, device="cuda", renderer=renderer, log=log)
    sync()
    launches = kernels.launch_counts()
    slam = out.pop("slam")
    out.pop("world")
    out.pop("live_rows")
    for ok, msg in out["checks"]:
        log(f"soak {'ok' if ok else 'FAIL'}: {msg}")
    log(f"soak: {out['n_frames']} frames in {out['wall_s']:.1f} s ({out['fps_wall']:.2f} frames/s "
        f"wall), {out['n_keyframes']} keyframes, {out['n_evictions']} evictions, arena "
        f"{out['arena_live']} live at the end, high water {out['arena_high_water']}/"
        f"{out['arena_capacity']} (full after {out['arena_full_chunks']} of {out['arena_chunks']} "
        f"chunks), rss +{out['rss_growth_mb']:.1f} MB over {out['rss_chunks']} chunks; "
        f"launches {launches}")
    if not out["ok"] or out["n_evictions"] < 1 or len(slam.stats) != SOAK_FRAMES:
        raise AssertionError(f"phase 11: soak ok {out['ok']}, {out['n_evictions']} evictions")
    check_per_frame(launches, SOAK_FRAMES, out["n_keyframes"], cfg.frontend.n_levels, "soak")
    return launches, out


def run_profilers(cfg, frames, dev):
    """Phase 12: the four profilers at short lengths, on phase 4's first
    chunk, with their checks."""
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.profiling import production, scan_split, timing, window

    images = production.pack(cfg, frames[:production.B], dev)
    out, launches = {}, {}
    out["timing"] = timing.run(cfg, dev, r=PROFILE_FLOOR_R, best_of=PROFILE_BEST_OF)
    for name, run in (
            ("production", lambda: production.run(
                cfg, dev, r=PROFILE_R, best_of=PROFILE_BEST_OF, composed_r=PROFILE_COMPOSED_R,
                images=images)),
            ("scan_split", lambda: scan_split.run(cfg, dev, r=PROFILE_R, best_of=PROFILE_BEST_OF,
                                                  images=images)),
            ("window", lambda: window.run(
                cfg, dev, r=PROFILE_R, best_of=PROFILE_WINDOW_BEST_OF,
                growth_windows=MESH_WINDOWS[:1],
                shard_windows=MESH_WINDOWS[1:], scaling_L=MESH_WINDOWS[0][1],
                scaling_windows=MESH_WINDOWS[:1], cpu=False))):
        kernels.reset_launch_counts()
        sync()
        out[name] = run()
        sync()
        launches[f"profile_{name}"] = kernels.launch_counts()
    for name in ("timing", "production", "scan_split"):
        log(f"profile {name}:")
        log(timing.table(out[name]["rows"]))
    win = out["window"]
    rows = (out["timing"]["rows"] + out["production"]["rows"] + out["scan_split"]["rows"]
            + win["growth"] + win["shard_local"] + win["scaling"]["nccl"])
    log(timing.table(win["growth"] + win["shard_local"] + win["scaling"]["nccl"]))
    log(f"profile launches of the port's kernels: {launches}; the measurement's own cost: "
        f"{sum(r['timed_s'] for r in rows):.1f} s timed, {sum(r['traced_s'] for r in rows):.1f} s "
        f"traced")

    bad = [(r["label"], r["device_ms"], r["wall_ms"]) for r in rows
           if not 0 < r["device_ms"] <= r["wall_ms"] * DEVICE_OVER_WALL]
    if bad:
        raise AssertionError(f"phase 12: device ms outside (0, wall x {DEVICE_OVER_WALL}]: {bad}")
    prod = {r["label"].strip(): r for r in out["production"]["rows"]}
    n = cfg.frontend.n_levels
    in_rows = []
    for label, kernel in (("detect: score maps + nms_topk", "fast_nms"),
                          (f"describe ({n} levels)", "gather_patches"),
                          ("stereo zncc sweep", "zncc_sweep")):
        seen = prod[label]["hand_kernels"][kernel]
        if not seen["launches"] > 0:
            raise AssertionError(f"phase 12: no {timing.HAND_KERNELS[kernel]} in the profile of "
                                 f"the {label!r} row: {prod[label]['top_ops']}")
        in_rows.append(f"{kernel} in {label!r}: {seen['launches']:.1f} launches, "
                       f"{seen['device_ms']:.4f} ms")
    log("profile, per iteration: " + "; ".join(in_rows))
    labels = production.labels(cfg)
    stages = sum(prod[label.strip()]["device_ms"] for label in labels[4:9])
    whole = prod[labels[1]]["device_ms"]
    if not stages <= whole * STAGES_OVER_WHOLE:
        raise AssertionError(f"phase 12: the extractor's stages take {stages:.3f} device ms, "
                             f"batch_extract {whole:.3f}")
    split = {r["label"]: r["device_ms"] for r in out["scan_split"]["rows"]}
    parts = split["matcher"] + split["PnP-RANSAC"]
    track = split[scan_split.LABELS[1]]
    if not parts <= track * STAGES_OVER_WHOLE:
        raise AssertionError(f"phase 12: matcher + PnP take {parts:.3f} device ms, "
                             f"track_step {track:.3f}")
    if not all(r["bit_equal_no_mesh"] and r["backend"] == "nccl" for r in win["scaling"]["nccl"]):
        raise AssertionError("phase 12: the one-rank NCCL schedule is not bit-equal to no mesh")
    for name in ("profile_production", "profile_scan_split"):
        check_launches(launches[name], name)
    log(f"profilers, device ms: stages {stages:.3f} against batch_extract {whole:.3f}; matcher + "
        f"PnP {parts:.3f} against track_step {track:.3f}; every row's device time within its "
        f"wall")
    summary = {name: [{k: r[k] for k in ("label", "wall_ms", "device_ms", "launches", "syncs")}
                      for r in res.get("rows", [])] for name, res in out.items()}
    summary["window"] = {k: [{f: r[f] for f in ("label", "wall_ms", "device_ms", "launches")}
                             for r in v] for k, v in
                         (("growth", win["growth"]), ("shard_local", win["shard_local"]),
                          ("nccl", win["scaling"]["nccl"]))}
    return launches, summary


def run_roofline(cfg, frames, dev, production_rows):
    """Phase 13: the per-phase roofline report on phase 12's production
    times, the extractor's stage costs and the top-k study on phase 4's
    first chunk, and one chunk counted against the same chunk uncounted."""
    from stereo_visual_slam_tpu_torch.ops import kernels
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.profiling import (
        extract_cost, micro_topk, production, roofline_report,
    )
    from stereo_visual_slam_tpu_torch.utils import roofline

    kernels.reset_launch_counts()
    sync()
    images = production.pack(cfg, frames[:production.B], dev)
    report = roofline_report.run(cfg, dev, images=images,
                                 timings={r["label"]: r for r in production_rows})
    log(roofline_report.render(report))
    costs = extract_cost.run(cfg, dev, images)   # raises unless the stages sum to the TOTAL
    log(extract_cost.render(costs))
    topk = micro_topk.run(cfg, dev, r=TOPK_R, best_of=1)   # raises on a wrong claim
    log(micro_topk.render(topk))
    t0 = time.perf_counter()
    staged = ChunkedSlam(cfg, chunk=CHUNK, device=dev).stage(frames[:CHUNK])
    plain, counted = (ChunkedSlam(cfg, chunk=CHUNK, device=dev) for _ in range(2))
    plain.run_staged(staged)
    plain.finish()
    with roofline.Counter() as counter:
        counted.run_staged(staged)
        counted.finish()
    sync()
    launches = kernels.launch_counts()
    diff = same_run(plain, counted)
    log(f"roofline (d): one chunk counted in {time.perf_counter() - t0:.1f} s with its uncounted "
        f"twin: {counter.flops / 1e9:.4f} GFLOP, {counter.bytes_accessed / 1e9:.4f} GB, kernel "
        f"units {counter.units}; differs from uncounted in: {diff or 'nothing'}; launches "
        f"{launches}")
    if diff:
        raise AssertionError(f"phase 13(d): the counted chunk differs in {diff}")
    shares = [(r["label"], k, r[k]) for r in report["rows"]
              for k in ("mfu_device", "hbm_device", "mfu_wall", "hbm_wall")]
    bad = [s for s in shares if not (s[2] is not None and 0 < s[2] <= SHARE_BOUND)]
    if bad:
        raise AssertionError(f"phase 13: shares outside (0, {SHARE_BOUND}]: {bad}")
    total = costs["rows"][0]
    parts = [r for r in costs["rows"][1:] if r["disjoint"]]
    log(f"roofline: the {len(parts)} disjoint stages sum to {sum(r['gflop'] for r in parts):.6f} "
        f"GFLOP, {sum(r['gb'] for r in parts):.6f} GB; TOTAL {total['gflop']:.6f} GFLOP, "
        f"{total['gb']:.6f} GB; every share within (0, {SHARE_BOUND}]")
    check_launches(launches, "roofline")
    return launches, dict(
        report=report["rows"], peaks=report["peaks"], extract_cost=costs["rows"],
        extract_units=costs["units"], counted_chunk=dict(
            gflop=counter.flops / 1e9, gb=counter.bytes_accessed / 1e9, units=counter.units),
        micro_topk=[dict(letter=r["letter"], label=r["label"], absent=r["absent"],
                         production_result=r["production_result"],
                         **({} if r["row"] is None else {
                             k: r["row"][k] for k in ("wall_ms", "device_ms", "launches")}))
                    for r in topk["rows"]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from stereo_visual_slam_tpu_torch.data import render_pool, synthetic
    from stereo_visual_slam_tpu_torch.ops.kernels import _build
    from stereo_visual_slam_tpu_torch.utils.config import Config

    dev = torch.device("cuda")
    t_start = t_phase = time.perf_counter()
    walls = {}
    _build.library()
    log(f"build: {time.perf_counter() - t_phase:.1f} s -> {_build.library_path()}")
    walls["2 build"] = time.perf_counter() - t_phase

    cfg = Config()
    t0 = time.perf_counter()
    world = synthetic.make_world(cfg, n_frames=FRAMES, n_points=N_POINTS, seed=SEED)
    frames = list(synthetic.frames(world))
    log(f"render: {FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    walls["render"] = time.perf_counter() - t0

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    measured = phase("3 kernels", check_kernels, cfg, frames, dev)
    launches = {}
    launches["chunked"], slice_run, slice_wall = phase("4 slice", run_slice, frames, world, cfg)
    launches["host"], host_rates = phase("5 host", run_host, frames, world, cfg)
    launches["reference_config"] = phase("6 reference config", run_reference, frames, world, cfg)
    launches["mesh_nccl_1"], mesh_one = phase("7a mesh nccl", run_mesh_one_rank, frames, cfg,
                                              slice_run, dev)
    mesh_two = phase("7b mesh gloo", run_mesh_two_ranks, frames, world, cfg, slice_run, dev)
    for r, res in enumerate(mesh_two):
        launches[f"mesh_gloo_{MESH_RANKS}_rank{r}"] = res["launches"]
    timing = "; ".join(
        [f"(a) NCCL 1 rank: slice wall {mesh_one['wall_s']:.3f} s"]
        + [f"(a) {k} {v['ms_sharded']:.3f} ms sharded / {v['ms_single']:.3f} ms unsharded"
           for k, v in mesh_one["schedules"].items()]
        + [f"(b) gloo rank {r} of {MESH_RANKS} on one card: slice wall {res['wall_s']:.3f} s, "
           + ", ".join(f"{k} {v['ms_sharded']:.3f} ms sharded / {v['ms_single']:.3f} ms unsharded"
                       for k, v in res["schedules"].items())
           for r, res in enumerate(mesh_two)])
    log(f"mesh BA per BA run and slice walls, on {card}: {timing}")
    dataset = phase("8 dataset", run_dataset, frames, world, cfg, slice_run, slice_wall)
    launches["dataset"], launches["dataset_cli"] = dataset["launches"], dataset["cli_launches"]
    launches["dataset_mixed"] = dataset["mixed_launches"]
    log(f"dataset on {card}: decode frames/s {dataset['decode_frames_per_s']}, mixed kinds "
        f"{dataset['mixed_decode_frames_per_s']}, on {dataset['cpu_count']} CPUs; walls: "
        f"rolling from files {dataset['rolling_wall_s']:.3f} s, from mixed kinds "
        f"{dataset['mixed_rolling_wall_s']:.3f} s, CLI {dataset['cli_wall_s']:.3f} s, "
        f"phase 4 {slice_wall:.3f} s")
    # phases 9 and 11 render on one pool of processes, started once
    with render_pool.Renderer() as renderer:
        bench_launches, benched = phase("9 bench", run_bench_phase, cfg, renderer)
        launches.update(bench_launches)
        entry_launches, entry_points = phase("10 entry points", run_entry_points, cfg)
        launches.update(entry_launches)
        launches["soak"], soaked = phase("11 soak", run_short_soak, cfg, renderer)
    profile_launches, profiled = phase("12 profilers", run_profilers, cfg, frames, dev)
    launches.update(profile_launches)
    launches["roofline"], roofs = phase("13 roofline", run_roofline, cfg, frames, dev,
                                        profiled["production"])
    walls["total"] = time.perf_counter() - t_start
    log("phase walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))

    src = {"fast_nms": ("stereo_visual_slam_tpu_torch/csrc/fast_nms.cu",
                        "stereo_visual_slam_tpu/ops/pallas/fast_kernel.py:96"),
           "gather_patches": ("stereo_visual_slam_tpu_torch/csrc/patch_gather.cu",
                              "stereo_visual_slam_tpu/ops/pallas/patch_kernel.py:82"),
           "zncc_sweep": ("stereo_visual_slam_tpu_torch/csrc/zncc_sweep.cu",
                          "stereo_visual_slam_tpu/ops/pallas/stereo_kernel.py:126"),
           "pnp_hypotheses": ("stereo_visual_slam_tpu_torch/csrc/pnp_ransac.cu",
                              "none: XLA ops of stereo_visual_slam_tpu/tracking/pnp.py"),
           "pnp_refine": ("stereo_visual_slam_tpu_torch/csrc/pnp_ransac.cu",
                          "none: XLA ops of stereo_visual_slam_tpu/tracking/pnp.py")}
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
                      "slice_reference_gaps": slice_run.reference_gaps,
                      "mesh": {"nccl_1_rank": mesh_one, f"gloo_{MESH_RANKS}_ranks": mesh_two},
                      "dataset": dataset, **benched, "entry_points": entry_points,
                      "soak": soaked, "profilers": profiled, "roofline": roofs,
                      "phase_walls_s": walls,
                      "brief_bit_flips": [g["brief_bit_flips"], g["brief_bits"]],
                      "steered_bit_flips": [g["steered_bit_flips"], g["brief_bits"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
