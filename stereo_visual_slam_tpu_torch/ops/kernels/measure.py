"""Time the CUDA kernels at the main path's shapes, and an earlier version
of them beside the current one, in one process on one card.

    python -m stereo_visual_slam_tpu_torch.ops.kernels.measure \
        [--parent DIR] [--rounds 5] [--out DIR]

Inputs: production Config(), the first 8 frames (one chunk) of the default
synthetic world. Shapes: FAST+NMS on each pyramid level's (8*H_i, W_i)
stack; the patch gather at each level's 8 x budget_i keypoints on the
blurred stack, one level a launch and all levels in one (the main path's
call); the ZNCC sweep at N=2,048 on frame 0's pair (the keyframe branch
and the host driver) and N=16,384 on the stacked pair with per-frame row
offsets (the eager chunk path).

`--parent DIR` names a directory of earlier kernel sources with the same C
entry points (e.g. a copy of an earlier commit's csrc/ under archive/),
built into a library of its own. Each round times, per shape, every
variant in turns, forward then backward (parent, current, current,
parent); each sample is the device time of one launch, averaged over
back-to-back launches queued behind a sleep kernel so that no host gap
enters it. For all levels, the parent's variant is its 8 per-level
launches back to back where it has no all-levels entry. The
gather rows are also timed L2-cold (`device_ms_cold`: each launch alone
between two events, after a 128 MB buffer is written and read back):
back to back, a level's image and patches can stay in the 50 MB L2, and
a copy can then beat its HBM bound. The current
kernels are also checked against their plain versions and the parent's
(FAST+NMS and the gather bit-exact, ZNCC atol 2e-5).

The module also holds what `chip_smoke.py` needs for the same shapes: the
inputs and each kernel's bound (the least time the card could take), from
each kernel's work (`fast_work`, `gather_work`, `zncc_work`,
`pnp_work`: bytes and operations), which the cost model (utils/roofline.py) counts for a call of
the kernel's wrapper too. The gather's bound counts only the image pixels
under its windows (`covered_pixels`); its cost-model unit counts whole
level images.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from stereo_visual_slam_tpu_torch.ops.kernels import _build
from stereo_visual_slam_tpu_torch.utils.roofline import PEAK_BYTES, PEAK_F32

ZNCC_ATOL = 2e-5
FRAMES = 8
# operations per pixel of FAST+NMS: the compass test (4 differences, 8
# compares) and the 8 NMS compares for every pixel; the full arc score (16
# differences, 128 min/max, 30 to reduce the 16 arcs, 3 selects) for the
# pixels the compass test passes
FAST_OPS_ALL, FAST_OPS_CANDIDATE = 20, 177
# flops per window pixel of the ZNCC sweep: the difference from the window
# mean, its square sum and its product with the patch (2 each)
ZNCC_FLOPS = 5
# operations of PnP-RANSAC's kernels (csrc/pnp_ransac.cu): a point of a
# Gauss-Newton step (the transform 18, the projection 7, the residual and
# depth test 3, the 2x6 Jacobian 30, its 21 JtJ and 6 Jtr sums 108), 20
# more for its Huber weight; a step's 6x6 solve by 3x3 blocks, the twist's
# exp and the compose; a point scored against a pose (the transform, the
# projection, the residual's norm, three tests)
PNP_GN_OPS, PNP_HUBER_OPS, PNP_STEP_OPS, PNP_SCORE_OPS = 166, 20, 500, 34


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the larger of bytes over the
    memory rate and operations over the f32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def compass_pass(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) bool: the pixels whose compass test passes (at least two of
    the circle pixels 0, 4, 8, 12 above the threshold, or two below minus
    it), the ones FAST+NMS's kernel scores in full; every pixel with a
    nonzero FAST score is one of them."""
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    H, W = img.shape
    d = torch.stack([p[0:H, 3:3 + W], p[3:3 + H, 6:6 + W],
                     p[6:6 + H, 3:3 + W], p[3:3 + H, 0:W]]) - img
    return ((d > threshold).sum(0) >= 2) | ((-d > threshold).sum(0) >= 2)


# Each kernel's work on its inputs, (bytes, operations): every input read
# once and every output written once, and the operations these inputs need.
# The bounds below and the cost model's kernel units (utils/roofline.py)
# both count it.
def fast_work(img: torch.Tensor, threshold: float) -> tuple:
    n = img.numel()
    ops = n * FAST_OPS_ALL + int(compass_pass(img, threshold).sum()) * FAST_OPS_CANDIDATE
    return 8.0 * n, float(ops)


def gather_work(img: torch.Tensor, n: int, patch: int, covered=None) -> tuple:
    """The gather's work: its keypoints and patches, and the image's
    pixels: `covered` of them (the pixels under the windows, what the
    kernel must read: `covered_pixels`), or, when None, every pixel (the
    cost model's unit, as counted since it began)."""
    pixels = img.numel() if covered is None else covered
    return 4.0 * pixels + 8.0 * n + 4.0 * n * patch * patch, 0.0


def covered_pixels(img: torch.Tensor, yx: torch.Tensor, patch: int, frame_h=None) -> int:
    """The pixels of img under at least one keypoint's window (the union
    of the windows, as the gather clamps them): the part of the image the
    gather reads."""
    from stereo_visual_slam_tpu_torch.ops import image as im_ops

    mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    if yx.shape[0]:
        y0, x0 = im_ops.patch_origins(yx, img.shape, patch, frame_h)
        ar = torch.arange(patch, device=img.device)
        mask[y0[:, None, None] + ar[None, :, None], x0[:, None, None] + ar[None, None, :]] = True
    return int(mask.sum())


def gather_levels_work(imgs, ns, patch: int, covered=None) -> tuple:
    """The all-levels gather's work: the levels' gather_work summed
    (`covered`: each level's covered pixels, or None for whole images)."""
    covered = [None] * len(imgs) if covered is None else covered
    works = [gather_work(img, n, patch, c) for img, n, c in zip(imgs, ns, covered)]
    return sum(w[0] for w in works), sum(w[1] for w in works)


def zncc_work(img: torch.Tensor, n: int, patch: int, D: int) -> tuple:
    return 8.0 * img.numel() + 8.0 * n + 4.0 * n * D, float(ZNCC_FLOPS * n * D * patch * patch)


def pnp_hypotheses_work(H: int, N: int, S: int, iters: int) -> tuple:
    """`pnp_hypotheses_kernel`'s: the Gumbel rows, the points (21 bytes
    each), each hypothesis's draws and outputs; the minimal sets, H chains
    of `iters` steps on S points, the H x N score."""
    nbytes = 4.0 * H * N + 21.0 * N + H * (28.0 + 8 * S + 68) + 128
    ops = H * N * (S + 1) + H * iters * (S * PNP_GN_OPS + PNP_STEP_OPS) + H * N * PNP_SCORE_OPS
    return nbytes, float(ops)


def pnp_refine_work(H: int, N: int, iters: int) -> tuple:
    """`pnp_refine_kernel`'s: the points and the mask, the hypotheses and
    scores, the result; the argmax, the winner's inlier set and the final
    one, and `iters` Huber-weighted steps over N."""
    nbytes = 22.0 * N + 68.0 * H + 172
    ops = H + 2 * N * PNP_SCORE_OPS + iters * (N * (PNP_GN_OPS + PNP_HUBER_OPS) + PNP_STEP_OPS)
    return nbytes, float(ops)


def pnp_work(pts_w, uv, valid, K, T_init, gumbel, twist_noise, *, sample_size=4,
             gn_iters_hypothesis=10, gn_iters_refine=10, **_) -> tuple:
    """Both PnP kernels' work for one `tracking/pnp.solve_pnp_ransac` call."""
    H, N = gumbel.shape
    a = pnp_hypotheses_work(H, N, sample_size, gn_iters_hypothesis)
    b = pnp_refine_work(H, N, gn_iters_refine)
    return a[0] + b[0], a[1] + b[1]


def fast_bound(img: torch.Tensor, threshold: float) -> tuple:
    return bound(*fast_work(img, threshold))


def gather_bound(img: torch.Tensor, n: int, patch: int) -> tuple:
    return bound(*gather_work(img, n, patch))


def gather_levels_bound(gathers, patch: int) -> dict:
    """The bound of the gather over `gathers` ([(image, yx, frame_h)]),
    from the pixels its windows cover, beside the bound that reads whole
    images: {bound_ms, bound_by, covered_pixels, image_pixels,
    whole_image_bound_ms}."""
    imgs, ns = [img for img, _, _ in gathers], [yx.shape[0] for _, yx, _ in gathers]
    covered = [covered_pixels(img, yx, patch, fh) for img, yx, fh in gathers]
    ms, by = bound(*gather_levels_work(imgs, ns, patch, covered))
    return dict(bound_ms=ms, bound_by=by, covered_pixels=sum(covered),
                image_pixels=sum(img.numel() for img in imgs),
                whole_image_bound_ms=bound(*gather_levels_work(imgs, ns, patch))[0])


def zncc_bound(img: torch.Tensor, n: int, patch: int, D: int) -> tuple:
    return bound(*zncc_work(img, n, patch, D))


def production_frames(n_frames: int = FRAMES):
    """Production Config() and the first frames of the default world."""
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.utils.config import Config

    cfg = Config()
    world = synthetic.make_world(cfg, n_frames=n_frames, n_points=8000, seed=0)
    return cfg, list(synthetic.frames(world))


def pnp_inputs(cfg, seed: int, dev) -> tuple:
    """PnP's arguments at the production shapes: points ahead of a driving
    camera, their pixels under a known pose with 0.5 px noise, a third of
    them outliers, a tenth invalid, the draws from `seed`."""
    from stereo_visual_slam_tpu_torch.geom import se3
    from stereo_visual_slam_tpu_torch.models import vslam

    n, H = cfg.frontend.max_raw_keypoints, cfg.pnp.n_hypotheses
    rng = np.random.default_rng(seed)
    cam = cfg.camera
    pts = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                    rng.uniform(8, 60, n)], -1).astype(np.float32)
    T_gt = se3.exp(torch.tensor([0.3, -0.1, 0.8, 0.01, 0.03, -0.005]))
    Xc = pts @ T_gt[:3, :3].numpy().T + T_gt[:3, 3].numpy()
    uv = np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                   cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1) + rng.normal(0, 0.5, (n, 2))
    bad = n // 3
    uv[:bad] += rng.uniform(30, 200, (bad, 2)) * rng.choice([-1, 1], (bad, 2))
    valid = rng.random(n) > 0.1
    gumbel = -np.log(-np.log(rng.uniform(1e-6, 1.0, (H, n))))
    twist = rng.normal(0, 1, (H, 6))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    T_init = se3.exp(torch.tensor([0.25, -0.05, 0.7, 0.0, 0.02, 0.0])).to(dev)
    return (f32(pts), f32(uv), torch.as_tensor(valid, device=dev), vslam.camera_matrix(cfg, dev),
            T_init, f32(gumbel), f32(twist))


def kernel_inputs(cfg, frames, dev) -> dict:
    """The three kernels' inputs at the main path's shapes, for one chunk
    of frames (models/frontend.py builds the same per level)."""
    from stereo_visual_slam_tpu_torch.models import frontend
    from stereo_visual_slam_tpu_torch.ops import fast as fast_ops
    from stereo_visual_slam_tpu_torch.ops import image as im_ops
    from stereo_visual_slam_tpu_torch.ops.kernels import fast_kernel

    fe = cfg.frontend
    H, W = cfg.padded_hw
    vh, vw = cfg.image_hw
    imgs = np.zeros((len(frames), 2, H, W), np.uint8)
    for i, (_, left, right) in enumerate(frames):
        imgs[i, 0, :vh, :vw] = left
        imgs[i, 1, :vh, :vw] = right
    imgs = torch.from_numpy(imgs).to(dev)
    B = imgs.shape[0]
    left = imgs[:, 0].float()
    levels, gathers = [], []
    for i, (_, (h_i, w_i), (H_i, W_i), budget) in enumerate(frontend._level_geometry(cfg)):
        if i == 0:
            level = left
        else:
            mats = im_ops.resize_matrices((vh, vw), (h_i, w_i), dev)
            level = im_ops.pad_to(im_ops.resize_linear(left[:, :vh, :vw], mats), (H_i, W_i))
        stacked = level.reshape(B * H_i, W_i).contiguous()
        levels.append(stacked)
        score = fast_kernel.fast_nms_plain(stacked, fe.fast_threshold).reshape(B, H_i, W_i)
        m = fe.border_margin
        yy = torch.arange(H_i, device=dev)[:, None]
        xx = torch.arange(W_i, device=dev)[None, :]
        score = torch.where((yy >= m) & (yy < h_i - m) & (xx >= m) & (xx < w_i - m), score, 0.0)
        _, yx = fast_ops.nms_topk(score, budget)
        row_off = (torch.arange(B, device=dev, dtype=torch.int32) * H_i)[:, None]
        yx_st = torch.stack([yx[..., 0] + row_off, yx[..., 1]], -1).reshape(-1, 2).contiguous()
        gathers.append((im_ops.box_blur(stacked, fe.blur_box), yx_st, H_i))
        if i == 0:
            score0 = score
    # ZNCC: each frame's 2,048 strongest level-0 keypoints
    _, yx0 = fast_ops.nms_topk(score0, fe.max_raw_keypoints)        # (B, N, 2)
    row_off = (torch.arange(B, device=dev, dtype=torch.int32) * H)[:, None]
    yx_st = torch.stack([yx0[..., 0] + row_off, yx0[..., 1]], -1).reshape(-1, 2).contiguous()
    right = imgs[:, 1].float()
    zncc = {
        "single": (left[0].contiguous(), right[0].contiguous(), yx0[0].contiguous()),
        "stacked": (left.reshape(B * H, W).contiguous(), right.reshape(B * H, W).contiguous(), yx_st),
    }
    return dict(levels=levels, gathers=gathers, zncc=zncc)


def device_ms(fn, reps: int = 50) -> float:
    """Device time of one fn() call: reps calls queued back to back behind
    a sleep kernel that outlasts their enqueueing (so the host's launch
    rate does not enter), between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    # cycles at up to 2 GHz: twice the enqueue time of the reps, + 0.1 ms
    torch.cuda._sleep(int(2e9 * (2.0 * reps * host_s + 1e-4)))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms_cold(fn, reps: int = 20, scrub_mb: int = 128) -> float:
    """Device time of one fn() call with nothing of its inputs in L2: each
    of reps calls alone between two CUDA events, after a scrub_mb buffer
    is written and read back (evicting the 50 MB L2, dirty lines
    included), all queued behind a sleep kernel; the mean of the calls.
    Lines fn writes can still leave L2 after its end event."""
    scrub = torch.empty(scrub_mb << 18, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    scrub.fill_(1.0)
    scrub.sum()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda._sleep(int(2e9 * (2.0 * reps * host_s + 1e-4)))
    for a, b in events:
        scrub.fill_(1.0)
        scrub.sum()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def raw_calls(lib, cfg, dev):
    """Launchers of lib's three C entry points (None for one that lib does
    not define), outputs preallocated, for timing two libraries with the
    same entry points on equal terms."""
    fe = cfg.frontend
    stream = torch.cuda.current_stream(dev).cuda_stream

    def fast(img):
        out = torch.empty_like(img)

        def go():
            _build.check("fast_nms", lib.svs_fast_nms(
                img.data_ptr(), out.data_ptr(), img.shape[0], img.shape[1],
                float(fe.fast_threshold), stream))
            return out
        return go

    def gather(img, yx, frame_h, out=None):
        P = fe.patch_size
        if out is None:
            out = torch.empty((yx.shape[0], P, P), dtype=torch.float32, device=dev)

        def go():
            _build.check("gather_patches", lib.svs_gather_patches(
                img.data_ptr(), yx.data_ptr(), out.data_ptr(), yx.shape[0],
                img.shape[0], img.shape[1], frame_h, P, stream))
            return out
        return go

    def zncc(left, right, yx):
        D, P = fe.max_disparity, fe.stereo_patch
        out = torch.empty((yx.shape[0], D), dtype=torch.float32, device=dev)

        def go():
            _build.check("zncc_sweep", lib.svs_zncc_sweep(
                left.data_ptr(), right.data_ptr(), yx.data_ptr(), out.data_ptr(),
                yx.shape[0], left.shape[0], left.shape[1], P, D, stream))
            return out
        return go

    return [fn if hasattr(lib, name) else None for fn, name in (
        (fast, "svs_fast_nms"), (gather, "svs_gather_patches"), (zncc, "svs_zncc_sweep"))]


def gather_levels_call(lib, cfg, dev, gathers):
    """Launcher of the gather over every level of `gathers` ([(blurred,
    yx, frame_h)]) into one (sum N, P, P) output: lib's all-levels entry,
    or, where lib lacks it (an earlier version), its per-level launches
    back to back."""
    P = cfg.frontend.patch_size
    out = torch.empty((sum(yx.shape[0] for _, yx, _ in gathers), P, P),
                      dtype=torch.float32, device=dev)
    if not hasattr(lib, "svs_gather_patches_levels"):
        gather = raw_calls(lib, cfg, dev)[1]
        launches, start = [], 0
        for blurred, yx, fh in gathers:
            launches.append(gather(blurred, yx, fh, out[start:start + yx.shape[0]]))
            start += yx.shape[0]

        def each():
            for go in launches:
                go()
            return out
        return each
    n = len(gathers)
    imgs = (ctypes.c_int64 * n)(*[b.data_ptr() for b, _, _ in gathers])
    yxs = (ctypes.c_int64 * n)(*[yx.data_ptr() for _, yx, _ in gathers])
    dims = (ctypes.c_int * (4 * n))(*[v for b, yx, fh in gathers
                                      for v in (*b.shape, fh, yx.shape[0])])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def go():
        _build.check("gather_patches_levels", lib.svs_gather_patches_levels(
            imgs, yxs, dims, n, out.data_ptr(), P, stream))
        return out
    return go


def _check(name, shape, new, parent, plain, exact):
    for label, other in (("parent", parent), ("plain", plain)):
        if other is None:
            continue
        err = float((new - other).abs().max()) if new.numel() else 0.0
        if (exact and not torch.equal(new, other)) or err > ZNCC_ATOL:
            raise AssertionError(f"{name} {shape}: differs from the {label} version (max |err| {err})")


def _summary(xs):
    return dict(median_ms=statistics.median(xs), min_ms=min(xs), max_ms=max(xs), samples=xs)


def measure(parent_dir, rounds: int) -> dict:
    from stereo_visual_slam_tpu_torch.ops.kernels import fast_kernel, patch_kernel, stereo_kernel

    dev = torch.device("cuda")
    cfg, frames = production_frames()
    fe = cfg.frontend
    P = fe.patch_size
    inp = kernel_inputs(cfg, frames, dev)
    libs = {"new": _build.library()}
    if parent_dir is not None:
        libs["parent"] = _build.library(Path(parent_dir))
    calls = {k: raw_calls(lib, cfg, dev) for k, lib in libs.items()}

    def gather_variants(gathers):
        """Each library's gather over `gathers`: for one level its C entry
        of one level, for several its all-levels launch."""
        if len(gathers) == 1:
            return {k: c[1](*gathers[0]) for k, c in calls.items() if c[1]}
        return {k: gather_levels_call(lib, cfg, dev, gathers) for k, lib in libs.items()}

    # (kernel, shape label, {variant: launcher}, {bound_ms, bound_by, ...}, exact, plain)
    cases = []
    for i, img in enumerate(inp["levels"]):
        cases.append(("fast_nms", f"L{i} {tuple(img.shape)}",
                      {k: c[0](img) for k, c in calls.items() if c[0]},
                      dict(zip(("bound_ms", "bound_by"), fast_bound(img, fe.fast_threshold))),
                      True,
                      lambda img=img: fast_kernel.fast_nms_plain(img, fe.fast_threshold)))
    gathers = inp["gathers"]
    for i, (blurred, yx, fh) in enumerate(gathers):
        cases.append(("gather_patches", f"L{i} {yx.shape[0]} x {P}^2",
                      gather_variants([(blurred, yx, fh)]),
                      gather_levels_bound([(blurred, yx, fh)], P), True,
                      lambda b=blurred, y=yx, h=fh: patch_kernel.gather_patches_plain(b, y, P, h)))
    n_all = sum(yx.shape[0] for _, yx, _ in gathers)
    cases.append(("gather_patches", f"all {len(gathers)} levels {n_all} x {P}^2",
                  gather_variants(gathers), gather_levels_bound(gathers, P), True,
                  lambda: patch_kernel.gather_patches_levels_plain(
                      [b for b, _, _ in gathers], [yx for _, yx, _ in gathers], P,
                      [fh for _, _, fh in gathers])))
    for label, (l, r, yx) in inp["zncc"].items():
        cases.append(("zncc_sweep", f"{label} N={yx.shape[0]} on {tuple(l.shape)}",
                      {k: c[2](l, r, yx) for k, c in calls.items() if c[2]},
                      dict(zip(("bound_ms", "bound_by"),
                               zncc_bound(l, yx.shape[0], fe.stereo_patch, fe.max_disparity))),
                      False,
                      lambda l=l, r=r, y=yx: stereo_kernel.zncc_sweep_plain(
                          l, r, y, patch=fe.stereo_patch, max_disparity=fe.max_disparity)))

    for name, shape, fns, _, exact, plain in cases:
        ref = plain()
        par = fns["parent"]().clone() if "parent" in fns else None
        for k, fn in fns.items():
            if k != "parent":
                _check(name, f"{shape} ({k})", fn().clone(), par, ref, exact)
    torch.cuda.synchronize()

    samples = [{} for _ in cases]
    for _ in range(rounds):
        for c, (name, _, fns, _, _, _) in enumerate(cases):
            order = list(fns) + list(fns)[::-1]
            timers = [("", device_ms)] + ([("_cold", device_ms_cold)]
                                          if name == "gather_patches" else [])
            for suffix, timer in timers:
                for k in order:
                    samples[c].setdefault(k + suffix, []).append(timer(fns[k]))
    rows = []
    for c, (name, shape, _, bounds, _, _) in enumerate(cases):
        row = dict(kernel=name, shape=shape, **bounds,
                   **{k: _summary(v) for k, v in samples[c].items()})
        if "parent" in row:
            row["new_over_parent"] = row["new"]["median_ms"] / row["parent"]["median_ms"]
        rows.append(row)
    return dict(card=card_line(), torch=torch.__version__, rounds=rounds, rows=rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", help="directory of earlier kernel sources to time beside csrc/")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default="chiprun_out", help="directory for measure_kernels.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("measure: no CUDA device", file=sys.stderr)
        return 1
    res = measure(args.parent, args.rounds)
    for row in res["rows"]:
        times = "  ".join(f"{k} {v['median_ms']:.6f} [{v['min_ms']:.6f}-{v['max_ms']:.6f}]"
                          for k, v in row.items() if isinstance(v, dict))
        covered = (f"; {row['covered_pixels']} of {row['image_pixels']} pixels under the "
                   f"windows, whole-image bound {row['whole_image_bound_ms']:.6f} ms"
                   if "covered_pixels" in row else "")
        print(f"{row['kernel']:15s} {row['shape']:32s} {times} ms  bound {row['bound_ms']:.6f} ms "
              f"({row['bound_by']}{covered})")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "measure_kernels.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(res["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
