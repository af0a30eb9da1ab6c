"""The benchmark's own arithmetic: the table of peaks, each hand kernel's
work and bound from its shapes, and the device-busy union.

Frozen copies, each from stereo_visual_slam_tpu_torch at commit c627a7a:
  * `fast_work`, `compass_pass`, `gather_work`, `covered_pixels`,
    `gather_levels_work`, `zncc_work` and `bound` from
    ops/kernels/measure.py (the peaks as arguments, not the cost model's
    constants; `covered_pixels` on this package's reference ops);
  * `busy` from profiling/timing.py (`busy_us`).
They stay here, where a change to the program cannot move them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# Published peaks of one card (NVIDIA's data sheet, SXM part, dense):
# float32 outside the tensor cores and HBM bandwidth, at its full 700 W.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(flops_f32=67e12, bytes_per_s=3.35e12),
}

# operations per pixel of FAST+NMS: the compass test (4 differences, 8
# compares) and the 8 NMS compares for every pixel; the full arc score (16
# differences, 128 min/max, 30 to reduce the 16 arcs, 3 selects) for the
# pixels the compass test passes
FAST_OPS_ALL, FAST_OPS_CANDIDATE = 20, 177
# flops per window pixel of the ZNCC sweep: the difference from the window
# mean, its square sum and its product with the patch (2 each)
ZNCC_FLOPS = 5


def peaks(device_name: str) -> Optional[dict]:
    """The card's peaks by `torch.cuda.get_device_name()`, None for a card
    the table does not know."""
    return PEAKS.get(device_name)


def bound(nbytes: float, ops: float, peak: dict) -> Tuple[float, str]:
    """(bound in seconds, "bytes" or "operations"): the larger of bytes
    over the memory rate and operations over the f32 rate."""
    t_bytes, t_ops = nbytes / peak["bytes_per_s"], ops / peak["flops_f32"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compass_pass(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) bool: the pixels whose compass test passes (at least two of
    the circle pixels 0, 4, 8, 12 above the threshold, or two below minus
    it), the ones FAST+NMS's kernel scores in full."""
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    H, W = img.shape
    d = torch.stack([p[0:H, 3:3 + W], p[3:3 + H, 6:6 + W],
                     p[6:6 + H, 3:3 + W], p[3:3 + H, 0:W]]) - img
    return ((d > threshold).sum(0) >= 2) | ((-d > threshold).sum(0) >= 2)


# Each kernel's work on its inputs, (bytes, operations): every input read
# once and every output written once, and the operations these inputs need.
def fast_work(img: torch.Tensor, threshold: float) -> Tuple[float, float]:
    n = img.numel()
    ops = n * FAST_OPS_ALL + int(compass_pass(img, threshold).sum()) * FAST_OPS_CANDIDATE
    return 8.0 * n, float(ops)


def gather_work(img: torch.Tensor, n: int, patch: int, covered=None) -> Tuple[float, float]:
    """The gather's work: its keypoints and patches, and the image's
    pixels: `covered` of them (the pixels under the windows, what the
    kernel must read), or, when None, every pixel."""
    pixels = img.numel() if covered is None else covered
    return 4.0 * pixels + 8.0 * n + 4.0 * n * patch * patch, 0.0


def covered_pixels(img: torch.Tensor, yx: torch.Tensor, patch: int, frame_h=None) -> int:
    """The pixels of img under at least one keypoint's window (the union
    of the windows, as the gather clamps them)."""
    from slam_bench.reference import image as im_ops

    mask = torch.zeros(img.shape, dtype=torch.bool, device=img.device)
    if yx.shape[0]:
        y0, x0 = im_ops.patch_origins(yx, img.shape, patch, frame_h)
        ar = torch.arange(patch, device=img.device)
        mask[y0[:, None, None] + ar[None, :, None], x0[:, None, None] + ar[None, None, :]] = True
    return int(mask.sum())


def gather_levels_work(imgs, ns, patch: int, covered=None) -> Tuple[float, float]:
    """The all-levels gather's work: the levels' gather_work summed."""
    covered = [None] * len(imgs) if covered is None else covered
    works = [gather_work(img, n, patch, c) for img, n, c in zip(imgs, ns, covered)]
    return sum(w[0] for w in works), sum(w[1] for w in works)


def zncc_work(img: torch.Tensor, n: int, patch: int, D: int) -> Tuple[float, float]:
    return 8.0 * img.numel() + 8.0 * n + 4.0 * n * D, float(ZNCC_FLOPS * n * D * patch * patch)


def busy(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals: the time the
    device was busy, where operations that overlap count once."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def chunk_kernel_work(cfg, images: torch.Tensor) -> dict:
    """The work of FAST+NMS and of the patch gather on one chunk of frames
    (images (B, 2, H, W) uint8 on a device), at the keypoints the plain
    reference extracts from them: {"fast_nms": [(bytes, ops)] a level,
    "gather_patches": (bytes, ops) of the one all-levels call}. The gather
    reads the pixels under its windows, each once, and writes its patches."""
    from slam_bench.reference import frontend

    st = frontend.ExtractStages(cfg, images.device)
    fe = cfg.frontend
    left = images[:, 0].float()
    fast, blurred, yxs, frame_hs = [], [], [], []
    for i in range(len(st.levels)):
        stacked, _, yx = st.detect(i, st.level_image(left, i))
        fast.append(fast_work(stacked, fe.fast_threshold))
        blurred.append(st.blur(stacked))
        yxs.append(st.stacked_yx(i, yx))
        frame_hs.append(st.levels[i][2][0])
    covered = [covered_pixels(b, yx, fe.patch_size, fh)
               for b, yx, fh in zip(blurred, yxs, frame_hs)]
    gather = gather_levels_work(blurred, [yx.shape[0] for yx in yxs], fe.patch_size, covered)
    return {"fast_nms": fast, "gather_patches": gather}


def keyframe_zncc_work(cfg, image: torch.Tensor) -> Tuple[float, float]:
    """The ZNCC sweep's work in one keyframe branch: the frame's N raw
    keypoints on its full-resolution pair (image (2, H, W))."""
    fe = cfg.frontend
    return zncc_work(image[0].float(), fe.max_raw_keypoints, fe.stereo_patch, fe.max_disparity)
