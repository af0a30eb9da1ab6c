"""kernels.roofline_pct (%): the three hand kernels' bounds summed over
their device time summed, in the profiled slice. Device times come from
the trace by kernel name; each bound is the larger of bytes over the
card's HBM rate and operations over its float32 rate (slam_bench/
yardstick.py), from the work these chunks need: FAST+NMS on each level's
stacked images, the patch gather over the pixels under its windows at the
keypoints the plain reference extracts from the same frames (each read
once) and its patches written once, and one ZNCC sweep of the N raw
keypoints a keyframe branch. None on a card the table of peaks does not
know, or where the slice ran none of the kernels."""

import torch

from slam_bench import yardstick

KERNELS = ("fast_nms_kernel", "gather_patches_kernel", "zncc_kernel")


def read(ctx):
    trace, peak = ctx["trace"], ctx["peaks"]
    if trace is None or peak is None:
        return None
    device_s = sum(b - a for name, a, b in trace["ops"] if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    cfg, chunk, frames = ctx["ref_cfg"], ctx["chunk"], ctx["sequence"]
    H, W = cfg.padded_hw
    bound_s = 0.0
    image = None
    for k in ctx["profiled"]:
        rows = frames[k * chunk:(k + 1) * chunk]
        images = torch.zeros((len(rows), 2, H, W), dtype=torch.uint8)
        for i, (_, left, right) in enumerate(rows):
            images[i, 0, :left.shape[0], :left.shape[1]] = torch.from_numpy(left)
            images[i, 1, :right.shape[0], :right.shape[1]] = torch.from_numpy(right)
        images = images.to(ctx["device"])
        work = yardstick.chunk_kernel_work(cfg, images)
        bound_s += sum(yardstick.bound(*w, peak)[0] for w in work["fast_nms"])
        bound_s += yardstick.bound(*work["gather_patches"], peak)[0]
        image = images[0]
    n_kf = sum(1 for layer, _, _ in trace["spans"] if layer == "keyframe.depth")
    if n_kf:
        bound_s += n_kf * yardstick.bound(*yardstick.keyframe_zncc_work(cfg, image), peak)[0]
    return 100.0 * bound_s / device_s
