"""FAST-9/16 score + 3x3 NMS: the CUDA kernel (csrc/fast_nms.cu), its
plain torch twin and the dispatching wrapper.

Replaces `fast_nms_score_map` of stereo_visual_slam_tpu/ops/pallas/
fast_kernel.py. Semantics are ops/fast.py's: zero outside the image for the
circle, -inf outside the image for NMS.
"""

from __future__ import annotations

import torch

from stereo_visual_slam_tpu_torch.ops import fast
from stereo_visual_slam_tpu_torch.ops.kernels import _build, measure
from stereo_visual_slam_tpu_torch.utils import roofline


def fast_nms_plain(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """The plain torch version: `nms_3x3(fast_score_map(img))`."""
    return fast.nms_3x3(fast.fast_score_map(img, threshold))


def fast_nms_cuda(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Launch the kernel on a contiguous (H, W) float32 CUDA image."""
    _build.require(img, "fast_nms", torch.float32, 2)
    H, W = img.shape
    out = torch.empty_like(img)
    err = _build.library().svs_fast_nms(
        img.data_ptr(), out.data_ptr(), H, W, float(threshold),
        _build.stream_handle(img),
    )
    _build.check("fast_nms", err)
    fast_nms_cuda.launches += 1
    return out


fast_nms_cuda.launches = 0


@roofline.kernel_unit("fast_nms", lambda img, threshold=20.0: measure.fast_work(img, threshold))
def fast_nms_score_map(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """NMS'd FAST score map of img (H, W) f32: the plain version for a CPU
    tensor, the CUDA kernel for a CUDA tensor. The cost model counts a call
    as one unit of `measure.fast_work`."""
    if img.device.type == "cpu":
        return fast_nms_plain(img, threshold)
    return fast_nms_cuda(img, threshold)
