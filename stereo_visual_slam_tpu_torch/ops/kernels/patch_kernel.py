"""Per-keypoint patch gather feeding BRIEF: the CUDA kernel
(csrc/patch_gather.cu), its plain torch twin and the dispatching wrapper.

Replaces `gather_patches_aligned` of stereo_visual_slam_tpu/ops/pallas/
patch_kernel.py: the patch at top-left clip(yx - P//2, 0, H - P) (x
likewise), clamped per frame of a vertical stack when `frame_h` is set.
"""

from __future__ import annotations

from typing import Optional

import torch

from stereo_visual_slam_tpu_torch.ops import image
from stereo_visual_slam_tpu_torch.ops.kernels import _build, measure
from stereo_visual_slam_tpu_torch.utils import roofline


def gather_patches_plain(
    img: torch.Tensor, yx: torch.Tensor, patch: int = 33,
    frame_h: Optional[int] = None,
) -> torch.Tensor:
    """The plain torch version: indexing (ops/image.gather_patches)."""
    return image.gather_patches(img, yx, patch, frame_h)


def gather_patches_cuda(
    img: torch.Tensor, yx: torch.Tensor, patch: int = 33,
    frame_h: Optional[int] = None,
) -> torch.Tensor:
    """Launch the kernel: img (H, W) f32, yx (N, 2) int32, both contiguous
    CUDA tensors on one device."""
    _build.require(img, "gather_patches img", torch.float32, 2)
    _build.require(yx, "gather_patches yx", torch.int32, 2)
    H, W = img.shape
    N = yx.shape[0]
    if yx.shape[1] != 2 or yx.device != img.device:
        raise ValueError("gather_patches: yx must be (N, 2) on the image's device")
    if not (1 <= patch <= min(H, W)):
        raise ValueError(f"gather_patches: patch {patch} does not fit {H}x{W}")
    fh = 0 if frame_h is None else int(frame_h)
    if fh and (H % fh or fh < patch):
        raise ValueError(f"gather_patches: frame_h {fh} must divide {H} and be >= {patch}")
    out = torch.empty((N, patch, patch), dtype=torch.float32, device=img.device)
    if N == 0:
        return out
    err = _build.library().svs_gather_patches(
        img.data_ptr(), yx.data_ptr(), out.data_ptr(), N, H, W, fh, patch,
        _build.stream_handle(img),
    )
    _build.check("gather_patches", err)
    gather_patches_cuda.launches += 1
    return out


gather_patches_cuda.launches = 0


@roofline.kernel_unit("gather_patches", lambda img, yx, patch=33, frame_h=None:
                      measure.gather_work(img, yx.shape[0], patch))
def gather_patches(
    img: torch.Tensor, yx: torch.Tensor, patch: int = 33,
    frame_h: Optional[int] = None,
) -> torch.Tensor:
    """(N, patch, patch) f32 patches: the plain version for a CPU tensor,
    the CUDA kernel for a CUDA tensor. The cost model counts a call as one
    unit of `measure.gather_work`."""
    if img.device.type == "cpu":
        return gather_patches_plain(img, yx, patch, frame_h)
    return gather_patches_cuda(img, yx, patch, frame_h)
