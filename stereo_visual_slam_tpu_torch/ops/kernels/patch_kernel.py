"""Per-keypoint patch gather feeding BRIEF: the CUDA kernel
(csrc/patch_gather.cu), its plain torch twin and the dispatching wrappers,
for one image (`gather_patches`) and for every pyramid level in one launch
(`gather_patches_levels`).

Replaces `gather_patches_aligned` of stereo_visual_slam_tpu/ops/pallas/
patch_kernel.py: the patch at top-left clip(yx - P//2, 0, H - P) (x
likewise), clamped per frame of a vertical stack when `frame_h` is set.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from stereo_visual_slam_tpu_torch.ops import image
from stereo_visual_slam_tpu_torch.ops.kernels import _build, measure
from stereo_visual_slam_tpu_torch.utils import roofline

MAX_LEVELS = 8   # the kernel's table of level descriptors


def gather_patches_plain(
    img: torch.Tensor, yx: torch.Tensor, patch: int = 33,
    frame_h: Optional[int] = None,
) -> torch.Tensor:
    """The plain torch version: indexing (ops/image.gather_patches)."""
    return image.gather_patches(img, yx, patch, frame_h)


def gather_patches_levels_plain(
    imgs: Sequence[torch.Tensor], yxs: Sequence[torch.Tensor], patch: int = 33,
    frame_hs: Optional[Sequence[Optional[int]]] = None,
) -> torch.Tensor:
    """The plain torch version of the all-levels gather: the per-level
    plain gathers, concatenated in level order."""
    frame_hs = [None] * len(imgs) if frame_hs is None else frame_hs
    return torch.cat([gather_patches_plain(img, yx, patch, fh)
                      for img, yx, fh in zip(imgs, yxs, frame_hs)])


def _check_level(img: torch.Tensor, yx: torch.Tensor, patch: int,
                 frame_h: Optional[int]) -> int:
    """Raise unless the kernel takes (img, yx, patch, frame_h); returns
    frame_h as the kernel's int (0: not stacked)."""
    _build.require(img, "gather_patches img", torch.float32, 2)
    _build.require(yx, "gather_patches yx", torch.int32, 2)
    H, W = img.shape
    if yx.shape[1] != 2 or yx.device != img.device:
        raise ValueError("gather_patches: yx must be (N, 2) on the image's device")
    if not (1 <= patch <= min(H, W)):
        raise ValueError(f"gather_patches: patch {patch} does not fit {H}x{W}")
    fh = 0 if frame_h is None else int(frame_h)
    if fh and (H % fh or fh < patch):
        raise ValueError(f"gather_patches: frame_h {fh} must divide {H} and be >= {patch}")
    return fh


def gather_patches_cuda(
    img: torch.Tensor, yx: torch.Tensor, patch: int = 33,
    frame_h: Optional[int] = None,
) -> torch.Tensor:
    """Launch the kernel on one image: img (H, W) f32, yx (N, 2) int32, both
    contiguous CUDA tensors on one device."""
    fh = _check_level(img, yx, patch, frame_h)
    H, W = img.shape
    N = yx.shape[0]
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


def gather_patches_levels_cuda(
    imgs: Sequence[torch.Tensor], yxs: Sequence[torch.Tensor], patch: int = 33,
    frame_hs: Optional[Sequence[Optional[int]]] = None,
) -> torch.Tensor:
    """Launch the kernel once for every level: imgs[i] (H_i, W_i) f32 and
    yxs[i] (N_i, 2) int32, contiguous CUDA tensors on one device, at most
    MAX_LEVELS levels. Returns (sum N_i, patch, patch), level i's patches
    the i-th contiguous slice."""
    n = len(imgs)
    frame_hs = [None] * n if frame_hs is None else list(frame_hs)
    if not (1 <= n <= MAX_LEVELS and len(yxs) == n == len(frame_hs)):
        raise ValueError(f"gather_patches_levels: 1-{MAX_LEVELS} levels of images, keypoints "
                         f"and frame heights, got {n}, {len(yxs)}, {len(frame_hs)}")
    dev = imgs[0].device
    if any(img.device != dev for img in imgs):
        raise ValueError("gather_patches_levels: every level on one device")
    dims = []
    for img, yx, fh in zip(imgs, yxs, frame_hs):
        dims += [*img.shape, _check_level(img, yx, patch, fh), yx.shape[0]]
    total = sum(yx.shape[0] for yx in yxs)
    out = torch.empty((total, patch, patch), dtype=torch.float32, device=dev)
    if total == 0:
        return out
    err = _build.library().svs_gather_patches_levels(
        (ctypes.c_int64 * n)(*[img.data_ptr() for img in imgs]),
        (ctypes.c_int64 * n)(*[yx.data_ptr() for yx in yxs]),
        (ctypes.c_int * (4 * n))(*dims), n, out.data_ptr(), patch,
        _build.stream_handle(out),
    )
    _build.check("gather_patches_levels", err)
    gather_patches_levels_cuda.launches += 1
    return out


gather_patches_levels_cuda.launches = 0


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


@roofline.kernel_unit("gather_patches", lambda imgs, yxs, patch=33, frame_hs=None:
                      measure.gather_levels_work(imgs, [yx.shape[0] for yx in yxs], patch))
def gather_patches_levels(
    imgs: Sequence[torch.Tensor], yxs: Sequence[torch.Tensor], patch: int = 33,
    frame_hs: Optional[Sequence[Optional[int]]] = None,
) -> torch.Tensor:
    """(sum N_i, patch, patch) f32 patches of every level, level by level:
    the plain version for CPU tensors, one launch of the CUDA kernel for
    CUDA tensors. The cost model counts a call as one unit of the levels'
    summed `measure.gather_work`."""
    if imgs[0].device.type == "cpu":
        return gather_patches_levels_plain(imgs, yxs, patch, frame_hs)
    return gather_patches_levels_cuda(imgs, yxs, patch, frame_hs)
