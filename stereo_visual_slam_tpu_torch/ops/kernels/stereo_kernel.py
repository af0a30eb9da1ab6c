"""Per-keypoint epipolar ZNCC sweep: the CUDA kernel (csrc/zncc_sweep.cu),
its plain torch twin and the dispatching wrapper.

Replaces `zncc_sweep` of stereo_visual_slam_tpu/ops/pallas/stereo_kernel.py;
the math and eps placement follow the reference's XLA ground truth
(`zncc_sweep_xla`), whose port is ops/stereo.zncc_sweep.
"""

from __future__ import annotations

import torch

from stereo_visual_slam_tpu_torch.ops import stereo
from stereo_visual_slam_tpu_torch.ops.kernels import _build, measure
from stereo_visual_slam_tpu_torch.utils import roofline

MAX_DISPARITY = 128  # 32 lanes x at most 4 disparities each
MAX_PATCH = 15      # the kernel is instantiated for odd patches 3..15


def zncc_sweep_plain(
    left: torch.Tensor, right: torch.Tensor, yx: torch.Tensor, *,
    patch: int = 11, max_disparity: int = 96,
) -> torch.Tensor:
    """The plain torch version (ops/stereo.zncc_sweep)."""
    return stereo.zncc_sweep(left, right, yx, patch=patch, max_disparity=max_disparity)


def zncc_sweep_cuda(
    left: torch.Tensor, right: torch.Tensor, yx: torch.Tensor, *,
    patch: int = 11, max_disparity: int = 96,
) -> torch.Tensor:
    """Launch the kernel: left/right (H, W) f32, yx (N, 2) int32, all
    contiguous CUDA tensors on one device. Returns (N, D) f32."""
    _build.require(left, "zncc_sweep left", torch.float32, 2)
    _build.require(right, "zncc_sweep right", torch.float32, 2)
    _build.require(yx, "zncc_sweep yx", torch.int32, 2)
    if right.shape != left.shape:
        raise ValueError("zncc_sweep: left and right differ in shape")
    if yx.shape[1] != 2 or not (left.device == right.device == yx.device):
        raise ValueError("zncc_sweep: yx must be (N, 2) on the images' device")
    if patch % 2 != 1 or not (3 <= patch <= MAX_PATCH) or not (1 <= max_disparity <= MAX_DISPARITY):
        raise ValueError(f"zncc_sweep: odd 3 <= patch <= {MAX_PATCH} and "
                         f"1 <= D <= {MAX_DISPARITY} required")
    H, W = left.shape
    N = yx.shape[0]
    out = torch.empty((N, max_disparity), dtype=torch.float32, device=left.device)
    if N == 0:
        return out
    err = _build.library().svs_zncc_sweep(
        left.data_ptr(), right.data_ptr(), yx.data_ptr(), out.data_ptr(),
        N, H, W, patch, max_disparity, _build.stream_handle(left),
    )
    _build.check("zncc_sweep", err)
    zncc_sweep_cuda.launches += 1
    return out


zncc_sweep_cuda.launches = 0


@roofline.kernel_unit("zncc_sweep", lambda left, right, yx, *, patch=11, max_disparity=96:
                      measure.zncc_work(left, yx.shape[0], patch, max_disparity))
def zncc_sweep(
    left: torch.Tensor, right: torch.Tensor, yx: torch.Tensor, *,
    patch: int = 11, max_disparity: int = 96,
) -> torch.Tensor:
    """(N, D) ZNCC scores: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors. The cost model counts a call as one unit of
    `measure.zncc_work`."""
    if left.device.type == "cpu":
        return zncc_sweep_plain(left, right, yx, patch=patch, max_disparity=max_disparity)
    return zncc_sweep_cuda(left, right, yx, patch=patch, max_disparity=max_disparity)
