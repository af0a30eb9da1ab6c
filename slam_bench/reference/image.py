# Frozen copy of stereo_visual_slam_tpu_torch/ops/image.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""Image utilities (port of ops/image.py): padding, box blur, patch gather,
and the pyramid resize that reproduces `jax.image.resize(..., "linear")`.

Images are float32 (..., H, W) in [0, 255].
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def pad_to(img: torch.Tensor, hw) -> torch.Tensor:
    """Zero-pad (..., h, w) on the bottom/right to the static shape hw."""
    h, w = img.shape[-2:]
    H, W = hw
    return F.pad(img, (0, W - w, 0, H - h))


def box_blur(img: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Separable k x k box blur with edge padding, summed in the reference's
    order (k shifted adds per axis, then / k), so it is bit-exact."""
    r = k // 2

    def blur_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis]
        src = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
        xp = x.index_select(axis, src)
        acc = xp.narrow(axis, 0, n)
        for s in range(1, k):
            acc = acc + xp.narrow(axis, s, n)
        return acc / k

    return blur_axis(blur_axis(img, img.dim() - 2), img.dim() - 1)


def patch_origins(
    yx: torch.Tensor, hw, patch: int, frame_h: Optional[int] = None
):
    """Top-left (y0, x0) of each `patch` x `patch` window centred at yx,
    clamped to the image — per frame of a vertical stack when `frame_h` is
    set (the frame index is clamped to the stack, so no read leaves it)."""
    H, W = hw
    r = patch // 2
    y, x = yx[:, 0].long(), yx[:, 1].long()
    if frame_h is None:
        y0 = torch.clamp(y - r, 0, H - patch)
    else:
        b = torch.clamp(torch.div(y, frame_h, rounding_mode="floor"),
                        0, H // frame_h - 1)
        y0 = torch.clamp(y - b * frame_h - r, 0, frame_h - patch) + b * frame_h
    x0 = torch.clamp(x - r, 0, W - patch)
    return y0, x0


def gather_patches(
    img: torch.Tensor, yx: torch.Tensor, patch: int,
    frame_h: Optional[int] = None,
) -> torch.Tensor:
    """(N, patch, patch) windows of img (H, W) at integer centres yx (N, 2),
    as plain indexing: exact image values (the reference's one-hot matmul
    rounds them through bf16, which BRIEF does anyway)."""
    y0, x0 = patch_origins(yx, img.shape, patch, frame_h)
    ar = torch.arange(patch, device=img.device)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    return img[rows, cols]


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize(linear)`
    along one axis: jax/_src/image/scale.py `compute_weight_mat` with the
    triangle kernel and antialiasing, evaluated in float32 numpy as XLA
    compiles it inside the JAX package's jitted extractor. There the scale
    is a Python float, out_size / in_size, and so is 1 / scale: the
    inverse scale is rounded to float32 once, from float64. And XLA fuses
    the sample position (i + 0.5) * inv_scale - 0.5 into one multiply-add,
    rounded once: here the product is exact in float64. (Rounded after
    the multiply, the positions drift by up to an ulp of the column index,
    6.1e-5 px at 1241 -> 1034, and the weights by up to 5.1e-5.)"""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
                * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    safe = np.where(total != 0, total, f32(1.0))
    weights = np.where(
        np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps,
        weights / safe, f32(0.0),
    )
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size) - f32(0.5))
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_matrices(in_hw, out_hw, device):
    """(wy^T (oh, h), wx (w, ow)): the weights of `resize_linear` from in_hw
    to out_hw as float32 tensors on `device`, built once per pyramid level."""
    (h, w), (oh, ow) = in_hw, out_hw
    wyT = torch.from_numpy(resize_weights(h, oh)).T.contiguous().to(device)
    wx = torch.from_numpy(resize_weights(w, ow)).to(device)
    return wyT, wx


def resize_linear(img: torch.Tensor, mats) -> torch.Tensor:
    """Antialiased bilinear resize of (..., h, w), as two fp32 matmuls
    against the `resize_matrices` weights."""
    wyT, wx = mats
    return wyT @ img @ wx
