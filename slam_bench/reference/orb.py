# Frozen copy of stereo_visual_slam_tpu_torch/ops/orb.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""BRIEF description, upright and orientation-steered (port of ops/orb.py).

`brief_pattern`, `_centroid_weights` and `_steering_matrix` are numpy and
copied verbatim from the JAX module (which imports jax), so both packages
build the same constants.

Steering: the intensity-centroid angle of each patch picks one of 30
12-degree bins, and the bits come from that bin's columns of the steering
matrix. The reference's XLA gather rounds the patches to bf16 before the
centroid moments; the port's gather (and K2) gives exact f32 values, so
`describe_patches` rounds them to bf16 before the moments too, or the
angle bins would differ on blurred images.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_PATTERN_SEED = 20240817
_PATTERN_RADIUS = 15.0
_PATTERN_SIGMA = 6.6
_N_ANGLE_BINS = 30


@functools.lru_cache()
def brief_pattern(bits: int = 256) -> np.ndarray:
    """(bits, 2, 2) float32: for each bit, two (y, x) offsets from center."""
    rng = np.random.default_rng(_PATTERN_SEED)
    pts = rng.normal(0.0, _PATTERN_SIGMA, size=(bits, 2, 2))
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, _PATTERN_RADIUS / np.maximum(r, 1e-6))
    return (pts * scale).astype(np.float32)


@functools.lru_cache()
def _steering_matrix(bits: int, patch: int) -> np.ndarray:
    """(patch^2, n_bins * bits) float32 constant: column [r * bits + b] holds
    +bilinear weights at pattern point B of bit b rotated by bin angle r and
    -bilinear weights at point A, so patch . column = I_b - I_a."""
    P = patch
    r0 = P // 2
    pat = brief_pattern(bits)
    M = np.zeros((P * P, _N_ANGLE_BINS * bits), np.float32)
    for rbin in range(_N_ANGLE_BINS):
        th = 2.0 * np.pi * rbin / _N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for b in range(bits):
            for which, sign in ((0, -1.0), (1, +1.0)):
                py, px = pat[b, which]
                ry = s * px + c * py
                rx = c * px - s * py
                fy = np.clip(ry + r0, 0.0, P - 1.001)
                fx = np.clip(rx + r0, 0.0, P - 1.001)
                y0, x0 = int(np.floor(fy)), int(np.floor(fx))
                wy, wx = fy - y0, fx - x0
                col = rbin * bits + b
                M[y0 * P + x0, col] += sign * (1 - wy) * (1 - wx)
                M[y0 * P + x0 + 1, col] += sign * (1 - wy) * wx
                M[(y0 + 1) * P + x0, col] += sign * wy * (1 - wx)
                M[(y0 + 1) * P + x0 + 1, col] += sign * wy * wx
    return M


@functools.lru_cache()
def _centroid_weights(patch: int, radius: int) -> np.ndarray:
    """Circular-mask y/x moment weight maps, flattened (patch^2, 2)."""
    r = patch // 2
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = (ys * ys + xs * xs) <= radius * radius
    wy = (ys * mask).astype(np.float32).reshape(-1)
    wx = (xs * mask).astype(np.float32).reshape(-1)
    return np.stack([wy, wx], axis=-1)


@functools.lru_cache()
def brief_matrix_bf16(bits: int, patch: int, steer: bool) -> np.ndarray:
    """The steering matrix (all 30 bins when `steer`, else the bin-0
    columns) rounded to bf16 and widened back to float32 — the operand of
    the reference's BRIEF matmul."""
    M = _steering_matrix(bits, patch)
    M = torch.from_numpy(np.ascontiguousarray(M if steer else M[:, :bits]))
    return M.to(torch.bfloat16).float().numpy()


def orientations(patches: torch.Tensor, radius: int = 15) -> torch.Tensor:
    """Intensity-centroid angle per patch: (N, P, P) -> (N,) radians."""
    P = patches.shape[-1]
    Wm = torch.from_numpy(_centroid_weights(P, radius)).to(patches.device)
    m = patches.reshape(patches.shape[0], -1) @ Wm     # (N, 2) = (m01, m10)
    return torch.atan2(m[:, 0], m[:, 1])


def pack_bits(bits_bool: torch.Tensor) -> torch.Tensor:
    """(N, bits) bool -> (N, bits // 32) descriptor words. The values are
    the reference's uint32 words, held in int64 (torch has few uint32 ops)."""
    N, B = bits_bool.shape
    w = bits_bool.reshape(N, B // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits_bool.device)
    return torch.sum(w << shifts, dim=-1)


def describe_patches(patches: torch.Tensor, M: torch.Tensor, steer: bool = False):
    """BRIEF of pre-gathered (N, P, P) patches, steered when `steer`.

    M is `brief_matrix_bf16(bits, P, steer)` on the patches' device. The
    reference's product is bf16 x bf16 with f32 accumulation
    (orb.py:178-195): both operands are rounded to bf16 here and multiplied
    as fp32 (TF32 off), so every product is exact and only the f32
    summation order can differ. Steered, the (N, 30 * bits) product holds
    every bin's bits and each row keeps its own bin's.
    Returns (packed (N, bits // 32) int64, signs (N, bits) f32 {-1, +1})."""
    N = patches.shape[0]
    flat = patches.reshape(N, -1).to(torch.bfloat16).float()
    if steer:
        bits = M.shape[1] // _N_ANGLE_BINS
        theta = orientations(flat.reshape(patches.shape))
        bin_f = torch.round(theta * (_N_ANGLE_BINS / (2.0 * np.pi)))
        bin_idx = torch.remainder(bin_f.to(torch.int64), _N_ANGLE_BINS)
        diffs = (flat @ M).reshape(N, _N_ANGLE_BINS, bits)
        sel = torch.gather(diffs, 1, bin_idx[:, None, None].expand(N, 1, bits))[:, 0]
    else:
        sel = flat @ M
    bit = sel > 0.0
    return pack_bits(bit), torch.where(bit, 1.0, -1.0)


def hamming_from_signs(signs_a: torch.Tensor, signs_b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance from {-1, +1} descriptors via one matmul:
    hamming = (bits - dot) / 2, exact in fp32 (integers <= bits)."""
    bits = signs_a.shape[-1]
    return (bits - signs_a @ signs_b.T) * 0.5
