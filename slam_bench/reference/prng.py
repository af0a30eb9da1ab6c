# Frozen copy of stereo_visual_slam_tpu_torch/utils/prng.py at commit c627a7a, part of
# the benchmark's plain reference: imports renamed, nothing else changed.
"""The JAX package's random stream: `jax.random` with its default
threefry2x32 implementation and `jax_threefry_partitionable` on, as JAX
0.9.0 runs it, so the port draws the numbers the JAX package draws.

Keys are pairs of uint32 held as Python ints on the host: `prng_key`,
`fold_in` and `split` run threefry in plain integers and cost no launch
and no sync. Bits are made on the device: the counters of the partitionable
layout (the flat index of each element, as a 64-bit iota split into high
and low words) go through the 20 rounds as torch int64 lanes masked to 32
bits (torch's uint32 has no shifts on the CPU). One pass serves many keys
and shapes at once (`_bits`), so a chunk's frames pay one threefry pass.

The distributions follow jax/_src/random.py: `uniform` puts the top 23
bits into the mantissa of a float in [1, 2), subtracts 1, scales and
clamps at `minval` (bit-equal to jax); `gumbel` is -log(-log(U)) with U on
[tiny, 1) (jax's mode "low"); `normal` is sqrt(2) * erfinv(U) with U on
(-1, 1), erfinv by XLA's own single-precision polynomial (Giles), not
torch.erfinv (60-90 ulps from XLA's). torch's `log` and `log1p` are not
XLA's: gumbel and normal values may differ from jax's in the last bits
(tests/test_torch_prng.py states the bound).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_TINY = float(np.finfo(np.float32).tiny)
# jax's normal draws U on [nextafter(-1, 0), 1)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): w =
# -log1p(-x*x), then a degree-8 polynomial in w - 2.5 (w < 5) or in
# sqrt(w) - 3, highest coefficient first
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _schedule(k1, k2):
    """The key words each of threefry's five injections adds: x0 gets
    ks[(i+1) % 3], x1 gets ks[(i+2) % 3] + i + 1, ks = (k1, k2, k1^k2^C)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    return [(ks[(i + 1) % 3], (ks[(i + 2) % 3] + i + 1) & _MASK) for i in range(5)]


def _rounds(x0, x1, injections):
    """threefry2x32's 20 rounds on (x0 + k1, x1 + k2), both already masked
    to 32 bits: Python ints or int64 tensors. x0 is masked once a group of
    four rounds (its high bits never reach x1, which is masked every
    round), so a round costs six elementwise ops."""
    for i, (a, b) in enumerate(injections):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK
        x0 = (x0 + a) & _MASK
        x1 = (x1 + b) & _MASK
    return x0, x1


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """The threefry2x32 hash of one counter pair under `key`, on the host."""
    k1, k2 = key
    return _rounds((x0 + k1) & _MASK, (x1 + k2) & _MASK, _schedule(k1, k2))


def prng_key(seed: int) -> Key:
    """jax.random.PRNGKey(seed) with x64 off: the seed is taken as a 32-bit
    integer, so the key is (0, seed mod 2**32) (-1 gives (0, 2**32 - 1),
    2**32 + 5 gives (0, 5))."""
    return (0, int(seed) & _MASK)


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in: threefry of the counter pair (0, data)."""
    return threefry2x32(key, 0, int(data) & _MASK)


def split(key: Key, num: int = 2) -> List[Key]:
    """jax.random.split (the partitionable, fold-like form): key i is
    threefry of the counter pair (0, i)."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def _key_table(keys: Sequence[Key]) -> np.ndarray:
    """(R, 12) int64: per key, x1's and x0's start words (k2, k1), then the
    five (x0, x1) injections."""
    rows = []
    for k1, k2 in keys:
        row = [k2, k1]
        for a, b in _schedule(k1, k2):
            row += [a, b]
        rows.append(row)
    return np.asarray(rows, np.int64).reshape(-1, 12)


def _to_device(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """The host table on `device`; on a card through pinned memory, queued
    on the stream without a wait."""
    t = torch.from_numpy(table)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _bits(segments: Sequence[Tuple[Sequence[Key], Tuple[int, ...]]], device) -> List[torch.Tensor]:
    """jax.random.bits (uint32) for every (keys, shape) segment in ONE
    threefry pass: segment s gives an int64 tensor (len(keys), *shape)
    holding uint32 values, row r drawn with keys[r]."""
    device = torch.device(device)
    table = _to_device(_key_table([k for keys, _ in segments for k in keys]), device)
    counts, tabs = [], []
    start = 0
    for keys, shape in segments:
        r, m = len(keys), math.prod(shape)
        if m >= 1 << 32:
            raise ValueError(f"random bits: {m} elements need 64-bit counters")
        counts.append(torch.arange(m, dtype=torch.int64, device=device).expand(r, m).reshape(-1))
        tabs.append(table[start:start + r, None, :].expand(r, m, 12).reshape(-1, 12))
        start += r
    lo = counts[0] if len(counts) == 1 else torch.cat(counts)
    tab = tabs[0] if len(tabs) == 1 else torch.cat(tabs)
    # counter (hi, lo) = (0, flat index); hi + k1 = k1
    x0, x1 = _rounds(tab[:, 1], (lo + tab[:, 0]) & _MASK,
                     [(tab[:, 2 + 2 * i], tab[:, 3 + 2 * i]) for i in range(5)])
    flat = x0 ^ x1
    out, start = [], 0
    for keys, shape in segments:
        n = len(keys) * math.prod(shape)
        out.append(flat[start:start + n].view(len(keys), *shape))
        start += n
    return out


def random_bits(key: Key, shape: Tuple[int, ...], device) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32) as an int64 tensor."""
    return _bits([([key], tuple(shape))], device)[0][0]


def _uniform_of_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """jax's _uniform for float32 on given bits: the top 23 bits as the
    mantissa of [1, 2), minus 1, times (maxval - minval), plus minval,
    clamped below at minval. XLA's CPU code fuses the multiply and the add
    into one FMA; here the product is exact in float64 and the sum is
    rounded to float64, then to float32 (bit-equal to jax on every case of
    tests/test_torch_prng.py; the two differ only where a sum falls within
    2**-29 of a float32 tie)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = float(hi - lo)
    floats = ((bits >> 9) | _F32_ONE_BITS).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min((floats.double() * scale + float(lo)).float(), float(lo))


def _gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(_uniform_of_bits(bits, _TINY, 1.0)))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: Giles' polynomial, +-inf at +-1."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, float(np.float32(a)), float(np.float32(b)))
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    return erfinv(_uniform_of_bits(bits, _NORMAL_LO, 1.0)) * _SQRT2


def uniform(key: Key, shape, device, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    return _uniform_of_bits(random_bits(key, shape, device), minval, maxval)


def gumbel(key: Key, shape, device) -> torch.Tensor:
    """jax.random.gumbel(key, shape, float32) (mode "low")."""
    return _gumbel_of_bits(random_bits(key, shape, device))


def normal(key: Key, shape, device) -> torch.Tensor:
    """jax.random.normal(key, shape, float32)."""
    return _normal_of_bits(random_bits(key, shape, device))


def pnp_draws_batch(keys: Sequence[Key], n_hypotheses: int, n: int, device):
    """For each key, the draws of the JAX package's PnP-RANSAC
    (tracking/pnp.py there: split(key) -> gumbel (H, N) to sample the
    minimal sets, normal (H, 6) to perturb the hypotheses' starts), as
    (gumbel (B, H, N), twist_noise (B, H, 6)), all in one threefry pass."""
    halves = [split(k) for k in keys]
    g_bits, t_bits = _bits([([h[0] for h in halves], (n_hypotheses, n)),
                            ([h[1] for h in halves], (n_hypotheses, 6))], device)
    return _gumbel_of_bits(g_bits), _normal_of_bits(t_bits)


def pnp_draws(key: Key, n_hypotheses: int, n: int, device):
    """One key's PnP draws: (gumbel (H, N), twist_noise (H, 6))."""
    g, t = pnp_draws_batch([key], n_hypotheses, n, device)
    return g[0], t[0]


def frame_draws(key: Key, n_hypotheses: int, n: int, device):
    """The chunk program's draws: a function of a chunk's frame ids giving
    one (gumbel, twist_noise) pair a frame, frame f drawn from
    fold_in(key, f) (slam_core.py's scan in the JAX package, `key` its
    driver's PRNGKey(seed)). The whole chunk takes one threefry pass."""

    def draws(frame_ids: Sequence[int]):
        g, t = pnp_draws_batch([fold_in(key, f) for f in frame_ids], n_hypotheses, n, device)
        return list(zip(g.unbind(0), t.unbind(0)))

    return draws
