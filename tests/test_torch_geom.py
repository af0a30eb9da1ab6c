"""The port's SE(3) core and closed-form solves against the JAX package, on
the same batched random inputs (atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu.geom import linalg as jlinalg
from stereo_visual_slam_tpu.geom import se3 as jse3
from stereo_visual_slam_tpu_torch.geom import linalg as tlinalg
from stereo_visual_slam_tpu_torch.geom import se3 as tse3

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

ATOL = 1e-5


def _twists(seed, n=64, scale=0.5):
    rng = np.random.default_rng(seed)
    tw = rng.normal(0.0, scale, (n, 6)).astype(np.float32)
    tw[:4] *= 1e-4          # near the Taylor branches
    tw[4, 3:] = [np.pi - 1e-3, 0.0, 0.0]  # near pi
    return tw


def _poses(seed, n=64):
    return np.array(jse3.exp(jnp.asarray(_twists(seed, n))))


def _cmp(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("fn", ["exp", "log", "compose", "inverse", "act",
                                "angle_y", "normalize_rotation"])
def test_se3_matches_jax(fn):
    tw = _twists(0)
    A = _poses(1)
    B = _poses(2)
    pts = np.random.default_rng(3).normal(0, 10, (64, 3)).astype(np.float32)
    t = torch.from_numpy
    if fn == "exp":
        _cmp(jse3.exp(jnp.asarray(tw)), tse3.exp(t(tw)))
    elif fn == "log":
        _cmp(jse3.log(jnp.asarray(A)), tse3.log(t(A)))
    elif fn == "compose":
        _cmp(jse3.compose(jnp.asarray(A), jnp.asarray(B)), tse3.compose(t(A), t(B)))
    elif fn == "inverse":
        _cmp(jse3.inverse(jnp.asarray(A)), tse3.inverse(t(A)))
    elif fn == "act":
        _cmp(jse3.act(jnp.asarray(A), jnp.asarray(pts)), tse3.act(t(A), t(pts)))
    elif fn == "angle_y":
        _cmp(jse3.angle_y(jnp.asarray(A)), tse3.angle_y(t(A)))
    else:
        noisy = (A + np.random.default_rng(4).normal(0, 1e-3, A.shape)).astype(np.float32)
        _cmp(jse3.normalize_rotation(jnp.asarray(noisy)), tse3.normalize_rotation(t(noisy)))


def _spd(seed, n, dim):
    rng = np.random.default_rng(seed)
    M = rng.normal(0, 1, (n, dim, dim)).astype(np.float32)
    return (M @ np.swapaxes(M, -1, -2) + np.eye(dim, dtype=np.float32)).astype(np.float32)


def test_inv3x3_matches_jax():
    A = _spd(5, 64, 3)
    _cmp(jlinalg.inv3x3(jnp.asarray(A)), tlinalg.inv3x3(torch.from_numpy(A)))


def test_inv3x3_rank2_blocks_bit_equal_to_jit():
    """BA's landmark blocks seen from one keyframe: J^T J of one 2x3
    Jacobian, rank 2 up to the damping. Their cofactors nearly cancel, so
    the result depends on how the products are rounded; the port's fused
    multiply-adds reproduce the jitted reference bit for bit."""
    rng = np.random.default_rng(8)
    J = rng.normal(0, 50, (4096, 2, 3)).astype(np.float32)
    V = np.einsum("nri,nrj->nij", J, J).astype(np.float32)
    damp = 1e-4 * np.maximum(np.trace(V, axis1=1, axis2=2) / 3, 1.0)
    V = (V + (damp[:, None, None] + 1e-6) * np.eye(3, dtype=np.float32)).astype(np.float32)
    ref = np.asarray(jax.jit(jlinalg.inv3x3)(jnp.asarray(V)))
    np.testing.assert_array_equal(tlinalg.inv3x3(torch.from_numpy(V)).numpy(), ref)


def test_solve6_matches_jax():
    A = _spd(6, 64, 6)
    b = np.random.default_rng(7).normal(0, 1, (64, 6)).astype(np.float32)
    x_j = jlinalg.solve6(jnp.asarray(A), jnp.asarray(b))
    x_t = tlinalg.solve6(torch.from_numpy(A), torch.from_numpy(b))
    _cmp(x_j, x_t)
    # and it solves the system
    np.testing.assert_allclose(np.einsum("nij,nj->ni", A, x_t.numpy()), b, atol=1e-3)
