"""PnP-RANSAC as the tracker calls it, on the CPU: `solve_pnp_ransac`,
written so that a CUDA graph can capture it (its constants made once, the
winner picked by a one-element index, `se3.make` with no scalar write),
is bit-equal to the port's plain path as the benchmark froze it
(slam_bench/reference, commit c627a7a) on clean points, on 30 % outliers,
with perturbed starts and with fewer than 4 valid points (the prior pose
kept); and `se3.make` is bit-equal to the frozen one batched and
unbatched.

How the tracker's `pnp.graphed` runs it (eager on the CPU and under a
TorchDispatchMode, one capture shared a process) is tested with the BA
schedule's in tests/test_torch_cuda_graph.py. The card's side (graph
against eager, replays, syncs) is in tests/test_torch_pnp_graph_cuda.py."""

import numpy as np
import pytest
import torch

from slam_bench.reference import pnp as ref_pnp
from slam_bench.reference import se3 as ref_se3
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.tracking import pnp

# the suite runs in several pytest-xdist workers on a few cores: one
# intra-op thread per process keeps the many small torch ops from
# oversubscribing the CPU
torch.set_num_threads(1)

FX, FY, CX, CY = 718.856, 718.856, 607.1928, 185.2157
K = torch.tensor([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], dtype=torch.float32)
H = 128
SETTINGS = dict(sample_size=4, inlier_px=4.0, gn_iters_hypothesis=10, gn_iters_refine=10,
                huber_px=4.0)


def scene(seed, n=300, outliers=0, n_valid=None, spread=0.0):
    """PnP's inputs: points ahead of a driving camera, their pixels under a
    known pose with 0.5 px noise, `outliers` of them thrown 30-200 px off,
    the first `n_valid` valid (all if None), the draws from `seed`."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                    rng.uniform(8, 60, n)], -1).astype(np.float32)
    T_gt = se3.exp(torch.tensor([0.3, -0.1, 0.8, 0.01, 0.03, -0.005]))
    Xc = pts @ T_gt[:3, :3].numpy().T + T_gt[:3, 3].numpy()
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)
    uv = uv + rng.normal(0, 0.5, (n, 2))
    uv[:outliers] += rng.uniform(30, 200, (outliers, 2)) * rng.choice([-1, 1], (outliers, 2))
    valid = np.ones(n, bool)
    if n_valid is not None:
        valid[n_valid:] = False
    gumbel = -np.log(-np.log(rng.uniform(1e-6, 1.0, (H, n))))
    twist = rng.normal(0, 1, (H, 6))
    T_init = se3.exp(torch.tensor([0.25, -0.05, 0.7, 0.0, 0.02, 0.0]))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return dict(args=(f32(pts), f32(uv), torch.from_numpy(valid), K, T_init, f32(gumbel),
                      f32(twist)), prior_spread=spread)


SCENES = {
    "clean": dict(seed=0),
    "outliers_30pct": dict(seed=1, outliers=90),
    "prior_spread": dict(seed=2, outliers=60, spread=0.3),
    "three_valid": dict(seed=3, n_valid=3, spread=0.3),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_pnp_bit_equal_to_the_frozen_plain_path(name):
    s = scene(**SCENES[name])
    a = ref_pnp.solve_pnp_ransac(*s["args"], prior_spread=s["prior_spread"], **SETTINGS)
    b = pnp.solve_pnp_ransac(*s["args"], prior_spread=s["prior_spread"], **SETTINGS)
    for field in pnp.PnPResult._fields:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert torch.equal(x, y), field
    if name == "three_valid":
        # under 4 valid points no hypothesis scores 4: the prior pose stays
        assert int(b.best_score) < 4 and int(b.n_inliers) == 0
        assert torch.equal(b.T_c_w, s["args"][4])
    else:
        assert int(b.n_inliers) >= 150


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)], ids=["unbatched", "5", "2x3"])
def test_se3_make_bit_equal_to_the_frozen_one(batch):
    g = torch.Generator().manual_seed(len(batch))
    R = torch.randn(batch + (3, 3), generator=g)
    t = torch.randn(batch + (3,), generator=g)
    T = se3.make(R, t)
    assert T.is_contiguous()
    assert torch.equal(T, ref_se3.make(R, t))
    # t broadcast against a batch of rotations
    if batch:
        assert torch.equal(se3.make(R, t[(0,) * len(batch)]),
                           ref_se3.make(R, t[(0,) * len(batch)]))
