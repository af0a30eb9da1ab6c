"""Batched PnP-RANSAC + robust Gauss-Newton refinement (port of
tracking/pnp.py).

The random draws come in as tensors — `gumbel` (H, N) for the minimal-set
sampling and `twist_noise` (H, 6) for the hypothesis-start diversity —
instead of a key. The drivers draw them on the device from the JAX
package's own stream (`utils/prng.pnp_draws`: split(key) -> gumbel,
normal, as tracking/pnp.py there), so both packages fit the same
hypotheses.

On the card the per-frame tracker calls `graphed(...)`: the same function
captured once as a CUDA graph and replayed, one launch from the host where
the eager call makes some 5,700 (see `GraphedPnP`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from stereo_visual_slam_tpu_torch.ba import residuals as res
from stereo_visual_slam_tpu_torch.geom import se3
from stereo_visual_slam_tpu_torch.geom.linalg import solve6
from stereo_visual_slam_tpu_torch.ops.fast import top_k_stable
from stereo_visual_slam_tpu_torch.utils import trace


class PnPResult(NamedTuple):
    T_c_w: torch.Tensor        # (4, 4) estimated pose
    inlier_mask: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor    # () int32
    best_score: torch.Tensor   # () int32 — inliers of the winning hypothesis


def _gn_step(T, pts_w, uv, w, K, damping):
    """One damped Gauss-Newton step on pose only, batched over leading dims
    of T (..., 4, 4); pts_w (..., n, 3), uv (..., n, 2), w (..., n)."""
    r, Jp, depth_ok = res.reprojection_residual_jac(T[..., None, :, :], pts_w, uv, K)
    w = w * depth_ok
    JtJ = torch.einsum("...nri,...nrj,...n->...ij", Jp, Jp, w)
    Jtr = torch.einsum("...nri,...nr,...n->...i", Jp, r, w)
    A = JtJ + damping * torch.eye(6, dtype=T.dtype, device=T.device)
    delta = solve6(A, -Jtr)
    return se3.compose(se3.exp(delta), T)


_START_WEIGHTS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _start_weights(H: int, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H,) 0 for the first half of the hypotheses and the ramp 0..1 over
    the rest, and the (6,) per-axis weights of a start's twist; made once
    per (H, dtype, device). Made per call they were launches every frame and
    a copy from the host, which a CUDA graph cannot capture."""
    key = (H, dtype, torch.device(device))
    if key not in _START_WEIGHTS:
        ramp = torch.linspace(0.0, 1.0, H, dtype=dtype, device=device)
        half = torch.where(torch.arange(H, device=device) < H // 2, 0.0, ramp)
        rot_w = torch.tensor([1.0, 1.0, 1.0, 0.05, 0.05, 0.05], dtype=dtype, device=device)
        _START_WEIGHTS[key] = (half, rot_w)
    return _START_WEIGHTS[key]


def solve_pnp_ransac(
    pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
    K: torch.Tensor, T_init: torch.Tensor,
    gumbel: torch.Tensor, twist_noise: torch.Tensor, *,
    sample_size: int = 4, inlier_px: float = 4.0,
    gn_iters_hypothesis: int = 10, gn_iters_refine: int = 10,
    huber_px: float = 4.0, prior_spread=0.0,
) -> PnPResult:
    """Estimate T_c_w from world points (N, 3) and pixels (N, 2) with
    outliers; H = gumbel.shape[0] hypotheses start from T_init (half of
    them perturbed by twist_noise scaled up to prior_spread)."""
    H = gumbel.shape[0]
    dtype, dev = pts_w.dtype, pts_w.device

    # --- H minimal sets over valid entries (Gumbel top-k, lowest index
    #     first among ties, -inf ties included)
    g = torch.where(valid[None, :], gumbel, float("-inf"))
    _, sample_idx = top_k_stable(g, sample_size)             # (H, S)

    # --- hypothesis starts: half the exact prior, half perturbed
    half, rot_w = _start_weights(H, dtype, dev)
    scale = half * prior_spread
    twists = twist_noise * scale[:, None] * rot_w
    T_starts = se3.compose(se3.exp(twists), T_init)          # (H, 4, 4)

    p = pts_w[sample_idx]                                    # (H, S, 3)
    u = uv[sample_idx]                                       # (H, S, 2)
    w = torch.ones((H, sample_size), dtype=dtype, device=dev)
    T_hyp = T_starts
    for _ in range(gn_iters_hypothesis):
        T_hyp = _gn_step(T_hyp, p, u, w, K, 1e-4)

    # --- score every hypothesis against every point
    r, _, depth_ok = res.reprojection_residual_jac(T_hyp[:, None], pts_w[None], uv[None], K)
    err = torch.linalg.vector_norm(r, dim=-1)
    inlier_sets = valid[None] & depth_ok.bool() & (err < inlier_px)  # (H, N)
    scores = inlier_sets.sum(dim=1, dtype=torch.int32)
    # the winner by a one-element index: indexing by the 0-dim argmax would
    # read it on the host
    best = torch.argmax(scores).reshape(1)
    best_score = scores.index_select(0, best)[0]
    T_best = T_hyp.index_select(0, best)[0]
    inl0 = inlier_sets.index_select(0, best)[0].to(dtype)

    # --- robust refinement on the winning consensus set
    T_ref = T_best
    for _ in range(gn_iters_refine):
        r, _, depth_ok = res.reprojection_residual_jac(T_ref, pts_w, uv, K)
        w_ref = res.huber_weight(r, huber_px) * inl0 * depth_ok
        T_ref = _gn_step(T_ref, pts_w, uv, w_ref, K, 1e-6)
    T_ref = se3.normalize_rotation(T_ref)

    # --- final inlier classification at the refined pose
    r, _, depth_ok = res.reprojection_residual_jac(T_ref, pts_w, uv, K)
    err = torch.linalg.vector_norm(r, dim=-1)
    inlier_mask = valid & depth_ok.bool() & (err < inlier_px)
    ok = best_score >= 4
    T_out = torch.where(ok, T_ref, T_init)
    inlier_mask = inlier_mask & ok
    return PnPResult(
        T_c_w=T_out,
        inlier_mask=inlier_mask,
        n_inliers=inlier_mask.sum(dtype=torch.int32),
        best_score=best_score,
    )


class _Graph(NamedTuple):
    """One capture of `solve_pnp_ransac`: its static inputs (the tensor
    arguments, then `prior_spread` as a 0-dim tensor), the graph, and the
    outputs each replay writes."""

    inputs: Tuple[torch.Tensor, ...]
    graph: torch.cuda.CUDAGraph
    outputs: PnPResult


def _load(static: Tuple[torch.Tensor, ...], inputs, prior_spread) -> None:
    """Copy a call's arguments into a graph's static inputs, on the current
    stream: no copy from the host, no wait."""
    for buf, x in zip(static[:-1], inputs):
        buf.copy_(x)
    if torch.is_tensor(prior_spread):
        static[-1].copy_(prior_spread)
    else:
        static[-1].fill_(prior_spread)


class GraphedPnP:
    """`solve_pnp_ransac` with its settings fixed: the same arguments, the
    same values (the graph replays the kernels of the eager call, in its
    order and with its launch shapes).

    CUDA inputs replay a CUDA graph: the first call of a (device, N, H,
    dtype) warms the eager function up on a side stream, as capture
    requires, captures it into a private memory pool and replays it; later
    calls copy their inputs into the graph's static buffers and replay. The
    four outputs are cloned, since the next replay overwrites them. CPU
    inputs, and any call under a TorchDispatchMode (the cost model's
    counter, which a replay would bypass), run the eager function.

    `captures` and `replays` count graphs captured and replayed; the tracer
    counts `track.pnp_graph` a replay and `track.pnp_eager` an eager call."""

    def __init__(self, **settings):
        self.settings = settings
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, pts_w, uv, valid, K, T_init, gumbel, twist_noise, *,
                 prior_spread=0.0) -> PnPResult:
        inputs = (pts_w, uv, valid, K, T_init, gumbel, twist_noise)
        if not pts_w.is_cuda or is_in_torch_dispatch_mode():
            trace.add("track.pnp_eager", 1)
            return solve_pnp_ransac(*inputs, prior_spread=prior_spread, **self.settings)
        key = (pts_w.device, pts_w.shape[0], gumbel.shape[0], pts_w.dtype)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(inputs, prior_spread)
        else:
            _load(g.inputs, inputs, prior_spread)
        g.graph.replay()
        self.replays += 1
        trace.add("track.pnp_graph", 1)
        return PnPResult(*[t.clone() for t in g.outputs])

    def _capture(self, inputs, prior_spread) -> _Graph:
        dev = inputs[0].device
        static = tuple(torch.empty_like(x) for x in inputs) + (
            torch.empty((), dtype=inputs[0].dtype, device=dev),)
        _load(static, inputs, prior_spread)

        def body():
            return solve_pnp_ransac(*static[:-1], prior_spread=static[-1], **self.settings)

        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(3):
                body()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph, stream=side):
            outputs = body()
        self.captures += 1
        return _Graph(static, graph, outputs)


_GRAPHED: Dict[tuple, GraphedPnP] = {}


def graphed(**settings) -> GraphedPnP:
    """The process's one `GraphedPnP` for these settings (`solve_pnp_ransac`'s
    keywords but `prior_spread`): every tracker built with them shares its
    graphs, so a graph is captured once a process, not once a driver."""
    key = tuple(sorted(settings.items()))
    if key not in _GRAPHED:
        _GRAPHED[key] = GraphedPnP(**settings)
    return _GRAPHED[key]
