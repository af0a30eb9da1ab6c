"""The per-keyframe BA schedule (port of ba/schedule.py): classify passes,
full BA (poses kept, landmarks not), pose-only refinement, with the inlier
set flowing from pass to pass.

With `mesh` (the JAX shard_map path), each rank runs the three passes on
its landmark rows of the window, the sums go over the mesh (ba/schur_lm,
ba/pose_only), and the full (L,) inlier verdicts are assembled on every
rank; poses and costs are replicated.

On the card, without a mesh, `make_ba_schedule` hands out the process's
one `GraphedSchedule` for the config: the schedule captured once as a CUDA
graph and replayed, one launch from the host where the eager run makes
6,000-18,000."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from stereo_visual_slam_tpu_torch.ba import pose_only as pose_only_mod
from stereo_visual_slam_tpu_torch.ba import schur_lm
from stereo_visual_slam_tpu_torch.utils import trace
from stereo_visual_slam_tpu_torch.utils.config import BAConfig


class ScheduleInput(NamedTuple):
    """The window; masks are float32 {0, 1}."""

    T_c_w: torch.Tensor       # (K, 4, 4)
    points: torch.Tensor      # (L, 3)
    uv: torch.Tensor          # (L, K, 2)
    obs_mask: torch.Tensor    # (L, K)
    inlier: torch.Tensor      # (L,) current landmark is_inlier flags
    reliable: torch.Tensor    # (L,) landmark reliable_depth_ flags
    present: torch.Tensor     # (L,) row holds a real landmark
    pose_mask: torch.Tensor   # (K,)
    fixed_pose: torch.Tensor  # (K,)


# the fields with a landmark axis (JAX in_specs P(LM_AXIS))
LANDMARK_FIELDS = ("points", "uv", "obs_mask", "inlier", "reliable", "present")


class ScheduleResult(NamedTuple):
    T_c_w: torch.Tensor      # (K, 4, 4) optimized poses
    inlier: torch.Tensor     # (L,) final is_inlier verdicts
    cost_full: torch.Tensor  # () robust cost after the full BA pass
    cost_pose: torch.Tensor  # () robust cost after pose-only
    threshold: torch.Tensor  # () final adaptive chi2 threshold


def make_ba_schedule(cfg: BAConfig, mesh=None) -> "GraphedSchedule":
    """The schedule closed over the static BA config:
    run(inp: ScheduleInput, K) -> ScheduleResult. With `mesh`, every rank
    passes the whole window and gets the whole result (eager); without,
    the process's one `GraphedSchedule` for `cfg` (`graphed`)."""
    return graphed(cfg) if mesh is None else GraphedSchedule(cfg, mesh)


def eager_schedule(cfg: BAConfig, mesh=None):
    """The schedule as eager torch calls: `run(inp, K)`."""
    common = dict(
        huber_delta=cfg.huber_delta,
        chi2_threshold=cfg.chi2_threshold,
        adaptive_rounds=cfg.adaptive_rounds,
        target_inlier_ratio=cfg.target_inlier_ratio,
        lambda_init=cfg.lm_lambda_init,
        lambda_up=cfg.lm_lambda_up,
        lambda_down=cfg.lm_lambda_down,
        rel_tol=cfg.rel_tol,
        mesh=mesh,
    )

    def run(inp: ScheduleInput, K: torch.Tensor) -> ScheduleResult:
        if mesh is not None:
            inp = mesh.shard(inp, LANDMARK_FIELDS)
        inlier = inp.inlier * inp.present

        def problem(point_mask, T):
            return schur_lm.BAProblem(
                T_c_w=T, points=inp.points, uv=inp.uv, obs_mask=inp.obs_mask,
                point_mask=point_mask, pose_mask=inp.pose_mask,
                fixed_pose=inp.fixed_pose,
            )

        def apply_verdict(inlier, participated, verdict):
            # verdicts touch only landmarks that took part in the pass
            return torch.where(participated > 0, inlier * verdict.to(inlier.dtype), inlier)

        T = inp.T_c_w
        for _ in range(cfg.classify_passes):
            pm = inlier * inp.reliable
            r = schur_lm.lm_optimize(problem(pm, T), K, iters=cfg.classify_iters, **common)
            inlier = apply_verdict(inlier, pm, r.landmark_inlier)

        pm = inlier * inp.reliable
        res_full = schur_lm.lm_optimize(problem(pm, T), K, iters=cfg.full_iters, **common)
        T = res_full.T_c_w
        inlier = apply_verdict(inlier, pm, res_full.landmark_inlier)

        res_po = pose_only_mod.optimize_pose_only(
            problem(inlier, T), K, iters=cfg.pose_only_iters, **common
        )
        T = res_po.T_c_w
        inlier = apply_verdict(inlier, inlier, res_po.landmark_inlier)
        if mesh is not None:
            inlier = mesh.all_gather(inlier)
        return ScheduleResult(
            T_c_w=T, inlier=inlier > 0, cost_full=res_full.cost,
            cost_pose=res_po.cost, threshold=res_po.chi2_threshold,
        )

    return run


class _Graph(NamedTuple):
    """One capture of the schedule: its static inputs (the ScheduleInput
    fields, then K), the graph, the outputs each replay writes, and the
    tracer's counters the captured run adds (`trace.collect`)."""

    inputs: Tuple[torch.Tensor, ...]
    graph: torch.cuda.CUDAGraph
    outputs: ScheduleResult
    counts: trace.Counters


class GraphedSchedule:
    """The schedule of `cfg`: the same arguments, the same values (the
    graph replays the kernels of the eager run, in its order and with its
    launch shapes).

    CUDA inputs replay a CUDA graph: the first call of a (device, input
    shapes and dtypes, TF32 setting) warms the eager run up on a side
    stream, as capture requires, captures it into a private memory pool
    and replays it; later calls copy their inputs into the graph's static
    buffers on the current stream (no copy from the host, no wait) and
    replay. The outputs are cloned, since the next replay overwrites them.
    CPU inputs, a call under a TorchDispatchMode (the cost model's counter,
    which a replay would bypass) and a mesh (its collectives) run the eager
    schedule.

    The captured run counts its LM iterations into the graph's outputs
    (`trace.collect`), and each replay adds them to the tracer, so
    `ba.lm_iters` and `ba.lm_useful` read as they do eager. `captures` and
    `replays` count graphs captured and replayed; the tracer counts
    `ba.schedule_graph` a replay and `ba.schedule_eager` an eager call."""

    WARMUP = 3

    def __init__(self, cfg: BAConfig, mesh=None):
        self.mesh = mesh
        self.run = eager_schedule(cfg, mesh)
        self.graphs: Dict[tuple, _Graph] = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, inp: ScheduleInput, K: torch.Tensor) -> ScheduleResult:
        if self.mesh is not None or not inp.points.is_cuda or is_in_torch_dispatch_mode():
            trace.add("ba.schedule_eager", 1)
            return self.run(inp, K)
        inputs = (*inp, K)
        key = (inp.points.device, torch.backends.cuda.matmul.allow_tf32,
               *[(x.shape, x.dtype) for x in inputs])
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(inputs)
        else:
            for buf, x in zip(g.inputs, inputs):
                buf.copy_(x)
        g.graph.replay()
        self.replays += 1
        trace.add("ba.schedule_graph", 1)
        trace.add_counts(g.counts)
        return ScheduleResult(*[t.clone() for t in g.outputs])

    def _capture(self, inputs) -> _Graph:
        dev = inputs[0].device
        static = tuple(x.clone() for x in inputs)

        def body():
            with trace.collect() as counts:
                return self.run(ScheduleInput(*static[:-1]), static[-1]), counts

        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                body()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph, stream=side):
            outputs, counts = body()
        self.captures += 1
        return _Graph(static, graph, outputs, counts)


_GRAPHED: Dict[BAConfig, GraphedSchedule] = {}


def graphed(cfg: BAConfig) -> GraphedSchedule:
    """The process's one `GraphedSchedule` for `cfg`: every driver built
    with it shares its graphs, so a graph is captured once a process, not
    once a driver."""
    if cfg not in _GRAPHED:
        _GRAPHED[cfg] = GraphedSchedule(cfg)
    return _GRAPHED[cfg]
