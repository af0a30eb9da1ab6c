"""A stage of the port replayed as one CUDA graph: one launch from the host
where the eager stage makes thousands (PnP-RANSAC some 5,700 a frame, the
BA schedule 6,000-18,000 a keyframe).

    run = cuda_graph.shared(("ba.schedule", cfg),
                            lambda: cuda_graph.Graphed(fn, "ba.schedule"))
    res = run(inp, K)          # the same arguments and values as fn(inp, K)

`fn` takes tensors, NamedTuples of tensors and Python numbers (as
arguments or keywords) and returns a NamedTuple of tensors; it must wait
on the host nowhere, as capture requires.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from stereo_visual_slam_tpu_torch.ops import kernels
from stereo_visual_slam_tpu_torch.utils import trace

WARMUP = 3


class _Capture(NamedTuple):
    """One capture: its static inputs (the arguments' leaves, a number as
    a 0-dim tensor), the graph, the outputs each replay writes, the
    tracer's counters the captured run adds (`trace.collect`) and the
    hand kernels it launches (`kernels.collect_launches`)."""

    inputs: Tuple[torch.Tensor, ...]
    graph: torch.cuda.CUDAGraph
    outputs: NamedTuple
    counts: trace.Counters
    launches: dict


class Graphed:
    """`fn` with the same arguments and the same values: the graph replays
    the kernels of the eager call, in its order and with its launch shapes.

    CUDA inputs replay a CUDA graph: the first call of a (device, TF32
    setting, shape and dtype of every input) warms `fn` up WARMUP times on
    a side stream, captures it into a private memory pool and replays it;
    later calls copy their inputs into the static buffers and replay. A
    Python number enters as a 0-dim tensor of the first input's dtype,
    filled each call. The outputs are cloned, since the next replay
    overwrites them. CPU inputs, and any call under a TorchDispatchMode
    (the cost model's counter, which a replay would bypass), run `fn`.

    The captured run counts into the graph's outputs (`trace.collect`,
    `kernels.collect_launches`) and each replay hands the counts on, so
    the tracer's counters and the hand kernels' launch counters read as
    they do eager.
    `captures` and `replays` count graphs captured and replayed; the tracer
    counts `<name>_graph` a replay and `<name>_eager` an eager call."""

    def __init__(self, fn: Callable, name: str):
        self.fn, self.name = fn, name
        self.graphs: Dict[tuple, _Capture] = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *args, **kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        first = next(x for x in leaves if torch.is_tensor(x))
        if not first.is_cuda or is_in_torch_dispatch_mode():
            trace.add(self.name + "_eager", 1)
            return self.fn(*args, **kwargs)
        key = (first.device, torch.backends.cuda.matmul.allow_tf32,
               *[(x.shape, x.dtype) if torch.is_tensor(x) else (torch.Size(), first.dtype)
                 for x in leaves])
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(leaves, spec, first)
        else:   # on the current stream: no copy from the host, no wait
            for buf, x in zip(g.inputs, leaves):
                if torch.is_tensor(x):
                    buf.copy_(x)
                else:
                    buf.fill_(x)
        g.graph.replay()
        self.replays += 1
        trace.add(self.name + "_graph", 1)
        trace.add_counts(g.counts)
        kernels.add_launches(g.launches)
        return type(g.outputs)(*[t.clone() for t in g.outputs])

    def _capture(self, leaves, spec, first) -> _Capture:
        dev = first.device
        static = tuple(x.clone() if torch.is_tensor(x) else
                       torch.full((), x, dtype=first.dtype, device=dev) for x in leaves)
        args, kwargs = pytree.tree_unflatten(list(static), spec)

        def body():
            with trace.collect() as counts, kernels.collect_launches() as launches:
                out = self.fn(*args, **kwargs)
            return out, counts, launches

        stream = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                body()
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.graph(graph, stream=side):
            outputs, counts, launches = body()
        self.captures += 1
        return _Capture(static, graph, outputs, counts, launches)


_SHARED: Dict[Hashable, Graphed] = {}


def shared(key: Hashable, make: Callable[[], Graphed]) -> Graphed:
    """The process's one `Graphed` for `key`, made by `make()` at its first
    use: every driver built with it shares its graphs, so a graph is
    captured once a process, not once a driver."""
    if key not in _SHARED:
        _SHARED[key] = make()
    return _SHARED[key]
