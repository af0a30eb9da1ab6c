"""The port's tracer: spans and counters at its layer boundaries, off by
default.

    from stereo_visual_slam_tpu_torch.utils import trace

    with trace.span("track", frame=fid):
        ...
    trace.add("ba.lm_iters", iters)        # a host int
    trace.add("ba.lm_useful", ~done)       # a device tensor, no sync
    rows, totals = trace.drain()           # one sync

Off (the default), `span` returns one shared no-op context and `add`
returns at once: neither creates a tensor, launches anything or calls
`record_function`. A caller that would have to compute a value for `add`
asks `enabled()` first.

On (`enable()`), a span appends one `Row` when it opens: its name, its id,
its parent's id (the innermost span open then), the chunk and frame ids
(given as keywords, else its parent's), and its start and end from
`time.time_ns()`. That is Unix time, the clock on which kineto stamps a
torch.profiler trace's events (`start_ns()`), so the rows lie on a device
trace; `time.perf_counter` runs on another clock. A span also opens
`torch.profiler.record_function("svs." + name)`, so that any profiler
trace shows the program's layers. A span never synchronizes: its wall is
the host's time in the layer, dispatch plus any wait inside it.

`add` sums host numbers on the host and device tensors into one device
tensor per name. `drain()` returns the closed rows and every counter's
total with one sync, and clears them.

Inside `collect()`, on or off, `enabled()` is true and the counters go to
the `Counters` it yields instead: code captured into a CUDA graph counts
into the graph's own outputs, and its caller hands them on with
`add_counts` after each replay (utils/cuda_graph.Graphed).

The tracer is one per process, like torch's profiler, and spans open and
close on one thread: the drivers dispatch from one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "svs."


@dataclasses.dataclass(slots=True)
class Row:
    """One span: ids, and start and end in Unix ns (kineto's clock)."""

    name: str
    id: int
    parent: Optional[int]
    chunk: Optional[int]
    frame: Optional[int]
    t0: int
    t1: Optional[int] = None


class Counters:
    """Counter totals: host numbers, and one device tensor per name."""

    __slots__ = ("host", "device")

    def __init__(self):
        self.host: Dict[str, float] = {}
        self.device: Dict[str, torch.Tensor] = {}

    def add(self, name: str, value) -> None:
        if torch.is_tensor(value):
            v = value.sum()
            self.device[name] = self.device[name] + v if name in self.device else v
        else:
            self.host[name] = self.host.get(name, 0) + value


class _Tracer:
    def __init__(self):
        self.on = False
        self.rows: List[Row] = []
        self.open: List[Row] = []
        self.ids = itertools.count()
        self.counters = Counters()
        self.sink: Optional[Counters] = None   # `collect()`'s


_TRACER = _Tracer()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "chunk", "frame", "row", "rf")

    def __init__(self, name: str, chunk: Optional[int], frame: Optional[int]):
        self.name, self.chunk, self.frame = name, chunk, frame

    def __enter__(self) -> Row:
        tr = _TRACER
        parent = tr.open[-1] if tr.open else None
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        self.row = Row(
            self.name, next(tr.ids), parent.id if parent else None,
            self.chunk if self.chunk is not None else (parent.chunk if parent else None),
            self.frame if self.frame is not None else (parent.frame if parent else None),
            time.time_ns())
        tr.rows.append(self.row)
        tr.open.append(self.row)
        return self.row

    def __exit__(self, *exc) -> bool:
        self.row.t1 = time.time_ns()
        _TRACER.open.remove(self.row)
        self.rf.__exit__(*exc)
        return False


def enable() -> None:
    _TRACER.on = True


def disable() -> None:
    """Stop recording; what was recorded waits for `drain()`."""
    _TRACER.on = False


def enabled() -> bool:
    """Whether `add` counts (the tracer on, or inside `collect()`)."""
    return _TRACER.on or _TRACER.sink is not None


def span(name: str, *, chunk: Optional[int] = None, frame: Optional[int] = None):
    """A context around one layer's call (see the module's docstring)."""
    if not _TRACER.on:
        return _OFF
    return _Span(name, chunk, frame)


def add(name: str, value) -> None:
    """Add `value` (a host number, or a device tensor, summed) to the
    counter `name`."""
    tr = _TRACER
    if tr.sink is not None:
        tr.sink.add(name, value)
    elif tr.on:
        tr.counters.add(name, value)


def add_counts(counts: Counters) -> None:
    """`add` every counter of `counts` (what a `collect()` gathered)."""
    if not enabled():
        return
    for name, v in counts.host.items():
        add(name, v)
    for name, v in counts.device.items():
        add(name, v)


@contextlib.contextmanager
def collect():
    """Counters added inside go to the yielded `Counters`, whether the
    tracer is on or off; spans are unchanged."""
    tr = _TRACER
    saved, tr.sink = tr.sink, Counters()
    try:
        yield tr.sink
    finally:
        tr.sink = saved


def drain() -> Tuple[List[Row], Dict[str, float]]:
    """(the closed rows in the order they opened, {counter: total}) with one
    sync; both are cleared (a span still open stays for the next drain)."""
    tr = _TRACER
    rows = [r for r in tr.rows if r.t1 is not None]
    tr.rows = [r for r in tr.rows if r.t1 is None]
    c = tr.counters
    totals = dict(c.host)
    if c.device:
        names = list(c.device)
        vals = torch.stack([c.device[n].to(torch.float64) for n in names]).tolist()
        for n, v in zip(names, vals):
            v = v if c.device[n].is_floating_point() else int(v)
            totals[n] = totals.get(n, 0) + v
    tr.counters = Counters()
    return rows, totals
