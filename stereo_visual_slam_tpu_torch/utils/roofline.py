"""Roofline / MFU accounting for the port's production programs: the
counterpart of stereo_visual_slam_tpu/utils/roofline.py.

The JAX module reads XLA's cost model off a compiled executable without
running it. The port compiles nothing, so `cost_of` RUNS the function once
under a counting dispatch mode (`Counter`) and counts every aten op it
executes; the function's results are those of an uncounted run, bit for
bit. Rules, each held against XLA's `compiled.cost_analysis()` on the CPU
(tests/test_torch_roofline.py):

  matmuls     mm, addmm, bmm, baddbmm, convolution: torch.utils.
              flop_counter's formulas, 2*M*N*K; a batched LU solve
              2n^3/3 + 2n^2*k a matrix
  elementwise one FLOP an output element, integer arithmetic, compares,
              selects and dtype conversions included (addcmul and addcdiv:
              two)
  transcend.  exp, log, sqrt, rsqrt, tanh, trig, pow, ...: no FLOPs (XLA
              counts them apart, as `transcendentals`)
  reductions  input elements - output elements (mean: + one divide an
              output; a 2-norm: + one square an input)
  scans       cumsum, cumprod: one FLOP an element
  no FLOPs    sort, top-k, gather, scatter, indexing, copies, fills, views
  bytes       each op: its distinct input tensors (a broadcast or
              overlapping view counts the elements it spans) plus its
              outputs; views, `empty*`, the `*_like` factories' templates
              and host-device transfers cost nothing; copy_ and fill_ do
              not read the tensor they overwrite, index_put_ writes as many
              elements as it is given

The three hand kernels (ops/kernels/{fast,patch,stereo}_kernel.py) count
as ONE unit a call of their dispatching wrapper (`kernel_unit`), with the
analytic work of ops/kernels/measure.py's bounds (`fast_work`,
`gather_work`, `zncc_work`; K1's compares and differences count as FLOPs;
the gather's unit reads its whole level images, where its bound reads
only the pixels under its windows), whether the CUDA kernel or the plain
twin runs, and none of the ops inside: a kernel's count is the same on
the CPU and on the card.

Where the port's count differs from the JAX tools' numbers:
  * XLA counts each scan or cond body once; the port counts every frame of
    the scan and every LM iteration that ran.
  * XLA counts bytes after fusion; the port counts the eager program's
    op-by-op traffic, L2 hits counted as HBM bytes.
  * XLA charges compares to sort (22,528 at (64, 32)), expands integer
    floor division (~10 a element) and argmax (~9), counts a log-depth
    scan for cumsum and a 4-byte init scalar a reduction; the port does
    not.

Peaks: the port runs fp32 with TF32 off (stereo_visual_slam_tpu_torch/
__init__.py), so MFU here is against the fp32 peak OUTSIDE the tensor
cores (67 TFLOP/s on an H100 SXM), not the bf16 matmul peak the JAX
module uses. `chip_peaks` knows one card; any other raises, so no H100
share is printed for another card. GENERIC (the CPU) is meaningless and
exists so that the tools run anywhere.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils.flop_counter import flop_registry

# NVIDIA's data sheet, H100 SXM: f32 FLOP/s outside the tensor cores, HBM3
# bytes/s (at the full 700 W power limit)
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


class ChipPeaks(NamedTuple):
    name: str
    f32_flops: float     # FLOP/s, fp32 outside the tensor cores
    hbm_bytes: float     # B/s


H100_SXM = ChipPeaks("NVIDIA H100 80GB HBM3", PEAK_F32, PEAK_BYTES)
# CPU fallback so the tools run anywhere (numbers meaningless)
GENERIC = ChipPeaks("generic", 1e12, 100e9)


def chip_peaks(device) -> ChipPeaks:
    """GENERIC for a CPU device; H100_SXM for that card; any other card
    raises ValueError naming it."""
    device = torch.device(device)
    if device.type == "cpu":
        return GENERIC
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    if name == H100_SXM.name:
        return H100_SXM
    raise ValueError(f"no peaks known for {name!r}: the roofline shares are defined for "
                     f"{H100_SXM.name!r} only")


class ProgramCost(NamedTuple):
    flops: float
    bytes_accessed: float

    def mfu(self, seconds: float, peaks: ChipPeaks) -> float:
        return self.flops / max(seconds, 1e-12) / peaks.f32_flops

    def hbm_util(self, seconds: float, peaks: ChipPeaks) -> float:
        return self.bytes_accessed / max(seconds, 1e-12) / peaks.hbm_bytes


_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
    "sigmoid", "erf", "erfc", "erfinv", "pow", "float_power", "lgamma", "digamma"))
_TWO_OPS = frozenset(("addcmul", "addcdiv"))
_ELEMENTWISE = frozenset(("floor_divide",))     # not tagged pointwise
_COPIES = frozenset(("clone", "_to_copy", "copy_"))
_SCANS = frozenset(("cumsum", "cumprod"))
_FREE = frozenset(("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
                   "_unsafe_view", "resize_", "set_", "_local_scalar_dense"))
_OVERWRITES = frozenset(("copy_", "fill_", "zero_", "index_put_"))
_SOLVES = frozenset(("_linalg_solve_ex",))


def _span_bytes(t: torch.Tensor) -> int:
    """Bytes of the elements t spans: a broadcast (stride 0) dimension
    counts once, an overlapping view (unfold) its memory span."""
    n, span = 1, 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if size > 1 and stride != 0:
            n *= size
            span += (size - 1) * abs(stride)
    return min(n, span) * t.element_size()


def _tensors(xs) -> list:
    """The tensors among xs and in its lists and tuples (an aten op's
    arguments nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def op_cost(func, args, kwargs, out) -> Tuple[float, float]:
    """(FLOPs, bytes) of one executed aten op by the rules above."""
    name = func._overloadpacket.__name__
    if func.is_view or name in _FREE:
        return 0.0, 0.0
    ins = _tensors(args) + _tensors(kwargs.values())
    outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
    if name in _COPIES and ins and outs and ins[-1].device != outs[0].device:
        return 0.0, 0.0                      # a host-device transfer
    if name.endswith("_like") or name.startswith("new_"):
        ins = []                             # the template is metadata
    elif name in _OVERWRITES:
        ins = ins[1:]                        # the overwritten tensor is not read
    if name == "index_put_":
        outs = ins[-1:]
    seen, nbytes = set(), 0
    for t in ins:
        key = (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)
        if key not in seen:
            seen.add(key)
            nbytes += _span_bytes(t)
    nbytes += sum(t.numel() * t.element_size() for t in outs)

    formula = flop_registry.get(func._overloadpacket)
    tags = func.tags
    if formula is not None:
        flops = formula(*args, **kwargs, out_val=out)
    elif name in _SOLVES:
        a, b = ins[0], ins[1]
        n = a.shape[-1]
        k = b.shape[-1] if b.dim() == a.dim() else 1
        flops = a.numel() // (n * n) * (2 * n ** 3 / 3 + 2 * n * n * k)
    elif torch.Tag.reduction in tags:
        n_in, n_out = ins[0].numel(), outs[0].numel()
        flops = n_in - n_out
        if name == "mean":
            flops += n_out
        elif name == "linalg_vector_norm":
            flops += n_in
    elif name in _SCANS:
        flops = outs[0].numel()
    elif name in _COPIES:
        # a dtype conversion is one op an element (XLA's convert)
        flops = outs[0].numel() if ins[-1].dtype != outs[0].dtype else 0
    elif (torch.Tag.pointwise in tags or name in _ELEMENTWISE) and name not in _TRANSCENDENTAL:
        flops = outs[0].numel() * (2 if name in _TWO_OPS else 1) if outs else 0
    else:
        flops = 0
    return float(flops), float(nbytes)


class Counter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op run inside `with
    Counter() as c:` (then `c.cost`), each kernel unit's calls and work in
    `c.units`, and, with `c.scope(name)` open, each op's share in
    `c.scopes[name]` too (nested scopes all count it)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.units: Dict[str, list] = {}    # kernel -> [calls, bytes, ops]
        self.scopes: Dict[str, ProgramCost] = {}
        self._open: list = []
        self._in_unit = False

    @property
    def cost(self) -> ProgramCost:
        return ProgramCost(self.flops, self.bytes_accessed)

    def _add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes_accessed += nbytes
        for name in self._open:
            c = self.scopes[name]
            self.scopes[name] = ProgramCost(c.flops + flops, c.bytes_accessed + nbytes)

    @contextlib.contextmanager
    def scope(self, name: str):
        self.scopes.setdefault(name, ProgramCost(0.0, 0.0))
        self._open.append(name)
        try:
            yield
        finally:
            self._open.remove(name)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._in_unit:
            self._add(*op_cost(func, args, kwargs, out))
        return out


def _active_counter():
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Counter):
            return mode
    return None


def kernel_unit(name: str, work: Callable[..., Tuple[float, float]]):
    """Decorate a hand kernel's dispatching wrapper: under a Counter, one
    call counts as `work(*args, **kwargs)` = (bytes, operations) and the
    ops inside count nothing. Without a Counter it costs one lookup."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            counter = _active_counter()
            if counter is None or counter._in_unit:
                return fn(*args, **kwargs)
            counter._in_unit = True
            try:
                out = fn(*args, **kwargs)
                nbytes, ops = work(*args, **kwargs)
            finally:
                counter._in_unit = False
            counter._add(float(ops), float(nbytes))
            unit = counter.units.setdefault(name, [0, 0.0, 0.0])
            unit[0] += 1
            unit[1] += nbytes
            unit[2] += ops
            return out

        return wrapped

    return deco


def cost_of(fn, *args, **kwargs) -> ProgramCost:
    """The cost of running fn(*args, **kwargs) once, counted while it runs;
    what it computes is what an uncounted call computes."""
    with Counter() as counter:
        fn(*args, **kwargs)
    return counter.cost


def summarize(label: str, cost: ProgramCost, seconds: float, peaks: ChipPeaks) -> str:
    """The JAX module's line, with the port's peak named (and more digits:
    the eager program's shares are small)."""
    return (
        f"{label}: {cost.flops / 1e9:.3f} GFLOP, "
        f"{cost.bytes_accessed / 1e9:.3f} GB HBM, {seconds * 1e3:.3f} ms -> "
        f"{100 * cost.mfu(seconds, peaks):.3f}% MFU / "
        f"{100 * cost.hbm_util(seconds, peaks):.2f}% HBM bw "
        f"({peaks.name}: {peaks.f32_flops / 1e12:.0f} TFLOP/s f32 outside the tensor cores, "
        f"{peaks.hbm_bytes / 1e9:.0f} GB/s)"
    )
