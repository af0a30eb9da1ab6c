"""Micro-benchmark of top-k and detect strategies for the pooled NMS score
map: the counterpart of tools/micro_topk.py.

    python -m stereo_visual_slam_tpu_torch.profiling.micro_topk [--device cuda]
        [--params small.yaml] [--r 8] [--json]

The JAX tool decided ops/fast._pruned_topk on the TPU; the same question
is open on the card, where the port's `nms_topk` is a full stable
descending sort (ops/fast.py) and its radix sort the top device op of the
detect row. Every strategy A-S keeps the JAX tool's letter and label, at
its shapes (R=8 rows of M=(384/2)*(1280/2) pooled scores, K=536, C=1280,
NB=64) and on its seeded sparse input (np.random.default_rng(0), drawn in
its order), each timed by timing.measure. T and U are the port's own:
torch.topk, and an exact stable top-k built on it.

A strategy that claims the production result is checked: against a numpy
stable argsort (the stable top-k: A, F, U) or against `nms_topk` (K, Q,
R), tie order included; the run raises if one differs. G (approx_max_k)
and O (an XLA optimization barrier) have no torch counterpart and are
printed as absent with the reason. J and M are the production nms_topk.
"""

from __future__ import annotations

import sys
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from stereo_visual_slam_tpu_torch.models import frontend
from stereo_visual_slam_tpu_torch.ops import fast as fast_ops
from stereo_visual_slam_tpu_torch.ops.kernels import fast_kernel
from stereo_visual_slam_tpu_torch.profiling import timing

# the JAX tool's shapes: frames, the level-0 image, k, the compaction
# width, the histogram's bins and the nonzeros a row of its input
SHAPE = dict(R=8, H=384, W=1280, K=536, C=1280, NB=64, nnz=900)
THRESHOLD = 20.0


class Strategy(NamedTuple):
    letter: str
    label: str                 # the JAX tool's
    port: str                  # what runs here
    fn: Optional[Callable]     # None: absent
    check: Optional[Callable]  # () -> True when the production result is met
    absent: Optional[str] = None


def make_inputs(cfg, device, shape=SHAPE, seed: int = 0, ties: bool = False) -> dict:
    """The JAX tool's inputs, drawn in its order: x (R, M) with nnz
    uniform(1, 200) scores a row, one level-0 image stack, x as a (R, H, W)
    score map (each pooled value repeated 2x2), each level's image stack
    and a 1 %-dense score map per level. `ties`: the scores are integers
    1..4 instead, so that nearly every pick is a tie."""
    R, H, W, nnz = shape["R"], shape["H"], shape["W"], shape["nnz"]
    M = (H // 2) * (W // 2)
    rng = np.random.default_rng(seed)

    def scores(n):
        return rng.integers(1, 5, n).astype(np.float32) if ties else rng.uniform(1, 200, n)

    x = np.zeros((R, M), np.float32)
    for r in range(R):
        idx = rng.choice(M, nnz, replace=False)
        x[r, idx] = scores(nnz)
    img = rng.uniform(0, 255, (R * H, W)).astype(np.float32)
    smap = x.reshape(R, H // 2, W // 2).repeat(2, 1).repeat(2, 2)
    levels = frontend._level_geometry(cfg)
    pyr = [rng.uniform(0, 255, (R * Hl, Wl)).astype(np.float32) for _, _, (Hl, Wl), _ in levels]
    smaps = [((rng.random((R, Hl, Wl)) < 0.01).astype(np.float32)
              * scores((R, Hl, Wl)).astype(np.float32)) for _, _, (Hl, Wl), _ in levels]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    return dict(x=t(x), img=t(img), smap=t(smap), pyr=[t(p) for p in pyr],
                smaps=[t(s) for s in smaps], levels=levels, shape=dict(shape, M=M))


def topk_rw(score: torch.Tensor, k: int):
    """nms_topk through a max-pool (the JAX tool's reduce_window) and the
    gather-based offset."""
    B, H, W = score.shape
    pooled = F.max_pool2d(score[:, None], 2, 2)[:, 0]
    W2 = W // 2
    ts, ti = fast_ops.top_k_stable(pooled.reshape(B, -1), k)
    y2, x2 = ti // W2, ti % W2
    base = (2 * y2) * W + 2 * x2
    flat = score.reshape(B, H * W)
    ga, gb, gc = (torch.gather(flat, -1, base + o) for o in (0, 1, W))
    sel = torch.where(ga == ts, 0, torch.where(gb == ts, 1, torch.where(gc == ts, 2, 3)))
    return ts, torch.stack([2 * y2 + sel // 2, 2 * x2 + (sel & 1)], -1).to(torch.int32)


def topk_exact(x: torch.Tensor, k: int):
    """The stable top-k (lax.top_k's ties: the lowest index first) without
    a full sort: the k-th value from torch.topk, every value above it and
    the first of its ties by index, compacted by a scatter in index order,
    then a stable sort of the k."""
    R, M = x.shape
    kth = torch.topk(x, k, dim=-1, sorted=False).values.amin(-1, keepdim=True)
    above, tie = x > kth, x == kth
    need = k - above.sum(-1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie.to(torch.int32), -1) <= need))
    pos = torch.where(take, torch.cumsum(take.to(torch.int32), -1) - 1, k).to(torch.int64)
    idx = torch.zeros((R, k + 1), dtype=torch.int64, device=x.device).scatter_(
        1, pos, torch.arange(M, device=x.device).expand(R, M))[:, :k]
    vals = torch.gather(x, -1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return torch.gather(vals, -1, order), torch.gather(idx, -1, order)


def _stable_topk_oracle(x: torch.Tensor, k: int):
    a = x.cpu().numpy()
    idx = np.argsort(-a, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(a, idx, -1), idx


def _same_stable_topk(fn, x, k) -> bool:
    vals, idx = fn()
    want_v, want_i = _stable_topk_oracle(x, k)
    return (np.array_equal(vals.cpu().numpy(), want_v)
            and np.array_equal(idx.cpu().numpy().astype(np.int64), want_i))


def _same_nms_topk(pairs) -> bool:
    """pairs: [(strategy's (scores, yx), nms_topk's)]."""
    return all(torch.equal(a[0], b[0]) and torch.equal(a[1].to(torch.int32), b[1])
               for a, b in pairs)


def strategies(inp: dict) -> list:
    """The strategies on `inp` (make_inputs), in the JAX tool's order, then
    the port's own."""
    s = inp["shape"]
    R, H, W, M, K, C, NB = (s[k] for k in ("R", "H", "W", "M", "K", "C", "NB"))
    x, img, smap, pyr, smaps, levels = (inp[k] for k in ("x", "img", "smap", "pyr", "smaps",
                                                         "levels"))
    dev = x.device
    n = len(levels)
    out = []

    def add(letter, label, port, fn=None, check=None, absent=None):
        out.append(Strategy(letter, f"{letter} {label}", port, fn, check, absent))

    add("A", f"lax.top_k M={M} k={K}", "fast.top_k_stable: a full stable descending sort",
        lambda: fast_ops.top_k_stable(x, K),
        lambda: _same_stable_topk(lambda: fast_ops.top_k_stable(x, K), x, K))

    def hist():
        xmax = x.amax(-1, keepdim=True)
        bins = (x * (NB / xmax.clamp_min(1e-20))).to(torch.int32).clamp(0, NB)
        return (bins[:, :, None] == torch.arange(NB + 1, device=dev)).sum(1)

    add("B", f"histogram (compare-reduce, nb={NB})", "the same compare and sum", hist)
    add("C", "mask + cumsum", "torch.cumsum",
        lambda: torch.cumsum((x > 1.0).to(torch.int32), -1)[:, -1])

    def scatter():
        mask = x > 1.0
        rank = torch.cumsum(mask.to(torch.int32), -1) - 1
        pos = torch.where(mask, rank, C).clamp(max=C).to(torch.int64)
        return torch.zeros((R, C + 1), device=dev).scatter_(1, pos, x)[:, :C]

    add("D", "compact via scatter", "scatter_ into C+1 columns, the last one dropped",
        scatter)

    def searchsorted():
        cs = torch.cumsum((x > 1.0).to(torch.int32), -1)
        tgt = torch.arange(1, C + 1, device=dev, dtype=cs.dtype).expand(R, C).contiguous()
        pos = torch.searchsorted(cs, tgt)
        buf = torch.gather(x, -1, pos.clamp(max=M - 1))
        return torch.where(pos < M, buf, 0.0)

    add("E", "compact via searchsorted+gather", "torch.searchsorted + gather", searchsorted)
    add("F", f"lax.top_k C={C} k={K}", "fast.top_k_stable on the first C",
        lambda: fast_ops.top_k_stable(x[:, :C], K),
        lambda: _same_stable_topk(lambda: fast_ops.top_k_stable(x[:, :C], K), x[:, :C], K))
    add("G", "approx_max_k (recall .95)", "-",
        absent="the TPU's approximate top-k has no torch counterpart")
    add("H", "full sort (reference)", "torch.sort ascending, the last K",
        lambda: torch.sort(x, -1).values[:, -K:])
    add("I", f"pallas score map ({R * H}x{W} stacked)", "fast_kernel.fast_nms_score_map "
        "(the CUDA kernel on the card)",
        lambda: fast_kernel.fast_nms_score_map(img, THRESHOLD))
    add("J", f"nms_topk current ({R},{H},{W})", "fast.nms_topk (production)",
        lambda: fast_ops.nms_topk(smap, K))
    add("L", f"score maps, ALL {n} levels", "K1 on each level's stack",
        lambda: [fast_kernel.fast_nms_score_map(p, THRESHOLD) for p in pyr])
    add("M", f"nms_topk, ALL {n} levels (prod budgets)", "fast.nms_topk (production)",
        lambda: [fast_ops.nms_topk(sm, lv[3]) for sm, lv in zip(smaps, levels)])

    def detect(topk, only=None):
        def go():
            res = []
            for i, (_, _, (Hl, Wl), budget) in enumerate(levels[:only]):
                score = fast_kernel.fast_nms_score_map(pyr[i], THRESHOLD).reshape(R, Hl, Wl)
                res.append(topk(score, budget))
            return res
        return go

    add("N", f"score+topk composed, ALL {n} levels", "K1 then fast.nms_topk",
        detect(fast_ops.nms_topk))
    add("O", f"composed + barrier, ALL {n} levels", "-",
        absent="it studies an XLA optimization barrier; eager torch fuses nothing, so O is N")
    add("P", "composed, L0 only", "K1 then fast.nms_topk at level 0",
        detect(fast_ops.nms_topk, 1))

    def q_check():
        got, want = detect(topk_rw)(), detect(fast_ops.nms_topk)()
        return _same_nms_topk(list(zip(got, want)))

    add("Q", f"composed reduce_window+gather-off, {n} lv", "K1 then max_pool2d + gathers",
        detect(topk_rw), q_check)
    add("R", f"rw-topk alone, ALL {n} levels", "max_pool2d + gathers",
        lambda: [topk_rw(sm, lv[3]) for sm, lv in zip(smaps, levels)],
        lambda: _same_nms_topk([(topk_rw(sm, lv[3]), fast_ops.nms_topk(sm, lv[3]))
                                for sm, lv in zip(smaps, levels)]))
    add("S", f"composed full-map top_k (no pool), {n} lv", "K1 then fast.top_k_stable over "
        "H*W", detect(lambda score, k: fast_ops.top_k_stable(score.reshape(R, -1), k)))

    def pool_off():
        s4 = smap.reshape(R, H // 2, 2, W // 2, 2)
        a, b, c, d = s4[..., 0, :, 0], s4[..., 0, :, 1], s4[..., 1, :, 0], s4[..., 1, :, 1]
        pooled = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
        off = torch.where(a == pooled, 0, torch.where(b == pooled, 1,
                                                      torch.where(c == pooled, 2, 3)))
        ts, ti = fast_ops.top_k_stable(pooled.reshape(R, -1), K)
        return ts, ti, torch.gather(off.reshape(R, -1), -1, ti)

    def k_check():
        ts, ti, sel = pool_off()
        W2 = W // 2
        yx = torch.stack([2 * (ti // W2) + sel // 2, 2 * (ti % W2) + (sel & 1)], -1)
        return _same_nms_topk([((ts, yx), fast_ops.nms_topk(smap, K))])

    add("K", "pool+off+top_k (old nms_topk body)", "strided slices, where, stable top-k",
        pool_off, k_check)
    add("T", f"torch.topk M={M} k={K} (port)", "torch.topk: radix select, ties in no "
        "promised order", lambda: torch.topk(x, K, dim=-1))
    add("U", f"exact stable top-k via torch.topk M={M} k={K} (port)", "topk_exact",
        lambda: topk_exact(x, K), lambda: _same_stable_topk(lambda: topk_exact(x, K), x, K))
    return out


def run(cfg, device, r: int = 8, best_of: int = 3, shape=SHAPE, ties: bool = False) -> dict:
    """Every strategy on `device`: checked where it claims the production
    result (raises if one differs), then timed."""
    device = timing.require(device)
    inp = make_inputs(cfg, device, shape, ties=ties)
    rows = []
    for st in strategies(inp):
        row = dict(letter=st.letter, label=st.label, port=st.port, absent=st.absent,
                   production_result=None, row=None)
        if st.fn is not None:
            if st.check is not None:
                row["production_result"] = bool(st.check())
                if not row["production_result"]:
                    raise AssertionError(f"micro_topk {st.label}: differs from the production "
                                         "result")
            row["row"] = timing.measure(st.fn, st.label, device, r, best_of)
        rows.append(row)
    return dict(timing.header("micro_topk", device, r, best_of), shape=inp["shape"],
                ties=ties, rows=rows)


def render(result: dict) -> str:
    d = result["device"]
    lines = [f"# top-k / detect strategies on {d['card'] or d['kind']}, shape "
             f"{result['shape']}, r={result['r']}, best of {result['best_of']}",
             f"{'strategy':58s} {'wall ms':>10s} {'device ms':>10s}  production result"]
    for row in result["rows"]:
        if row["row"] is None:
            lines.append(f"{row['label'][:58]:58s} {'absent':>10s} {'':>10s}  {row['absent']}")
            continue
        m = row["row"]
        claim = {None: "-", True: "equal"}[row["production_result"]]
        dev = "-" if m["device_ms"] is None else f"{m['device_ms']:.4f}"
        lines.append(f"{row['label'][:58]:58s} {m['wall_ms']:10.4f} {dev:>10s}  {claim}"
                     f"  [{row['port']}]")
    prod = {row["letter"]: row["row"] for row in result["rows"]}
    lines.append(f"# the production nms_topk: J {prod['J']['wall_ms']:.4f} ms at level 0, "
                 f"M {prod['M']['wall_ms']:.4f} ms over every level (wall)")
    return "\n".join(lines)


def main(argv=None) -> int:
    return timing.cli("micro_topk", __doc__, run, render, default_r=8, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
