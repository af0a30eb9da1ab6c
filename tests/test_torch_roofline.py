"""The port's cost model (stereo_visual_slam_tpu_torch/utils/roofline.py)
and the tools that read it, on the CPU at small_config: each op's FLOPs
and bytes against XLA's own cost model on the same numpy inputs, each hand
kernel counted as one unit of its bound's work, the extractor's stage rows
summing exactly to batch_extract, counted runs bit-equal to uncounted ones
and equal to each other, the peaks of the card and of nothing else, and
the report's rows (tests/test_torch_roofline_cli.py runs the CLIs; the
bench's counted pass is in tests/test_torch_bench.py). The times and shares
come from the card only."""

import dataclasses

import numpy as np
import pytest
import torch

# the JAX side on the CPU, as tests/conftest.py sets it
jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from stereo_visual_slam_tpu_torch.models import frontend  # noqa: E402
from stereo_visual_slam_tpu_torch.ops.kernels import (  # noqa: E402
    fast_kernel, measure, patch_kernel, stereo_kernel,
)
from stereo_visual_slam_tpu_torch.profiling import (  # noqa: E402
    extract_cost, production, roofline_report,
)
from stereo_visual_slam_tpu_torch.tracking import pnp  # noqa: E402
from stereo_visual_slam_tpu_torch.utils import roofline  # noqa: E402
from stereo_visual_slam_tpu_torch.utils.config import small_config  # noqa: E402

from test_torch_pnp_graph import SETTINGS, scene  # noqa: E402

torch.set_num_threads(1)


def _inputs():
    rng = np.random.default_rng(0)
    f = np.float32
    return dict(
        a=rng.uniform(0.5, 2.0, (64, 32)).astype(f), b=rng.uniform(0.5, 2.0, (32, 16)).astype(f),
        c=rng.uniform(0.5, 2.0, (64, 32)).astype(f), m=rng.random((64, 32)) < 0.5,
        x=rng.uniform(0.5, 2.0, (4, 64, 32)).astype(f), y=rng.uniform(0.5, 2.0, (4, 32, 16)).astype(f),
        i=rng.integers(0, 100, (64, 32)).astype(np.int32))


# (name, the port's op, the JAX op, its inputs, XLA's reduction init
# scalar: XLA's bytes count a 4-byte init value of a reduce that the port
# does not; the only tolerance)
OPS = [
    ("mm", lambda a, b: a @ b, lambda a, b: a @ b, "ab", 0),
    ("einsum_ij_kj", lambda a: torch.einsum("ij,kj->ik", a, a),
     lambda a: jnp.einsum("ij,kj->ik", a, a), "a", 0),
    ("bmm", lambda x, y: torch.bmm(x, y), lambda x, y: x @ y, "xy", 0),
    ("einsum_bij_bjk", lambda x, y: torch.einsum("bij,bjk->bik", x, y),
     lambda x, y: jnp.einsum("bij,bjk->bik", x, y), "xy", 0),
    ("add", lambda a, c: a + c, lambda a, c: a + c, "ac", 0),
    ("mul", lambda a, c: a * c, lambda a, c: a * c, "ac", 0),
    ("square", lambda a: a * a, lambda a: a * a, "a", 0),
    ("sub", lambda a, c: a - c, lambda a, c: a - c, "ac", 0),
    ("div", lambda a, c: a / c, lambda a, c: a / c, "ac", 0),
    ("neg", lambda a: -a, lambda a: -a, "a", 0),
    ("abs", torch.abs, jnp.abs, "a", 0),
    ("maximum", torch.maximum, jnp.maximum, "ac", 0),
    ("int_add", lambda i: i + 1, lambda i: i + 1, "i", 0),
    ("gt_scalar", lambda a: a > 1, lambda a: a > 1, "a", 0),
    ("lt", lambda a, c: a < c, lambda a, c: a < c, "ac", 0),
    ("where", torch.where, jnp.where, "mac", 0),
    ("cast", lambda a: a.to(torch.int32), lambda a: a.astype(jnp.int32), "a", 0),
    ("sum_axis", lambda a: a.sum(1), lambda a: a.sum(1), "a", 4),
    ("amax_axis", lambda a: a.amax(1), lambda a: a.max(1), "a", 4),
    ("amin_axis", lambda a: a.amin(1), lambda a: a.min(1), "a", 4),
    ("mean_axis", lambda a: a.mean(1), lambda a: a.mean(1), "a", 0),
    ("norm_axis", lambda a: torch.linalg.vector_norm(a, dim=1),
     lambda a: jnp.linalg.norm(a, axis=1), "a", 0),
    ("sqrt", torch.sqrt, jnp.sqrt, "a", 0),
    ("exp", torch.exp, jnp.exp, "a", 0),
]


@pytest.mark.parametrize("name,port_op,jax_op,args,init", OPS, ids=[o[0] for o in OPS])
def test_op_counts_equal_xla(name, port_op, jax_op, args, init):
    inp = _inputs()
    arrays = [inp[k] for k in args]
    ca = jax.jit(jax_op).lower(*arrays).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    cost = roofline.cost_of(port_op, *[torch.from_numpy(a) for a in arrays])
    assert cost.flops == ca.get("flops", 0.0)
    assert cost.bytes_accessed + init == ca["bytes accessed"]
    if name in ("sqrt", "exp"):
        assert cost.flops == 0 and ca["transcendentals"] == 64 * 32


def test_broadcast_and_views_cost_what_they_touch():
    a = torch.ones(64, 32)
    row = torch.ones(32)
    # a broadcast row is read once; a view and empty cost nothing
    assert roofline.cost_of(lambda: a + row) == (2048.0, 4 * (2048 + 32 + 2048))
    assert roofline.cost_of(lambda: a[3:].reshape(-1).unsqueeze(0).t()) == (0.0, 0.0)
    assert roofline.cost_of(lambda: torch.empty_like(a)) == (0.0, 0.0)
    # copy_ writes its destination without reading it; zeros_like reads nothing
    b = torch.empty(64, 32)
    assert roofline.cost_of(lambda: b.copy_(a)) == (0.0, 2 * 8192)
    assert roofline.cost_of(lambda: torch.zeros_like(a)) == (0.0, 8192)


def _kernel_calls():
    """kernel -> (the wrapper's call, measure's work and bound for the same
    tensors)."""
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    right = torch.from_numpy(rng.uniform(0, 255, (96, 128)).astype(np.float32))
    yx = torch.from_numpy(np.stack([rng.integers(0, 96, 50), rng.integers(0, 128, 50)],
                                   -1).astype(np.int32))
    s = scene(seed=1, outliers=60, spread=0.3)
    pnp_work = measure.pnp_work(*s["args"], **SETTINGS)
    return {
        "fast_nms": (lambda: fast_kernel.fast_nms_score_map(img, 20.0),
                     measure.fast_work(img, 20.0), measure.fast_bound(img, 20.0)),
        "gather_patches": (lambda: patch_kernel.gather_patches(img, yx, 33, 48),
                           measure.gather_work(img, 50, 33), measure.gather_bound(img, 50, 33)),
        "zncc_sweep": (lambda: stereo_kernel.zncc_sweep(img, right, yx, patch=11,
                                                        max_disparity=32),
                       measure.zncc_work(img, 50, 11, 32), measure.zncc_bound(img, 50, 11, 32)),
        "pnp_ransac": (lambda: pnp.solve_pnp_ransac(*s["args"], prior_spread=s["prior_spread"],
                                                    **SETTINGS).T_c_w,
                       pnp_work, measure.bound(*pnp_work)),
    }


@pytest.mark.parametrize("kernel", ["fast_nms", "gather_patches", "zncc_sweep", "pnp_ransac"])
def test_kernel_counts_as_one_unit_of_its_bound_work(kernel):
    call, (nbytes, ops), bound = _kernel_calls()[kernel]
    with roofline.Counter() as counter:
        out = call()
    # the plain twin ran (a CPU tensor) and none of its ops counted
    assert counter.units == {kernel: [1, nbytes, ops]}
    assert counter.cost == (ops, nbytes)
    assert torch.equal(out, call())
    # the bound is the same work over the card's peaks
    assert bound == measure.bound(nbytes, ops)
    assert nbytes > 0 and (ops > 0) == (kernel != "gather_patches")


def test_fast_unit_counts_the_candidates_of_its_input():
    flat = torch.full((64, 128), 7.0)
    with roofline.Counter() as counter:
        fast_kernel.fast_nms_score_map(flat, 20.0)
    assert counter.cost == (64 * 128 * measure.FAST_OPS_ALL, 8.0 * 64 * 128)


@pytest.fixture(scope="module")
def images():
    return production.chunk_images(small_config(), "cpu", n_world=production.B + 1)


def test_extract_stage_rows_sum_exactly_to_the_total(images):
    cfg = small_config()
    batch_extract = frontend.make_batch_extractor(cfg, "cpu", with_depth=True)
    with roofline.Counter() as whole:
        ref = batch_extract(images)
    with roofline.Counter() as counter:
        got = production.extract_by_stages(batch_extract.stages, images, True, counter.scope)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    parts = [counter.scopes[k] for k in extract_cost.DISJOINT]
    assert sum(p.flops for p in parts) == whole.flops
    assert sum(p.bytes_accessed for p in parts) == whole.bytes_accessed
    assert all(p.bytes_accessed > 0 for p in parts)
    blur, describe = counter.scopes["blur"], counter.scopes["describe"]
    assert 0 < blur.bytes_accessed < describe.bytes_accessed
    # FAST+NMS once a level, the patch gather once for every level
    assert whole.units["fast_nms"][0] == cfg.frontend.n_levels
    assert whole.units["gather_patches"][0] == 1
    assert whole.units["zncc_sweep"][0] == 1

    result = extract_cost.run(cfg, "cpu", images)
    labels = [r["label"] for r in result["rows"]]
    assert labels == ["batch_extract TOTAL", "pyramid resize (2 levels)",
                      "FAST+NMS score maps (3 levels)", "pooled top-k (3 levels)",
                      "blur+describe (3 levels)", "box blur (3 levels)", "ANMS", "stereo sweep"]
    assert result["rows"][0]["gflop"] == whole.flops / 1e9


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("index", [0, 1, 3], ids=["chunk_step", "batch_extract", "ba_schedule"])
def test_counted_run_is_bit_equal_to_the_run_without(images, index):
    label, fn, _ = production.phases(small_config(), "cpu", images)[index]
    plain = _tensors(fn())
    with roofline.Counter() as counter:
        counted = _tensors(fn())
    assert len(plain) == len(counted) > 0
    for a, b in zip(plain, counted):
        assert a.dtype == b.dtype and torch.equal(a, b), label
    assert counter.flops > 0 and counter.bytes_accessed > 0
    # counted twice, the same input gives the same count
    assert roofline.cost_of(fn) == counter.cost


def test_ba_schedule_counts_every_lm_iteration(images):
    """The BA schedule's count grows with its iterations, where XLA counts a
    loop body once."""
    cfg = small_config()
    _, fn, _ = production.phases(cfg, "cpu", images)[3]
    one = roofline.cost_of(fn)
    more = cfg.replace(ba=dataclasses.replace(cfg.ba, full_iters=cfg.ba.full_iters + 2))
    _, fn2, _ = production.phases(more, "cpu", images)[3]
    assert roofline.cost_of(fn2).flops > one.flops


def test_chip_peaks_of_the_cpu_and_of_the_card(monkeypatch):
    assert roofline.chip_peaks("cpu") is roofline.GENERIC
    assert roofline.chip_peaks(torch.device("cpu")) is roofline.GENERIC
    assert (roofline.H100_SXM.f32_flops, roofline.H100_SXM.hbm_bytes) == (67e12, 3.35e12)
    assert (measure.PEAK_F32, measure.PEAK_BYTES) == (67e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert roofline.chip_peaks("cuda") is roofline.H100_SXM


@pytest.mark.parametrize("card", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "NVIDIA H200"])
def test_chip_peaks_refuse_another_card(monkeypatch, card):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: card)
    with pytest.raises(ValueError, match=card):
        roofline.chip_peaks("cuda")


def test_summarize_keeps_the_jax_line():
    cost = roofline.ProgramCost(2.5e9, 1.25e9)
    line = roofline.summarize("chunk", cost, 0.5, roofline.H100_SXM)
    assert line.startswith("chunk: 2.500 GFLOP, 1.250 GB HBM, 500.000 ms -> ")
    assert f"{100 * 2.5e9 / 0.5 / 67e12:.3f}% MFU / " in line
    assert f"{100 * 1.25e9 / 0.5 / 3.35e12:.2f}% HBM bw" in line
    assert "(NVIDIA H100 80GB HBM3: 67 TFLOP/s f32 outside the tensor cores, 3350 GB/s)" in line


def test_report_rows_from_given_timings(images):
    """The report's rows on timings already measured (as chip_smoke.py
    reuses phase 12's): the feats step is the scan over B, the shares are
    the cost over each time."""
    cfg = small_config()
    labels = production.labels(cfg)
    timings = {labels[i]: dict(wall_ms=100.0 * (i + 1), device_ms=10.0 * (i + 1))
               for i in range(4)}
    result = roofline_report.run(cfg, "cpu", images=images, timings=timings)
    rows = result["rows"]
    assert [r["label"] for r in rows] == ["chunk_step (B=8, no-BA)", "batch_extract (B=8)",
                                         "feats step (1 frame)", "BA schedule (1 keyframe)"]
    assert all(r["timed"] == "reused" for r in rows)
    feats = rows[2]
    assert feats["wall_ms"] == 300.0 / production.B and feats["device_ms"] == 30.0 / production.B
    p = roofline.GENERIC
    for r in rows:
        assert r["mfu_device"] == pytest.approx(r["gflop"] * 1e9 / (r["device_ms"] * 1e-3)
                                                / p.f32_flops)
        assert r["hbm_wall"] == pytest.approx(r["gb"] * 1e9 / (r["wall_ms"] * 1e-3) / p.hbm_bytes)
    # the chunk is its extraction and its B feats steps
    assert rows[0]["gflop"] == pytest.approx(rows[1]["gflop"] + production.B * rows[2]["gflop"])
