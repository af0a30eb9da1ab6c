"""How `tracking/pnp.solve_pnp_ransac` picks its path, on the CPU, and what
the kernels' wrapper (ops/kernels/pnp_kernel) refuses before it launches:

- CPU inputs run the plain path (`solve_pnp_ransac_plain`, bit for bit)
  and count no `track.pnp_kernel`;
- an input that says it is on the card runs the kernels and counts one
  `track.pnp_kernel`, under the cost model's counter too, which counts
  the call on either path as one unit of `measure.pnp_work`; nothing but
  the device decides: the function takes exactly the plain path's
  arguments;
- a CUDA graph takes the kernels' launches off their counters while it
  captures and hands them on at each replay;
- a wrong dtype, rank or minimal-set size raises before any launch;
- the minimal sets the kernel must reproduce: value descending, the lowest
  index first among equal values, -inf (invalid) entries by index.

The kernels themselves run only on the card:
tests/test_torch_pnp_kernel_cuda.py."""

import inspect

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch.ops import kernels
from stereo_visual_slam_tpu_torch.ops.kernels import _build, measure, pnp_kernel
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import roofline, trace

from test_torch_pnp_graph import SETTINGS, scene

torch.set_num_threads(1)


class OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def traced():
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()


@pytest.fixture
def launches(monkeypatch):
    """Stand-in kernels: record each call, return the plain path's fields."""
    calls = []

    def pnp_ransac(*args, **kw):
        calls.append((args, kw))
        res = pnp.solve_pnp_ransac_plain(*[a.as_subclass(torch.Tensor) for a in args[:7]],
                                         prior_spread=args[9], **kw)
        return tuple(res)

    monkeypatch.setattr(pnp_kernel, "pnp_ransac", pnp_ransac)
    return calls


def on_card(args):
    return tuple(a.as_subclass(OnCard) for a in args)


@pytest.mark.parametrize("name", ["outliers", "three_valid"])
def test_cpu_inputs_take_the_plain_path(traced, launches, name):
    s = scene(**dict(outliers=dict(seed=1, outliers=90), three_valid=dict(seed=3, n_valid=3))[name])
    got = pnp.solve_pnp_ransac(*s["args"], prior_spread=s["prior_spread"], **SETTINGS)
    want = pnp.solve_pnp_ransac_plain(*s["args"], prior_spread=s["prior_spread"], **SETTINGS)
    _, totals = trace.drain()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert launches == [] and "track.pnp_kernel" not in totals


def test_inputs_on_the_card_take_the_kernels(traced, launches):
    s = scene(seed=1, outliers=90, spread=0.3)
    got = pnp.solve_pnp_ransac(*on_card(s["args"]), prior_spread=s["prior_spread"], **SETTINGS)
    _, totals = trace.drain()
    assert len(launches) == 1 and totals["track.pnp_kernel"] == 1
    args, kw = launches[0]
    # the points, the draws, the start weights and the spread, the settings
    assert len(args) == 10 and args[9] == s["prior_spread"]
    assert torch.equal(args[7], pnp._start_weights(128, torch.float32, "cpu")[0])
    assert kw == SETTINGS
    want = pnp.solve_pnp_ransac_plain(*s["args"], prior_spread=s["prior_spread"], **SETTINGS)
    assert all(torch.equal(x.as_subclass(torch.Tensor), y) for x, y in zip(got, want))


@pytest.mark.parametrize("where", ["card", "cpu"])
def test_the_counter_counts_one_unit_of_the_kernels_work(traced, launches, where):
    """Under the cost model's counter each input keeps its path (the
    kernels on the card, the plain path on the CPU) and the call counts as
    one unit of `measure.pnp_work`, nothing of what runs inside."""
    s = scene(seed=2, outliers=60, spread=0.3)
    args = on_card(s["args"]) if where == "card" else s["args"]
    with roofline.Counter() as c:
        got = pnp.solve_pnp_ransac(*args, prior_spread=s["prior_spread"], **SETTINGS)
    _, totals = trace.drain()
    if where == "card":
        assert len(launches) == 1 and totals["track.pnp_kernel"] == 1
    else:
        assert launches == [] and "track.pnp_kernel" not in totals
    nbytes, ops = measure.pnp_work(*s["args"], **SETTINGS)
    assert c.units == {"pnp_ransac": [1, nbytes, ops]} and c.cost == (ops, nbytes)
    want = pnp.solve_pnp_ransac_plain(*s["args"], prior_spread=s["prior_spread"], **SETTINGS)
    assert all(torch.equal(x.as_subclass(torch.Tensor), y) for x, y in zip(got, want))


def test_the_work_grows_with_each_stage():
    """Each kernel's work: more hypotheses or points cost more bytes and
    operations, more steps more operations on the same bytes."""
    base = measure.pnp_hypotheses_work(128, 500, 4, 10)
    for more in ((256, 500, 4, 10), (128, 1000, 4, 10)):
        assert all(m > b for m, b in zip(measure.pnp_hypotheses_work(*more), base))
    steps = measure.pnp_hypotheses_work(128, 500, 4, 20)
    assert steps[0] == base[0] and steps[1] > base[1]
    base = measure.pnp_refine_work(128, 500, 10)
    assert all(m > b for m, b in zip(measure.pnp_refine_work(128, 1000, 10), base))
    steps = measure.pnp_refine_work(128, 500, 20)
    assert steps[0] == base[0] and steps[1] > base[1]
    assert measure.bound(*measure.pnp_hypotheses_work(128, 500, 4, 10))[0] > 0


def test_a_graph_takes_launches_off_the_counters_and_hands_them_on(monkeypatch):
    """What `utils/cuda_graph.Graphed` does with the kernels' launch
    counters: a capture's launches leave them as they were, and each
    replay adds them."""
    monkeypatch.setattr(pnp_kernel.pnp_hypotheses, "launches", 2)
    monkeypatch.setattr(pnp_kernel.pnp_refine, "launches", 2)
    with kernels.collect_launches() as launched:
        pnp_kernel.pnp_hypotheses.launches += 1
        pnp_kernel.pnp_refine.launches += 1
    assert launched == {pnp_kernel.pnp_hypotheses: 1, pnp_kernel.pnp_refine: 1}
    counts = kernels.launch_counts()
    assert counts["pnp_hypotheses"] == counts["pnp_refine"] == 2
    for _ in range(3):
        kernels.add_launches(launched)
    counts = kernels.launch_counts()
    assert counts["pnp_hypotheses"] == counts["pnp_refine"] == 5


def test_the_path_is_chosen_by_the_device_alone():
    """No option: the dispatching function takes the plain path's arguments
    and nothing more (a setting could only enter through one)."""
    assert inspect.signature(pnp.solve_pnp_ransac).parameters == \
        inspect.signature(pnp.solve_pnp_ransac_plain).parameters


@pytest.fixture
def no_launch(monkeypatch):
    def library(*_):
        raise AssertionError("the wrapper reached a launch")

    monkeypatch.setattr(_build, "library", library)


def wrapper_args():
    s = scene(seed=0)
    half, rot_w = pnp._start_weights(128, torch.float32, "cpu")
    return list(s["args"]) + [half, rot_w, 0.3]


@pytest.mark.parametrize("fault, error, match", [
    ("pts_w float64", TypeError, "float64"),
    ("gumbel float64", TypeError, "float64"),
    ("valid as uint8", TypeError, "uint8"),
    ("uv rank 3", ValueError, "rank"),
    ("T_init rank 1", ValueError, "rank"),
    ("sample size 5", ValueError, "minimal sets"),
    ("all right but on the CPU", ValueError, "CUDA"),
])
def test_the_wrapper_refuses_before_any_launch(no_launch, fault, error, match):
    args, kw = wrapper_args(), {}
    if fault == "pts_w float64":
        args[0] = args[0].double()
    elif fault == "gumbel float64":
        args[5] = args[5].double()
    elif fault == "valid as uint8":
        args[2] = args[2].to(torch.uint8)
    elif fault == "uv rank 3":
        args[1] = args[1][None]
    elif fault == "T_init rank 1":
        args[4] = args[4].reshape(-1)
    elif fault == "sample size 5":
        kw = dict(sample_size=5)
    with pytest.raises(error, match=match):
        pnp_kernel.pnp_ransac(*args, **kw)


def test_refine_refuses_scores_of_another_dtype(no_launch):
    args = wrapper_args()
    with pytest.raises(TypeError, match="int32"):
        pnp_kernel.pnp_refine(*args[:5], torch.zeros((128, 4, 4)), torch.zeros(128))


@pytest.mark.parametrize("kind", ["equal_values", "whole_row_equal", "fewer_valid_than_a_set"])
def test_minimal_sets_order(kind):
    """The plain path's minimal sets, against a lexicographic sort of
    (-value, index) with invalid entries at -inf."""
    rng = np.random.default_rng(5)
    H, N = 16, 40
    g = np.round(rng.gumbel(size=(H, N)), 1).astype(np.float32)
    valid = np.ones(N, bool)
    if kind == "whole_row_equal":
        g[:] = 0.5
    if kind == "fewer_valid_than_a_set":
        valid[:] = False
        valid[[7, 30]] = True
    s = scene(seed=0, n=N)
    args = list(s["args"])
    args[2], args[5], args[6] = torch.from_numpy(valid), torch.from_numpy(g), args[6][:H]
    idx = pnp.hypotheses_plain(*args, gn_iters_hypothesis=0)[0].numpy()
    gm = np.where(valid[None], g, -np.inf)
    want = np.stack([np.lexsort((np.arange(N), -row))[:4] for row in gm])
    assert np.array_equal(idx, want)
    if kind == "fewer_valid_than_a_set":
        assert (np.sort(idx[:, :2], axis=1) == [7, 30]).all() and (idx[:, 2:] == [0, 1]).all()
