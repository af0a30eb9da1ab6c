"""The port's one CUDA-graph mechanism (utils/cuda_graph.Graphed) on the
card:

- for both graphed stages, PnP-RANSAC at the production shapes (N=2,048,
  H=128) and the BA schedule at the production window (Kw=10, L=4,096), a
  call under the other TF32 setting captures a second graph, and so does a
  call with a new input shape; each replay equals the eager call under the
  setting it runs in;
- a new shape or dtype of any one input captures again;
- a Python number is filled into its 0-dim input each call, and a 0-dim
  tensor of that dtype shares its capture;
- outputs survive the next replay (they are clones);
- counters added inside the captured function come out after each replay.

They need a CUDA card: marked `cuda`, they skip without one. On the card,
run them without tests/conftest.py, which imports jax, pins it to 8
virtual CPU devices and turns its compilation cache on, none of which the
port uses:
python -m pytest --noconftest tests/test_torch_cuda_graph_cuda.py
"""

import contextlib
import dataclasses
import functools
from typing import NamedTuple

import pytest
import torch

from test_torch_ba_graph_cuda import KW, L
from test_torch_pnp_graph_cuda import inputs, settings
from stereo_visual_slam_tpu_torch.ba import schedule
from stereo_visual_slam_tpu_torch.profiling import window
from stereo_visual_slam_tpu_torch.tracking import pnp
from stereo_visual_slam_tpu_torch.utils import config as port_config
from stereo_visual_slam_tpu_torch.utils import cuda_graph, trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@contextlib.contextmanager
def tf32(on: bool):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def equal(a, b) -> bool:
    return type(a) is type(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def pnp_calls(dev):
    """PnP's Graphed, its eager function, a production call and one with
    half the matches."""
    cfg = port_config.Config()
    fn = functools.partial(pnp.solve_pnp_ransac, **settings(cfg))
    small = cfg.replace(frontend=dataclasses.replace(
        cfg.frontend, max_raw_keypoints=cfg.frontend.max_raw_keypoints // 2))
    spread = dict(prior_spread=0.3)
    return (cuda_graph.Graphed(fn, "track.pnp"), fn,
            (inputs(cfg, 1, dev), spread), (inputs(small, 2, dev), spread))


def ba_calls(dev):
    """The schedule's Graphed, the eager schedule, a production window and
    one with half the landmark rows."""
    fn = schedule.eager_schedule(port_config.BAConfig())
    return (cuda_graph.Graphed(fn, "ba.schedule"), fn,
            (window.make_window(L, KW, seed=1, device=dev), {}),
            (window.make_window(L // 2, KW, seed=2, device=dev), {}))


@pytest.mark.parametrize("stage", ["pnp", "ba"])
def test_tf32_and_a_new_shape_capture_again(dev, stage):
    run, fn, (args, kw), (other, other_kw) = {"pnp": pnp_calls, "ba": ba_calls}[stage](dev)
    with tf32(False):
        off = run(*args, **kw)
        assert (run.captures, run.replays) == (1, 1)
        assert equal(off, fn(*args, **kw))
    with tf32(True):
        on = run(*args, **kw)
        assert (run.captures, run.replays) == (2, 2)
        assert equal(on, fn(*args, **kw))
    with tf32(False):
        assert equal(run(*args, **kw), off)
        assert (run.captures, run.replays) == (2, 3)
        res = run(*other, **other_kw)
        assert (run.captures, run.replays) == (3, 4)
        assert equal(res, fn(*other, **other_kw))
    assert len(run.graphs) == 3


class Out(NamedTuple):
    y: torch.Tensor
    total: torch.Tensor


def toy(a, b, c, scale=1.0):
    y = a * scale + b.sum()
    trace.add("toy.calls", 1)
    trace.add("toy.positive", c > 0)
    return Out(y, y.sum() + c.to(y.dtype).sum())


@pytest.mark.parametrize("which", ["a", "b", "c", "c-dtype"])
def test_a_new_shape_or_dtype_of_any_input_captures_again(dev, which):
    run = cuda_graph.Graphed(toy, "toy")
    args = dict(a=torch.ones(4, device=dev), b=torch.ones(3, device=dev),
                c=torch.ones(5, device=dev))
    run(**args)
    run(**args)
    assert run.captures == 1
    name = which.split("-")[0]
    args[name] = (args[name].double() if which.endswith("dtype")
                  else torch.ones(args[name].numel() + 1, device=dev))
    res = run(**args)
    assert run.captures == 2 and equal(res, toy(**args))


def test_a_number_is_filled_each_call(dev):
    run = cuda_graph.Graphed(toy, "toy")
    a, b, c = (torch.arange(4.0, device=dev), torch.ones(3, device=dev),
               torch.ones(5, device=dev))
    for scale in (0.5, 2.0, torch.tensor(-1.0, device=dev), 3):
        assert equal(run(a, b, c, scale=scale), toy(a, b, c, scale=scale))
    assert (run.captures, run.replays) == (1, 4)


def test_outputs_survive_the_next_replay(dev):
    run = cuda_graph.Graphed(toy, "toy")
    b, c = torch.zeros(3, device=dev), torch.ones(5, device=dev)
    first = run(torch.ones(4, device=dev), b, c)
    second = run(torch.full((4,), 7.0, device=dev), b, c)
    assert run.replays == 2
    assert torch.equal(first.y, torch.ones(4, device=dev))
    assert torch.equal(second.y, torch.full((4,), 7.0, device=dev))


def test_counters_inside_come_out_after_each_replay(dev):
    run = cuda_graph.Graphed(toy, "toy")
    b = torch.ones(3, device=dev)
    cs = [torch.tensor([1.0, -1.0, 2.0], device=dev), torch.tensor([-1.0, -2.0, -3.0], device=dev),
          torch.tensor([4.0, 5.0, 6.0], device=dev)]
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        for c in cs:
            run(torch.ones(4, device=dev), b, c)
    finally:
        trace.disable()
        _, totals = trace.drain()
    # the capture's warm-up runs count nothing: only the three calls do
    assert totals == {"toy_graph": 3, "toy.calls": 3, "toy.positive": 2 + 0 + 3}
    assert (run.captures, run.replays) == (1, 3)
