"""The cost model on the card: the counts of batch_extract (lazy and with
depth) and of the BA schedule at small_config equal the CPU's, the hand
kernels' units included (the CUDA kernels launch where the CPU ran their
plain twins), and a counted run launches the kernels and computes what an
uncounted one does.

They need a CUDA card: marked `cuda`, they skip without one. On the card,
run them without tests/conftest.py, which imports jax, pins it to 8
virtual CPU devices and turns its compilation cache on, none of which
the port uses:
python -m pytest --noconftest tests/test_torch_roofline_cuda.py
"""

import pytest
import torch

from stereo_visual_slam_tpu_torch.models import frontend
from stereo_visual_slam_tpu_torch.ops import kernels
from stereo_visual_slam_tpu_torch.profiling import production
from stereo_visual_slam_tpu_torch.utils import roofline
from stereo_visual_slam_tpu_torch.utils.config import small_config

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def images():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cpu = production.chunk_images(small_config(), "cpu", n_world=production.B + 1)
    return {"cpu": cpu, "cuda": cpu.to("cuda")}


def _call(what, device, images):
    cfg = small_config()
    if what == "batch_extract_with_depth":
        return lambda: frontend.make_batch_extractor(cfg, device, with_depth=True)(images)
    index = {"batch_extract": 1, "ba_schedule": 3}[what]
    return production.phases(cfg, device, images)[index][1]


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("what", ["batch_extract", "batch_extract_with_depth", "ba_schedule"])
def test_card_counts_what_the_cpu_counts(images, what):
    counts = {}
    for device in ("cpu", "cuda"):
        fn = _call(what, device, images[device])
        plain = _tensors(fn())
        kernels.reset_launch_counts()
        with roofline.Counter() as counter:
            counted = _tensors(fn())
        torch.cuda.synchronize()
        for a, b in zip(plain, counted):
            assert torch.equal(a, b)
        counts[device] = (counter.cost, counter.units)
        if device == "cuda" and what != "ba_schedule":
            launched = kernels.launch_counts()
            assert {k: v[0] for k, v in counter.units.items()} == \
                {k: n for k, n in launched.items() if n}
    assert counts["cuda"] == counts["cpu"]
    assert roofline.chip_peaks("cuda") is roofline.H100_SXM
