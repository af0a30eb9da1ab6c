"""Each wait of the drivers names the stream of its own device.

A driver built on `cuda:1` queues its work on cuda:1's stream, whatever
the current device is (only utils/dist.initialize_distributed sets it).
The record fetch of ChunkedSlam, the host driver's fetches and its pinned
upload ring must wait on that stream: on the current device's, the host
could read records before their copies land, or rewrite a pinned buffer
while its copy is in flight.

On the CPU the waits are reached through tensors that say they lie on
cuda:1 and a recording stand-in for `torch.cuda.current_stream` and
`torch.cuda.Event`; the card test needs two cards.
"""

import numpy as np
import pytest
import torch

from stereo_visual_slam_tpu_torch.models import slam_core
from stereo_visual_slam_tpu_torch.pipeline import chunked, vo
from stereo_visual_slam_tpu_torch.utils.config import small_config

torch.set_num_threads(1)

CARD = torch.device("cuda", 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on cuda:1; its copy to the host is
    itself."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return CARD

    def to(self, *args, **kwargs):
        return self.as_subclass(torch.Tensor)


@pytest.fixture
def streams(monkeypatch):
    """What each stand-in was called with: ("sync", device) for a stream
    synchronize, ("record", device) for an event recorded on a stream
    (device None: no stream named)."""
    calls = []

    class Stream:
        def __init__(self, device=None):
            self.device = None if device is None else torch.device(device)

        def synchronize(self):
            calls.append(("sync", self.device))

    class Event:
        def record(self, stream=None):
            calls.append(("record", None if stream is None else stream.device))

        def synchronize(self):
            pass

    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    return calls


def _records(n):
    """n frame records whose tensors say they lie on cuda:1."""
    def t(x):
        return torch.as_tensor(x).as_subclass(_OnCard)

    return [slam_core.FrameRecord(
        frame_id=i, tracked=t(True), lost=t(False), is_keyframe=t(i == 0),
        n_matches=t(10), n_inliers=t(9), n_new=t(0), twist=t(0.1), angle_y=t(0.0),
        T_c_w=t(torch.eye(4)), ba_ran=False, ba_cost=t(0.0), evict_valid=t(False),
        evict_frame_id=t(-1), evict_T=t(torch.eye(4))) for i in range(n)]


def test_record_fetch_waits_on_the_records_device(streams):
    rows = chunked._to_host(_records(3))
    assert [r["frame_id"] for r in rows] == [0, 1, 2]
    assert streams == [("sync", CARD)]


def test_host_fetch_event_on_the_tensors_device(streams):
    fetch = vo._Fetch(torch.arange(5.0).as_subclass(_OnCard))
    np.testing.assert_array_equal(fetch.wait(), np.arange(5.0))
    assert streams == [("record", CARD)]


def test_upload_ring_event_on_the_drivers_device(streams):
    cfg = small_config()
    driver = vo.VisualOdometry(cfg, device="cpu", lookahead=0)
    # the ring a driver on cuda:1 keeps (pinned memory needs a card)
    driver.device = CARD
    driver._ring = [[torch.zeros((2, *cfg.padded_hw), dtype=torch.uint8).as_subclass(_OnCard),
                     None] for _ in range(2)]
    h, w = cfg.image_hw
    img = np.full((h, w), 7, np.uint8)
    for _ in range(3):   # the third upload waits on the first slot's event
        images = driver._upload(img, img)
    assert int(images[0, 0, 0]) == 7
    assert streams == [("record", CARD)] * 3


@pytest.mark.cuda
def test_drivers_on_the_second_card_match_the_first():
    """Both drivers built on cuda:1 while cuda:0 is current give the
    results they give on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import dataclasses

    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry

    cfg = small_config()
    cfg = cfg.replace(camera=dataclasses.replace(cfg.camera, cx=128.0, cy=64.0))
    frames = list(synthetic.frames(synthetic.make_world(cfg, n_frames=12, n_points=1500, seed=0)))
    torch.cuda.set_device(0)
    runs = {}
    for dev in ("cuda:0", "cuda:1"):
        slam = ChunkedSlam(cfg, chunk=4, device=dev)
        slam.run(frames, stage=False)
        slam.finish()
        host = VisualOdometry(cfg, lookahead=2, device=dev)
        for f, left, right in frames:
            host.process(f, left, right)
        host.finish()
        runs[dev] = (slam, host)
    def records(driver):   # without the host driver's wall times
        return [{k: v for k, v in s.items() if k != "wall_s"} for s in driver.stats]

    for a, b in zip(runs["cuda:0"], runs["cuda:1"]):
        assert records(a) == records(b)
        assert sorted(a.estimates) == sorted(b.estimates)
        for f in a.estimates:
            np.testing.assert_array_equal(a.estimates[f], b.estimates[f])
