"""track.device_ms_per_frame (ms): the device time of tracking in the
profiled slice: the union of the intervals of the device operations that
start inside a tracking span (`ChunkStep.track_step`: matching and
PnP-RANSAC, one a frame, ending in a synchronize), over the spans' count.
None where the slice holds no such span."""

from slam_bench import yardstick


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    spans = [(a, b) for layer, a, b in trace["spans"] if layer == "track"]
    if not spans:
        return None
    ops = [(t0, t1) for _, t0, t1 in trace["ops"] if any(a <= t0 <= b for a, b in spans)]
    return yardstick.busy(ops) * 1e3 / len(spans)
