"""extract.device_ms_per_frame (ms): the device time of the batched
extraction in the profiled slice: the union of the intervals of the device
operations that start inside an extraction span (`ChunkStep.extract`, one a
chunk, ending in a synchronize, so the work it queued runs inside it), over
the frames of the chunks those spans extracted. None where the slice holds
no such span."""

from slam_bench import yardstick


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    spans = [(a, b) for layer, a, b in trace["spans"] if layer == "extract"]
    n = len(ctx["sequence"])
    sizes = [min((k + 1) * ctx["chunk"], n) - k * ctx["chunk"] for k in ctx["profiled"]]
    frames = sum(size for size, _ in zip(sizes, spans))
    if not frames:
        return None
    ops = [(t0, t1) for _, t0, t1 in trace["ops"] if any(a <= t0 <= b for a, b in spans)]
    return yardstick.busy(ops) * 1e3 / frames
