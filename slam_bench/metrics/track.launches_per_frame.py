"""track.launches_per_frame (launches/frame): the device operations of
the profiled slice that start inside a tracking span, per tracking span
(one a frame). Each span ends in a synchronize, so the work it queued runs
inside it."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None:
        return None
    spans = [(a, b) for layer, a, b in trace["spans"] if layer == "track"]
    if not spans:
        return None
    n = sum(1 for _, t0, _ in trace["ops"] if any(a <= t0 <= b for a, b in spans))
    return n / len(spans)
