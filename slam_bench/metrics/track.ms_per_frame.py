"""track.ms_per_frame (ms): the wall of the tracking spans
(`ChunkStep.track_step`: matching and PnP-RANSAC, each ending in a
synchronize) over the traced window outside the profiled slice, per frame
handed in there."""


def read(ctx):
    if not ctx["span_frames"]:
        return None
    wall = sum(t1 - t0 for layer, t0, t1 in ctx["span_rows"] if layer == "track")
    return wall * 1e3 / ctx["span_frames"]
