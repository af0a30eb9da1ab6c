"""driver.syncs_per_frame (syncs/frame): every host wait on the device
that torch's sync debug mode reports over the traced window, the
harness's own synchronizes left out, over the frames handed in. The
driver's own count (`ChunkedSlam.syncs`) sees only its fetches."""


def read(ctx):
    if ctx["device"].type != "cuda" or not ctx["frames_done"]:
        return None
    return len(ctx["syncs"]) / ctx["frames_done"]
