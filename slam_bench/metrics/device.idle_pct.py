"""device.idle_pct (%): the share of the profiled slice's wall in which no
operation ran on the device: 1 - the union of the device operations'
intervals over the slice's wall."""


def read(ctx):
    if ctx["trace"] is None or not ctx["slice_wall_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["slice_wall_s"])
