"""keyframe.ms_per_keyframe (ms): the wall of the keyframe branch's spans
(`ChunkStep.depth_fn`, `insert_keyframe`, `run_ba`, each ending in a
synchronize) over the traced window outside the profiled slice, per
keyframe branch taken there. None where it took none."""


def read(ctx):
    rows = [r for r in ctx["span_rows"] if r[0].startswith("keyframe.")]
    branches = sum(1 for r in rows if r[0] == "keyframe.depth")
    if not branches:
        return None
    return sum(t1 - t0 for _, t0, t1 in rows) * 1e3 / branches
