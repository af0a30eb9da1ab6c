"""The readings that a cell's limits are set from, on the card, at the
cell's own size: for each seed, the program's sound numbers (one whole
pass through the streamed path, as the window drives it) and the
control's (the plain reference with TF32 on, in the program's place), both
against the reference in float32. The benchmark's own runs never run this.

    python3 -m slam_bench.control --workload <cell> --seeds 11 12 13

One JSON line a seed: both sides' numbers, and the seed's keyframe share,
frames tracked, Lost, and its accuracy against the world's ground truth
(the seed sweep reads these). The control has to come out not correct:
the cell's limits sit between the program's largest readings and the
control's smallest (PERF.md gives both).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import torch

from slam_bench import compare, run


def readings(name: str, seed: int, device, workers: int) -> dict:
    from slam_bench.reference import chunked as ref_chunked
    from slam_bench.reference import config as ref_config_mod
    from slam_bench.reference import precision
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils import config as port_config_mod

    spec = run.load_cell(run.ROOT, name)
    cfg_data, traffic = spec["config"]["config"], spec["traffic"]
    chunk = traffic["chunk"]
    world, frames = run.make_frames(cfg_data, traffic, seed, workers)
    ref_cfg = run.build_config(ref_config_mod.Config, cfg_data)
    judge = compare.Judge(ref_cfg, frames, world.poses_T_c_w, seed, chunk, device)
    cfg = run.build_config(port_config_mod.Config, cfg_data)
    side = compare.Outputs()
    compare.stream(lambda: ChunkedSlam(cfg, chunk=chunk, seed=seed, device=device),
                   frames, chunk, side)
    recs = side.passes[0].records.values()
    out = dict(workload=name, seed=seed, frames=len(recs),
               keyframes=sum(bool(r.is_keyframe) for r in recs),
               tracked=sum(bool(r.tracked) for r in recs),
               lost=any(bool(r.lost) for r in recs),
               accuracy=run._accuracy(side.passes, world),
               program=compare.compare(side, judge))
    del side
    gc.collect()
    control = compare.Outputs()
    with precision(True):
        compare.stream(lambda: ref_chunked.ChunkedSlam(ref_cfg, chunk=chunk, seed=seed,
                                                       device=device),
                       frames, chunk, control)
    out["control"] = compare.compare(control, judge)
    out["limits"] = spec["limits"]
    out["control_correct"] = compare.verdict(out["control"], spec["limits"])
    out["program_correct"] = compare.verdict(out["program"], spec["limits"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("slam_bench.control: no CUDA device", file=sys.stderr)
        return 2
    workers = max(1, min(7, (os.cpu_count() or 2) - 1))
    for seed in args.seeds:
        line = readings(args.workload, seed, torch.device("cuda"), workers)
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
