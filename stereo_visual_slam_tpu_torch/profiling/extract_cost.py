"""FLOP and HBM-byte breakdown of the batched extractor, stage by stage: the
counterpart of tools/profile_extract_cost.py.

    python -m stereo_visual_slam_tpu_torch.profiling.extract_cost [--device cuda]
        [--params small.yaml] [--json]

The JAX tool compiles a partial program per stage; here the stages are
the very calls batch_extract makes (models/frontend.ExtractStages),
composed by production.extract_by_stages in one counted run with a scope
around each stage (utils/roofline.Counter.scope), on production.
chunk_images (B=8 frames of make_world(cfg, 8, 8000, seed 0)). Rows, under
the JAX tool's labels (level counts the config's):

  batch_extract TOTAL             make_batch_extractor(cfg, with_depth=True),
                                  counted on its own
  pyramid resize (7 levels)       the uint8 -> f32 level 0 and the resizes
  FAST+NMS score maps (8 levels)  the stacking, the FAST+NMS kernel, the
                                  border mask
  pooled top-k (8 levels)         nms_topk
  box blur (8 levels)             the box blur (also inside the next row)
  blur+describe (8 levels)        the blur, the patch-gather kernel, BRIEF
  ANMS                            the levels' table: concatenation,
                                  validity and ANMS
  stereo sweep                    the ZNCC kernel, its gates, back-projection

Every row but the box blur is disjoint from the others, and together they
are the TOTAL, op for op: the run raises unless their sum equals it and the
composed features equal batch_extract's. Counts only; nothing is timed.
"""

from __future__ import annotations

import sys

import torch

from stereo_visual_slam_tpu_torch.models import frontend
from stereo_visual_slam_tpu_torch.profiling import production, timing
from stereo_visual_slam_tpu_torch.utils import roofline

TOTAL = "batch_extract TOTAL"
# the stages that partition the TOTAL ("blur" lies inside "describe")
DISJOINT = ("pyramid", "score", "topk", "describe", "anms", "stereo")


def labels(cfg) -> dict:
    """production.STAGES -> the JAX tool's row label."""
    n = cfg.frontend.n_levels
    return {"pyramid": f"pyramid resize ({n - 1} levels)",
            "score": f"FAST+NMS score maps ({n} levels)", "topk": f"pooled top-k ({n} levels)",
            "blur": f"box blur ({n} levels)", "describe": f"blur+describe ({n} levels)",
            "anms": "ANMS", "stereo": "stereo sweep"}


def run(cfg, device, images=None) -> dict:
    device = timing.require(device)
    if images is None:
        images = production.chunk_images(cfg, device)
    batch_extract = frontend.make_batch_extractor(cfg, device, with_depth=True)
    with roofline.Counter() as whole:
        ref = batch_extract(images)
    with roofline.Counter() as counter:
        got = production.extract_by_stages(batch_extract.stages, images, with_depth=True,
                                           scope=counter.scope)
    differ = [name for name, a, b in zip(frontend.FrameFeatures._fields, ref, got)
              if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"the stages composed differ from batch_extract in {differ}")
    parts = [counter.scopes[k] for k in DISJOINT]
    summed = roofline.ProgramCost(sum(c.flops for c in parts),
                                  sum(c.bytes_accessed for c in parts))
    if summed != whole.cost or counter.cost != whole.cost:
        raise RuntimeError(f"the stage rows sum to {summed}, batch_extract counts {whole.cost}")
    names = labels(cfg)
    rows = [dict(label=TOTAL, gflop=whole.flops / 1e9, gb=whole.bytes_accessed / 1e9)]
    rows += [dict(label=names[k], gflop=counter.scopes[k].flops / 1e9,
                  gb=counter.scopes[k].bytes_accessed / 1e9, disjoint=k in DISJOINT)
             for k in production.STAGES]
    return dict(timing.header("extract_cost", device, 0, 0), B=images.shape[0],
                image_hw=list(cfg.image_hw), rows=rows,
                units={k: dict(calls=v[0], gb=v[1] / 1e9, gflop=v[2] / 1e9)
                       for k, v in whole.units.items()})


def render(result: dict) -> str:
    d = result["device"]
    lines = [f"# batch_extract (B={result['B']}) by stage on {d['card'] or d['kind']}: "
             f"the counted eager program"]
    lines += [f"{r['label']}: {r['gflop']:.4f} GFLOP, {r['gb']:.4f} GB" for r in result["rows"]]
    lines += [f"  {k} kernel: {u['calls']} calls, {u['gflop']:.4f} GFLOP, {u['gb']:.4f} GB"
              for k, u in result["units"].items()]
    return "\n".join(lines)


def main(argv=None) -> int:
    return timing.cli("extract_cost", __doc__, run, render, default_r=None, argv=argv)


if __name__ == "__main__":
    sys.exit(main())
