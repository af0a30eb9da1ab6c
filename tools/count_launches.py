"""Device launches, host syncs and device time of the port's two drivers'
units of work on one CUDA card: one production chunk (the chunk_step row
of profiling.production at r=1: ChunkStep.__call__ from init_carry, B=8)
and the host driver (VisualOdometry, lookahead 1) over the first 16
frames of the default synthetic world, initialisation and keyframes
included.

    python tools/count_launches.py [--tree DIR] [--label NAME] [--out DIR]

`--tree` runs the copy of the port under DIR (e.g. an earlier commit
unpacked with `git archive`), so two trees can be counted in one call.
Prints one JSON line and writes it to --out (default build/profile/,
git-ignored).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="current")
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    import stereo_visual_slam_tpu_torch
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.pipeline.vo import VisualOdometry
    from stereo_visual_slam_tpu_torch.profiling import production, timing
    from stereo_visual_slam_tpu_torch.utils.config import Config

    if not os.path.abspath(stereo_visual_slam_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f"imported {stereo_visual_slam_tpu_torch.__file__}, not {tree}")
    device = timing.require("cuda")
    cfg = Config()
    label, chunk, per = production.phases(cfg, device)[0]
    frames = list(synthetic.frames(synthetic.make_world(cfg, n_frames=16, n_points=8000,
                                                        seed=0)))

    def host():
        vo = VisualOdometry(cfg, lookahead=1, device=device)
        for f, left, right in frames:
            vo.process(f, left, right)
        vo.finish()

    keep = ("label", "wall_ms", "device_ms", "launches", "syncs", "sync_sites")
    rows = [timing.measure(chunk, label, device, r=1, best_of=1, per=per),
            timing.measure(host, "host driver, 16 frames", device, r=1, best_of=1, per=16)]
    out = dict(tree=a.label, card=timing.card_line(device),
               rows=[{k: row[k] for k in keep} for row in rows])
    line = json.dumps(out)
    print(line)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"count_launches_{a.label}.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
