"""Per-phase profilers of the production program on the card: the
counterparts of the JAX package's device-time tools.

    timing       the method (`measure`): wall, device busy time, launches
                 and syncs per iteration of a phase; its own floor
    production   tools/profile_production.py: chunk_step, batch_extract,
                 the feats scan, the BA schedule, the extractor's stages
    scan_split   tools/profile_scan_split.py: feats_step, track_step, the
                 matcher, PnP-RANSAC
    window       tools/window_growth.py and tools/scaling_bench.py: the BA
                 schedule as the window grows, and sharded over ranks
    roofline_report  tools/roofline_report.py: GFLOP, GB and the MFU and
                 HBM shares of chunk_step, batch_extract, the feats step
                 and the BA schedule (the cost model: utils/roofline.py)
    extract_cost tools/profile_extract_cost.py: batch_extract's GFLOP and
                 GB, stage by stage
    micro_topk   tools/micro_topk.py: top-k and detect strategies, timed

Each runs as `python -m stereo_visual_slam_tpu_torch.profiling.<name>`
(default `--device cuda`, which needs the card), prints a table and, last,
one JSON line, which it also writes to `--out` (default build/profile/).
Each exposes `run(cfg, device, r=...) -> dict` for the tests and
chip_smoke.py. Importing a module here runs nothing.
"""
