"""The JAX package's full-size runs that the port is held to
(stereo_visual_slam_tpu_torch/data/reference_runs.json,
pipeline/reference_runs.py), and what writes them.

Rewrite the file (JAX package on the CPU, ~2 min):

    JAX_PLATFORMS=cpu python tests/test_torch_reference_runs.py

What parts the port's run from the file's, on this CPU (~6 min):

    JAX_PLATFORMS=cpu python tests/test_torch_reference_runs.py --study

runs the port's ChunkedSlam over the 64 frames three ways and compares
each with the file's chunked run (pipeline/reference_runs.compare): as it
is; with the pyramid's resize weights rounded op by op, the sample
position (i + 0.5) * inv_scale - 0.5 rounded after the multiply where
XLA's compiled code fuses it into one multiply-add (how the port computed
them before); and with the JAX package's own batched extraction in place
of the port's. It prints the gaps, the frames whose records differ and
how far the two weight roundings are from jax.image.resize's jitted
weights at the production sizes.

    JAX_PLATFORMS=cpu python tests/test_torch_reference_runs.py --study-bench

does the same for the bench's default world (216 frames, seed 0: both
packages' ChunkedSlam, ~8 min) and then runs both packages from one carry
at frame 105: the JAX package's, with the tracker pose the port computed
from the JAX carry at frame 104 (the only difference, rounding), to show
whether the JAX package follows the port's path from there.

Tier-1 cases, on the CPU at production Config() over the first chunk
(8 frames) of the reference world: the file's schema; the JAX
ChunkedSlam re-run equals the file (records equal; poses of the frames
that are not keyframes, whose poses no later BA moves, within 1e-6); the
port's ChunkedSlam with its default draws held to the file (records equal
but `n_inliers` within 1, those poses atol 1e-4, as test_torch_slice).
The port over all 64 frames of both runs runs on the card
(tests/test_torch_reference_runs_cuda.py, chip_smoke.py phases 4-5).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

if __name__ == "__main__":   # run as a script: the repo root holds the packages
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from stereo_visual_slam_tpu_torch.pipeline import reference_runs  # noqa: E402

torch.set_num_threads(1)

N_FRAMES = 64
N_POINTS = 8000
SEED = 0
CHUNK = 8
LOOKAHEAD = 1
COMMAND = "JAX_PLATFORMS=cpu python tests/test_torch_reference_runs.py"


def world_and_frames(config_mod, synthetic_mod, n=N_FRAMES):
    """The reference world at production Config() and its first n frames
    (either package's config and synthetic module: the port's are copies)."""
    cfg = config_mod.Config()
    world = synthetic_mod.make_world(cfg, n_frames=N_FRAMES, n_points=N_POINTS, seed=SEED)
    frames = []
    for f in synthetic_mod.frames(world):
        if f[0] >= n:
            break
        frames.append(f)
    return cfg, world, frames


@pytest.fixture(scope="module")
def first_frames():
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.utils import config as port_config

    return world_and_frames(port_config, synthetic, CHUNK)[2]


def jax_chunked(frames):
    from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu.utils.config import Config

    slam = ChunkedSlam(Config(), chunk=CHUNK, seed=SEED)
    slam.run(frames, stage=False)
    slam.finish()
    return reference_runs.records(slam.stats, slam.estimates)


def jax_host(frames):
    from stereo_visual_slam_tpu.pipeline.vo import VisualOdometry
    from stereo_visual_slam_tpu.utils.config import Config

    vo = VisualOdometry(Config(), seed=SEED, lookahead=LOOKAHEAD)
    for f, left, right in frames:
        vo.process(f, left, right)
    vo.finish()
    return reference_runs.records(vo.stats, vo.estimates)


def write_reference(path=reference_runs.PATH):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from stereo_visual_slam_tpu.data import synthetic
    from stereo_visual_slam_tpu.utils import config as jax_config

    _, world, frames = world_and_frames(jax_config, synthetic)
    runs = {}
    for name, fn, driver in (("chunked", jax_chunked, f"ChunkedSlam, chunk {CHUNK}"),
                             ("host", jax_host, f"VisualOdometry, lookahead {LOOKAHEAD}")):
        recs = fn(frames)
        acc = reference_runs.accuracy(recs, world.poses_T_c_w)
        runs[name] = dict(driver=driver, seed=SEED, ate_m=acc["ate_m"],
                          kitti_trans_pct=acc["kitti_trans_pct"], frames=recs)
        print(f"{name}: {len(recs)} frames, ATE {acc['ate_m']:.6f} m, "
              f"KITTI trans {acc['kitti_trans_pct']:.4f} %", file=sys.stderr)
    out = dict(
        jax_version=jax.__version__, platform="cpu", command=COMMAND,
        world=dict(config="Config()", n_frames=N_FRAMES, n_points=N_POINTS, seed=SEED),
        fields=["frame_id", *reference_runs.FIELDS, "T_c_w"], runs=runs)
    with open(path, "w") as f:
        json.dump(out, f, indent=None, separators=(",", ":"))
        f.write("\n")


@pytest.fixture(scope="module")
def reference():
    return reference_runs.load()


def test_schema(reference):
    assert reference["platform"] == "cpu" and reference["jax_version"]
    assert reference["world"] == dict(config="Config()", n_frames=N_FRAMES,
                                      n_points=N_POINTS, seed=SEED)
    assert set(reference["runs"]) == {"chunked", "host"}
    for run in reference["runs"].values():
        fids = [r["frame_id"] for r in run["frames"]]
        assert fids == list(range(N_FRAMES))
        for r in run["frames"]:
            assert set(r) == {"frame_id", *reference_runs.FIELDS, "T_c_w"}
            assert r["state"] in ("init", "tracked", "rejected", "lost")
            T = np.asarray(r["T_c_w"], np.float32).reshape(4, 4)
            assert np.isfinite(T).all() and np.array_equal(T[3], [0, 0, 0, 1])
            # every value round-trips float32
            assert [float(f"{v:.9g}") for v in T.reshape(-1)] == r["T_c_w"]
        assert 0 < run["ate_m"] < 2.0 and not any(r["state"] == "lost" for r in run["frames"])
    assert os.path.getsize(reference_runs.PATH) < 100_000


@pytest.mark.parametrize("run", ["chunked", "host"])
def test_bound_holds_on_the_reference_and_refuses_a_jump(reference, run):
    """The bound on a run equal to the reference (no miss, no gap), and on
    copies whose camera at one frame (40) moves 2 mm sideways, and whose
    last keyframes all turn into plain frames: each misses its part."""
    import copy

    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.utils.config import Config

    ref = reference["runs"][run]
    gt = synthetic.make_world(Config(), n_frames=N_FRAMES, n_points=N_POINTS,
                              seed=SEED).poses_T_c_w
    same = reference_runs.compare(copy.deepcopy(ref["frames"]), ref, gt)
    assert reference_runs.misses(same) == []
    assert same["records_equal"] == N_FRAMES and same["first_part"] is None
    assert same["centre_gap_max_m"] == same["motion_gap_max_m"] == 0.0

    moved = copy.deepcopy(ref["frames"])
    moved[40]["T_c_w"][3] += 2e-3           # t_x: the centre moves by R^T (2 mm)
    gaps = reference_runs.compare(moved, ref, gt)
    assert gaps["first_part"] == 40 and gaps["records_equal"] == N_FRAMES
    assert gaps["centre_gap_max_frame"] == 40
    assert abs(gaps["centre_gap_max_m"] - 2e-3) < 1e-6
    assert [m.split()[0] for m in reference_runs.misses(gaps)] == ["camera", "frame-to-frame"]

    fewer = copy.deepcopy(ref["frames"])
    for r in [r for r in fewer if r["keyframe"]][-2:]:
        r["keyframe"] = False
    gaps = reference_runs.compare(fewer, ref, gt)
    assert gaps["keyframes"] == gaps["ref_keyframes"] - 2
    assert reference_runs.misses(gaps) == [
        f"{gaps['keyframes']} keyframes against {gaps['ref_keyframes']}"]


def first_chunk(reference, recs):
    """The file's first chunk, and its frames that are not keyframes."""
    ref = reference["runs"]["chunked"]["frames"][:CHUNK]
    assert [r["frame_id"] for r in recs] == [r["frame_id"] for r in ref]
    return ref, [i for i, r in enumerate(ref) if not r["keyframe"]]


def test_first_chunk_rederived_by_jax(reference, first_frames):
    recs = jax_chunked(first_frames)
    ref, plain = first_chunk(reference, recs)
    assert len(plain) >= 4
    for a, b in zip(recs, ref):
        assert {k: a[k] for k in reference_runs.FIELDS} == {k: b[k] for k in reference_runs.FIELDS}
    for i in plain:
        np.testing.assert_allclose(recs[i]["T_c_w"], ref[i]["T_c_w"], rtol=0, atol=1e-6,
                                   err_msg=f"frame {i}")


def test_port_first_chunk_default_draws(reference, first_frames):
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils.config import Config

    slam = ChunkedSlam(Config(), chunk=CHUNK, seed=SEED, device="cpu")
    slam.run(first_frames, stage=False)
    slam.finish()
    recs = reference_runs.records(slam.stats, slam.estimates)
    ref, plain = first_chunk(reference, recs)
    for a, b in zip(recs, ref):
        assert (a["state"], a["keyframe"], a["n_matches"], a["n_new_landmarks"]) == \
            (b["state"], b["keyframe"], b["n_matches"], b["n_new_landmarks"]), (a, b)
        assert abs(a["n_inliers"] - b["n_inliers"]) <= 1, (a, b)
    for i in plain:
        np.testing.assert_allclose(recs[i]["T_c_w"], ref[i]["T_c_w"], rtol=0, atol=1e-4,
                                   err_msg=f"frame {i}")


def study():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from stereo_visual_slam_tpu.models import frontend as jfe
    from stereo_visual_slam_tpu.utils.config import Config as JaxConfig
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.models import frontend as tfe
    from stereo_visual_slam_tpu_torch.ops import image
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils import config as port_config

    torch.set_num_threads(os.cpu_count())
    ref = reference_runs.load()["runs"]["chunked"]
    cfg, world, frames = world_and_frames(port_config, synthetic)
    exact = image.resize_weights

    def rounded_after_multiply(n, m):
        """The weights rounded op by op: the scale and its inverse in
        float32, the sample positions rounded after the multiply."""
        f32 = np.float32
        inv = f32(1.0) / (f32(m) / f32(n))
        sample = (np.arange(m, dtype=f32) + f32(0.5)) * inv - f32(0.5)
        x = np.abs(sample[None, :] - np.arange(n, dtype=f32)[:, None]) / max(inv, f32(1.0))
        w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
        total = np.sum(w, axis=0, keepdims=True, dtype=f32)
        w = np.where(np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps,
                     w / np.where(total != 0, total, f32(1.0)), f32(0.0))
        inside = (sample >= f32(-0.5)) & (sample <= f32(n) - f32(0.5))
        return np.where(inside[None, :], w, f32(0.0)).astype(f32)

    vh, vw = cfg.image_hw
    for name, fn in (("fused (the port)", exact), ("rounded after the multiply", rounded_after_multiply)):
        worst = 0.0
        for _, (h, w), _, _ in tfe._level_geometry(cfg)[1:]:
            for n, m in ((vh, h), (vw, w)):
                jw = jax.jit(jax.vmap(lambda c: jax.image.resize(c, (m,), method="linear")))(
                    jnp.eye(n, dtype=jnp.float32))
                worst = max(worst, float(np.abs(fn(n, m) - np.asarray(jw)).max()))
        print(f"resize weights, {name}: at most {worst:.3g} from jax.image.resize's (jitted)")

    jext = jfe.make_batch_extractor(JaxConfig(), with_depth=False)

    def jax_extraction(images):
        f = jext(jnp.asarray(images.numpy()))
        return tfe.FrameFeatures(*[torch.from_numpy(np.array(getattr(f, n)))
                                   for n in tfe.FrameFeatures._fields])

    for label in ("the port", "weights rounded after the multiply", "the JAX extraction"):
        image.resize_weights = rounded_after_multiply if label.startswith("weights") else exact
        slam = ChunkedSlam(cfg, chunk=CHUNK, seed=SEED, device="cpu")
        if label == "the JAX extraction":
            slam.chunk_step.extract_chunk = jax_extraction
        slam.run(frames, stage=False)
        slam.finish()
        recs = reference_runs.records(slam.stats, slam.estimates)
        gaps = reference_runs.compare(recs, ref, world.poses_T_c_w)
        print(f"{label}: {reference_runs.summary(gaps)}; misses {reference_runs.misses(gaps)}")
        for a, b in zip(recs, ref["frames"]):
            diff = {k: (b[k], a[k]) for k in reference_runs.FIELDS if a[k] != b[k]}
            if diff:
                print(f"  frame {a['frame_id']}: (JAX, port) {diff}")
    image.resize_weights = exact


def study_bench(split_at=104, until=112):
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    from stereo_visual_slam_tpu.pipeline.chunked import ChunkedSlam as JaxSlam
    from stereo_visual_slam_tpu.utils.config import Config as JaxConfig
    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.models import slam_core
    from stereo_visual_slam_tpu_torch.pipeline.chunked import ChunkedSlam
    from stereo_visual_slam_tpu_torch.utils.config import Config

    torch.set_num_threads(os.cpu_count())
    world = synthetic.make_world(Config(), n_frames=216, n_points=N_POINTS, seed=SEED)
    frames = list(synthetic.frames(world))
    tmp = tempfile.mkdtemp()
    snap = os.path.join(tmp, "jax.npz")
    j = JaxSlam(JaxConfig(), chunk=CHUNK, seed=SEED)
    for f, left, right in frames:
        if f == split_at:
            j.save_snapshot(snap)
        j.process(f, left, right)
    j.finish()
    t = ChunkedSlam(Config(), chunk=CHUNK, seed=SEED, device="cpu")
    t.run(frames, stage=False)
    t.finish()
    ref = reference_runs.records(j.stats, j.estimates)
    as_ref = dict(frames=ref, ate_m=reference_runs.accuracy(ref, world.poses_T_c_w)["ate_m"])
    gaps = reference_runs.compare(reference_runs.records(t.stats, t.estimates), as_ref,
                                  world.poses_T_c_w)
    print(f"bench default world, the port against the JAX package: {reference_runs.summary(gaps)}")

    # the port's tracker pose after frame split_at, from the JAX carry
    t = ChunkedSlam(Config(), chunk=CHUNK, seed=SEED, device="cpu")
    t.load_snapshot(snap)
    t.process(*frames[split_at])
    t.flush()
    port = slam_core.carry_to_numpy(t.carry)
    j = JaxSlam(JaxConfig(), chunk=CHUNK, seed=SEED)
    j.load_snapshot(snap)
    j.process(*frames[split_at])
    j.save_snapshot(snap)
    carry = dict(np.load(snap))
    for name in ("tstate_T_c_w", "tstate_T_c_l"):
        print(f"after frame {split_at} from one carry: {name} differs by "
              f"{np.abs(port[name] - carry[name]).max():.3g}")
    mixed = os.path.join(tmp, "mixed.npz")
    np.savez_compressed(mixed, **{**carry, **{k: port[k] for k in ("tstate_T_c_w",
                                                                    "tstate_T_c_l")}})
    for label, slam in (("JAX package", JaxSlam(JaxConfig(), chunk=CHUNK, seed=SEED)),
                        ("port", ChunkedSlam(Config(), chunk=CHUNK, seed=SEED, device="cpu"))):
        for path, what in ((snap, "the JAX carry"), (mixed, "the JAX carry with the port's pose")):
            slam.load_snapshot(path)
            slam.stats = []
            for f, left, right in frames[split_at + 1:until]:
                slam.process(f, left, right)
            slam.flush()
            print(f"{label} from {what}, frames {split_at + 1}-{until - 1} (frame, matches, "
                  f"inliers, new landmarks): "
                  f"{[(r['frame_id'], r['n_matches'], r['n_inliers'], r['n_new_landmarks']) for r in slam.stats]}")


if __name__ == "__main__":
    if "--study" in sys.argv:
        study()
    elif "--study-bench" in sys.argv:
        study_bench()
    else:
        write_reference()
