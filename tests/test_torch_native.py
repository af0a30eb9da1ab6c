"""The port's native host runtime (stereo_visual_slam_tpu_torch/utils/native.py
over csrc/host/slamio.cpp and native/src/mapstore.cpp): the port's
counterpart of tests/test_native.py, run against the port's own modules.

Covers PNG/PGM grayscale decode against PIL and against the libpng build of
the original runtime (native/src/slamio.cpp), chip_smoke.py's PNG writer
with every row filter at compression levels 0, 6 and 9 (the other PNG kinds:
tests/test_torch_png.py), the multithreaded prefetching stereo loader, the
KITTI reader's native route, the native trajectory writer and map store
against the port's Python ones, and the build itself: two processes building
at once, the library's place, and a CLI run cut short that still exits.
Every case skips, with the reason, only where the library cannot be built
or loaded.
"""

import ctypes
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from stereo_visual_slam_tpu_torch.utils import native

REPO = Path(__file__).resolve().parents[1]
# the original runtime as native/Makefile builds it, with libpng, built by
# the port's build into its own directory under build/native/
LIBPNG_SOURCES = (REPO / "native" / "src" / "slamio.cpp", REPO / "native" / "src" / "mapstore.cpp")
LIBPNG_LDLIBS = ("-lpng", "-lz", "-pthread")
SUBPROCESS_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _native_runtime():
    if not native.available():
        pytest.skip(f"native slamio library not available: {native.load_error()}")


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


@pytest.fixture(scope="module")
def libpng_read():
    """Decode with the libpng build of native/src/slamio.cpp."""
    lib = ctypes.CDLL(str(native.build(LIBPNG_SOURCES, LIBPNG_LDLIBS)))
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    lib.sio_probe_image.argtypes = [ctypes.c_char_p, i32p, i32p]
    lib.sio_read_image_gray.argtypes = [ctypes.c_char_p, u8p, i32p, i32p, ctypes.c_int,
                                        ctypes.c_int]

    def read(path):
        h, w = ctypes.c_int(), ctypes.c_int()
        assert lib.sio_probe_image(str(path).encode(), ctypes.byref(h), ctypes.byref(w)) == 0
        out = np.empty((h.value, w.value), np.uint8)
        assert lib.sio_read_image_gray(str(path).encode(), out.ctypes.data_as(u8p),
                                       ctypes.byref(h), ctypes.byref(w), h.value, w.value) == 0
        return out

    return read


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _write_pgm(path, arr):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def test_png_decode_matches_pil(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, size=(37, 53), dtype=np.uint8)
    p = str(tmp_path / "img.png")
    _write_png(p, arr)
    out = native.read_image_gray(p)
    np.testing.assert_array_equal(out, arr)


def test_pgm_decode(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, size=(12, 19), dtype=np.uint8)
    p = str(tmp_path / "img.pgm")
    _write_pgm(p, arr)
    out = native.read_image_gray(p)
    np.testing.assert_array_equal(out, arr)


def test_probe_and_bad_file(tmp_path):
    arr = np.zeros((5, 9), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    _write_png(p, arr)
    assert native.probe_image(p) == (5, 9)
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    with pytest.raises(IOError, match="neither a PNG nor a binary PGM"):
        native.probe_image(bad)
    with open(p, "rb") as f:
        truncated = f.read()[:-20]
    with open(bad, "wb") as f:
        f.write(truncated)
    with pytest.raises(IOError, match="truncated PNG"):
        native.read_image_gray(bad)


def _corrupt_png(arr, case):
    """A PNG of `arr` whose image data is broken: its IDAT CRC does not
    match ("crc"), or the CRC matches data that do not inflate ("inflate")."""
    import struct
    import zlib

    png = _chip_smoke().png_bytes(arr)
    at = png.index(b"IDAT")
    n = struct.unpack(">I", png[at - 4:at])[0]
    data = bytearray(png[at + 4:at + 4 + n])
    data[2:] = bytes(len(data) - 2)   # keep the zlib header, zero the stream
    crc = zlib.crc32(b"IDAT" + data) ^ (0 if case == "inflate" else 1)
    return png[:at + 4] + bytes(data) + struct.pack(">I", crc) + png[at + 8 + n:]


@pytest.mark.parametrize("case, reason", [
    ("crc", "CRC error in PNG chunk IDAT"),
    ("inflate", "corrupt or short PNG image data"),
    ("pgm", "truncated PGM"),
])
def test_probe_reads_the_header_only(tmp_path, case, reason):
    """The probe gives the size from the header and never touches the image
    data, so an image whose data is broken probes fine and fails to decode:
    read_image_gray decodes each image once."""
    arr = np.random.default_rng(2).integers(0, 256, size=(21, 34), dtype=np.uint8)
    p = tmp_path / ("x.pgm" if case == "pgm" else "x.png")
    if case == "pgm":
        p.write_bytes(f"P5\n34 21\n255\n".encode() + arr.tobytes()[:-5])
    else:
        p.write_bytes(_corrupt_png(arr, case))
    assert native.probe_image(str(p)) == (21, 34)
    with pytest.raises(IOError, match=re.escape(reason)):
        native.read_image_gray(str(p))


@pytest.mark.parametrize("level", (0, 6, 9))
@pytest.mark.parametrize("first", range(5), ids=("none", "sub", "up", "average", "paeth"))
def test_png_writer_every_filter_read_back(tmp_path, libpng_read, first, level):
    """chip_smoke.png_bytes cycles the rows through the five filters,
    starting at `first` (so each filter also meets the first row): PIL
    reads back the samples, and the port's decoder gives the bytes of the
    libpng build (16-bit: the high byte, as libpng's png_set_strip_16)."""
    png_bytes = _chip_smoke().png_bytes
    rng = np.random.default_rng(10 * first + level)
    smooth = np.cumsum(rng.integers(-4, 5, size=(41, 67)), axis=1)
    for img in (rng.integers(0, 256, size=(41, 67), dtype=np.uint8),
                (smooth % 256).astype(np.uint8),
                rng.integers(0, 1 << 16, size=(23, 31), dtype=np.uint16)):
        p = tmp_path / f"{img.dtype}.png"
        p.write_bytes(png_bytes(img, level=level, first=first))
        from PIL import Image

        with Image.open(p) as im:
            np.testing.assert_array_equal(np.asarray(im), img)
        expect = img if img.dtype == np.uint8 else (img >> 8).astype(np.uint8)
        got = native.read_image_gray(str(p))
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(got, libpng_read(p))


def _make_sequence(tmp_path, n, h=24, w=32):
    left_dir = tmp_path / "image_0"
    right_dir = tmp_path / "image_1"
    left_dir.mkdir()
    right_dir.mkdir()
    rng = np.random.default_rng(7)
    frames = []
    for i in range(n):
        l = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
        r = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
        _write_png(str(left_dir / f"{i:06d}.png"), l)
        _write_png(str(right_dir / f"{i:06d}.png"), r)
        frames.append((l, r))
    return str(left_dir), str(right_dir), frames


def test_prefetcher_in_order_and_correct(tmp_path):
    n = 25
    left_dir, right_dir, frames = _make_sequence(tmp_path, n)
    got = []
    with native.StereoPrefetcher(
        left_dir, right_dir, count=n, hw=(24, 32), depth=4, workers=3
    ) as pf:
        for idx, l, r in pf:
            got.append(idx)
            np.testing.assert_array_equal(l, frames[idx][0])
            np.testing.assert_array_equal(r, frames[idx][1])
    assert got == list(range(n))


def test_prefetcher_early_close(tmp_path):
    n = 16
    left_dir, right_dir, _ = _make_sequence(tmp_path, n)
    pf = native.StereoPrefetcher(
        left_dir, right_dir, count=n, hw=(24, 32), depth=4, workers=2
    )
    it = iter(pf)
    next(it)
    next(it)
    pf.close()  # must join workers without deadlock


def test_kitti_sequence_uses_native(tmp_path, monkeypatch):
    from stereo_visual_slam_tpu_torch.data import kitti

    n = 5
    _make_sequence(tmp_path, n)
    opened, closed = [], []

    class Spy(native.StereoPrefetcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            opened.append(kw)
            self.n = len(opened)

        def close(self):
            if self._handle:
                closed.append(self.n)
            super().close()

    monkeypatch.setattr(native, "StereoPrefetcher", Spy)
    seq = kitti.open_sequence(str(tmp_path))
    assert seq.n_frames == n
    out = list(seq.frames())
    assert [i for i, _, _ in out] == list(range(n))
    l0, _ = seq.frame(0)
    np.testing.assert_array_equal(out[0][1], l0)
    assert opened == [dict(count=n, hw=(24, 32))] and closed == [1]
    # a consumer that stops early: closing the generator joins the workers
    gen = seq.frames()
    next(gen)
    gen.close()
    assert len(opened) == 2 and closed == [1, 2]


def _rand_rigid(rng):
    A = rng.normal(size=(3, 3))
    Q, _ = np.linalg.qr(A)
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    T = np.eye(4)
    T[:3, :3] = Q
    T[:3, 3] = rng.normal(scale=5.0, size=3)
    return T


def test_traj_writer_matches_python(tmp_path):
    from stereo_visual_slam_tpu_torch.pipeline import trajectory

    rng = np.random.default_rng(3)
    poses = [_rand_rigid(rng) for _ in range(6)]
    py_path = str(tmp_path / "py.txt")
    na_path = str(tmp_path / "native.txt")
    pyw = trajectory.TrajectoryWriter(py_path)
    with native.NativeTrajectoryWriter(na_path) as nw:
        for i, T in enumerate(poses):
            pyw.write(i * 3, T)
            nw.write(i * 3, T)
        nw.flush()

    py_rows = trajectory.read_trajectory(py_path)
    na_rows = trajectory.read_trajectory(na_path)
    assert set(py_rows) == set(na_rows)
    for k in py_rows:
        np.testing.assert_allclose(na_rows[k], py_rows[k], rtol=0, atol=1e-7)


def test_traj_writer_append(tmp_path):
    p = str(tmp_path / "t.txt")
    T = np.eye(4)
    with native.NativeTrajectoryWriter(p) as w:
        w.write(0, T)
    with native.NativeTrajectoryWriter(p, append=True) as w:
        w.write(1, T)
    with open(p) as f:
        lines = f.read().strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("0 ") and lines[1].startswith("1 ")


# ---------------------------------------------------------------------------
# Native map store (native/src/mapstore.cpp) vs the port's Python store
# (mapping/store.py): randomized operation-sequence equivalence.
# ---------------------------------------------------------------------------


def _small_cfg():
    from stereo_visual_slam_tpu_torch.utils.config import small_config

    return small_config()


def _rand_pose(rng):
    th = rng.normal(0, 0.2, 3)
    a = np.linalg.norm(th) + 1e-12
    k = th / a
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * (Kx @ Kx)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.astype(np.float32)
    T[:3, 3] = rng.normal(0, 2.0, 3).astype(np.float32)
    return T


def _random_kf(rng, cfg, kf_id, frame_id, store, next_ids):
    """One random Keyframe observing a mix of live landmarks, and a batch
    of new landmarks, as the pipeline makes per keyframe."""
    from stereo_visual_slam_tpu_torch.mapping.store import Keyframe

    N = cfg.frontend.max_raw_keypoints
    n_new = int(rng.integers(5, 40))
    ids_new = np.arange(next_ids, next_ids + n_new, dtype=np.int64)
    pos_new = rng.normal(0, 20, (n_new, 3)).astype(np.float32)
    rel_new = rng.uniform(size=n_new) < 0.7
    rows = np.full(N, -1, np.int32)
    valid = np.zeros(N, bool)
    uv = np.zeros((N, 2), np.float32)
    live = np.nonzero(store.alive)[0]
    n_old = min(len(live), int(rng.integers(0, 60)))
    if n_old:
        rows[:n_old] = rng.choice(live, n_old, replace=False).astype(np.int32)
        valid[:n_old] = True
        uv[:n_old] = rng.uniform(0, 500, (n_old, 2)).astype(np.float32)
    kf = Keyframe(keyframe_id=kf_id, frame_id=frame_id, T_c_w=_rand_pose(rng), rows=rows,
                  uv=uv, valid=valid)
    return kf, ids_new, pos_new, rel_new


def _add_keyframe(rng, cfg, step, frame_id, py, nat, next_id):
    """Spawn a keyframe's new landmarks in both stores, observe them in its
    tail slots, and insert it into both; returns the next free id."""
    kf, ids_new, pos_new, rel_new = _random_kf(rng, cfg, step, frame_id, py, next_id)
    py.spawn(ids_new, pos_new, rel_new)
    nat.spawn(ids_new, pos_new, rel_new)
    rows_new = py.rows_of(ids_new)
    np.testing.assert_array_equal(rows_new, nat.rows_of(ids_new))
    n_used = int(kf.valid.sum())
    m = min(len(ids_new), len(kf.rows) - n_used)
    kf.rows[n_used:n_used + m] = rows_new[:m]
    kf.valid[n_used:n_used + m] = True
    kf.uv[n_used:n_used + m] = rng.uniform(0, 500, (m, 2)).astype(np.float32)
    py.insert_keyframe(kf)
    nat.insert_keyframe(kf)
    return next_id + len(ids_new)


def _assert_same_window(py, nat):
    out_py, out_nat = py.assemble_schedule_input(), nat.assemble_schedule_input()
    assert (out_py is None) == (out_nat is None)
    if out_py is None:
        return
    (a_py, kf_py, sel_py), (a_nat, kf_nat, sel_nat) = out_py, out_nat
    np.testing.assert_array_equal(kf_py, kf_nat)
    np.testing.assert_array_equal(sel_py, sel_nat)
    for k in a_py:
        np.testing.assert_array_equal(a_py[k], a_nat[k], err_msg=k)


def test_native_mapstore_equivalence(rng):
    """The same random op sequence through the Python store and the native
    one: arena state, counts, eviction choices and the assembled BA window
    agree exactly."""
    from stereo_visual_slam_tpu_torch.mapping.store import MapStore

    cfg = _small_cfg()
    py = MapStore(cfg)
    nat = native.NativeMapStore(cfg)
    next_id = 0
    for step in range(30):
        next_id = _add_keyframe(rng, cfg, step, step * 2, py, nat, next_id)
        if step % 3 == 2:   # an occasional upgrade of some live rows
            rows_up = np.nonzero(py.alive)[0][:7].astype(np.int32)
            pos_up = rng.normal(0, 20, (len(rows_up), 3)).astype(np.float32)
            py.upgrade(rows_up, pos_up)
            nat.upgrade(rows_up, pos_up)

        assert py.n_keyframes() == nat.n_keyframes()
        assert py.n_landmarks() == nat.n_landmarks(), f"step {step}"
        st = nat.arena_state()
        n = len(py.alive)
        np.testing.assert_array_equal(py.alive, st["alive"][:n])
        np.testing.assert_array_equal(py.obs_count, st["obs_count"][:n])
        np.testing.assert_array_equal(py.row_id, st["row_id"][:n])
        live = py.alive
        np.testing.assert_array_equal(py.pos[live], st["pos"][:n][live])
        np.testing.assert_array_equal(py.reliable[live], st["reliable"][:n][live])
        assert len(py.evicted) == nat._lib.ms_evicted_count(nat._handle)
        _assert_same_window(py, nat)

    # the eviction queues agree (pop order and payload)
    for kf in py.evicted:
        kid, fid, T = nat.pop_evicted()
        assert kid == kf.keyframe_id and fid == kf.frame_id
        np.testing.assert_array_equal(T, np.asarray(kf.T_c_w, np.float32))
    assert nat.pop_evicted() is None
    nat.close()


def test_native_mapstore_write_back(rng):
    """BA write-back applies poses to live keyframes and verdicts to live
    rows identically in both stores."""
    from stereo_visual_slam_tpu_torch.mapping.store import MapStore

    cfg = _small_cfg()
    py = MapStore(cfg)
    nat = native.NativeMapStore(cfg)
    next_id = 0
    for step in range(12):
        next_id = _add_keyframe(rng, cfg, step, step, py, nat, next_id)

    _, kf_ids, sel = py.assemble_schedule_input()
    T_new = np.stack([_rand_pose(rng) for _ in range(len(kf_ids))])
    verdict = (rng.uniform(size=len(sel)) < 0.8).astype(np.float32)
    py.write_back_schedule(kf_ids, sel, T_new, verdict)
    nat.write_back_schedule(kf_ids, sel, T_new, verdict)
    st = nat.arena_state()
    np.testing.assert_array_equal(py.inlier, st["inlier"][:len(py.inlier)])
    _assert_same_window(py, nat)
    with pytest.raises(ValueError, match="write_back_schedule"):
        nat.write_back_schedule(kf_ids, sel, T_new[:1], verdict)


# ---------------------------------------------------------------------------
# The build, the library's place, and a cut run that exits
# ---------------------------------------------------------------------------


def _run(code, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *map(str, args)],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, timeout=SUBPROCESS_TIMEOUT_S):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        pytest.fail(f"{proc.args[:3]} did not exit within {timeout} s")
    assert proc.returncode == 0, err[-3000:]
    return out


def test_two_processes_build_into_an_empty_root_at_once(tmp_path):
    """Both wait for one build (the lock) and load a whole library; no
    temporary file is left behind."""
    code = """
        import sys
        from pathlib import Path
        from stereo_visual_slam_tpu_torch.utils import native
        native.BUILD_ROOT = Path(sys.argv[1])
        assert native.available(), native.load_error()
        print(native.library_path())
    """
    root = tmp_path / "build_root"
    procs = [_run(code, root) for _ in range(2)]
    paths = [_finish(p).strip() for p in procs]
    assert paths[0] == paths[1] and Path(paths[0]).parent.parent == root
    assert sorted(os.listdir(Path(paths[0]).parent)) == ["libslamio.so", "lock"]


def test_loaded_library_lies_under_build_native():
    """The port loads what it built under build/native/, never the JAX
    package's native/build/libslamio.so."""
    code = """
        from stereo_visual_slam_tpu_torch.utils import native
        assert native.available(), native.load_error()
        with open("/proc/self/maps") as f:
            print("\\n".join(sorted({l.split()[-1] for l in f if "libslamio" in l})))
    """
    loaded = _finish(_run(code)).split()
    assert loaded == [str(native.library_path())]
    assert Path(loaded[0]).is_relative_to(REPO / "build" / "native")
    assert not Path(loaded[0]).is_relative_to(REPO / "native" / "build")


def test_run_vslam_dataset_cut_by_frames_exits(tmp_path):
    """`run_vslam --dataset ... --frames 3` on a 16-frame sequence, longer
    than the prefetcher's depth of 8, so that workers wait on full slots
    when the run ends: the CLI closes its source and the process exits."""
    from PIL import Image

    from stereo_visual_slam_tpu_torch.data import synthetic
    from stereo_visual_slam_tpu_torch.utils import config_io

    cfg = _small_cfg()
    seq = tmp_path / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    (seq / "image_1").mkdir()
    world = synthetic.make_world(cfg, n_frames=16, n_points=800, seed=3)
    for f, left, right in synthetic.frames(world):
        Image.fromarray(left.astype(np.uint8)).save(seq / "image_0" / f"{f:06d}.png")
        Image.fromarray(right.astype(np.uint8)).save(seq / "image_1" / f"{f:06d}.png")
    params = tmp_path / "small.yaml"
    config_io.save_yaml(cfg, str(params))
    pose = tmp_path / "traj.txt"
    code = """
        import sys
        from stereo_visual_slam_tpu_torch import run_vslam
        sys.exit(run_vslam.main(sys.argv[1:]))
    """
    out = _finish(_run(code, "--dataset", tmp_path, "--sequence", "00", "--frames", "3",
                       "--device", "cpu", "--params", params, "--pose-out", pose, "--quiet"))
    assert "processed 3 frames" in out
    assert pose.exists()
