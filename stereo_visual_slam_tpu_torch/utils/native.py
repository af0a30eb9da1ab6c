"""ctypes bindings for the port's native host runtime (port of
stereo_visual_slam_tpu/utils/native.py, with the same public names).

`libslamio` provides PNG/PGM decode to 8-bit gray, a multithreaded
prefetching stereo-frame loader (bounded ring, in-order delivery), the KITTI
trajectory writer and the arena map store. It is built from the port's copy
of the runtime, `csrc/host/slamio.cpp`, and the repo's
`native/src/mapstore.cpp`, with native/Makefile's flags, into
`build/native/<hash of sources and flags>/libslamio.so` at first use. Its
PNG decoder needs zlib only, no libpng, and reads every PNG kind (colour
type, bit depth, Adam7, gAMA / cHRM / sRGB) byte-equal to what the
original's libpng calls give. A build holds an `flock` on a lock file in
that directory and moves a finished library into place with `os.replace`,
so processes that start at once wait for one build and never load a
half-written file. Nothing is built when this module is imported.

`available()` is False when the build or the load fails, and callers take
their pure-Python paths; `load_error()` says why.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO_ROOT = PACKAGE_DIR.parent
SOURCES = (
    PACKAGE_DIR / "csrc" / "host" / "slamio.cpp",
    REPO_ROOT / "native" / "src" / "mapstore.cpp",
)
CXX = "g++"
CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Werror", "-fPIC", "-fvisibility=hidden", "-pthread")
LDLIBS = ("-lz", "-pthread")
BUILD_ROOT = REPO_ROOT / "build" / "native"
BUILD_TIMEOUT_S = 300

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int)


def library_path(sources: Sequence[Path] = SOURCES, ldlibs: Sequence[str] = LDLIBS) -> Path:
    """Where the library of these sources, built with these flags, lies."""
    h = hashlib.sha256()
    for src in sources:
        h.update(Path(src).name.encode())
        h.update(Path(src).read_bytes())
    h.update(" ".join([CXX, *CXXFLAGS, *ldlibs]).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libslamio.so"


def build(sources: Sequence[Path] = SOURCES, ldlibs: Sequence[str] = LDLIBS) -> Path:
    """Compile the sources into one shared library unless it exists. Raises
    RuntimeError with the compiler's output when the compiler fails."""
    out = library_path(sources, ldlibs)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if out.exists():                   # another process built it meanwhile
            return out
        fd, tmp = tempfile.mkstemp(prefix=".libslamio-", suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            proc = subprocess.run(
                [CXX, *CXXFLAGS, "-shared", "-o", tmp, *map(str, sources), *ldlibs],
                capture_output=True, text=True, timeout=BUILD_TIMEOUT_S,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"{CXX} failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sio_version.restype = ctypes.c_int
    lib.sio_last_error.restype = ctypes.c_char_p
    lib.sio_probe_image.argtypes = [ctypes.c_char_p, _i32p, _i32p]
    lib.sio_probe_image.restype = ctypes.c_int
    lib.sio_read_image_gray.argtypes = [
        ctypes.c_char_p, _u8p, _i32p, _i32p, ctypes.c_int, ctypes.c_int,
    ]
    lib.sio_read_image_gray.restype = ctypes.c_int
    lib.sio_prefetch_open.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.sio_prefetch_open.restype = ctypes.c_void_p
    lib.sio_prefetch_next.argtypes = [ctypes.c_void_p, _u8p, _u8p]
    lib.sio_prefetch_next.restype = ctypes.c_int
    lib.sio_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.sio_prefetch_close.restype = None
    lib.sio_traj_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.sio_traj_open.restype = ctypes.c_void_p
    lib.sio_traj_write.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.POINTER(ctypes.c_double),
    ]
    lib.sio_traj_write.restype = ctypes.c_int
    lib.sio_traj_flush.argtypes = [ctypes.c_void_p]
    lib.sio_traj_flush.restype = ctypes.c_int
    lib.sio_traj_close.argtypes = [ctypes.c_void_p]
    lib.sio_traj_close.restype = None

    # --- mapstore (native/src/mapstore.cpp) ---
    _f32p = ctypes.POINTER(ctypes.c_float)
    _i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ms_create.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_int,
    ]
    lib.ms_create.restype = ctypes.c_void_p
    lib.ms_destroy.argtypes = [ctypes.c_void_p]
    lib.ms_destroy.restype = None
    lib.ms_spawn.argtypes = [ctypes.c_void_p, ctypes.c_int32, _i64p, _f32p, _u8p]
    lib.ms_spawn.restype = ctypes.c_int
    lib.ms_rows_of.argtypes = [ctypes.c_void_p, ctypes.c_int32, _i64p, _i32p]
    lib.ms_rows_of.restype = None
    lib.ms_upgrade.argtypes = [ctypes.c_void_p, ctypes.c_int32, _i32p, _f32p]
    lib.ms_upgrade.restype = None
    lib.ms_insert_keyframe.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, _f32p, _i32p, _f32p, _u8p,
    ]
    lib.ms_insert_keyframe.restype = ctypes.c_int
    lib.ms_n_keyframes.argtypes = [ctypes.c_void_p]
    lib.ms_n_keyframes.restype = ctypes.c_int32
    lib.ms_n_landmarks.argtypes = [ctypes.c_void_p]
    lib.ms_n_landmarks.restype = ctypes.c_int32
    lib.ms_evicted_count.argtypes = [ctypes.c_void_p]
    lib.ms_evicted_count.restype = ctypes.c_int32
    lib.ms_pop_evicted.argtypes = [ctypes.c_void_p, _i64p, _i64p, _f32p]
    lib.ms_pop_evicted.restype = ctypes.c_int
    lib.ms_assemble.argtypes = [
        ctypes.c_void_p, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p, _f32p,
        _f32p, _f32p, _i64p, _i32p,
    ]
    lib.ms_assemble.restype = ctypes.c_int32
    lib.ms_write_back.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, _i64p, _f32p, ctypes.c_int32, _i32p, _f32p,
    ]
    lib.ms_write_back.restype = None
    lib.ms_arena_state.argtypes = [ctypes.c_void_p, _f32p, _u8p, _u8p, _i32p, _i64p, _u8p]
    lib.ms_arena_state.restype = None
    return lib


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    with _lib_lock:
        if _lib is None and _load_error is None:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _load_error = f"{type(e).__name__}: {e}"
        return _lib


def available() -> bool:
    return _try_load() is not None


def load_error() -> Optional[str]:
    """Why the library could not be built or loaded (None when it loads)."""
    _try_load()
    return _load_error


def _require() -> ctypes.CDLL:
    lib = _try_load()
    if lib is None:
        raise RuntimeError(f"native slamio unavailable: {_load_error}")
    return lib


def _last_error(lib) -> str:
    return lib.sio_last_error().decode(errors="replace")


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32(a):
    return a.ctypes.data_as(_i32p)


def _u8(a):
    return a.ctypes.data_as(_u8p)


def probe_image(path: str) -> Tuple[int, int]:
    """(h, w) from the image's header, without decoding it (a kind the
    decoder refuses raises here already)."""
    lib = _require()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.sio_probe_image(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"cannot decode image: {_last_error(lib)}")
    return h.value, w.value


def read_image_gray(path: str) -> np.ndarray:
    """Decode a PNG of any kind, or a binary PGM, to 8-bit gray via the
    native library (once: the probe that sizes the buffer reads the header
    only)."""
    lib = _require()
    h, w = probe_image(path)
    buf = np.empty((h, w), dtype=np.uint8)
    hh = ctypes.c_int()
    ww = ctypes.c_int()
    rc = lib.sio_read_image_gray(
        path.encode(), _u8(buf), ctypes.byref(hh), ctypes.byref(ww), h, w,
    )
    if rc == -1:
        raise IOError(f"decode failed: {_last_error(lib)}")
    if rc != 0:
        raise IOError(f"decode failed ({rc}): {path} changed size after the probe")
    return buf


class StereoPrefetcher:
    """In-order stereo frame stream decoded by a native worker pool.

    Iterating yields (frame_index, left_u8[h,w], right_u8[h,w]). Decoding of
    frame i+1..i+depth overlaps the consumer's device compute on frame i —
    the async-IO replacement for the reference's synchronous imread inside
    the hot loop (run_vslam.cpp:40-44). `close` joins the workers.
    """

    def __init__(
        self,
        left_dir: str,
        right_dir: str,
        count: int,
        hw: Tuple[int, int],
        start: int = 0,
        ext: str = ".png",
        depth: int = 8,
        workers: int = 4,
    ):
        lib = _require()
        self._lib = lib
        self._h, self._w = int(hw[0]), int(hw[1])
        self._count = int(count)
        self._handle = lib.sio_prefetch_open(
            left_dir.encode(), right_dir.encode(), ext.encode(),
            int(start), self._count, self._h, self._w, int(depth), int(workers),
        )
        if not self._handle:
            raise RuntimeError("sio_prefetch_open failed")

    def __iter__(self):
        left = np.empty((self._h, self._w), dtype=np.uint8)
        right = np.empty((self._h, self._w), dtype=np.uint8)
        while True:
            rc = self._lib.sio_prefetch_next(self._handle, _u8(left), _u8(right))
            if rc == -1:
                return
            if rc == -2:
                raise IOError(f"frame decode failed in prefetcher: {_last_error(self._lib)}")
            yield rc, left.copy(), right.copy()

    def close(self):
        if self._handle:
            self._lib.sio_prefetch_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTrajectoryWriter:
    """KITTI trajectory writer backed by libslamio; row format identical to
    pipeline.trajectory.TrajectoryWriter (and to the reference's
    Map::write_pose, map.cpp:188-195)."""

    def __init__(self, path: str, append: bool = False):
        lib = _require()
        self._lib = lib
        self._handle = lib.sio_traj_open(path.encode(), 1 if append else 0)
        if not self._handle:
            raise IOError(f"cannot open {path}")
        self.path = path

    def write(self, frame_id: int, T_c_w: np.ndarray):
        T = np.ascontiguousarray(T_c_w, dtype=np.float64)
        if T.shape != (4, 4):
            raise ValueError(f"expected a 4x4 pose, got shape {T.shape}")
        rc = self._lib.sio_traj_write(
            self._handle, int(frame_id), T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if rc != 0:
            raise IOError("trajectory write failed")

    def flush(self):
        self._lib.sio_traj_flush(self._handle)

    def close(self):
        if self._handle:
            self._lib.sio_traj_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeMapStore:
    """The native C++ arena map store (native/src/mapstore.cpp) behind the
    same interface as mapping.store.MapStore (the Python oracle;
    tests/test_torch_native.py asserts bit-for-bit equivalence).

    Mirrors the reference's native Map (map.hpp:15-81): observation-counted
    landmark GC, distance-rule keyframe eviction, and the dense (L, K)
    window assembly consumed by the device BA schedule.
    """

    ARENA_CAP = 1 << 15

    def __init__(self, config):
        lib = _require()
        self._lib = lib
        self.config = config
        self._handle = lib.ms_create(
            self.ARENA_CAP,
            int(config.keyframe.window_size),
            int(config.ba.max_landmarks),
            int(config.frontend.max_raw_keypoints),
            float(config.keyframe.eviction_min_dist),
            1 if config.ba.fix_oldest_pose else 0,
        )
        if not self._handle:
            raise RuntimeError("ms_create failed")

    # ------------------------------------------------------------ landmarks
    def spawn(self, ids: np.ndarray, pos: np.ndarray, reliable: np.ndarray):
        ids = np.ascontiguousarray(ids, np.int64)
        if len(ids) == 0:
            return
        pos = np.ascontiguousarray(pos, np.float32)
        rel = np.ascontiguousarray(reliable, np.uint8)
        if pos.shape != (len(ids), 3) or rel.shape != (len(ids),):
            raise ValueError(f"spawn: {len(ids)} ids, positions {pos.shape}, flags {rel.shape}")
        rc = self._lib.ms_spawn(self._handle, len(ids), _i64(ids), _f32(pos), _u8(rel))
        if rc != 0:
            raise RuntimeError("landmark arena exhausted")

    def rows_of(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty(len(ids), np.int32)
        if len(ids):
            self._lib.ms_rows_of(self._handle, len(ids), _i64(ids), _i32(out))
        return out

    def upgrade(self, rows: np.ndarray, pos: np.ndarray):
        rows = np.ascontiguousarray(rows, np.int32)
        if len(rows) == 0:
            return
        pos = np.ascontiguousarray(pos, np.float32)
        if pos.shape != (len(rows), 3):
            raise ValueError(f"upgrade: {len(rows)} rows, positions {pos.shape}")
        self._lib.ms_upgrade(self._handle, len(rows), _i32(rows), _f32(pos))

    # ------------------------------------------------------------ keyframes
    def insert_keyframe(self, kf):
        """Accepts a mapping.store.Keyframe."""
        n = int(self.config.frontend.max_raw_keypoints)
        T = np.ascontiguousarray(kf.T_c_w, np.float32)
        rows = np.ascontiguousarray(kf.rows, np.int32)
        uv = np.ascontiguousarray(kf.uv, np.float32)
        valid = np.ascontiguousarray(kf.valid, np.uint8)
        if T.shape != (4, 4) or rows.shape != (n,) or uv.shape != (n, 2) or valid.shape != (n,):
            raise ValueError(f"insert_keyframe: expected {n} keypoint slots")
        self._lib.ms_insert_keyframe(
            self._handle, int(kf.keyframe_id), int(kf.frame_id), _f32(T),
            _i32(rows), _f32(uv), _u8(valid),
        )

    def pop_evicted(self):
        """(keyframe_id, frame_id, T_c_w) of the oldest evicted keyframe, or
        None."""
        kid = ctypes.c_int64()
        fid = ctypes.c_int64()
        T = np.empty((4, 4), np.float32)
        rc = self._lib.ms_pop_evicted(self._handle, ctypes.byref(kid), ctypes.byref(fid), _f32(T))
        if rc == 0:
            return None
        return int(kid.value), int(fid.value), T

    # ------------------------------------------------------------- queries
    def n_keyframes(self) -> int:
        return int(self._lib.ms_n_keyframes(self._handle))

    def n_landmarks(self) -> int:
        return int(self._lib.ms_n_landmarks(self._handle))

    def arena_state(self):
        """Full arena readout (oracle-equivalence tests)."""
        cap = self.ARENA_CAP
        pos = np.empty((cap, 3), np.float32)
        reliable = np.empty(cap, np.uint8)
        inlier = np.empty(cap, np.uint8)
        obs_count = np.empty(cap, np.int32)
        row_id = np.empty(cap, np.int64)
        alive = np.empty(cap, np.uint8)
        self._lib.ms_arena_state(
            self._handle, _f32(pos), _u8(reliable), _u8(inlier),
            _i32(obs_count), _i64(row_id), _u8(alive),
        )
        return dict(
            pos=pos, reliable=reliable.astype(bool), inlier=inlier.astype(bool),
            obs_count=obs_count, row_id=row_id, alive=alive.astype(bool),
        )

    # --------------------------------------------------------------- BA I/O
    def assemble_schedule_input(self):
        cfg = self.config
        Kw = cfg.keyframe.window_size
        L = cfg.ba.max_landmarks
        T = np.empty((Kw, 4, 4), np.float32)
        uv = np.empty((L, Kw, 2), np.float32)
        obs = np.empty((L, Kw), np.float32)
        pose_mask = np.empty((Kw,), np.float32)
        fixed = np.empty((Kw,), np.float32)
        pts = np.empty((L, 3), np.float32)
        inlier = np.empty((L,), np.float32)
        reliable = np.empty((L,), np.float32)
        present = np.empty((L,), np.float32)
        kf_ids = np.empty((Kw,), np.int64)
        sel = np.empty((L,), np.int32)
        nK = self._lib.ms_assemble(
            self._handle, _f32(T), _f32(uv), _f32(obs), _f32(pose_mask),
            _f32(fixed), _f32(pts), _f32(inlier), _f32(reliable),
            _f32(present), _i64(kf_ids), _i32(sel),
        )
        if nK <= 0:
            return None
        arrays = dict(
            T_c_w=T, points=pts, uv=uv, obs_mask=obs, inlier=inlier,
            reliable=reliable, present=present, pose_mask=pose_mask, fixed_pose=fixed,
        )
        n_sel = int((sel >= 0).sum())
        return arrays, kf_ids[:nK], sel[:n_sel]

    def write_back_schedule(self, kf_ids, rows, T_c_w, inlier):
        kf_ids = np.ascontiguousarray(kf_ids, np.int64)
        rows = np.ascontiguousarray(rows, np.int32)
        T = np.ascontiguousarray(T_c_w[: len(kf_ids)], np.float32)
        inl = np.ascontiguousarray(inlier[: len(rows)], np.float32)
        if T.shape != (len(kf_ids), 4, 4) or inl.shape != (len(rows),):
            raise ValueError(f"write_back_schedule: {len(kf_ids)} keyframes, poses {T.shape}, "
                             f"{len(rows)} rows, verdicts {inl.shape}")
        self._lib.ms_write_back(
            self._handle, len(kf_ids), _i64(kf_ids), _f32(T), len(rows), _i32(rows), _f32(inl),
        )

    def close(self):
        if self._handle:
            self._lib.ms_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
