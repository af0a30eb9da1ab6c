"""Build and load the CUDA kernels: nvcc -> one shared library with a plain
C interface, loaded with ctypes.

The library is built at first use from `csrc/*.cu` into
`build/kernels/<hash of the sources>/` next to the package (listed in
.gitignore), so a fresh checkout builds it on its first kernel call and an
edited source gets a new library. Nothing is imported or compiled when this
module is imported: the CPU tests import every module.

Every function takes the source directory, `csrc/` by default: another
directory of sources with the same C entry points (an earlier version of
the kernels) builds into a library of its own, so that `measure.py` can
time two versions in one process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
# flags of one source: pnp_ransac.cu rounds every product and sum alone, as
# the tensor ops of the plain path it replaces round them, and writes fmaf
# where those ops fuse
SOURCE_FLAGS = {"pnp_ransac.cu": ["-fmad=false"]}

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_i64s, _c_ints = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)
# C entry points and their argument types; each returns cudaGetLastError()
SIGNATURES = {
    "svs_fast_nms": [_c_ptr, _c_ptr, _c_int, _c_int, _c_float, _c_ptr],
    "svs_gather_patches": [_c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int,
                           _c_int, _c_int, _c_ptr],
    # host arrays: the levels' image and keypoint pointers, their dims
    "svs_gather_patches_levels": [_c_i64s, _c_i64s, _c_ints, _c_int, _c_ptr, _c_int,
                                  _c_ptr],
    "svs_zncc_sweep": [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int,
                       _c_int, _c_int, _c_int, _c_ptr],
    "svs_pnp_hypotheses": [_c_ptr] * 10 + [_c_int] * 4 + [_c_float, _c_ptr, _c_ptr, _c_ptr,
                                                         _c_ptr],
    "svs_pnp_refine": [_c_ptr] * 7 + [_c_int] * 3 + [_c_float, _c_float] + [_c_ptr] * 5,
}

_libs: Dict[Path, ctypes.CDLL] = {}


def _sources(src_dir: Path):
    return sorted(src_dir.glob("*.cu")) + sorted(src_dir.glob("*.cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(src_dir: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for src in _sources(src_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libsvs_kernels.so"


def build(src_dir: Path = CSRC) -> Path:
    """Compile the kernels of src_dir unless the library for these sources
    exists: one nvcc per source, all started together, then one link."""
    src_dir = Path(src_dir).resolve()
    out = library_path(src_dir)
    if out.exists():
        return out
    cus = [s for s in _sources(src_dir) if s.suffix == ".cu"]
    if not cus:
        raise FileNotFoundError(f"no CUDA sources in {src_dir}")
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        jobs = []
        for src in cus:
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, []), "-I", str(src_dir),
                   "-c", "-o", obj, str(src)]
            jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        logs = [(obj, proc.communicate()[0], proc.returncode) for obj, proc in jobs]
        failed = [f"{obj} ({rc}):\n{log}" for obj, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, out.name)
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                               *[obj for obj, _, _ in logs]],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(lib, out)  # atomic: a concurrent build sees all or nothing
    return out


def library(src_dir: Path = CSRC) -> ctypes.CDLL:
    """The loaded kernel library of src_dir (built on first call), with the
    argument types of each entry point it defines. Every kernel launch
    calls this: after the first call it is one dictionary lookup."""
    lib = _libs.get(src_dir)
    if lib is None:
        lib = ctypes.CDLL(str(build(src_dir)))
        for name, argtypes in SIGNATURES.items():
            if hasattr(lib, name):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[src_dir] = lib
    return lib


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the raw cudaStream_t."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def require_type(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless t has dtype and rank ndim, on any device."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype and rank ndim."""
    require_type(t, name, dtype, ndim)
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
