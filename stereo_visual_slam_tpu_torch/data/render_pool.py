"""Synthetic frames rendered ahead on a pool of worker processes.

`synthetic.render_frame` is plain numpy and takes 0.3-0.8 s a frame at
KITTI size on one core, longer than the card takes to process one; the
bench and the soak render on a `Renderer`'s `workers` processes while the
caller consumes frames in order. The pool starts once and serves every
world it is given: a spawned worker imports torch with the package, which
takes seconds, so a run that renders several worlds shares one pool. Each
world goes to the workers as one file in a private temporary directory,
read once by each worker. At most `depth` frames wait rendered, so memory
stays bounded however far the renderer could run ahead. Frames come out as
uint8, the cast both drivers apply on upload, so a run on them equals a run
on `synthetic.frames(world)`; the result does not depend on `workers` (0
renders in the calling process).
"""

from __future__ import annotations

import collections
import multiprocessing
import os
import pickle
import shutil
import tempfile
from typing import Iterator, Tuple

import numpy as np

from stereo_visual_slam_tpu_torch.data import synthetic

Frame = Tuple[int, np.ndarray, np.ndarray]

# a worker's world: (path of the file it came from, the world)
_world = (None, None)


def default_workers() -> int:
    """One process per CPU but one, which feeds the card."""
    return max(1, (os.cpu_count() or 2) - 1)


def _render(world, f: int) -> Tuple[np.ndarray, np.ndarray]:
    left, right = synthetic.render_frame(world, f)
    return left.astype(np.uint8), right.astype(np.uint8)


def _render_in_worker(path: str, f: int) -> Tuple[np.ndarray, np.ndarray]:
    global _world
    if _world[0] != path:
        with open(path, "rb") as fh:
            _world = (path, pickle.load(fh))
    return _render(_world[1], f)


class Renderer:
    """Renders the frames of any number of worlds on `workers` spawned
    processes (default: one per CPU but one; 0: in the calling process).
    The pool starts at the first world; `close` (or leaving a `with`
    block) stops it."""

    def __init__(self, workers: int | None = None):
        self.workers = default_workers() if workers is None else workers
        self._pool = None
        self._dir = None
        self._n_worlds = 0

    def frames(self, world, n_frames: int | None = None, *, depth: int = 32
               ) -> Iterator[Frame]:
        """(frame_id, left, right) uint8 for frames 0..n_frames-1 of
        `world`, in order."""
        n = world.poses_T_c_w.shape[0] if n_frames is None else n_frames
        if self.workers <= 0:
            for f in range(n):
                yield (f, *_render(world, f))
            return
        if self._pool is None:
            self._dir = tempfile.mkdtemp(prefix="render_pool_")
            self._pool = multiprocessing.get_context("spawn").Pool(self.workers)
        self._n_worlds += 1
        path = os.path.join(self._dir, f"world{self._n_worlds}.pkl")
        with open(path, "wb") as fh:
            pickle.dump(world, fh, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            pending = collections.deque()
            for f in range(n):
                while len(pending) < depth and f + len(pending) < n:
                    pending.append(self._pool.apply_async(_render_in_worker,
                                                          (path, f + len(pending))))
                yield (f, *pending.popleft().get())
        finally:
            os.remove(path)   # frames still queued after an early stop fail unread

    def render_all(self, world, n_frames: int | None = None) -> list:
        """Every frame at once (a pre-rendered sequence)."""
        return list(self.frames(world, n_frames, depth=64))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            shutil.rmtree(self._dir, ignore_errors=True)
            self._pool = self._dir = None

    def __enter__(self) -> "Renderer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
