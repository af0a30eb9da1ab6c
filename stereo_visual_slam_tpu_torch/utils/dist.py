"""Process-group plumbing for the landmark-sharded BA (port of
utils/dist.py).

The JAX package runs one SPMD program over the `lm` axis of a device mesh.
The port runs one process per rank: every rank runs the same host loop on
the same frames, owns the contiguous arena rows [r*L/n, (r+1)*L/n), and
each `psum` of the JAX program becomes one `all_reduce(SUM)` over the
mesh's group. Poses, the tracker state and the map stay replicated.

Environment contract (torchrun's): RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT, or the same values as arguments. Importing
this module initialises nothing.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

# a rank whose peers stopped calling collectives (a divergence, a crash)
# fails after this long instead of hanging
TIMEOUT_S = 300.0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def initialize_distributed(
    master_addr: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    *,
    device,
    master_port: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Idempotent `init_process_group`; arguments override the environment.
    `device` has no default, as in ChunkedSlam. The backend is nccl for a
    CUDA `device` and gloo for the CPU unless `backend` names one. One rank
    with no address gets an in-process store. Returns True when this call
    created the group."""
    if dist.is_initialized():
        return False
    env = os.environ
    world_size = int(world_size if world_size is not None else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    addr = master_addr or env.get("MASTER_ADDR")
    port = master_port or env.get("MASTER_PORT")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = dict(backend=backend, world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=TIMEOUT_S))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kw["device_id"] = device  # NCCL starts now: a failed init raises here
    if addr is None and world_size == 1:
        kw["store"] = dist.HashStore()
    elif addr is None or port is None:
        raise ValueError(f"initialize_distributed: {world_size} ranks need MASTER_ADDR "
                         "and MASTER_PORT (or master_addr / master_port)")
    else:
        kw["init_method"] = f"tcp://{addr}:{port}"
    dist.init_process_group(**kw)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class LandmarkMesh(NamedTuple):
    """The landmark axis over the first `size` ranks of the process group;
    this process is mesh rank `rank`."""

    group: object  # torch.distributed.ProcessGroup
    rank: int
    size: int

    def rows(self, L: int) -> slice:
        """This rank's contiguous rows of an L-row landmark axis."""
        if L % self.size:
            raise ValueError(f"{L} landmark rows do not divide over a mesh of {self.size}")
        n = L // self.size
        return slice(self.rank * n, (self.rank + 1) * n)

    def shard(self, tup, fields: Sequence[str]):
        """`tup` (a NamedTuple) with each named field cut to this rank's rows."""
        return tup._replace(**{f: getattr(tup, f)[self.rows(getattr(tup, f).shape[0])]
                               for f in fields})

    def all_reduce(self, *ts: torch.Tensor):
        """Each tensor summed over the mesh, in one collective. The results
        keep their inputs' strides, so that what follows reads the same
        layout as without a mesh."""
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=self.group)
        out, i = [], 0
        for t in ts:
            o = torch.empty_like(t)
            o.copy_(flat[i:i + t.numel()].view(t.shape))
            out.append(o)
            i += t.numel()
        return out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Mesh rank 0's value of `t` on every rank."""
        t = t.contiguous()
        dist.broadcast(t, src=0, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0, in rank order."""
        x = t.contiguous()
        if x.dtype == torch.bool:
            return self.all_gather(x.view(torch.uint8)).view(torch.bool)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts)


def make_landmark_mesh(n_ranks: int = 0) -> Optional[LandmarkMesh]:
    """The landmark mesh over the first n ranks (default: all) of the
    initialised group. Every rank of the group must call it; a rank beyond
    the first n gets None."""
    world = dist.get_world_size()
    n = n_ranks or world
    if n > world:
        raise ValueError(f"need {n} devices, have {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return LandmarkMesh(group=group, rank=rank, size=n)
