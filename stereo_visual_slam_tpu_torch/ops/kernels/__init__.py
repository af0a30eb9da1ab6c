"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel of
the JAX package, each with its plain torch twin in the same module.

Dispatch rule of every wrapper: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises — there is no fallback. Each kernel's
launch functions carry a plain-integer `launches` counter, which
`launch_counts` (their sum a kernel) / `reset_launch_counts` read and clear.
A CUDA graph that captures launches takes them off the counters
(`collect_launches`) and adds them back at every replay (`add_launches`,
utils/cuda_graph), so the counters read as they would eager.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict


def _launchers():
    from stereo_visual_slam_tpu_torch.ops.kernels import (
        fast_kernel, patch_kernel, pnp_kernel, stereo_kernel,
    )

    return {
        "fast_nms": (fast_kernel.fast_nms_cuda,),
        "gather_patches": (patch_kernel.gather_patches_cuda,
                           patch_kernel.gather_patches_levels_cuda),
        "zncc_sweep": (stereo_kernel.zncc_sweep_cuda,),
        "pnp_hypotheses": (pnp_kernel.pnp_hypotheses,),
        "pnp_refine": (pnp_kernel.pnp_refine,),
    }


def launch_counts() -> Dict[str, int]:
    return {name: sum(fn.launches for fn in fns) for name, fns in _launchers().items()}


def reset_launch_counts() -> None:
    for fns in _launchers().values():
        for fn in fns:
            fn.launches = 0


@contextlib.contextmanager
def collect_launches():
    """Launches inside the block leave the counters as they were; the dict
    yielded holds them (launch function -> launches) once the block ends."""
    fns = [fn for fns in _launchers().values() for fn in fns]
    before = [fn.launches for fn in fns]
    launched: Dict[Callable, int] = {}
    try:
        yield launched
    finally:
        for fn, n in zip(fns, before):
            if fn.launches != n:
                launched[fn] = fn.launches - n
            fn.launches = n


def add_launches(launched: Dict[Callable, int]) -> None:
    for fn, n in launched.items():
        fn.launches += n
