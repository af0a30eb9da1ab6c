"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel of
the JAX package, each with its plain torch twin in the same module.

Dispatch rule of every wrapper: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises — there is no fallback. Each kernel's
launch functions carry a plain-integer `launches` counter, which
`launch_counts` (their sum a kernel) / `reset_launch_counts` read and clear.
"""

from __future__ import annotations

from typing import Dict


def _launchers():
    from stereo_visual_slam_tpu_torch.ops.kernels import (
        fast_kernel, patch_kernel, stereo_kernel,
    )

    return {
        "fast_nms": (fast_kernel.fast_nms_cuda,),
        "gather_patches": (patch_kernel.gather_patches_cuda,
                           patch_kernel.gather_patches_levels_cuda),
        "zncc_sweep": (stereo_kernel.zncc_sweep_cuda,),
    }


def launch_counts() -> Dict[str, int]:
    return {name: sum(fn.launches for fn in fns) for name, fns in _launchers().items()}


def reset_launch_counts() -> None:
    for fns in _launchers().values():
        for fn in fns:
            fn.launches = 0
