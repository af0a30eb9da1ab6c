"""The benchmark's plain reference: a frozen copy of the port's plain path
(stereo_visual_slam_tpu_torch at commit c627a7a) in plain torch, float32,
with every hand kernel replaced by its plain twin.

It imports nothing of the port and nothing of JAX. From the frames the
benchmark hands both sides it builds its own tables (BRIEF matrix, resize
weights), extracts its own features, works out its own depths and draws
its own PnP hypotheses from the seed. The SLAM state is the one thing it
reads from the program: slam_bench/compare.py steps each frame from the
state the program handed on (a free run parts from the program on rounding
at the 4 px inlier line), checks the hand-over between steps by itself,
and holds the first pass's trajectory to the world's ground truth.
`precision(tf32)` sets the matmul precision it runs in: TF32 off is the
configuration's precision, TF32 on is the control that has to come out
not correct.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Run the enclosed code with TF32 on or off for matmuls and
    convolutions, restoring the process's settings after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
