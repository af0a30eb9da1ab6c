"""stereo_visual_slam_tpu_torch — the PyTorch + CUDA port of the stereo
visual SLAM system in `stereo_visual_slam_tpu`.

The JAX package stays the reference: this package mirrors its layout and
names so every module's counterpart is easy to find, and its tests hold each
module against the JAX function on the same numpy inputs.

Layout:
  geom/         SE(3)/SO(3) and closed-form small inverses
  ops/          front-end ops (FAST, BRIEF, ANMS, stereo, matcher) in torch
  ops/kernels/  the hand-written CUDA kernels (csrc/*.cu) with their plain
                torch twins, launch counters and the nvcc/ctypes loader
  tracking/     batched PnP-RANSAC
  ba/           LM + Schur bundle adjustment, pose-only, the BA schedule
  models/       batched extractor, tracking step, the SLAM core
  pipeline/     ChunkedSlam (the production chunked pipeline), the
                host-sequenced VisualOdometry, snapshots, trajectory tools
                and the visualisation writers
  mapping/      the host-side keyframe/landmark map of the host driver
  data/         the synthetic world and the KITTI reader
  utils/        the config and its YAML load/save, the cost model
                (roofline.py)
  csrc/         CUDA C++ sources for sm_90a

The config, data sources, map store, trajectory tools and visualisation
writers are numpy-only copies of the JAX package's modules: the port
imports nothing of the JAX package (tests/test_torch_shared_copies.py
holds each copy equal to its original).

Numerics follow the reference's CPU oracle: fp32 everywhere, TF32 off.
"""

import torch

from stereo_visual_slam_tpu_torch.utils.config import Config  # noqa: F401

# The reference computes its geometry and BA at highest f32 precision; TF32
# (~3 decimal digits) would move poses by far more than the tests allow.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
