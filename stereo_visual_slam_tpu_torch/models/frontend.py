"""Feature extraction and stereo depth (port of models/frontend.py:
`make_extractor`, `make_batch_extractor` and `make_depth_stage`).

Per pyramid level the B frames are stacked vertically into one (B*H_i, W_i)
image for FAST+NMS, box blur and the patch gather (clamped per frame), as
in the reference; the pooled top-k, BRIEF and ANMS run batched. Depth comes
in one of two ways, as in the reference:
  * eagerly (`with_depth=True`): one ZNCC sweep over all B*N keypoints on
    the stacked full-resolution pair, the `frontend.lazy_depth=False`
    chunk path and the single-frame extractor of the host driver;
  * lazily (`with_depth=False` + `make_depth_stage`): the production chunk
    path computes it in the keyframe branch only; its values equal the
    eager ones.
The single-frame `make_extractor` is the batched one at B=1, which the
reference holds bit-identical to its own single-frame program.

The `pallas_fast` / `pallas_patches` / `pallas_stereo` config flags keep
their JAX meaning, "use the kernel": with a flag on, the op goes through the
kernel's wrapper (plain torch on CPU tensors, the CUDA kernel on CUDA
tensors); with it off, the plain version runs on any device. The patch
gather serves steered BRIEF too: the reason the reference keeps its kernel
off there (frontend.py:86-93) is the bf16 rounding of its one-hot gather,
which `orb.describe_patches` reproduces.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_visual_slam_tpu_torch.ops import anms as anms_ops
from stereo_visual_slam_tpu_torch.ops import fast as fast_ops
from stereo_visual_slam_tpu_torch.ops import image as im_ops
from stereo_visual_slam_tpu_torch.ops import orb as orb_ops
from stereo_visual_slam_tpu_torch.ops import stereo as stereo_ops
from stereo_visual_slam_tpu_torch.ops.kernels import fast_kernel, patch_kernel
from stereo_visual_slam_tpu_torch.utils.config import Config


class FrameFeatures(NamedTuple):
    """Fixed-size feature table of one frame, or of B frames with a leading
    B axis. N = config max_raw_keypoints."""

    yx: torch.Tensor           # (N, 2) f32 full-res keypoint coords (row, col)
    score: torch.Tensor        # (N,) FAST response at the detection level
    scale: torch.Tensor        # (N,) f32 scale_factor**level
    valid: torch.Tensor        # (N,) bool detected keypoint
    spawn_mask: torch.Tensor   # (N,) bool ANMS-selected subset
    signs: torch.Tensor        # (N, 256) {-1, +1} descriptor
    packed: torch.Tensor       # (N, 8) descriptor words (uint32 values in int64)
    disparity: torch.Tensor    # (N,) f32
    depth: torch.Tensor        # (N,) f32 camera-frame z
    depth_valid: torch.Tensor  # (N,) bool
    reliable: torch.Tensor     # (N,) bool z < reliable_depth
    pts_cam: torch.Tensor      # (N, 3) camera-frame 3D


def _level_geometry(config: Config):
    """Static per-level geometry: (scale, valid (h, w), padded (H, W),
    keypoint budget) — identical to the reference's, padding included."""
    fe = config.frontend
    vh, vw = config.image_hw
    sf = fe.scale_factor
    n = fe.n_levels
    inv = [sf ** -i for i in range(n)]
    total = sum(inv)
    budgets = [int(fe.max_raw_keypoints * w / total) for w in inv]
    budgets[0] += fe.max_raw_keypoints - sum(budgets)

    def pad_up(x, q):
        return -(-x // q) * q

    out = []
    for i in range(n):
        s = sf ** i
        h_i, w_i = (vh, vw) if i == 0 else (round(vh / s), round(vw / s))
        out.append((s, (h_i, w_i), (pad_up(h_i, 64), pad_up(w_i, 256)), budgets[i]))
    return out


def _depth_fields(config: Config, left, right, yx_int, yx_f, valid) -> dict:
    """The five FrameFeatures depth fields of keypoints yx_int (N, 2) on the
    (H, W) pair; yx_f (N, 2) are their float coords for back-projection."""
    fe = config.frontend
    cam = config.camera
    st = stereo_ops.match_disparity(
        left, right, yx_int, valid,
        fx=cam.fx, baseline=cam.baseline, max_disparity=fe.max_disparity,
        patch=fe.stereo_patch, min_zncc=fe.min_zncc,
        min_depth=fe.min_depth, max_depth=fe.max_depth,
        reliable_depth=fe.reliable_depth, use_kernel=fe.pallas_stereo,
    )
    pts_cam = stereo_ops.backproject(
        yx_f, st.depth, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy
    )
    return dict(
        disparity=st.disparity, depth=st.depth, depth_valid=st.valid,
        reliable=st.reliable, pts_cam=pts_cam,
    )


def make_batch_extractor(config: Config, device, with_depth: bool = True):
    """Build batch_extract(images (B, 2, H, W) uint8 or f32 on `device`) ->
    FrameFeatures with a leading B axis. `with_depth=False` zeroes the
    depth fields (the lazy-depth chunk path)."""
    fe = config.frontend
    vh, vw = config.image_hw
    levels = _level_geometry(config)
    border = fe.border_margin
    device = torch.device(device)
    steer = fe.steer_descriptor
    M = torch.from_numpy(
        orb_ops.brief_matrix_bf16(fe.descriptor_bits, fe.patch_size, steer)
    ).to(device)
    # resize weights per level, built once host-side (ops/image.resize_weights)
    resize = [
        None if i == 0 else im_ops.resize_matrices((vh, vw), hw, device)
        for i, (_, hw, _, _) in enumerate(levels)
    ]
    # border masks per level (static)
    in_border = []
    for _, (h_i, w_i), (H_i, W_i), _ in levels:
        yy = torch.arange(H_i, device=device)[:, None]
        xx = torch.arange(W_i, device=device)[None, :]
        in_border.append(
            (yy >= border) & (yy < h_i - border) & (xx >= border) & (xx < w_i - border)
        )

    def score_map(stacked):
        if fe.pallas_fast:
            return fast_kernel.fast_nms_score_map(stacked, fe.fast_threshold)
        return fast_kernel.fast_nms_plain(stacked, fe.fast_threshold)

    def gather(blurred, yx, frame_h):
        if fe.pallas_patches:
            return patch_kernel.gather_patches(blurred, yx, fe.patch_size, frame_h)
        return patch_kernel.gather_patches_plain(blurred, yx, fe.patch_size, frame_h)

    def batch_extract(images: torch.Tensor) -> FrameFeatures:
        B = images.shape[0]
        left = images[:, 0].float()                       # (B, H, W)
        yx_parts, yxf_parts, score_parts, scale_parts = [], [], [], []
        packed_parts, signs_parts = [], []
        for i, (s, (h_i, w_i), (H_i, W_i), budget) in enumerate(levels):
            if i == 0:
                imgs = left
            else:
                imgs = im_ops.pad_to(
                    im_ops.resize_linear(left[:, :vh, :vw], resize[i]), (H_i, W_i)
                )
            stacked = imgs.reshape(B * H_i, W_i).contiguous()
            score = score_map(stacked).reshape(B, H_i, W_i)
            score = torch.where(in_border[i], score, 0.0)
            top_scores, yx_i = fast_ops.nms_topk(score, budget)   # (B, n, 2)

            blurred = im_ops.box_blur(stacked, fe.blur_box)
            row_off = (torch.arange(B, device=device, dtype=torch.int32) * H_i)[:, None]
            yx_st = torch.stack([yx_i[..., 0] + row_off, yx_i[..., 1]], dim=-1)
            patches = gather(blurred, yx_st.reshape(B * budget, 2).contiguous(), H_i)
            packed_i, signs_i = orb_ops.describe_patches(patches, M, steer)

            yx_full = yx_i.float() * s
            yx_parts.append(torch.round(yx_full).to(torch.int32))
            yxf_parts.append(yx_full)
            score_parts.append(top_scores)
            scale_parts.append(torch.full((B, budget), s, dtype=torch.float32, device=device))
            packed_parts.append(packed_i.reshape(B, budget, -1))
            signs_parts.append(signs_i.reshape(B, budget, -1))

        yx_int = torch.cat(yx_parts, dim=1)
        yx_f = torch.cat(yxf_parts, dim=1)
        score = torch.cat(score_parts, dim=1)
        valid = (score > 0.0) & (yx_int[..., 0] < vh) & (yx_int[..., 1] < vw)
        spawn_mask = anms_ops.anms_mask(
            yx_int, score, num=fe.n_features, robust_coeff=fe.anms_robust_coeff
        )
        N = yx_int.shape[1]
        if with_depth:
            # one sweep over all frames' keypoints on the stacked full-res
            # pair; frame b's rows are offset by b * H0
            H0, W0 = left.shape[1:]
            row_off = (torch.arange(B, device=device, dtype=torch.int32) * H0)[:, None]
            yx_st = torch.stack([yx_int[..., 0] + row_off, yx_int[..., 1]], dim=-1)
            depth = _depth_fields(
                config, left.reshape(B * H0, W0),
                images[:, 1].float().reshape(B * H0, W0),
                yx_st.reshape(B * N, 2).contiguous(), yx_f.reshape(B * N, 2),
                valid.reshape(B * N),
            )
            depth = {k: v.reshape(B, N, *v.shape[1:]) for k, v in depth.items()}
        else:
            zero = torch.zeros((B, N), dtype=torch.float32, device=device)
            no = torch.zeros((B, N), dtype=torch.bool, device=device)
            depth = dict(
                disparity=zero, depth=zero, depth_valid=no, reliable=no,
                pts_cam=torch.zeros((B, N, 3), dtype=torch.float32, device=device),
            )
        return FrameFeatures(
            yx=yx_f, score=score, scale=torch.cat(scale_parts, dim=1),
            valid=valid, spawn_mask=spawn_mask,
            signs=torch.cat(signs_parts, dim=1),
            packed=torch.cat(packed_parts, dim=1), **depth,
        )

    return batch_extract


def make_extractor(config: Config, device):
    """Build extract(images (2, H, W) uint8 or f32 on `device`) ->
    FrameFeatures of one frame, depth included: the batched extractor at
    B=1, so the ZNCC sweep runs once per frame on the merged N-row table."""
    batch_extract = make_batch_extractor(config, device, with_depth=True)

    def extract(images: torch.Tensor) -> FrameFeatures:
        return FrameFeatures(*[f[0] for f in batch_extract(images[None])])

    return extract


def make_depth_stage(config: Config):
    """depth_stage(image (2, H, W), feats of one frame) -> dict of the five
    FrameFeatures depth fields, from the keypoints' rounded coords."""

    def depth_stage(image: torch.Tensor, feats: FrameFeatures) -> dict:
        yx_int = torch.round(feats.yx).to(torch.int32).contiguous()
        return _depth_fields(
            config, image[0].float().contiguous(), image[1].float().contiguous(),
            yx_int, feats.yx, feats.valid,
        )

    return depth_stage
