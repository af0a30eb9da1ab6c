"""Feature extraction and stereo depth (port of models/frontend.py:
`make_extractor`, `make_batch_extractor` and `make_depth_stage`).

Per pyramid level the B frames are stacked vertically into one (B*H_i, W_i)
image for FAST+NMS, box blur and the patch gather (clamped per frame), as
in the reference; the pooled top-k, BRIEF and ANMS run batched, and one
patch gather serves every level (`ExtractStages.describe_levels`: one
launch of the kernel a call, where the reference calls it per level).
Depth comes in one of two ways, as in the reference:
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
from stereo_visual_slam_tpu_torch.utils import trace
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


def stereo_match(config: Config, left, right, yx_int, valid) -> stereo_ops.StereoResult:
    """The ZNCC disparity search (through the K3 wrapper when
    `frontend.pallas_stereo`) of keypoints yx_int (N, 2) on the (H, W) pair,
    with the config's gates."""
    fe = config.frontend
    cam = config.camera
    return stereo_ops.match_disparity(
        left, right, yx_int, valid,
        fx=cam.fx, baseline=cam.baseline, max_disparity=fe.max_disparity,
        patch=fe.stereo_patch, min_zncc=fe.min_zncc,
        min_depth=fe.min_depth, max_depth=fe.max_depth,
        reliable_depth=fe.reliable_depth, use_kernel=fe.pallas_stereo,
    )


def _depth_fields(config: Config, left, right, yx_int, yx_f, valid) -> dict:
    """The five FrameFeatures depth fields of keypoints yx_int (N, 2) on the
    (H, W) pair; yx_f (N, 2) are their float coords for back-projection."""
    cam = config.camera
    st = stereo_match(config, left, right, yx_int, valid)
    pts_cam = stereo_ops.backproject(
        yx_f, st.depth, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy
    )
    return dict(
        disparity=st.disparity, depth=st.depth, depth_valid=st.valid,
        reliable=st.reliable, pts_cam=pts_cam,
    )


class ExtractStages:
    """The batched extractor's stages, each the very call `batch_extract`
    makes, over its per-level geometry, resize weights, border masks and
    BRIEF matrix (built once on `device`). The profilers time them one
    stage at a time (profiling/production.py).

    Per level i: `level_image` (the pyramid), `detect` (`score_map`:
    FAST+NMS and the border; `topk`: the pooled top-k), `blur`; then
    `describe_levels` (one patch gather over every level, BRIEF per level;
    `describe` is one level's); then `merge`: `table` concatenates the
    levels and runs `anms`, `depth`, eagerly, the stereo search, and
    `features` assembles the FrameFeatures."""

    def __init__(self, config: Config, device):
        fe = config.frontend
        vh, vw = config.image_hw
        self.config = config
        self.device = device = torch.device(device)
        self.levels = _level_geometry(config)
        self.M = torch.from_numpy(
            orb_ops.brief_matrix_bf16(fe.descriptor_bits, fe.patch_size, fe.steer_descriptor)
        ).to(device)
        # resize weights per level, built once host-side (ops/image.resize_weights)
        self.resize = [
            None if i == 0 else im_ops.resize_matrices((vh, vw), hw, device)
            for i, (_, hw, _, _) in enumerate(self.levels)
        ]
        # border masks per level (static)
        border = fe.border_margin
        self.in_border = []
        for _, (h_i, w_i), (H_i, W_i), _ in self.levels:
            yy = torch.arange(H_i, device=device)[:, None]
            xx = torch.arange(W_i, device=device)[None, :]
            self.in_border.append(
                (yy >= border) & (yy < h_i - border) & (xx >= border) & (xx < w_i - border)
            )

    def level_image(self, left: torch.Tensor, i: int) -> torch.Tensor:
        """Level i of the pyramid of left (B, H, W) f32: left itself at
        level 0, else its valid region resized and zero-padded to
        (B, H_i, W_i)."""
        if i == 0:
            return left
        vh, vw = self.config.image_hw
        return im_ops.pad_to(
            im_ops.resize_linear(left[:, :vh, :vw], self.resize[i]), self.levels[i][2]
        )

    def detect(self, i: int, imgs: torch.Tensor):
        """FAST+NMS on level i's images (B, H_i, W_i) stacked to
        (B*H_i, W_i), the border mask and the pooled top-k. Returns
        (stacked, scores (B, n_i), yx (B, n_i, 2) int32)."""
        stacked, score = self.score_map(i, imgs)
        return (stacked, *self.topk(i, score))

    def score_map(self, i: int, imgs: torch.Tensor):
        """(stacked (B*H_i, W_i), the NMS'd score map (B, H_i, W_i) zeroed
        outside the border) of level i's images."""
        fe = self.config.frontend
        B = imgs.shape[0]
        H_i, W_i = self.levels[i][2]
        stacked = imgs.reshape(B * H_i, W_i).contiguous()
        if fe.pallas_fast:
            score = fast_kernel.fast_nms_score_map(stacked, fe.fast_threshold)
        else:
            score = fast_kernel.fast_nms_plain(stacked, fe.fast_threshold)
        return stacked, torch.where(self.in_border[i], score.reshape(B, H_i, W_i), 0.0)

    def topk(self, i: int, score: torch.Tensor):
        """(scores (B, n_i), yx (B, n_i, 2) int32): level i's budget of the
        pooled top-k."""
        return fast_ops.nms_topk(score, self.levels[i][3])

    def blur(self, stacked: torch.Tensor) -> torch.Tensor:
        return im_ops.box_blur(stacked, self.config.frontend.blur_box)

    def stacked_yx(self, i: int, yx: torch.Tensor) -> torch.Tensor:
        """Level i's keypoints yx (B, n, 2) as (B*n, 2) int32 rows of the
        (B*H_i, W_i) stack: frame b's rows offset by b*H_i."""
        B, n = yx.shape[:2]
        H_i = self.levels[i][2][0]
        row_off = (torch.arange(B, device=self.device, dtype=torch.int32) * H_i)[:, None]
        yx_st = torch.stack([yx[..., 0] + row_off, yx[..., 1]], dim=-1)
        return yx_st.reshape(B * n, 2).contiguous()

    def brief(self, patches: torch.Tensor, B: int, n: int):
        """BRIEF of (B*n, P, P) patches: (packed (B, n, words), signs (B, n,
        bits))."""
        steer = self.config.frontend.steer_descriptor
        packed, signs = orb_ops.describe_patches(patches, self.M, steer)
        return packed.reshape(B, n, -1), signs.reshape(B, n, -1)

    def describe(self, i: int, blurred: torch.Tensor, yx: torch.Tensor):
        """The patch gather on level i's blurred stack at keypoints yx
        (B, n, 2), clamped per frame, then BRIEF. Returns (packed (B, n,
        words), signs (B, n, bits))."""
        fe = self.config.frontend
        B, n = yx.shape[:2]
        H_i = self.levels[i][2][0]
        yx_st = self.stacked_yx(i, yx)
        if fe.pallas_patches:
            patches = patch_kernel.gather_patches(blurred, yx_st, fe.patch_size, H_i)
        else:
            patches = patch_kernel.gather_patches_plain(blurred, yx_st, fe.patch_size, H_i)
        return self.brief(patches, B, n)

    def describe_levels(self, blurred_list, yx_list):
        """`describe` of every level, with one patch gather for all of them
        (one launch of the kernel): then BRIEF per level on that level's
        slice of the patches, at the per-level shapes, so the bits equal
        `describe`'s; BRIEF of all levels (with steering, the orientation
        too) runs in the `extract.brief` span. Returns [(packed, signs)] in
        level order."""
        fe = self.config.frontend
        yx_st = [self.stacked_yx(i, yx) for i, yx in enumerate(yx_list)]
        frame_hs = [H_i for _, _, (H_i, _), _ in self.levels[:len(yx_list)]]
        gather = (patch_kernel.gather_patches_levels if fe.pallas_patches
                  else patch_kernel.gather_patches_levels_plain)
        patches = gather(blurred_list, yx_st, fe.patch_size, frame_hs)
        out, start = [], 0
        with trace.span("extract.brief"):
            for yx, rows in zip(yx_list, yx_st):
                B, n = yx.shape[:2]
                out.append(self.brief(patches[start:start + rows.shape[0]], B, n))
                start += rows.shape[0]
        return out

    def anms(self, yx_int: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
        fe = self.config.frontend
        return anms_ops.anms_mask(
            yx_int, score, num=fe.n_features, robust_coeff=fe.anms_robust_coeff
        )

    def stereo(self, left, right, yx_int, valid) -> stereo_ops.StereoResult:
        return stereo_match(self.config, left, right, yx_int, valid)

    def merge(self, images: torch.Tensor, per_level, with_depth: bool) -> FrameFeatures:
        """FrameFeatures (leading B axis) of the levels' (scores, yx,
        packed, signs), in level order; `with_depth=False` zeroes the
        depth fields."""
        table = self.table(per_level)
        return self.features(table, self.depth(images, table) if with_depth else None)

    def features(self, table: dict, depth=None) -> FrameFeatures:
        """FrameFeatures of a `table` and its `depth` fields (None: zeros)."""
        if depth is None:
            B, N = table["score"].shape
            zero = torch.zeros((B, N), dtype=torch.float32, device=self.device)
            no = torch.zeros((B, N), dtype=torch.bool, device=self.device)
            depth = dict(
                disparity=zero, depth=zero, depth_valid=no, reliable=no,
                pts_cam=torch.zeros((B, N, 3), dtype=torch.float32, device=self.device),
            )
        return FrameFeatures(**{k: v for k, v in table.items() if k != "yx_int"}, **depth)

    def table(self, per_level) -> dict:
        """The levels' (scores, yx, packed, signs) concatenated in level
        order, with the validity, the ANMS mask and the rounded coords
        `yx_int`: every FrameFeatures field but the depth ones."""
        vh, vw = self.config.image_hw
        B = per_level[0][0].shape[0]
        yx_f = torch.cat([yx.float() * s for (s, _, _, _), (_, yx, _, _)
                          in zip(self.levels, per_level)], dim=1)
        yx_int = torch.round(yx_f).to(torch.int32)
        score = torch.cat([p[0] for p in per_level], dim=1)
        scale = torch.cat([torch.full((B, p[1].shape[1]), s, dtype=torch.float32,
                                      device=self.device)
                           for (s, _, _, _), p in zip(self.levels, per_level)], dim=1)
        valid = (score > 0.0) & (yx_int[..., 0] < vh) & (yx_int[..., 1] < vw)
        return dict(yx=yx_f, score=score, scale=scale, valid=valid,
                    spawn_mask=self.anms(yx_int, score),
                    signs=torch.cat([p[3] for p in per_level], dim=1),
                    packed=torch.cat([p[2] for p in per_level], dim=1), yx_int=yx_int)

    def depth(self, images: torch.Tensor, table: dict) -> dict:
        """The five depth fields (B, N, ...) of `table`'s keypoints: one
        sweep over all frames' keypoints on the stacked full-res pair,
        frame b's rows offset by b * H0."""
        yx_int, yx_f, valid = table["yx_int"], table["yx"], table["valid"]
        B, N = valid.shape
        H0, W0 = images.shape[2:]
        row_off = (torch.arange(B, device=self.device, dtype=torch.int32) * H0)[:, None]
        yx_st = torch.stack([yx_int[..., 0] + row_off, yx_int[..., 1]], dim=-1)
        depth = _depth_fields(
            self.config, images[:, 0].float().reshape(B * H0, W0),
            images[:, 1].float().reshape(B * H0, W0),
            yx_st.reshape(B * N, 2).contiguous(), yx_f.reshape(B * N, 2),
            valid.reshape(B * N),
        )
        return {k: v.reshape(B, N, *v.shape[1:]) for k, v in depth.items()}


def make_batch_extractor(config: Config, device, with_depth: bool = True):
    """Build batch_extract(images (B, 2, H, W) uint8 or f32 on `device`) ->
    FrameFeatures with a leading B axis. `with_depth=False` zeroes the
    depth fields (the lazy-depth chunk path)."""
    st = ExtractStages(config, device)

    def batch_extract(images: torch.Tensor) -> FrameFeatures:
        left = images[:, 0].float()                       # (B, H, W)
        blurred, tops = [], []
        for i in range(len(st.levels)):
            stacked, top_scores, yx_i = st.detect(i, st.level_image(left, i))
            blurred.append(st.blur(stacked))
            tops.append((top_scores, yx_i))
        described = st.describe_levels(blurred, [yx for _, yx in tops])
        per_level = [(s, yx, p, g) for (s, yx), (p, g) in zip(tops, described)]
        return st.merge(images, per_level, with_depth)

    batch_extract.stages = st   # the profilers time these very calls
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
