"""Paired-frame DODT detector, eval paths (PyTorch port of
dodt_tpu/models/dt_avod.py: the monolithic pair forward ``__call__`` in
val mode as ``forward``, and the streaming ``encode_frame`` and
``pair_stage``).

Module and parameter names follow the Flax tree, so ``convert.py`` maps a
JAX checkpoint onto ``DtAvodNet.state_dict()`` one to one. Eval only:
no dropout and no path drop. Public tensors are NHWC like the JAX
package's.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dodt_tpu.config import PipelineConfig
from dodt_tpu_torch.models.backbone import VggPyramid, preprocess_image
from dodt_tpu_torch.ops import boxes as box_ops
from dodt_tpu_torch.ops.anchors import integral_image_2d, tile_anchors_3d
from dodt_tpu_torch.ops.correlation import corr_bottleneck, disp_grid
from dodt_tpu_torch.ops.dense_rpn import (build_bev_lattice, dense_bev_rois,
                                          dense_empty_anchor_mask)
from dodt_tpu_torch.ops.nms import nms_bev_exact, top_k, top_k_prefilter
from dodt_tpu_torch.ops.projection import (project_to_bev,
                                           project_to_image_space,
                                           reorder_boxes_yx)
from dodt_tpu_torch.ops.roi import crop_and_resize
from dodt_tpu_torch.ops.roi_window import (crop_and_resize_window,
                                           window_applies)
from dodt_tpu_torch.ops.voxel import bev_maps_from_points

# box-representation output sizes (dt_avod.py:166-169)
OFFSETS_SIZE = {"box_3d": 6, "box_8c": 24, "box_8co": 24,
                "box_4c": 10, "box_4ca": 10}
ANGLE_SIZE = {"box_3d": 2, "box_8c": 0, "box_8co": 0,
              "box_4c": 0, "box_4ca": 2}
# the decoded detections: what pair_stage returns and the evaluator reads
FINAL_KEYS = ("final_boxes_3d", "final_orientations", "final_cls_softmax",
              "final_scores", "final_valid", "final_corr_offsets")


class Dense(nn.Module):
    """Linear layer computing in a given dtype; weight (out, in)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


class MlpHead(nn.Module):
    """FC stack ``fc6, fc7, ...`` + linear ``out``; computes in ``dtype``
    and returns f32."""

    def __init__(self, d_in: int, sizes: Sequence[int], d_out: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.n_hidden = len(sizes)
        for i, s in enumerate(sizes):
            self.add_module(f"fc{6 + i}", Dense(d_in, s))
            d_in = s
        self.out = Dense(d_in, d_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"fc{6 + i}")(x, self.dtype))
        return self.out(x, self.dtype).to(torch.float32)


def feature_fuse(a: torch.Tensor, b: torch.Tensor, wa: float, wb: float,
                 method: str) -> torch.Tensor:
    """Two-branch fusion (mean | concat | max) of pre-weighted inputs."""
    a = a * wa
    b = b * wb
    if method == "concat":
        return torch.cat([a, b], dim=-1)
    if method == "max":
        return torch.maximum(a, b)
    return (a + b) / max(wa + wb, 1.0)


class AvodTrunk(nn.Module):
    """Second-stage FC trunk, early fusion: fuse (bev, img) ROI
    features, ``fc0..`` hidden layers, one linear ``out{i}`` per branch.
    Computes in ``dtype``, returns f32."""

    def __init__(self, d_in: int, sizes: Sequence[int],
                 out_dims: Sequence[int], fusion_type: str,
                 fusion_method: str, dtype: torch.dtype):
        super().__init__()
        if fusion_type != "early":
            raise NotImplementedError(
                f"AvodTrunk fusion_type {fusion_type!r}: the port has "
                "early fusion only")
        self.fusion_method = fusion_method
        self.dtype = dtype
        self.n_hidden = len(sizes)
        d = 2 * d_in if fusion_method == "concat" else d_in
        for i, s in enumerate(sizes):
            self.add_module(f"fc{i}", Dense(d, s))
            d = s
        self.n_out = len(out_dims)
        for i, o in enumerate(out_dims):
            self.add_module(f"out{i}", Dense(d, o))

    def forward(self, bev: torch.Tensor, img: torch.Tensor, wb: float,
                wi: float) -> Tuple[torch.Tensor, ...]:
        h = feature_fuse(bev.to(self.dtype), img.to(self.dtype), wb, wi,
                         self.fusion_method)
        for i in range(self.n_hidden):
            h = F.relu(getattr(self, f"fc{i}")(h, self.dtype))
        return tuple(getattr(self, f"out{i}")(h, self.dtype)
                     .to(torch.float32) for i in range(self.n_out))


class GroupNorm1(nn.Module):
    """GroupNorm with one group over NHWC, Flax's numerics: epsilon 1e-6
    (torch's default is 1e-5) and var = E[x^2] - E[x]^2."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, x.dim()))
        mean = x.mean(dim=dims, keepdim=True)
        mean2 = (x * x).mean(dim=dims, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class Bottleneck(nn.Module):
    """1x1 conv + GroupNorm(1) + ReLU over NHWC f32."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = nn.Parameter(torch.empty(co, ci, 1, 1))
        self.Conv_0.bias = nn.Parameter(torch.zeros(co))
        self.GroupNorm_0 = GroupNorm1(co)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.Conv_0.weight
        y = F.linear(x, w.reshape(w.shape[0], w.shape[1]), self.Conv_0.bias)
        return F.relu(self.GroupNorm_0(y))


class CorrBottleneck(nn.Module):
    """Correlation of two frames' BEV maps fused with a 1x1 bottleneck
    (kernel B3, ops/correlation.py) + bias + GroupNorm(1) + ReLU:
    (B, H, W, C) pair -> (B, H, W, channels). ``weight`` is (channels,
    D^2), the transpose of the Flax ``kernel``."""

    def __init__(self, channels: int = 1, max_displacement: int = 5,
                 stride_2: int = 1):
        super().__init__()
        self.max_displacement = max_displacement
        self.stride_2 = stride_2
        _, d = disp_grid(max_displacement, stride_2)
        self.weight = nn.Parameter(torch.empty(channels, d * d))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.GroupNorm_0 = GroupNorm1(channels)

    def forward(self, feat_a: torch.Tensor, feat_b: torch.Tensor
                ) -> torch.Tensor:
        x_cf = corr_bottleneck(feat_a, feat_b, self.weight.t(),
                               self.max_displacement, self.stride_2)
        x = x_cf.permute(0, 2, 3, 1) + self.bias
        return F.relu(self.GroupNorm_0(x))


def encode_proposals(rep: str, prop_boxes_3d: torch.Tensor, gp4):
    if rep in ("box_4c", "box_4ca"):
        return box_ops.box_3d_to_box_4c(prop_boxes_3d, gp4)
    raise NotImplementedError(f"box representation {rep!r} is not ported")


def decode_predictions(rep: str, prop_enc, box_offsets, angle_vecs, gp4):
    """Apply the predicted offsets; (pred_boxes_3d, pred_orientations)."""
    if rep not in ("box_4c", "box_4ca"):
        raise NotImplementedError(f"box representation {rep!r} is not "
                                  "ported")
    boxes = box_ops.box_4c_to_box_3d(prop_enc + box_offsets, gp4)
    if angle_vecs is not None:
        return boxes, box_ops.angle_vector_to_orientation(angle_vecs)
    return boxes, boxes[..., 6]


def _resize_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear-upsample NHWC (B, h, w, C) to (B, H, W, C) if needed
    (half-pixel centres, as jax.image.resize "bilinear")."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def bev_crop_fn(crop_size: int, window: int, map_shape, device):
    """Second-stage BEV crop over (M, H, W, C) maps and (M, N, 4) boxes:
    the windowed kernel (B2) on the card when the map and its channel
    alignment leave the window slack, the gather form otherwise and on
    the CPU (the JAX model's dispatch, dt_avod.py:172-193)."""
    if device.type != "cpu" and window_applies(*map_shape, crop_size,
                                               window):
        return lambda maps, bx: crop_and_resize_window(maps, bx, crop_size,
                                                       window)
    return lambda maps, bx: torch.stack(
        [crop_and_resize(fm, b, crop_size) for fm, b in zip(maps, bx)])


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """take_along_axis with idx broadcast over x's trailing dims."""
    extra = x.dim() - idx.dim()
    idx = idx.reshape(idx.shape + (1,) * extra)
    return torch.gather(x, dim, idx.expand(idx.shape[:dim + 1]
                                           + x.shape[dim + 1:]))


class DtAvodNet(nn.Module):
    """Paired-frame AVOD with correlation head: the monolithic pair
    forward and the streaming interface."""

    def __init__(self, cfg: PipelineConfig,
                 cluster_sizes: Tuple[Tuple[float, float, float], ...]):
        super().__init__()
        self.cfg = cfg
        self.cluster_sizes = cluster_sizes
        m = cfg.model
        ku = cfg.dataset.kitti_utils
        dtype = (torch.bfloat16 if m.tower_dtype == "bfloat16"
                 else torch.float32)
        self.bev_vgg_pyr = VggPyramid(m.bev_extractor,
                                      ku.bev_generator.num_slices + 1, dtype)
        self.img_vgg_pyr = VggPyramid(m.img_extractor, 3, dtype)
        bev_ch, img_ch = m.bev_extractor.conv1[1], m.img_extractor.conv1[1]
        bch = m.rpn.bottleneck_channels
        self.bev_bottleneck = Bottleneck(bev_ch, bch)
        self.img_bottleneck = Bottleneck(img_ch, bch)
        self.bev_corr_bottleneck = CorrBottleneck(
            1, m.correlation.max_displacement, m.correlation.stride_2)
        rpn_in = m.rpn.proposal_roi_crop_size ** 2 * bch
        if m.rpn.fusion_method == "concat":
            rpn_in *= 2
        self.rpn_cls = MlpHead(rpn_in, m.rpn.cls_fc_sizes, 2, dtype)
        self.rpn_reg = MlpHead(rpn_in, m.rpn.reg_fc_sizes, 6, dtype)
        rep = m.avod.box_representation
        out_dims = (self.num_classes, OFFSETS_SIZE[rep])
        if ANGLE_SIZE[rep]:
            out_dims = out_dims + (ANGLE_SIZE[rep],)
        s2 = m.avod.proposal_roi_crop_size ** 2
        if bev_ch != img_ch and m.avod.fusion_method != "concat":
            raise ValueError("mean/max fusion needs equal tower widths")
        self.avod_fc = AvodTrunk(s2 * bev_ch, m.avod.fc_layer_sizes,
                                 out_dims, m.avod.fusion_type,
                                 m.avod.fusion_method, dtype)
        self.corr_fc = MlpHead(s2, m.avod.fc_layer_sizes, 3, dtype)
        self.lattice = build_bev_lattice(
            ku.area_extents, ku.anchor_strides, cluster_sizes, ku.bev_shape,
            ku.voxel_size, m.rpn.proposal_roi_crop_size)

    @property
    def num_classes(self) -> int:
        return len(self.cfg.dataset.classes) + 1

    # ------------------------------------------------------------------
    # Shared stages. The streaming interface (encode_frame / pair_stage)
    # and the monolithic forward run the same RPN and second-stage math;
    # the JAX package keeps two copies, the port one.

    def _encode(self, points, points_valid, gps, images, p2, img_shapes
                ) -> Dict[str, torch.Tensor]:
        """Encode M frame rows: rasterisation, anchors and the lattice's
        empty-anchor mask, both towers over all rows at once, then the
        RPN (``_rpn``). Returns bev_input, anchors (M, N, 6),
        anchor_valid (M, N), the f32 tower features and ``_rpn``'s
        outputs."""
        ku = self.cfg.dataset.kitti_utils
        bg = ku.bev_generator
        if self.lattice is None:
            raise NotImplementedError(
                "anchor geometry off the BEV pixel lattice: the per-anchor "
                "crop path is not ported (ROADMAP A15)")
        maps = [bev_maps_from_points(p, v, gp, ku.area_extents,
                                     ku.voxel_size, bg.height_lo,
                                     bg.height_hi, bg.num_slices)
                for p, v, gp in zip(points, points_valid, gps)]
        sizes = np.asarray(self.cluster_sizes, np.float32)
        anchors = torch.stack([box_ops.box_3d_to_anchor(tile_anchors_3d(
            ku.area_extents, sizes, ku.anchor_strides, gp)) for gp in gps])
        anchor_valid = torch.stack([dense_empty_anchor_mask(
            integral_image_2d(mp.occupancy), self.lattice,
            ku.density_threshold) for mp in maps])
        bev_input = torch.stack([mp.features for mp in maps])
        bev_feats = self.bev_vgg_pyr(bev_input).to(torch.float32)
        img_feats = self.img_vgg_pyr(
            preprocess_image(images)).to(torch.float32)
        return {"bev_input": bev_input, "anchors": anchors,
                "anchor_valid": anchor_valid, "bev_feats": bev_feats,
                "img_feats": img_feats,
                **self._rpn(bev_feats, img_feats, anchors, anchor_valid, p2,
                            img_shapes)}

    def _rpn(self, bev_feats, img_feats, anchors, anchor_valid, p2,
             img_shapes) -> Dict[str, torch.Tensor]:
        """Bottlenecks, dense-lattice RPN with (two-pass) image fusion and
        exact NMS, per frame row: objectness (M, K, 2), rpn_offsets
        (M, K, 6) over the K scored anchors (all of them, or the
        fusion_top_k candidates), and the test_nms_size proposals."""
        ku = self.cfg.dataset.kitti_utils
        m = self.cfg.model
        lat = self.lattice
        bev_bottle = _resize_to(self.bev_bottleneck(bev_feats),
                                ku.bev_shape)
        img_bottle = self.img_bottleneck(img_feats)

        b, n_anchors = anchors.shape[0], anchors.shape[1]
        crop_size = m.rpn.proposal_roi_crop_size
        bev_flat = torch.stack([dense_bev_rois(fm, lat)
                                for fm in bev_bottle]).reshape(b, n_anchors,
                                                               -1)
        k_fuse = m.rpn.fusion_top_k
        if k_fuse and k_fuse < n_anchors:
            # two-pass fusion: rank all anchors by the BEV-only head
            # score, fuse image ROIs only for the top-K candidates
            pass1 = feature_fuse(bev_flat, torch.zeros_like(bev_flat), 1.0,
                                 0.0, m.rpn.fusion_method)
            obj1 = self.rpn_cls(pass1.reshape(b * n_anchors, -1)
                                ).reshape(b, n_anchors, 2)
            s1 = torch.where(anchor_valid, obj1[..., 1] - obj1[..., 0],
                             -1e9)
            _, cand_idx = top_k(s1, k_fuse)
            cand_valid = _take(anchor_valid, cand_idx, 1)
            cand_anchors = _take(anchors, cand_idx, 1)
            bev_sel = _take(bev_flat, cand_idx, 1)
        else:
            k_fuse = n_anchors
            cand_valid, cand_anchors, bev_sel = anchor_valid, anchors, bev_flat

        img_rois = torch.stack([
            crop_and_resize(fm, reorder_boxes_yx(project_to_image_space(
                anc, p2_, sh)[1]), crop_size)
            for fm, anc, p2_, sh in zip(img_bottle, cand_anchors, p2,
                                        img_shapes)])
        fused = feature_fuse(bev_sel, img_rois.reshape(b, k_fuse, -1), 1.0,
                             1.0, m.rpn.fusion_method)
        flat = fused.reshape(b * k_fuse, -1)
        objectness = self.rpn_cls(flat).reshape(b, k_fuse, 2)
        rpn_offsets = self.rpn_reg(flat).reshape(b, k_fuse, 6)

        proposals = box_ops.offset_to_anchor(cand_anchors, rpn_offsets)
        _, prop_bev_norm = project_to_bev(proposals, ku.bev_extents)
        obj_scores = torch.softmax(objectness, dim=-1)[..., 1]
        obj_scores = torch.where(cand_valid, obj_scores, -1.0)
        k_rpn = m.rpn.test_nms_size
        pre_idx, pre_valid = top_k_prefilter(
            torch.where(cand_valid, obj_scores, -1e9), cand_valid,
            min(4 * k_rpn, k_fuse))
        keep, top_valid = nms_bev_exact(
            _take(prop_bev_norm, pre_idx, 1), _take(obj_scores, pre_idx, 1),
            pre_valid, k_rpn, m.rpn.nms_iou_thresh)
        top_idx = _take(pre_idx, keep, 1)
        return {"objectness": objectness, "rpn_offsets": rpn_offsets,
                "top_anchors": _take(proposals, top_idx, 1),
                "top_scores": _take(obj_scores, top_idx, 1),
                "top_valid": top_valid}

    def _second_stage(self, bev_bf, img_bf, top_anchors, top_valid, gp, p2,
                      img_shapes, expand: float) -> Dict[str, torch.Tensor]:
        """Correlation of frame 0 against frame 1, second-stage crops,
        trunk, corr head, decode and final NMS over (B, F, ...) frame
        pairs. ``expand`` widens the proposals' x/z extents for the crops
        only (``expand_proposals_xz``)."""
        ku = self.cfg.dataset.kitti_utils
        m = self.cfg.model
        corr_bottle = self.bev_corr_bottleneck(bev_bf[:, 0], bev_bf[:, 1])
        b, f, k = top_anchors.shape[0:3]
        proj_in = top_anchors
        if expand > 0.0:
            proj_in = top_anchors + top_anchors.new_tensor(
                [0.0, 0.0, 0.0, expand, 0.0, expand])
        _, ss_bev_norm = project_to_bev(proj_in, ku.bev_extents)
        ss_img_norm = torch.stack([
            project_to_image_space(anc.reshape(-1, 6), p2_, sh)[1]
            for anc, p2_, sh in zip(proj_in, p2, img_shapes)
        ]).reshape(b, f, k, 4)
        ss_bev_yx = reorder_boxes_yx(ss_bev_norm)
        ss_img_yx = reorder_boxes_yx(ss_img_norm)

        s = m.avod.proposal_roi_crop_size
        bev_maps = bev_bf.flatten(0, 1)                    # (B*F, H, W, C)
        bev_crop = bev_crop_fn(s, m.avod.bev_roi_window, bev_maps.shape[1:],
                               bev_maps.device)
        ss_bev_rois = bev_crop(bev_maps, ss_bev_yx.flatten(0, 1))
        ss_img_rois = torch.stack([
            crop_and_resize(fm, bx, s)
            for fm, bx in zip(img_bf.flatten(0, 1), ss_img_yx.flatten(0, 1))])

        rep = m.avod.box_representation
        branch = self.avod_fc(ss_bev_rois.reshape(b * f * k, -1),
                              ss_img_rois.reshape(b * f * k, -1), 1.0, 1.0)
        cls_logits = branch[0].reshape(b, f, k, self.num_classes)
        box_offsets = branch[1].reshape(b, f, k, OFFSETS_SIZE[rep])
        angle_vecs = (branch[2].reshape(b, f, k, 2)
                      if ANGLE_SIZE[rep] else None)

        corr_rois = torch.stack([crop_and_resize(cm, bx, s) for cm, bx in
                                 zip(corr_bottle, ss_bev_yx[:, 0])])
        corr_offsets = self.corr_fc(corr_rois.reshape(b * k, -1)
                                    ).reshape(b, k, 3)

        prop_boxes_3d = box_ops.anchors_to_box_3d(top_anchors, fix_lw=True)
        gp4 = gp.to(torch.float32)[:, None, None, :]
        prop_enc = encode_proposals(rep, prop_boxes_3d, gp4)
        pred_boxes_3d, pred_orient = decode_predictions(
            rep, prop_enc, box_offsets, angle_vecs, gp4)

        pred_anchors = box_ops.box_3d_to_anchor(pred_boxes_3d,
                                                ortho_rotate=True)
        _, pred_bev_norm = project_to_bev(pred_anchors, ku.bev_extents)
        cls_softmax = torch.softmax(cls_logits, dim=-1)
        final_scores_all = cls_softmax[..., 1:].amax(dim=-1)
        f_idx, f_valid = nms_bev_exact(pred_bev_norm, final_scores_all,
                                       top_valid, m.avod.nms_size,
                                       m.avod.nms_iou_thresh)
        return {
            "corr_pred": corr_offsets,
            "proposal_boxes_3d": prop_boxes_3d, "proposal_enc": prop_enc,
            "cls_logits": cls_logits, "box_offsets": box_offsets,
            "angle_vectors": angle_vecs,
            "pred_boxes_3d": pred_boxes_3d,
            "pred_orientations": pred_orient,
            "final_indices": f_idx,
            "final_valid": f_valid & _take(top_valid, f_idx, 2),
            "final_boxes_3d": _take(pred_boxes_3d, f_idx, 2),
            "final_orientations": _take(pred_orient, f_idx, 2),
            "final_cls_softmax": _take(cls_softmax, f_idx, 2),
            "final_scores": _take(final_scores_all, f_idx, 2),
            "final_corr_offsets": _take(corr_offsets, f_idx[:, 0], 1),
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "val"
                ) -> Dict[str, torch.Tensor]:
        """The monolithic pair forward (the JAX ``__call__`` in eval).

        batch (B couples, F = 2 frames): points (B, F, P, 3),
        points_valid (B, F, P), image (B, F, Hi, Wi, 3), ground_plane
        (B, 4), p2 (B, 3, 4), orig_image_shape (B, 2). Both towers run
        over all B*F frames at once. Returns every output of the JAX
        ``__call__`` in val mode; ``angle_vectors`` is None for box
        representations without an angle branch.
        """
        if mode == "train":
            raise NotImplementedError(
                "mode='train': losses, sampling and the trainer are not "
                "ported (ROADMAP A9-A11)")
        points = batch["points"]
        b, f = points.shape[0], points.shape[1]
        if f != 2:
            raise NotImplementedError(
                f"{f} frames per sample: the port's forward is the paired "
                "model; num_frames=1 is not ported (ROADMAP A15)")
        gps = batch["ground_plane"].to(torch.float32)
        p2 = batch["p2"]
        img_shapes = batch["orig_image_shape"].to(torch.float32)

        def per_frame(x):                         # (B, ...) -> (B*F, ...)
            return x.repeat_interleave(f, dim=0)

        enc = self._encode(points.flatten(0, 1),
                           batch["points_valid"].flatten(0, 1),
                           per_frame(gps), batch["image"].flatten(0, 1),
                           per_frame(p2), per_frame(img_shapes))
        out = {k: v.reshape((b, f) + v.shape[1:]) for k, v in enc.items()}
        out["anchors"] = out["anchors"][:, 0]
        out["img_mask"] = torch.ones(b, device=points.device)
        out["bev_mask"] = torch.ones(b, device=points.device)
        out.update(self._second_stage(
            out.pop("bev_feats"), out.pop("img_feats"), out["top_anchors"],
            out["top_valid"], gps, p2, img_shapes,
            self.cfg.model.expand_proposals_xz))
        return out

    @torch.no_grad()
    def encode_frame(self, batch: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """Encode ONE frame per batch row: towers + RPN proposals.

        batch: points (B, P, 3), points_valid (B, P), image (B, Hi, Wi, 3),
        ground_plane (B, 4), p2 (B, 3, 4), orig_image_shape (B, 2).
        Returns the frame state the pair stage consumes.
        """
        enc = self._encode(batch["points"], batch["points_valid"],
                           batch["ground_plane"].to(torch.float32),
                           batch["image"], batch["p2"],
                           batch["orig_image_shape"].to(torch.float32))
        return {
            **{k: enc[k] for k in ("bev_feats", "img_feats", "top_anchors",
                                   "top_valid")},
            "ground_plane": batch["ground_plane"], "p2": batch["p2"],
            "orig_image_shape": batch["orig_image_shape"],
        }

    @torch.no_grad()
    def pair_stage(self, state_a: Dict[str, torch.Tensor],
                   state_b: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Second stage over a cached frame pair. Like the JAX
        ``pair_stage`` it does not apply ``expand_proposals_xz``."""
        def pair(key):
            return torch.stack([state_a[key], state_b[key]], dim=1)

        out = self._second_stage(
            pair("bev_feats"), pair("img_feats"), pair("top_anchors"),
            pair("top_valid"), state_a["ground_plane"], state_a["p2"],
            state_a["orig_image_shape"].to(torch.float32), 0.0)
        return {k: out[k] for k in FINAL_KEYS}


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's initialisers, drawn from ``generator`` on the CPU: kernels
    LeCun-normal (truncated at 2 sigma, fan-in over every axis but the
    output one), biases zero, GroupNorm scales one."""
    lo, hi = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), \
        0.5 * math.erfc(-2.0 / math.sqrt(2.0))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                fan_in = p[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                u = torch.rand(p.shape, generator=generator,
                               dtype=torch.float64)
                z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u)
                                                  - 1.0)
                p.copy_((z * std).to(p.dtype))
            elif name.endswith("GroupNorm_0.weight"):
                p.fill_(1.0)
            else:
                p.zero_()
