"""The benchmark's plain reference of the Stack model: a copy of the val
forward of ``dodt_tpu_torch/models/stack.py`` (the port of
``dodt_tpu/models/stack.py``, Guoxs/DODT's StackRpnModel and
StackAvodModel), built on ``reference/model.py``'s helpers, which
imports nothing of either package.

A sample is F frames, ego-aligned in frame 0's coordinates. The four
clouds are rasterized one by one, and their concatenation (F * P points)
once more as the integrated BEV. A BEV tower runs over the F frames'
maps, a second BEV tower with its own weights over the integrated map,
and the image tower over the F images. The RPN runs once, over every
anchor, on the integrated BEV bottleneck and frame 0's image bottleneck.
Its proposals are shared by all frames: each frame crops its own
features, and the shared second-stage trunk reads F * K rows. The stack
correlation head joins the first and the last frame's ROIs into the
coexist logits and (dx, dz, dry). NMS runs once per frame.

Departures from the program:

  * every convolution and matrix product contracts float32 values
    (``precision="float32"``, the towers' and heads' bfloat16 included),
    or values rounded to float8 e4m3 under a per-tensor scale
    (``precision="float8"``, the control; ``reference/lowp``), the
    correlation head's 1x1 conv and its FC stacks included (the program
    runs them in float32);
  * the towers' conv chain and the second stage's BEV crop take their
    plain forms (no CUDA kernel);
  * the val forward alone: no train mode, dropout, path drop or losses;
  * ``forward`` takes ``proposals``, the selection and values of another
    run's RPN (``reference.model.force_proposals``), and then also
    returns ``own_top_anchors``, ``own_top_valid`` (its own NMS's) and
    ``forced_hit``;
  * it returns, besides the program's outputs, ``bev_input`` (B, F, H,
    W, C) and ``int_bev_input`` (B, H, W, C), the rasterized maps, and
    ``proposal_boxes_3d`` (B, F, K, 7), the shared proposals repeated per
    frame, as ``harness/check.final_gap`` reads them.

Module and parameter names, and their order, are the program's, so that
``harness/weights`` fills both alike."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import boxes as box_ops
from .anchors import tile_anchors_3d
from .backbone import VggPyramid, preprocess_image, tower_channels
from .config import PipelineConfig
from .dense_rpn import build_bev_lattice
from .lowp import contract
from .model import (Bottleneck, Dense, MlpHead, _resize_to, _take,
                    anchor_valid_mask, bev_anchor_rois, bev_crop_fn,
                    force_proposals, tower_forward)
from .nms import nms_bev_mode, top_k_prefilter
from .projection import (project_to_bev, project_to_image_space,
                         reorder_boxes_yx)
from .roi import crop_and_resize
from .voxel import bev_maps_from_points


class FcTrunk(nn.Module):
    """The second stage's shared FC trunk ``fc0..`` over the fused ROIs,
    one linear ``out{i}`` per output branch, contracting at
    ``precision``."""

    def __init__(self, d_in: int, sizes: Sequence[int],
                 out_dims: Sequence[int], precision: str):
        super().__init__()
        self.precision = precision
        self.n_hidden = len(sizes)
        for i, s in enumerate(sizes):
            self.add_module(f"fc{i}", Dense(d_in, s))
            d_in = s
        self.n_out = len(out_dims)
        for i, o in enumerate(out_dims):
            self.add_module(f"out{i}", Dense(d_in, o))

    def forward(self, h: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        for i in range(self.n_hidden):
            h = F.relu(getattr(self, f"fc{i}")(h, self.precision))
        return tuple(getattr(self, f"out{i}")(h, self.precision)
                     for i in range(self.n_out))


class StackCorrHead(nn.Module):
    """Concatenated first and last frame ROIs (M, S, S, C) each -> 1x1
    conv + ReLU -> two FC stacks -> (coexist logits (M, 2), corr offsets
    (M, 3))."""

    def __init__(self, c_in: int, crop_size: int, fc_sizes: Sequence[int],
                 keep_prob: float, precision: str, conv_channels: int = 256):
        super().__init__()
        self.precision = precision
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = nn.Parameter(torch.empty(conv_channels,
                                                      2 * c_in, 1, 1))
        self.Conv_0.bias = nn.Parameter(torch.zeros(conv_channels))
        d = crop_size * crop_size * conv_channels
        self.corr_cls = MlpHead(d, fc_sizes, 2, precision, keep_prob,
                                "stack_corr.corr_cls")
        self.corr_off = MlpHead(d, fc_sizes, 3, precision, keep_prob,
                                "stack_corr.corr_off")

    def forward(self, roi_first: torch.Tensor, roi_last: torch.Tensor):
        x = torch.cat([roi_first, roi_last], dim=-1)
        w = self.Conv_0.weight
        x = F.relu(F.linear(contract(x, self.precision),
                            contract(w.reshape(w.shape[0], w.shape[1]),
                                     self.precision), self.Conv_0.bias))
        flat = x.reshape(x.shape[0], -1)
        return self.corr_cls(flat), self.corr_off(flat)


class StackAvodNet(nn.Module):
    """The Stack model over F frames a sample: the val forward."""

    def __init__(self, cfg: PipelineConfig,
                 cluster_sizes: Tuple[Tuple[float, float, float], ...],
                 precision: str = "float32"):
        super().__init__()
        self.cfg = cfg
        self.cluster_sizes = cluster_sizes
        m = cfg.model
        ku = cfg.dataset.kitti_utils
        n_in = ku.bev_generator.num_slices + 1
        self.bev_vgg_pyr = VggPyramid(m.bev_extractor, n_in, precision)
        self.int_bev_vgg_pyr = VggPyramid(m.bev_extractor, n_in, precision)
        self.img_vgg_pyr = VggPyramid(m.img_extractor, 3, precision)
        bev_ch = tower_channels(m.bev_extractor)
        if bev_ch != tower_channels(m.img_extractor):
            raise ValueError("the Stack model's mean fusion needs equal "
                             "tower widths")
        bch = m.rpn.bottleneck_channels
        self.int_bev_bottleneck = Bottleneck(bev_ch, bch)
        self.img_bottleneck = Bottleneck(bev_ch, bch)
        rpn_in = m.rpn.proposal_roi_crop_size ** 2 * bch
        self.rpn_cls = MlpHead(rpn_in, m.rpn.cls_fc_sizes, 2, precision,
                               m.rpn.keep_prob, "rpn_cls")
        self.rpn_reg = MlpHead(rpn_in, m.rpn.reg_fc_sizes, 6, precision,
                               m.rpn.keep_prob, "rpn_reg")
        s = m.avod.proposal_roi_crop_size
        self.avod_fc = FcTrunk(s * s * bev_ch, m.avod.fc_layer_sizes,
                               (self.num_classes, 10, 2), precision)
        self.stack_corr = StackCorrHead(bev_ch, s, m.rpn.corr_fc_sizes,
                                        m.rpn.keep_prob, precision)
        self.lattice = build_bev_lattice(
            ku.area_extents, ku.anchor_strides, cluster_sizes, ku.bev_shape,
            ku.voxel_size, m.rpn.proposal_roi_crop_size)

    @property
    def num_classes(self) -> int:
        return len(self.cfg.dataset.classes) + 1

    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "val",
                proposals=None) -> Dict[str, torch.Tensor]:
        """The val forward. batch (B samples, F frames): points (B, F, P,
        3), points_valid (B, F, P), image (B, F, Hi, Wi, 3), ground_plane
        (B, 4), p2 (B, 3, 4), orig_image_shape (B, 2). ``proposals``
        ((B, K, 6), (B, K)) follows another run's RPN selection."""
        if mode == "train":
            raise ValueError("the Stack reference has the val forward only")
        with torch.no_grad():
            return self._forward(batch, proposals)

    def _forward(self, batch, proposals):
        cfg = self.cfg
        ku = cfg.dataset.kitti_utils
        m = cfg.model
        bg = ku.bev_generator
        ext = ku.bev_extents
        points = batch["points"]
        b, f = points.shape[0], points.shape[1]
        gps = batch["ground_plane"].to(torch.float32)
        p2 = batch["p2"]
        img_shapes = batch["orig_image_shape"].to(torch.float32)

        def rasterize(p, v, gp):
            return bev_maps_from_points(p, v, gp, ku.area_extents,
                                        ku.voxel_size, bg.height_lo,
                                        bg.height_hi, bg.num_slices)

        frame_maps = [rasterize(p, v, gp) for p, v, gp in zip(
            points.flatten(0, 1), batch["points_valid"].flatten(0, 1),
            gps.repeat_interleave(f, dim=0))]
        int_maps = [rasterize(p, v, gp) for p, v, gp in zip(
            points.reshape(b, -1, 3), batch["points_valid"].reshape(b, -1),
            gps)]
        sizes = np.asarray(self.cluster_sizes, np.float32)
        anchors = torch.stack([box_ops.box_3d_to_anchor(tile_anchors_3d(
            ku.area_extents, sizes, ku.anchor_strides, gp)) for gp in gps])
        n_anchors = anchors.shape[1]
        anchor_valid = torch.stack([
            anchor_valid_mask(cfg, self.lattice, mp.occupancy, anc)
            for mp, anc in zip(int_maps, anchors)])

        bev_input = torch.stack([mp.features for mp in frame_maps])
        int_input = torch.stack([mp.features for mp in int_maps])
        bev_feats = tower_forward(False, self.bev_vgg_pyr, bev_input, True)
        int_feats = tower_forward(False, self.int_bev_vgg_pyr, int_input,
                                  True)
        img_feats = tower_forward(False, self.img_vgg_pyr, preprocess_image(
            batch["image"].flatten(0, 1)), True)
        int_bottle = _resize_to(self.int_bev_bottleneck(int_feats),
                                ku.bev_shape)
        img_bottle0 = self.img_bottleneck(
            img_feats.reshape((b, f) + img_feats.shape[1:])[:, 0])

        # RPN: the integrated BEV and frame 0's image, every anchor; at
        # val both paths are kept, so the mean fusion halves their sum
        crop = m.rpn.proposal_roi_crop_size
        bev_rois = bev_anchor_rois(cfg, self.lattice, int_bottle, anchors)
        img_rois = torch.stack([
            crop_and_resize(fm, reorder_boxes_yx(project_to_image_space(
                anc, p2_, sh)[1]), crop)
            for fm, anc, p2_, sh in zip(img_bottle0, anchors, p2,
                                        img_shapes)]).reshape(b, n_anchors,
                                                              -1)
        flat = ((bev_rois + img_rois) / 2.0).reshape(b * n_anchors, -1)
        objectness = self.rpn_cls(flat).reshape(b, n_anchors, 2)
        rpn_offsets = self.rpn_reg(flat).reshape(b, n_anchors, 6)

        cand = box_ops.offset_to_anchor(anchors, rpn_offsets)
        _, prop_bev_norm = project_to_bev(cand, ext)
        obj_scores = torch.softmax(objectness, dim=-1)[..., 1]
        obj_scores = torch.where(anchor_valid, obj_scores, -1.0)
        k_rpn = m.rpn.test_nms_size
        pre_idx, pre_valid = top_k_prefilter(
            torch.where(anchor_valid, obj_scores, -1e9), anchor_valid,
            min(4 * k_rpn, n_anchors))
        keep, top_valid = nms_bev_mode(m.nms_mode)(
            _take(prop_bev_norm, pre_idx, 1), _take(obj_scores, pre_idx, 1),
            pre_valid, k_rpn, m.rpn.nms_iou_thresh)
        top_idx = _take(pre_idx, keep, 1)
        top_anchors = _take(cand, top_idx, 1)                # (B, K, 6)
        top_scores = _take(obj_scores, top_idx, 1)
        out = {}
        if proposals is not None:
            out["own_top_anchors"] = top_anchors
            out["own_top_valid"] = top_valid
            top_anchors, top_scores, top_valid, out["forced_hit"] = \
                force_proposals(cand, obj_scores, *proposals)

        # second stage: shared proposals, each frame's own features
        _, ss_bev_norm = project_to_bev(top_anchors, ext)
        ss_img_norm = torch.stack([
            project_to_image_space(anc, p2_, sh)[1]
            for anc, p2_, sh in zip(top_anchors, p2, img_shapes)])
        ss_bev_yx = reorder_boxes_yx(ss_bev_norm).repeat_interleave(f, 0)
        ss_img_yx = reorder_boxes_yx(ss_img_norm).repeat_interleave(f, 0)
        s = m.avod.proposal_roi_crop_size
        ss_bev_rois = bev_crop_fn(s)(bev_feats, ss_bev_yx)
        ss_img_rois = torch.stack([crop_and_resize(fm, bx, s) for fm, bx
                                   in zip(img_feats, ss_img_yx)])
        k = top_anchors.shape[1]
        ss_fused = ((ss_bev_rois + ss_img_rois) / 2.0).reshape(
            (b, f) + ss_bev_rois.shape[1:])             # (B, F, K, S, S, C)
        cls_logits, box_offsets, angle_vecs = self.avod_fc(
            ss_fused.reshape(b * f * k, -1))
        cls_logits = cls_logits.reshape(b, f, k, self.num_classes)
        box_offsets = box_offsets.reshape(b, f, k, 10)
        angle_vecs = angle_vecs.reshape(b, f, k, 2)

        coexist_logits, corr_offsets = self.stack_corr(
            ss_fused[:, 0].reshape((b * k,) + ss_fused.shape[3:]),
            ss_fused[:, -1].reshape((b * k,) + ss_fused.shape[3:]))
        coexist_logits = coexist_logits.reshape(b, k, 2)
        corr_offsets = corr_offsets.reshape(b, k, 3)

        prop_boxes_3d = box_ops.anchors_to_box_3d(top_anchors, fix_lw=True)
        prop_4c = box_ops.box_3d_to_box_4c(prop_boxes_3d, gps[:, None, :])
        pred_boxes_3d = box_ops.box_4c_to_box_3d(prop_4c[:, None]
                                                 + box_offsets,
                                                 gps[:, None, None, :])
        pred_orient = box_ops.angle_vector_to_orientation(angle_vecs)
        pred_anchors = box_ops.box_3d_to_anchor(pred_boxes_3d,
                                                ortho_rotate=True)
        _, pred_bev_norm = project_to_bev(pred_anchors, ext)
        cls_softmax = torch.softmax(cls_logits, dim=-1)
        final_scores_all = cls_softmax[..., 1:].amax(dim=-1)
        top_valid_bf = top_valid[:, None].expand(b, f, k)
        f_idx, f_valid = nms_bev_mode(m.nms_mode)(
            pred_bev_norm, final_scores_all, top_valid_bf, m.avod.nms_size,
            m.avod.nms_iou_thresh)
        coexist = torch.softmax(coexist_logits, dim=-1)[..., 1]
        return {
            "anchors": anchors, "anchor_valid": anchor_valid,
            "objectness": objectness, "rpn_offsets": rpn_offsets,
            "top_anchors": top_anchors, "top_scores": top_scores,
            "top_valid": top_valid, "proposal_4c": prop_4c,
            "cls_logits": cls_logits, "box_offsets": box_offsets,
            "angle_vectors": angle_vecs,
            "coexist_logits": coexist_logits, "corr_pred": corr_offsets,
            "pred_boxes_3d": pred_boxes_3d,
            "final_indices": f_idx,
            "final_valid": f_valid & _take(top_valid_bf, f_idx, 2),
            "final_boxes_3d": _take(pred_boxes_3d, f_idx, 2),
            "final_orientations": _take(pred_orient, f_idx, 2),
            "final_cls_softmax": _take(cls_softmax, f_idx, 2),
            "final_scores": _take(final_scores_all, f_idx, 2),
            "final_corr_offsets": _take(corr_offsets, f_idx[:, 0], 1),
            "final_coexist": _take(coexist, f_idx[:, 0], 1),
            "bev_input": bev_input.reshape((b, f) + bev_input.shape[1:]),
            "int_bev_input": int_input,
            "proposal_boxes_3d": prop_boxes_3d[:, None].expand(
                b, f, k, prop_boxes_3d.shape[-1]),
            **out}
