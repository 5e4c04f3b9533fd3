"""Stack model: N-frame detection over an integrated BEV (PyTorch port of
dodt_tpu/models/stack.py).

Parity targets: reference StackRpnModel (stack_rpn_model.py:25) and
StackAvodModel (stack_avod_model.py:24):
  * the integrated point cloud (all frames ego-aligned and combined)
    feeds a dedicated BEV tower; the RPN runs ONCE, in a single pass over
    every anchor, on the integrated BEV bottleneck + frame-0 image
    (stack_rpn_model.py:349-460);
  * proposals are shared by all frames; each frame ROI-pools its own
    BEV/image features through shared-weight second-stage heads;
  * a correlation head over the concatenated first/last-frame ROI
    features predicts coexist logits + [dx, dz, dry] motion
    (corr_fc_layers.py:6-63, stack_avod_model.py:306-316). Its coexist
    output is P(in both keyframes), as the JAX model has it.

The integrated cloud is points.reshape(B, F*P, 3): the rasteriser does
not care about frame boundaries. Every tower and head folds frames into
the batch axis for weight sharing. Module names follow the Flax tree, so
``convert.flax_to_state_dict`` maps a JAX checkpoint one to one. The
towers run the conv-chain kernel (B1) on eval paths only, and the
second-stage BEV crops take ``dt_avod.bev_crop_fn`` (B2 at eval on the
card).

Under a profiler the forward is the span ``dodt/forward`` and its layers
the spans DtAvodNet's have, where the work is the same
(``utils/metrics.span``):

  dodt/rasterize     the per-frame and integrated maps, the anchors and
                     their empty-anchor mask
    dodt/integrate   the rasterization of the integrated (F * P) cloud
  dodt/towers        the three towers over every input, both bottlenecks
  dodt/rpn           ROIs, fusion, heads, prefilter and NMS
  dodt/second_stage  per-frame crops, trunk, correlation head, decode and
                     per-frame NMS
    dodt/stack_corr  the stack correlation head (``StackCorrHead``)

Where ``GraphCache``'s rule (models/graphs.py) replays the second stage
as a CUDA graph (the model's ``graphs``), ``dodt/second_stage`` holds
the input copies, ``dodt/graph_replay`` and the output clones, and
``dodt/stack_corr`` and the stage's ``dodt/nms`` are recorded only at
the capture.

Randomness comes through ``rand(name, shape)`` as in dt_avod.py:

  pathdrop           (B, 3)        path-drop coin flips
  <module>.<fc>      activation    dropout after each hidden FC layer
                                   (``rpn_cls.fc6``, ``avod_fc.fc0``,
                                   ``stack_corr.corr_cls.fc6``, ...)
  stack_loss_rpn     (B, 2, N)     RPN mini-batch in compute_stack_losses
  stack_loss_avod    (B, F, 2, K)  per-frame second-stage mini-batch
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dodt_tpu_torch.config import PipelineConfig
from dodt_tpu_torch.models.backbone import (VggPyramid, preprocess_image,
                                             tower_channels)
from dodt_tpu_torch.models.dt_avod import (Bottleneck, FcTrunk, MlpHead,
                                           Rand, _path_drop_masks, _resize_to,
                                           _take, anchors_and_mask,
                                           bev_anchor_rois, bev_crop_fn,
                                           select_finals, select_proposals,
                                           tower_forward)
from dodt_tpu_torch.models.graphs import GraphCache
from dodt_tpu_torch.ops import boxes as box_ops
from dodt_tpu_torch.ops import sampling
from dodt_tpu_torch.ops.dense_rpn import build_bev_lattice
from dodt_tpu_torch.ops.iou import aligned_iou_matrix
from dodt_tpu_torch.ops.losses import weighted_smooth_l1
from dodt_tpu_torch.ops.projection import (project_to_bev,
                                           project_to_image_space,
                                           reorder_boxes_yx)
from dodt_tpu_torch.ops.roi import crop_and_resize
from dodt_tpu_torch.ops.voxel import bev_maps_from_points
from dodt_tpu_torch.utils.metrics import span


class StackCorrHead(nn.Module):
    """Concat paired ROI features (M, S, S, C) -> 1x1 conv + ReLU -> two
    f32 FC stacks -> (coexist logits (M, 2), corr offsets (M, 3))."""

    def __init__(self, c_in: int, crop_size: int, conv_channels: int = 256,
                 fc_sizes: Sequence[int] = (256, 256),
                 keep_prob: float = 0.5):
        super().__init__()
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = nn.Parameter(torch.empty(conv_channels,
                                                      2 * c_in, 1, 1))
        self.Conv_0.bias = nn.Parameter(torch.zeros(conv_channels))
        d = crop_size * crop_size * conv_channels
        self.corr_cls = MlpHead(d, fc_sizes, 2, torch.float32, keep_prob,
                                "stack_corr.corr_cls")
        self.corr_off = MlpHead(d, fc_sizes, 3, torch.float32, keep_prob,
                                "stack_corr.corr_off")

    def forward(self, roi_first: torch.Tensor, roi_last: torch.Tensor,
                rand: Optional[Rand] = None):
        x = torch.cat([roi_first, roi_last], dim=-1)
        w = self.Conv_0.weight
        x = F.relu(F.linear(x, w.reshape(w.shape[0], w.shape[1]),
                            self.Conv_0.bias))
        flat = x.reshape(x.shape[0], -1)
        return self.corr_cls(flat, rand), self.corr_off(flat, rand)


class StackAvodNet(nn.Module):
    """The Stack model over F = data_stride + 1 frames per sample."""

    def __init__(self, cfg: PipelineConfig,
                 cluster_sizes: Tuple[Tuple[float, float, float], ...]):
        super().__init__()
        self.cfg = cfg
        self.cluster_sizes = cluster_sizes
        m = cfg.model
        ku = cfg.dataset.kitti_utils
        dtype = (torch.bfloat16 if m.tower_dtype == "bfloat16"
                 else torch.float32)
        n_in = ku.bev_generator.num_slices + 1
        self.bev_vgg_pyr = VggPyramid(m.bev_extractor, n_in, dtype)
        self.int_bev_vgg_pyr = VggPyramid(m.bev_extractor, n_in, dtype)
        self.img_vgg_pyr = VggPyramid(m.img_extractor, 3, dtype)
        bev_ch = tower_channels(m.bev_extractor)
        img_ch = tower_channels(m.img_extractor)
        if bev_ch != img_ch:
            raise ValueError("the Stack model's mean fusion needs equal "
                             "tower widths")
        bch = m.rpn.bottleneck_channels
        self.int_bev_bottleneck = Bottleneck(bev_ch, bch)
        self.img_bottleneck = Bottleneck(img_ch, bch)
        rpn_in = m.rpn.proposal_roi_crop_size ** 2 * bch
        self.rpn_cls = MlpHead(rpn_in, m.rpn.cls_fc_sizes, 2, dtype,
                               m.rpn.keep_prob, "rpn_cls")
        self.rpn_reg = MlpHead(rpn_in, m.rpn.reg_fc_sizes, 6, dtype,
                               m.rpn.keep_prob, "rpn_reg")
        s = m.avod.proposal_roi_crop_size
        self.avod_fc = FcTrunk(s * s * bev_ch, m.avod.fc_layer_sizes,
                               (self.num_classes, 10, 2), dtype,
                               m.avod.keep_prob)
        self.stack_corr = StackCorrHead(bev_ch, s,
                                        fc_sizes=m.rpn.corr_fc_sizes,
                                        keep_prob=m.rpn.keep_prob)
        self.lattice = build_bev_lattice(
            ku.area_extents, ku.anchor_strides, cluster_sizes, ku.bev_shape,
            ku.voxel_size, m.rpn.proposal_roi_crop_size)
        # the second stage's CUDA graphs (_run_second_stage)
        self.graphs = GraphCache()

    @property
    def num_classes(self) -> int:
        return len(self.cfg.dataset.classes) + 1

    @staticmethod
    def loss_builder():
        """The Stack loss family, which the Trainer and val_health
        take."""
        return compute_stack_losses

    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "val",
                train: bool = False, rand: Optional[Rand] = None
                ) -> Dict[str, torch.Tensor]:
        """The JAX ``__call__(batch, train, mode)``. batch (B samples, F
        frames): points (B, F, P, 3), points_valid (B, F, P), image (B, F,
        Hi, Wi, 3), ground_plane (B, 4), p2 (B, 3, 4), orig_image_shape
        (B, 2). ``mode="train"`` builds the autograd graph, runs the
        towers without the conv-chain kernel, the second-stage BEV crops
        in the gather form and keeps train_nms_size proposals; other
        modes run under ``torch.no_grad()``. ``train=True`` turns on
        dropout and path drop, whose draws come from ``rand``. Under a
        profiler the call is the span ``dodt/forward`` (module
        docstring)."""
        grad = contextlib.nullcontext() if mode == "train" \
            else torch.no_grad()
        with span("dodt/forward"), grad:
            return self._forward(batch, mode, train, rand)

    def _forward(self, batch, mode, train, rand):
        cfg = self.cfg
        ku = cfg.dataset.kitti_utils
        m = cfg.model
        bg = ku.bev_generator
        train_mode = mode == "train"
        points = batch["points"]
        b, f = points.shape[0], points.shape[1]
        dev = points.device
        gps = batch["ground_plane"].to(torch.float32)
        p2 = batch["p2"]
        img_shapes = batch["orig_image_shape"].to(torch.float32)
        p_img, p_bev = m.path_drop_probabilities
        drop_paths = train and not (p_img == p_bev == 1.0)
        if rand is None and train:
            raise ValueError("forward: dropout and path drop need rand "
                             "(generator_draws)")
        drand = rand if train else None

        def rasterize(p, v, gp):
            return bev_maps_from_points(p, v, gp, ku.area_extents,
                                        ku.voxel_size, bg.height_lo,
                                        bg.height_hi, bg.num_slices)

        # per-frame BEV maps, and the integrated BEV of all frames' points
        with span("dodt/rasterize"):
            frame_maps = [rasterize(p, v, gp) for p, v, gp in zip(
                points.flatten(0, 1), batch["points_valid"].flatten(0, 1),
                gps.repeat_interleave(f, dim=0))]
            with span("dodt/integrate"):
                int_maps = [rasterize(p, v, gp) for p, v, gp in zip(
                    points.reshape(b, -1, 3),
                    batch["points_valid"].reshape(b, -1), gps)]

            # anchors on the integrated occupancy
            anchors, anchor_valid = anchors_and_mask(
                cfg, self.lattice, self.cluster_sizes, gps,
                [mp.occupancy for mp in int_maps])
            n_anchors = anchors.shape[1]

        fused = not train_mode
        remat = m.remat_towers
        with span("dodt/towers"):
            bev_feats = tower_forward(remat, self.bev_vgg_pyr, torch.stack(
                [mp.features for mp in frame_maps]), fused)     # (B*F, ...)
            int_feats = tower_forward(remat, self.int_bev_vgg_pyr,
                                      torch.stack([mp.features
                                                   for mp in int_maps]),
                                      fused)                    # (B, ...)
            img_feats = tower_forward(remat, self.img_vgg_pyr,
                                      preprocess_image(
                                          batch["image"].flatten(0, 1)),
                                      fused)                    # (B*F, ...)
            int_bottle = _resize_to(self.int_bev_bottleneck(int_feats),
                                    ku.bev_shape)
            # the RPN reads frame 0's image bottleneck only (a per-sample
            # GroupNorm: the other frames' rows do not change it)
            img_bottle0 = self.img_bottleneck(
                img_feats.reshape((b, f) + img_feats.shape[1:])[:, 0])

        img_mask = bev_mask = torch.ones(b, device=dev)
        if drop_paths:
            img_mask, bev_mask = _path_drop_masks(rand("pathdrop", (b, 3)),
                                                  p_img, p_bev)
        fusion_div = img_mask + bev_mask

        # ---- RPN on the integrated BEV + frame-0 image, every anchor ----
        with span("dodt/rpn"):
            crop = m.rpn.proposal_roi_crop_size
            bev_rois = bev_anchor_rois(cfg, self.lattice, int_bottle,
                                       anchors)
            img_rois = torch.stack([
                crop_and_resize(fm, reorder_boxes_yx(project_to_image_space(
                    anc, p2_, sh)[1]), crop)
                for fm, anc, p2_, sh in zip(img_bottle0, anchors, p2,
                                            img_shapes)]).reshape(
                                                b, n_anchors, -1)
            fused_rois = (bev_rois * bev_mask[:, None, None]
                          + img_rois * img_mask[:, None, None]) \
                / fusion_div[:, None, None]
            flat = fused_rois.reshape(b * n_anchors, -1)
            objectness = self.rpn_cls(flat, drand).reshape(b, n_anchors, 2)
            rpn_offsets = self.rpn_reg(flat, drand).reshape(b, n_anchors, 6)

            proposals = box_ops.offset_to_anchor(anchors, rpn_offsets)
            out = {"anchors": anchors, "anchor_valid": anchor_valid,
                   "objectness": objectness, "rpn_offsets": rpn_offsets,
                   **select_proposals(cfg, proposals, objectness,
                                      anchor_valid, train_mode)}
        with span("dodt/second_stage"):
            out.update(self._run_second_stage(
                (bev_feats, img_feats, out["top_anchors"], out["top_valid"],
                 gps, p2, img_shapes, bev_mask, img_mask), train_mode, drand))
        return out

    def _second_stage(self, bev_feats, img_feats, top_anchors, top_valid,
                      gps, p2, img_shapes, bev_mask, img_mask,
                      train_mode: bool = False, rand: Optional[Rand] = None
                      ) -> Dict[str, torch.Tensor]:
        """The proposals' per-frame crops over (B*F, ...) feature rows,
        trunk, stack correlation head, decode and per-frame NMS; returns
        the forward's second-stage outputs. In train mode the BEV crops
        take the gather form; ``rand`` gives the dropout draws."""
        m = self.cfg.model
        ext = self.cfg.dataset.kitti_utils.bev_extents
        b, k = top_anchors.shape[0], top_anchors.shape[1]
        f = bev_feats.shape[0] // b
        _, ss_bev_norm = project_to_bev(top_anchors, ext)
        ss_img_norm = torch.stack([
            project_to_image_space(anc, p2_, sh)[1]
            for anc, p2_, sh in zip(top_anchors, p2, img_shapes)])
        ss_bev_yx = reorder_boxes_yx(ss_bev_norm).repeat_interleave(f, 0)
        ss_img_yx = reorder_boxes_yx(ss_img_norm).repeat_interleave(f, 0)
        s = m.avod.proposal_roi_crop_size
        bev_crop = bev_crop_fn(s, m.avod.bev_roi_window, train_mode,
                               bev_feats.shape[1:], bev_feats.device)
        # (B*F, K, S, S, C)
        ss_bev_rois = bev_crop(bev_feats, ss_bev_yx)
        ss_img_rois = torch.stack([crop_and_resize(fm, bx, s) for fm, bx
                                   in zip(img_feats, ss_img_yx)])
        fusion_div = img_mask + bev_mask
        bm = bev_mask.repeat_interleave(f)[:, None, None, None, None]
        im = img_mask.repeat_interleave(f)[:, None, None, None, None]
        dv = fusion_div.repeat_interleave(f)[:, None, None, None, None]
        ss_fused = ((ss_bev_rois * bm + ss_img_rois * im) / dv
                    ).reshape((b, f) + ss_bev_rois.shape[1:])
        # ss_fused: (B, F, K, S, S, C)
        cls_logits, box_offsets, angle_vecs = self.avod_fc(
            ss_fused.reshape(b * f * k, -1), rand)
        cls_logits = cls_logits.reshape(b, f, k, self.num_classes)
        box_offsets = box_offsets.reshape(b, f, k, 10)
        angle_vecs = angle_vecs.reshape(b, f, k, 2)

        # ---- stack correlation head (first vs last frame ROIs) -------
        with span("dodt/stack_corr"):
            roi_first = ss_fused[:, 0].reshape((b * k,) + ss_fused.shape[3:])
            roi_last = ss_fused[:, -1].reshape((b * k,) + ss_fused.shape[3:])
            coexist_logits, corr_offsets = self.stack_corr(
                roi_first, roi_last, rand)
            coexist_logits = coexist_logits.reshape(b, k, 2)
            corr_offsets = corr_offsets.reshape(b, k, 3)

        # ---- decode + per-frame NMS -----------------------------------
        prop_boxes_3d = box_ops.anchors_to_box_3d(top_anchors, fix_lw=True)
        prop_4c = box_ops.box_3d_to_box_4c(prop_boxes_3d, gps[:, None, :])
        pred_boxes_3d = box_ops.box_4c_to_box_3d(prop_4c[:, None]
                                                 + box_offsets,
                                                 gps[:, None, None, :])
        pred_orient = box_ops.angle_vector_to_orientation(angle_vecs)
        finals = select_finals(self.cfg, pred_boxes_3d, pred_orient,
                               cls_logits, top_valid[:, None].expand(b, f, k))
        f0 = finals["final_indices"][:, 0]
        coexist = torch.softmax(coexist_logits, dim=-1)[..., 1]
        return {
            "proposal_4c": prop_4c,
            "cls_logits": cls_logits, "box_offsets": box_offsets,
            "angle_vectors": angle_vecs,
            "coexist_logits": coexist_logits, "corr_pred": corr_offsets,
            "pred_boxes_3d": pred_boxes_3d, **finals,
            "final_corr_offsets": _take(corr_offsets, f0, 1),
            "final_coexist": _take(coexist, f0, 1),
        }

    def _run_second_stage(self, sources: Sequence[torch.Tensor],
                          train_mode: bool, rand: Optional[Rand]
                          ) -> Dict[str, torch.Tensor]:
        """``_second_stage(*sources)``: a graph replay (keyed on
        ``train_mode`` and the NMS mode) or an eager call, by
        ``GraphCache``'s rule."""
        return self.graphs.call(
            lambda *inputs: self._second_stage(
                *inputs, train_mode=train_mode, rand=rand),
            sources, (train_mode, self.cfg.model.nms_mode),
            (self.avod_fc, self.stack_corr), rand)


def compute_stack_losses(cfg: PipelineConfig,
                         outputs: Dict[str, torch.Tensor],
                         batch: Dict[str, torch.Tensor], rand: Rand
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RPN (merged GT) + per-frame AVOD + coexist CE + corr smooth-L1
    (stack.py:350-482; reference stack_avod_loss_builder.py:488), batched
    over samples and frames. Mini-batch draws come from ``rand``
    ("stack_loss_rpn", "stack_loss_avod"; module docstring). Returns
    (total, {rpn_cls, rpn_reg, avod_cls, avod_reg, avod_ang, coexist,
    corr, total})."""
    ku = cfg.dataset.kitti_utils
    mbc = cfg.dataset.mini_batch
    lw = cfg.model.loss
    eps = cfg.model.label_smoothing_epsilon
    ext = ku.bev_extents

    anchors = outputs["anchors"]                          # (B, N, 6)
    b, n = anchors.shape[0], anchors.shape[1]
    f = outputs["cls_logits"].shape[1]
    num_classes = outputs["cls_logits"].shape[-1]

    def ce(logits, labels, eps_):
        onehot = F.one_hot(labels, logits.shape[-1]).to(torch.float32) \
            * (1 - 2 * eps_) + eps_
        return -(onehot * F.log_softmax(logits, dim=-1)).sum(-1)

    def per_selected(values, sel, weight):
        return (values * sel).sum(-1) * weight / torch.clamp(sel.sum(-1),
                                                             min=1)

    # ---- RPN on the merged (hull) GT -----------------------------------
    merged = batch["merged_boxes"].to(torch.float32)      # (B, G, 7)
    merged_valid = batch["merged_valid"].bool()
    merged_anchors = box_ops.box_3d_to_anchor(merged, ortho_rotate=True)
    merged_bev, _ = project_to_bev(merged_anchors, ext)
    anchors_bev, _ = project_to_bev(anchors, ext)
    valid = outputs["anchor_valid"]
    tgt = sampling.assign_targets(anchors_bev, anchors, merged_bev,
                                  merged_anchors,
                                  batch["merged_classes"].long(),
                                  merged_valid)
    sel, pos = sampling.sample_mini_batch(
        rand("stack_loss_rpn", (b, 2, n)),
        torch.where(valid, tgt.max_iou, 0.0), mbc.rpn_mini_batch_size,
        mbc.rpn_neg_iou_range, mbc.rpn_pos_iou_range)
    sel &= valid
    pos &= valid
    posw = pos.to(torch.float32)
    rpn_cls = per_selected(ce(outputs["objectness"], pos.long(), eps),
                           sel.to(torch.float32), lw.cls_loss_weight)
    rpn_reg = (weighted_smooth_l1(outputs["rpn_offsets"], tgt.offsets,
                                  posw).sum(-1)
               * lw.reg_loss_weight / torch.clamp(posw.sum(-1), min=1))

    # ---- per-frame second stage -----------------------------------------
    top_anchors = outputs["top_anchors"]                  # (B, K, 6)
    top_valid = outputs["top_valid"]
    k = top_anchors.shape[1]
    top_bev, _ = project_to_bev(top_anchors, ext)
    gt_boxes = batch["gt_boxes"].to(torch.float32)        # (B, F, G, 7)
    gt_valid = batch["gt_valid"].bool()
    gt_anchors = box_ops.box_3d_to_anchor(gt_boxes, ortho_rotate=True)
    gt_bev, _ = project_to_bev(gt_anchors, ext)
    iou = torch.where(gt_valid[:, :, None, :],
                      aligned_iou_matrix(top_bev[:, None], gt_bev), -1.0)
    max_iou, gt_index = iou.max(dim=-1)                   # (B, F, K)
    tv = top_valid[:, None].expand(b, f, k)
    sel, pos = sampling.sample_mini_batch(
        rand("stack_loss_avod", (b, f, 2, k)),
        torch.where(tv, torch.clamp(max_iou, min=0.0), 0.0),
        mbc.avod_mini_batch_size, mbc.avod_neg_iou_range,
        mbc.avod_pos_iou_range)
    sel &= tv
    pos &= tv
    posw = pos.to(torch.float32)
    num_pos = torch.clamp(posw.sum(-1), min=1)
    cls_gt = torch.where(pos, _take(batch["gt_classes"].long(), gt_index,
                                    2), 0)
    avod_cls = per_selected(ce(outputs["cls_logits"], cls_gt, eps),
                            sel.to(torch.float32), lw.cls_loss_weight)
    gt_best = _take(gt_boxes, gt_index, 2)                # (B, F, K, 7)
    gt_4c = box_ops.box_3d_to_box_4c(
        gt_best, batch["ground_plane"].to(torch.float32)[:, None, None, :])
    avod_reg = (weighted_smooth_l1(outputs["box_offsets"],
                                   gt_4c - outputs["proposal_4c"][:, None],
                                   posw).sum(-1)
                * lw.reg_loss_weight / num_pos)
    ang_gt = box_ops.orientation_to_angle_vector(gt_best[..., 6])
    avod_ang = (weighted_smooth_l1(outputs["angle_vectors"], ang_gt,
                                   posw).sum(-1)
                * lw.ang_loss_weight / num_pos)

    # ---- coexist + motion: positives matched to the merged GT rows -----
    iou = torch.where(merged_valid[:, None, :],
                      aligned_iou_matrix(top_bev, merged_bev), -1.0)
    best, gt_index = iou.max(dim=-1)                      # (B, K)
    pos = top_valid & (best > 0.5)
    both = _take(batch["coexist"].to(torch.float32), gt_index, 1) == 0.0
    posw = pos.to(torch.float32)
    coexist = per_selected(ce(outputs["coexist_logits"], both.long(), 0.0),
                           posw, lw.cls_loss_weight)
    w = posw * both.to(torch.float32)
    corr_gt = _take(batch["corr_offsets"].to(torch.float32), gt_index, 1)
    corr = (weighted_smooth_l1(outputs["corr_pred"], corr_gt, w).sum(-1)
            * lw.corr_loss_weight / torch.clamp(w.sum(-1), min=1))

    losses = {"rpn_cls": rpn_cls.mean(), "rpn_reg": rpn_reg.mean(),
              "avod_cls": avod_cls.mean(), "avod_reg": avod_reg.mean(),
              "avod_ang": avod_ang.mean(), "coexist": coexist.mean(),
              "corr": corr.mean()}
    total = sum(losses.values())
    losses["total"] = total
    return total, losses
