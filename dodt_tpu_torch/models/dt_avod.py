"""DODT detector (PyTorch port of dodt_tpu/models/dt_avod.py): the
monolithic forward ``__call__`` as ``forward`` in val and train mode, for
the paired model (``num_frames=2``, with the correlation branch) and the
single-frame AVOD detector (``num_frames=1``, without it), the streaming
``encode_frame`` and ``pair_stage``, and ``compute_losses``. Anchor
geometry on the BEV pixel lattice takes the dense lattice RPN
(ops/dense_rpn.py); any other takes the per-anchor form (the occupancy
filter per anchor, BEV ROIs by crop_and_resize).

Module and parameter names follow the Flax tree, so ``convert.py`` maps a
JAX checkpoint onto ``DtAvodNet.state_dict()`` one to one. Public tensors
are NHWC like the JAX package's.

Randomness (dropout, path drop, mini-batch sampling) comes from a
``rand(name, shape)`` callable returning uniform [0, 1) float32 draws:
``generator_draws`` wraps an explicit ``torch.Generator``, and the tests
inject the JAX package's draws under the same names:

  pathdrop        (B, 3)          path-drop coin flips
  <module>.<fc>   activation      dropout after each hidden FC layer
                                  (e.g. ``rpn_cls.fc6``, ``avod_fc.fc0``)
  rpn_mb          (B*F, 2, N)     in-forward RPN mini-batch, per frame row
  loss_rpn        (B, F, 2, N)    RPN mini-batch in compute_losses
  loss_avod       (B, F, 2, K)    second-stage mini-batch

The (…, 2, N) draws rank positives ([..., 0, :]) and negatives
([..., 1, :]), see ops/sampling.py.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dodt_tpu_torch.config import PipelineConfig
from dodt_tpu_torch.models.backbone import (GroupNorm, VggPyramid,
                                             preprocess_image,
                                             tower_channels)
from dodt_tpu_torch.models.graphs import GraphCache
from dodt_tpu_torch.ops import boxes as box_ops
from dodt_tpu_torch.ops import sampling
from dodt_tpu_torch.ops.losses import weighted_smooth_l1
from dodt_tpu_torch.ops.anchors import (empty_anchor_mask,
                                        integral_image_2d, tile_anchors_3d)
from dodt_tpu_torch.ops.correlation import corr_bottleneck, disp_grid
from dodt_tpu_torch.ops.resize import resize_bilinear
from dodt_tpu_torch.ops.dense_rpn import (build_bev_lattice, dense_bev_rois,
                                          dense_empty_anchor_mask)
from dodt_tpu_torch.ops.nms import nms_bev_mode, top_k, top_k_prefilter
from dodt_tpu_torch.ops.projection import (project_to_bev,
                                           project_to_image_space,
                                           reorder_boxes_yx)
from dodt_tpu_torch.ops.roi import crop_and_resize
from dodt_tpu_torch.ops.iou import aligned_iou_matrix
from dodt_tpu_torch.ops.roi_window import (crop_and_resize_window,
                                           window_applies)
from dodt_tpu_torch.ops.voxel import bev_maps_from_points
from dodt_tpu_torch.parallel.mesh import column_linear
from dodt_tpu_torch.utils.metrics import span

Rand = Callable[[str, Tuple[int, ...]], torch.Tensor]

# box-representation output sizes (dt_avod.py:166-169)
OFFSETS_SIZE = {"box_3d": 6, "box_8c": 24, "box_8co": 24,
                "box_4c": 10, "box_4ca": 10}
ANGLE_SIZE = {"box_3d": 2, "box_8c": 0, "box_8co": 0,
              "box_4c": 0, "box_4ca": 2}
# the decoded detections: what pair_stage returns and the evaluator reads
FINAL_KEYS = ("final_boxes_3d", "final_orientations", "final_cls_softmax",
              "final_scores", "final_valid", "final_corr_offsets")


def generator_draws(generator: torch.Generator) -> Rand:
    """``rand`` drawing from ``generator`` on the generator's device."""
    def rand(name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.rand(shape, generator=generator,
                          device=generator.device)
    return rand


def table_draws(table: Dict[str, np.ndarray], device="cpu") -> Rand:
    """``rand`` returning draws made elsewhere (another framework, or
    another process), one per name; a call for another shape raises."""
    def rand(name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        u = table[name]
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"draw {name}: table holds {u.shape}, the "
                             f"model asks for {shape}")
        return torch.as_tensor(u, device=device)
    return rand


def dropout(x: torch.Tensor, keep_prob: float, rand: Optional[Rand],
            name: str) -> torch.Tensor:
    """Flax ``nn.Dropout(1 - keep_prob)``: keep where the draw is below
    the keep probability, scaled by its inverse; ``rand`` None is
    deterministic."""
    rate = 1.0 - keep_prob
    if rand is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    u = rand(name, tuple(x.shape))
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Dense(nn.Module):
    """Linear layer computing in a given dtype; weight (out, in).

    Tensor-parallel on a mesh (parallel/mesh.py): a weight holding fewer
    rows than the bias is this rank's block of output columns, computed
    here and gathered over the mesh's model group (``tp``, set by
    ``mesh.shard_module``)."""

    tp = None

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x, w, b = x.to(dtype), self.weight.to(dtype), self.bias.to(dtype)
        if w.shape[0] == b.shape[0]:
            return F.linear(x, w, b)
        if self.tp is None:
            raise ValueError(f"a ({w.shape[0]}, {w.shape[1]}) block of a "
                             f"{b.shape[0]}-column Dense without a mesh")
        return column_linear(x, w, b, self.tp)


class MlpHead(nn.Module):
    """FC stack ``fc6, fc7, ...`` with dropout + linear ``out``; computes
    in ``dtype`` and returns f32. ``scope`` names the dropout draws."""

    def __init__(self, d_in: int, sizes: Sequence[int], d_out: int,
                 dtype: torch.dtype, keep_prob: float, scope: str):
        super().__init__()
        self.dtype = dtype
        self.keep_prob = keep_prob
        self.scope = scope
        self.n_hidden = len(sizes)
        for i, s in enumerate(sizes):
            self.add_module(f"fc{6 + i}", Dense(d_in, s))
            d_in = s
        self.out = Dense(d_in, d_out)

    def forward(self, x: torch.Tensor, rand: Optional[Rand] = None
                ) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"fc{6 + i}")(x, self.dtype))
            x = dropout(x, self.keep_prob, rand, f"{self.scope}.fc{6 + i}")
        return self.out(x, self.dtype).to(torch.float32)


def feature_fuse(a: torch.Tensor, b: torch.Tensor, wa, wb,
                 method: str) -> torch.Tensor:
    """Two-branch fusion (mean | concat | max) of pre-weighted inputs;
    the weights are floats or broadcastable path-drop masks."""
    a = a * wa
    b = b * wb
    if method == "concat":
        return torch.cat([a, b], dim=-1)
    if method == "max":
        return torch.maximum(a, b)
    div = wa + wb
    if isinstance(div, torch.Tensor):
        return (a + b) / torch.clamp(div, min=1.0)
    return (a + b) / max(div, 1.0)


class FcTrunk(nn.Module):
    """Shared FC trunk ``fc0..`` with dropout, one linear ``out{i}`` per
    output branch. Computes in ``dtype``, returns f32; ``scope`` names
    the dropout draws."""

    def __init__(self, d_in: int, sizes: Sequence[int],
                 out_dims: Sequence[int], dtype: torch.dtype,
                 keep_prob: float, scope: str = "avod_fc"):
        super().__init__()
        self.dtype = dtype
        self.keep_prob = keep_prob
        self.scope = scope
        self.n_hidden = len(sizes)
        for i, s in enumerate(sizes):
            self.add_module(f"fc{i}", Dense(d_in, s))
            d_in = s
        self.n_out = len(out_dims)
        for i, o in enumerate(out_dims):
            self.add_module(f"out{i}", Dense(d_in, o))

    def forward(self, h: torch.Tensor, rand: Optional[Rand] = None
                ) -> Tuple[torch.Tensor, ...]:
        h = h.to(self.dtype)
        for i in range(self.n_hidden):
            h = F.relu(getattr(self, f"fc{i}")(h, self.dtype))
            h = dropout(h, self.keep_prob, rand, f"{self.scope}.fc{i}")
        return tuple(getattr(self, f"out{i}")(h, self.dtype)
                     .to(torch.float32) for i in range(self.n_out))


class AvodTrunk(nn.Module):
    """Second-stage FC trunk over (bev, img) ROI features, then one
    linear ``out{i}`` per output branch; computes in ``dtype``, returns
    f32. ``fusion_type`` (JAX dt_avod.py:134-154):

      early   fuse (bev, img), then ``fc{i}``
      late    separate ``bev_fc{i}`` and ``img_fc{i}`` stacks, then fuse
              the last hiddens
      deep    fuse before every layer; ``bev_fc{i}`` and ``img_fc{i}``
              both take the fusion, and the last hiddens fuse

    with ``fusion_method`` mean | concat | max (``feature_fuse``). The
    path-drop weights wb, wi weight the inputs' fusion (and, late, the
    hiddens'). Dropout follows every hidden layer, one draw per Flax
    ``nn.Dropout`` call in JAX's order: ``avod_fc.fc{i}`` (early),
    ``avod_fc.bev_fc{i}`` then ``avod_fc.img_fc{i}`` per layer (late,
    deep)."""

    def __init__(self, d_bev: int, d_img: int, sizes: Sequence[int],
                 out_dims: Sequence[int], fusion_type: str,
                 fusion_method: str, dtype: torch.dtype, keep_prob: float):
        super().__init__()
        if fusion_type not in ("early", "late", "deep"):
            raise ValueError(f"fusion_type {fusion_type!r}")
        self.fusion_type = fusion_type
        self.fusion_method = fusion_method
        self.dtype = dtype
        self.keep_prob = keep_prob
        self.n_hidden = len(sizes)
        self.n_out = len(out_dims)

        def fused(a: int, b: int) -> int:
            return a + b if fusion_method == "concat" else a

        d = fused(d_bev, d_img)                  # the fusion's width
        for i, s in enumerate(sizes):
            if fusion_type == "early":
                self.add_module(f"fc{i}", Dense(d, s))
                d = s
            elif fusion_type == "deep":
                self.add_module(f"bev_fc{i}", Dense(d, s))
                self.add_module(f"img_fc{i}", Dense(d, s))
                d = fused(s, s)
            else:
                self.add_module(f"bev_fc{i}", Dense(d_bev, s))
                self.add_module(f"img_fc{i}", Dense(d_img, s))
                d_bev = d_img = s
                d = fused(s, s)
        for i, o in enumerate(out_dims):
            self.add_module(f"out{i}", Dense(d, o))

    def _layer(self, name: str, x: torch.Tensor, rand: Optional[Rand]
               ) -> torch.Tensor:
        x = F.relu(getattr(self, name)(x, self.dtype))
        return dropout(x, self.keep_prob, rand, f"avod_fc.{name}")

    def forward(self, bev: torch.Tensor, img: torch.Tensor, wb, wi,
                rand: Optional[Rand] = None) -> Tuple[torch.Tensor, ...]:
        """wb, wi: floats or (M, 1) path-drop masks, applied in the
        compute dtype as the Flax module does."""
        if isinstance(wb, torch.Tensor):
            wb, wi = wb.to(self.dtype), wi.to(self.dtype)
        bev, img = bev.to(self.dtype), img.to(self.dtype)
        method = self.fusion_method
        if self.fusion_type == "late":
            hb, hi = bev, img
            for i in range(self.n_hidden):
                hb = self._layer(f"bev_fc{i}", hb, rand)
                hi = self._layer(f"img_fc{i}", hi, rand)
            h = feature_fuse(hb, hi, wb, wi, method)
        elif self.fusion_type == "deep":
            h = feature_fuse(bev, img, wb, wi, method)
            for i in range(self.n_hidden):
                if i:
                    h = feature_fuse(hb, hi, 1.0, 1.0, method)
                hb = self._layer(f"bev_fc{i}", h, rand)
                hi = self._layer(f"img_fc{i}", h, rand)
            h = feature_fuse(hb, hi, 1.0, 1.0, method)
        else:
            h = feature_fuse(bev, img, wb, wi, method)
            for i in range(self.n_hidden):
                h = self._layer(f"fc{i}", h, rand)
        return tuple(getattr(self, f"out{i}")(h, self.dtype)
                     .to(torch.float32) for i in range(self.n_out))


class Bottleneck(nn.Module):
    """1x1 conv + GroupNorm(1) + ReLU over NHWC f32."""

    def __init__(self, ci: int, co: int):
        super().__init__()
        self.Conv_0 = nn.Module()
        self.Conv_0.weight = nn.Parameter(torch.empty(co, ci, 1, 1))
        self.Conv_0.bias = nn.Parameter(torch.zeros(co))
        self.GroupNorm_0 = GroupNorm(co)

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
        self.GroupNorm_0 = GroupNorm(channels)

    def forward(self, feat_a: torch.Tensor, feat_b: torch.Tensor
                ) -> torch.Tensor:
        x_cf = corr_bottleneck(feat_a, feat_b, self.weight.t(),
                               self.max_displacement, self.stride_2)
        x = x_cf.permute(0, 2, 3, 1) + self.bias
        return F.relu(self.GroupNorm_0(x))


def encode_proposals(rep: str, prop_boxes_3d: torch.Tensor,
                     top_anchors: torch.Tensor, gp4) -> torch.Tensor:
    """Proposals in the regression representation: box_4c corners,
    box_8c's 24 corner coordinates, or (box_3d) the anchors
    themselves."""
    if rep in ("box_4c", "box_4ca"):
        return box_ops.box_3d_to_box_4c(prop_boxes_3d, gp4)
    if rep in ("box_8c", "box_8co"):
        c = box_ops.box_3d_to_box_8c(prop_boxes_3d)
        return c.reshape(c.shape[:-2] + (24,))
    return top_anchors


def decode_predictions(rep: str, prop_enc, box_offsets, angle_vecs, gp4):
    """Apply the predicted offsets; (pred_boxes_3d, pred_orientations)."""
    if rep in ("box_4c", "box_4ca"):
        boxes = box_ops.box_4c_to_box_3d(prop_enc + box_offsets, gp4)
    elif rep in ("box_8c", "box_8co"):
        boxes = box_ops.box_8c_to_box_3d((prop_enc + box_offsets).reshape(
            prop_enc.shape[:-1] + (3, 8)))
    else:                                            # box_3d
        boxes = box_ops.anchors_to_box_3d(
            box_ops.offset_to_anchor(prop_enc, box_offsets), fix_lw=True)
    if angle_vecs is not None:
        return boxes, box_ops.angle_vector_to_orientation(angle_vecs)
    return boxes, boxes[..., 6]


def _resize_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear-upsample NHWC (B, h, w, C) to (B, H, W, C) if needed
    (jax.image.resize "bilinear"; its backward is deterministic)."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return resize_bilinear(x, hw)


def bev_crop_fn(crop_size: int, window: int, train: bool, map_shape,
                device):
    """Second-stage BEV crop over (M, H, W, C) maps and (M, N, 4) boxes:
    the windowed kernel (B2) at eval on the card when the map and its
    channel alignment leave the window slack, the gather form (with
    autograd) in training, otherwise and on the CPU (the JAX model's
    dispatch, dt_avod.py:172-193)."""
    if (not train and device.type != "cpu"
            and window_applies(*map_shape, crop_size, window)):
        return lambda maps, bx: crop_and_resize_window(maps, bx, crop_size,
                                                       window)
    return lambda maps, bx: torch.stack(
        [crop_and_resize(fm, b, crop_size) for fm, b in zip(maps, bx)])


def tower_forward(remat: bool, tower: VggPyramid, x: torch.Tensor,
                  fused: bool) -> torch.Tensor:
    """A tower in f32 out; ``remat`` recomputes its activations in the
    backward (the JAX model's nn.remat, dt_avod.py:283-288)."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        y = checkpoint(tower, x, fused, use_reentrant=False)
    else:
        y = tower(x, fused)
    return y.to(torch.float32)


def anchor_valid_mask(cfg: PipelineConfig, lattice, occupancy: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """(N,) anchors over at least density_threshold occupied cells of
    one (X, Z) occupancy grid: the lattice's strided form, or per anchor
    (N, 6) off the lattice."""
    ku = cfg.dataset.kitti_utils
    integral = integral_image_2d(occupancy)
    if lattice is not None:
        return dense_empty_anchor_mask(integral, lattice,
                                       ku.density_threshold)
    return empty_anchor_mask(integral, anchors, ku.bev_extents,
                             ku.voxel_size, ku.density_threshold)


def bev_anchor_rois(cfg: PipelineConfig, lattice, bev_bottle: torch.Tensor,
                    anchors: torch.Tensor) -> torch.Tensor:
    """Every anchor's RPN BEV ROI over (M, H, W, C) maps, (M, N, S*S*C):
    the lattice's gather-free crops, or off the lattice crop_and_resize
    of the anchors' (M, N, 6) BEV boxes in y-x order."""
    m, n = anchors.shape[0], anchors.shape[1]
    if lattice is not None:
        rois = [dense_bev_rois(fm, lattice) for fm in bev_bottle]
    else:
        _, norm = project_to_bev(anchors, cfg.dataset.kitti_utils.bev_extents)
        rois = [crop_and_resize(fm, bx, cfg.model.rpn.proposal_roi_crop_size)
                for fm, bx in zip(bev_bottle, reorder_boxes_yx(norm))]
    return torch.stack(rois).reshape(m, n, -1)


def anchors_and_mask(cfg: PipelineConfig, lattice, cluster_sizes, gps,
                     occupancies) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's anchors (M, N, 6) on its ground plane and their
    ``anchor_valid_mask`` (M, N) over its occupancy grid."""
    ku = cfg.dataset.kitti_utils
    sizes = np.asarray(cluster_sizes, np.float32)
    anchors = torch.stack([box_ops.box_3d_to_anchor(tile_anchors_3d(
        ku.area_extents, sizes, ku.anchor_strides, gp)) for gp in gps])
    return anchors, torch.stack([
        anchor_valid_mask(cfg, lattice, occ, anc)
        for occ, anc in zip(occupancies, anchors)])


def select_proposals(cfg: PipelineConfig, proposals: torch.Tensor,
                     objectness: torch.Tensor, valid: torch.Tensor,
                     train_mode: bool) -> Dict[str, torch.Tensor]:
    """top_anchors, top_scores and top_valid of (M, N, 6) proposals:
    the prefilter's 4 k best scores, then NMS down to k (test_nms_size,
    train_nms_size in train mode)."""
    m = cfg.model
    _, prop_bev_norm = project_to_bev(proposals,
                                      cfg.dataset.kitti_utils.bev_extents)
    obj_scores = torch.softmax(objectness, dim=-1)[..., 1]
    obj_scores = torch.where(valid, obj_scores, -1.0)
    k_rpn = m.rpn.train_nms_size if train_mode else m.rpn.test_nms_size
    pre_idx, pre_valid = top_k_prefilter(
        torch.where(valid, obj_scores, -1e9), valid,
        min(4 * k_rpn, proposals.shape[1]))
    keep, top_valid = nms_bev_mode(m.nms_mode)(  # indices: no graph
        _take(prop_bev_norm.detach(), pre_idx, 1),
        _take(obj_scores.detach(), pre_idx, 1), pre_valid, k_rpn,
        m.rpn.nms_iou_thresh)
    top_idx = _take(pre_idx, keep, 1)
    return {"top_anchors": _take(proposals, top_idx, 1),
            "top_scores": _take(obj_scores, top_idx, 1),
            "top_valid": top_valid}


def select_finals(cfg: PipelineConfig, pred_boxes_3d: torch.Tensor,
                  pred_orient: torch.Tensor, cls_logits: torch.Tensor,
                  top_valid: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The six ``final_*`` outputs of (B, F, K) predictions: NMS of
    their BEV boxes by best class score down to avod nms_size."""
    m = cfg.model
    pred_anchors = box_ops.box_3d_to_anchor(pred_boxes_3d.detach(),
                                            ortho_rotate=True)
    _, pred_bev_norm = project_to_bev(pred_anchors,
                                      cfg.dataset.kitti_utils.bev_extents)
    cls_softmax = torch.softmax(cls_logits, dim=-1)
    final_scores_all = cls_softmax[..., 1:].amax(dim=-1)
    f_idx, f_valid = nms_bev_mode(m.nms_mode)(
        pred_bev_norm, final_scores_all.detach(), top_valid,
        m.avod.nms_size, m.avod.nms_iou_thresh)
    return {"final_indices": f_idx,
            "final_valid": f_valid & _take(top_valid, f_idx, 2),
            "final_boxes_3d": _take(pred_boxes_3d, f_idx, 2),
            "final_orientations": _take(pred_orient, f_idx, 2),
            "final_cls_softmax": _take(cls_softmax, f_idx, 2),
            "final_scores": _take(final_scores_all, f_idx, 2)}


@functools.lru_cache(maxsize=None)
def _expand_offset(expand: float, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The ``expand_proposals_xz`` widening [0, 0, 0, e, 0, e] of an
    anchor, made on the CPU and kept per device (a copy from the host
    on every call waits for the card)."""
    return torch.tensor([0.0, 0.0, 0.0, expand, 0.0, expand],
                        dtype=dtype).to(device)


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """take_along_axis with idx broadcast over x's trailing dims."""
    extra = x.dim() - idx.dim()
    idx = idx.reshape(idx.shape + (1,) * extra)
    return torch.gather(x, dim, idx.expand(idx.shape[:dim + 1]
                                           + x.shape[dim + 1:]))


def _path_drop_masks(rnd: torch.Tensor, p_img: float, p_bev: float):
    """Per-sample path-drop coin flips from (B, 3) draws: keep each
    branch with its probability; when both die, the third draw revives
    one."""
    img_chance = (rnd[:, 0] < p_img).to(torch.float32)
    bev_chance = (rnd[:, 1] < p_bev).to(torch.float32)
    both_dead = (img_chance + bev_chance) < 0.5
    img_second = (rnd[:, 2] > 0.5).to(torch.float32)
    bev_second = 1.0 - img_second
    return (torch.where(both_dead, img_second, img_chance),
            torch.where(both_dead, bev_second, bev_chance))


class _TrainCtx:
    """What the monolithic forward threads through the stages: dropout
    draws (None: deterministic), per-row path-drop masks, the RPN
    mini-batch inputs (None: not sampled), and ``monolithic`` (False
    for the streaming ``encode_frame``)."""

    def __init__(self, rand=None, bev_w=None, img_w=None, train_mode=False,
                 mb=None, monolithic=False):
        self.rand = rand
        self.bev_w, self.img_w = bev_w, img_w
        self.train_mode = train_mode
        self.mb = mb
        self.monolithic = monolithic


_EVAL = _TrainCtx()


class DtAvodNet(nn.Module):
    """AVOD over ``num_frames`` frames per sample: the paired model (2,
    with the correlation head) or the single-frame detector (1, without
    it); the monolithic forward (val and train mode) and, for the pair,
    the streaming interface."""

    def __init__(self, cfg: PipelineConfig,
                 cluster_sizes: Tuple[Tuple[float, float, float], ...],
                 num_frames: int = 2):
        super().__init__()
        self.cfg = cfg
        self.cluster_sizes = cluster_sizes
        self.num_frames = num_frames
        m = cfg.model
        ku = cfg.dataset.kitti_utils
        dtype = (torch.bfloat16 if m.tower_dtype == "bfloat16"
                 else torch.float32)
        self.bev_vgg_pyr = VggPyramid(m.bev_extractor,
                                      ku.bev_generator.num_slices + 1, dtype)
        self.img_vgg_pyr = VggPyramid(m.img_extractor, 3, dtype)
        bev_ch = tower_channels(m.bev_extractor)
        img_ch = tower_channels(m.img_extractor)
        bch = m.rpn.bottleneck_channels
        self.bev_bottleneck = Bottleneck(bev_ch, bch)
        self.img_bottleneck = Bottleneck(img_ch, bch)
        if self.correlates:
            self.bev_corr_bottleneck = CorrBottleneck(
                1, m.correlation.max_displacement, m.correlation.stride_2)
        rpn_in = m.rpn.proposal_roi_crop_size ** 2 * bch
        if m.rpn.fusion_method == "concat":
            rpn_in *= 2
        self.rpn_cls = MlpHead(rpn_in, m.rpn.cls_fc_sizes, 2, dtype,
                               m.rpn.keep_prob, "rpn_cls")
        self.rpn_reg = MlpHead(rpn_in, m.rpn.reg_fc_sizes, 6, dtype,
                               m.rpn.keep_prob, "rpn_reg")
        rep = m.avod.box_representation
        out_dims = (self.num_classes, OFFSETS_SIZE[rep])
        if ANGLE_SIZE[rep]:
            out_dims = out_dims + (ANGLE_SIZE[rep],)
        s2 = m.avod.proposal_roi_crop_size ** 2
        if bev_ch != img_ch and m.avod.fusion_method != "concat":
            raise ValueError("mean/max fusion needs equal tower widths")
        self.avod_fc = AvodTrunk(s2 * bev_ch, s2 * img_ch,
                                 m.avod.fc_layer_sizes, out_dims,
                                 m.avod.fusion_type,
                                 m.avod.fusion_method, dtype,
                                 m.avod.keep_prob)
        if self.correlates:
            self.corr_fc = MlpHead(s2, m.avod.fc_layer_sizes, 3, dtype,
                                   m.avod.keep_prob, "corr_fc")
        self.lattice = build_bev_lattice(
            ku.area_extents, ku.anchor_strides, cluster_sizes, ku.bev_shape,
            ku.voxel_size, m.rpn.proposal_roi_crop_size)
        # the second stage's CUDA graphs (_run_second_stage)
        self.graphs = GraphCache()

    @property
    def num_classes(self) -> int:
        return len(self.cfg.dataset.classes) + 1

    @property
    def correlates(self) -> bool:
        """Only the paired model has the correlation branch (the JAX
        model correlates when F == 2)."""
        return self.num_frames == 2

    @staticmethod
    def loss_builder():
        """This model family's losses, which the Trainer and val_health
        take."""
        return compute_losses

    # ------------------------------------------------------------------
    # Shared stages. The streaming interface (encode_frame / pair_stage)
    # and the monolithic forward run the same RPN and second-stage math;
    # the JAX package keeps two copies, the port one.

    def _encode(self, points, points_valid, gps, images, p2, img_shapes,
                ctx: _TrainCtx = _EVAL) -> Dict[str, torch.Tensor]:
        """Encode M frame rows: rasterisation, anchors and the empty-anchor
        mask, both towers over all rows at once, then the RPN (``_rpn``).
        Returns bev_input, anchors (M, N, 6), anchor_valid (M, N), the f32
        tower features and ``_rpn``'s outputs. The conv-chain kernel runs
        on eval paths only. Spans ``dodt/rasterize``, ``dodt/towers``
        (outside any checkpoint, so remat does not replay it) and
        ``dodt/rpn``."""
        ku = self.cfg.dataset.kitti_utils
        bg = ku.bev_generator
        with span("dodt/rasterize"):
            maps = [bev_maps_from_points(p, v, gp, ku.area_extents,
                                         ku.voxel_size, bg.height_lo,
                                         bg.height_hi, bg.num_slices)
                    for p, v, gp in zip(points, points_valid, gps)]
            anchors, anchor_valid = anchors_and_mask(
                self.cfg, self.lattice, self.cluster_sizes, gps,
                [mp.occupancy for mp in maps])
            bev_input = torch.stack([mp.features for mp in maps])
        fused = not ctx.train_mode
        remat = self.cfg.model.remat_towers
        with span("dodt/towers"):
            bev_feats = tower_forward(remat, self.bev_vgg_pyr, bev_input,
                                      fused)
            img_feats = tower_forward(remat, self.img_vgg_pyr,
                                      preprocess_image(images), fused)
        with span("dodt/rpn"):
            rpn = self._rpn(bev_feats, img_feats, anchors, anchor_valid, p2,
                            img_shapes, ctx)
        return {"bev_input": bev_input, "anchors": anchors,
                "anchor_valid": anchor_valid, "bev_feats": bev_feats,
                "img_feats": img_feats, **rpn}

    def _rpn_mini_batch(self, anchors, anchor_valid, mb):
        """The RPN mini-batch sampled inside the forward (IoU-based,
        score-free; dt_avod.py:479-511), per frame row: the indices of
        the rpn_mini_batch_size sampled anchors (selected ones first)
        and their sel / pos masks and offset targets."""
        mbc = self.cfg.dataset.mini_batch
        ext = self.cfg.dataset.kitti_utils.bev_extents
        s_mb = mbc.rpn_mini_batch_size
        if mb["rand"] is None:
            raise ValueError("the RPN mini-batch needs rand "
                             "(generator_draws)")
        u = mb["rand"]("rpn_mb", (anchors.shape[0], 2, anchors.shape[1]))
        gt_anchors = box_ops.box_3d_to_anchor(mb["gt_boxes"],
                                              ortho_rotate=True)
        gt_bev, _ = project_to_bev(gt_anchors, ext)
        anchors_bev, _ = project_to_bev(anchors, ext)
        tgt = sampling.assign_targets(anchors_bev, anchors, gt_bev,
                                      gt_anchors, mb["gt_classes"],
                                      mb["gt_valid"])
        miou = torch.where(anchor_valid, tgt.max_iou, 0.0)
        sel, pos = sampling.sample_mini_batch(
            u, miou, s_mb, mbc.rpn_neg_iou_range,
            mbc.rpn_pos_iou_range)
        sel &= anchor_valid
        pos &= anchor_valid
        _, idx = top_k(sel.to(torch.float32), s_mb)
        return idx, _take(sel, idx, 1), _take(pos, idx, 1), \
            _take(tgt.offsets, idx, 1)

    def _rpn(self, bev_feats, img_feats, anchors, anchor_valid, p2,
             img_shapes, ctx: _TrainCtx = _EVAL) -> Dict[str, torch.Tensor]:
        """Bottlenecks, all-anchor BEV ROIs, RPN with (two-pass) image
        fusion and exact NMS, per frame row: objectness (M, K, 2),
        rpn_offsets (M, K, 6) over the K scored anchors (all of them, or
        the fusion_top_k candidates followed, when ``ctx.mb`` is set, by
        the sampled mini-batch, whose head outputs and targets are
        returned as ``rpn_mb``), and the test_nms_size (train_nms_size in
        train mode) proposals."""
        ku = self.cfg.dataset.kitti_utils
        m = self.cfg.model
        bev_bottle = _resize_to(self.bev_bottleneck(bev_feats),
                                ku.bev_shape)
        img_bottle = self.img_bottleneck(img_feats)

        b, n_anchors = anchors.shape[0], anchors.shape[1]
        crop_size = m.rpn.proposal_roi_crop_size
        ones = anchors.new_ones(b)
        bev_w = (ones if ctx.bev_w is None else ctx.bev_w)[:, None, None]
        img_w = (ones if ctx.img_w is None else ctx.img_w)[:, None, None]
        bev_flat = bev_anchor_rois(self.cfg, self.lattice, bev_bottle,
                                   anchors)
        k_fuse = m.rpn.fusion_top_k
        two_pass = bool(k_fuse) and k_fuse < n_anchors
        sample_mb = two_pass and ctx.mb is not None
        if two_pass:
            # two-pass fusion: rank all anchors by the BEV-only head
            # score (no gradient, no dropout), fuse image ROIs only for
            # the top-K candidates and the sampled mini-batch
            pass1 = feature_fuse(bev_flat.detach(),
                                 torch.zeros_like(bev_flat), bev_w, 0.0,
                                 m.rpn.fusion_method)
            obj1 = self.rpn_cls(pass1.reshape(b * n_anchors, -1)
                                ).reshape(b, n_anchors, 2)
            s1 = torch.where(anchor_valid, obj1[..., 1] - obj1[..., 0],
                             -1e9)
            _, interest = top_k(s1, k_fuse)
            if sample_mb:
                mb_idx, mb_sel, mb_pos, mb_offt = self._rpn_mini_batch(
                    anchors, anchor_valid, ctx.mb)
                interest = torch.cat([interest, mb_idx], dim=-1)
            int_valid = _take(anchor_valid, interest, 1)
            int_anchors = _take(anchors, interest, 1)
            bev_sel = _take(bev_flat, interest, 1)
        else:
            k_fuse = n_anchors
            int_valid, int_anchors, bev_sel = anchor_valid, anchors, bev_flat
        n_int = int_anchors.shape[1]

        img_rois = torch.stack([
            crop_and_resize(fm, reorder_boxes_yx(project_to_image_space(
                anc, p2_, sh)[1]), crop_size)
            for fm, anc, p2_, sh in zip(img_bottle, int_anchors, p2,
                                        img_shapes)])
        if ctx.monolithic and not two_pass:
            # the JAX __call__'s single pass fuses the (S, S, C) crops, so
            # concat interleaves the branches per pixel; its two-pass route
            # and encode_frame concatenate the flattened crops
            fused = feature_fuse(bev_sel.reshape(img_rois.shape), img_rois,
                                 bev_w[..., None, None], img_w[..., None, None],
                                 m.rpn.fusion_method)
        else:
            fused = feature_fuse(bev_sel, img_rois.reshape(b, n_int, -1),
                                 bev_w, img_w, m.rpn.fusion_method)
        flat = fused.reshape(b * n_int, -1)
        objectness = self.rpn_cls(flat, ctx.rand).reshape(b, n_int, 2)
        rpn_offsets = self.rpn_reg(flat, ctx.rand).reshape(b, n_int, 6)
        proposals = box_ops.offset_to_anchor(int_anchors, rpn_offsets)
        out = {}
        if sample_mb:
            out["rpn_mb"] = {"objectness": objectness[:, k_fuse:],
                             "offsets": rpn_offsets[:, k_fuse:],
                             "sel": mb_sel, "pos": mb_pos,
                             "offset_targets": mb_offt}
        # NMS over the candidates, not the appended mini-batch
        return {"objectness": objectness, "rpn_offsets": rpn_offsets,
                **select_proposals(self.cfg, proposals[:, :k_fuse],
                                   objectness[:, :k_fuse],
                                   int_valid[:, :k_fuse], ctx.train_mode),
                **out}

    def _second_stage(self, bev_bf, img_bf, top_anchors, top_valid, gp, p2,
                      img_shapes, expand: float, ctx: _TrainCtx = _EVAL
                      ) -> Dict[str, torch.Tensor]:
        """Correlation of frame 0 against frame 1 (the paired model),
        second-stage crops, trunk, corr head, decode and final NMS over
        (B, F, ...) frame rows. ``expand`` widens the proposals' x/z
        extents for the crops only (``expand_proposals_xz``). In train
        mode the crops take the gather form, so gradients reach the maps
        and, through the proposal coordinates, the RPN regression
        head."""
        ku = self.cfg.dataset.kitti_utils
        m = self.cfg.model
        b, f, k = top_anchors.shape[0:3]
        proj_in = top_anchors
        if expand > 0.0:
            proj_in = top_anchors + _expand_offset(expand, top_anchors.dtype,
                                                   top_anchors.device)
        _, ss_bev_norm = project_to_bev(proj_in, ku.bev_extents)
        ss_img_norm = torch.stack([
            project_to_image_space(anc.reshape(-1, 6), p2_, sh)[1]
            for anc, p2_, sh in zip(proj_in, p2, img_shapes)
        ]).reshape(b, f, k, 4)
        ss_bev_yx = reorder_boxes_yx(ss_bev_norm)
        ss_img_yx = reorder_boxes_yx(ss_img_norm)

        s = m.avod.proposal_roi_crop_size
        bev_maps = bev_bf.flatten(0, 1)                    # (B*F, H, W, C)
        bev_crop = bev_crop_fn(s, m.avod.bev_roi_window, ctx.train_mode,
                               bev_maps.shape[1:], bev_maps.device)
        ss_bev_rois = bev_crop(bev_maps, ss_bev_yx.flatten(0, 1))
        ss_img_rois = torch.stack([
            crop_and_resize(fm, bx, s)
            for fm, bx in zip(img_bf.flatten(0, 1), ss_img_yx.flatten(0, 1))])

        rep = m.avod.box_representation
        wb = wi = 1.0
        if ctx.bev_w is not None:              # per couple -> per ROI row
            wb = ctx.bev_w[::f].repeat_interleave(f * k)[:, None]
            wi = ctx.img_w[::f].repeat_interleave(f * k)[:, None]
        branch = self.avod_fc(ss_bev_rois.reshape(b * f * k, -1),
                              ss_img_rois.reshape(b * f * k, -1), wb, wi,
                              ctx.rand)
        cls_logits = branch[0].reshape(b, f, k, self.num_classes)
        box_offsets = branch[1].reshape(b, f, k, OFFSETS_SIZE[rep])
        angle_vecs = (branch[2].reshape(b, f, k, 2)
                      if ANGLE_SIZE[rep] else None)

        prop_boxes_3d = box_ops.anchors_to_box_3d(top_anchors, fix_lw=True)
        gp4 = gp.to(torch.float32)[:, None, None, :]
        prop_enc = encode_proposals(rep, prop_boxes_3d, top_anchors, gp4)
        pred_boxes_3d, pred_orient = decode_predictions(
            rep, prop_enc, box_offsets, angle_vecs, gp4)

        out = {
            "proposal_boxes_3d": prop_boxes_3d, "proposal_enc": prop_enc,
            "cls_logits": cls_logits, "box_offsets": box_offsets,
            "angle_vectors": angle_vecs,
            "pred_boxes_3d": pred_boxes_3d,
            "pred_orientations": pred_orient,
            **select_finals(self.cfg, pred_boxes_3d, pred_orient,
                            cls_logits, top_valid),
        }
        if self.correlates:
            with span("dodt/correlation"):
                corr_bottle = self.bev_corr_bottleneck(bev_bf[:, 0],
                                                       bev_bf[:, 1])
                corr_rois = torch.stack([
                    crop_and_resize(cm, bx, s)
                    for cm, bx in zip(corr_bottle, ss_bev_yx[:, 0])])
                corr_offsets = self.corr_fc(corr_rois.reshape(b * k, -1),
                                            ctx.rand).reshape(b, k, 3)
            out["corr_pred"] = corr_offsets
            out["final_corr_offsets"] = _take(
                corr_offsets, out["final_indices"][:, 0], 1)
        return out

    def _run_second_stage(self, sources: Sequence, expand: float,
                          ctx: _TrainCtx = _EVAL,
                          keys: Optional[Sequence[str]] = None
                          ) -> Dict[str, torch.Tensor]:
        """``_second_stage``'s outputs (``keys`` of them, or all) over
        ``sources``: bev_bf, img_bf, top_anchors, top_valid, gp, p2,
        img_shapes, each a tensor or a tuple of the pair's two frame
        tensors (stacked on axis 1), then ctx's path-drop weights bev_w
        and img_w (None where absent).

        A graph replay (keyed on ``expand``, ``ctx.train_mode`` and the
        NMS mode) or an eager call, by ``GraphCache``'s rule."""
        def stage(*inputs):
            *args, bev_w, img_w = inputs
            out = self._second_stage(*args, expand, _TrainCtx(
                rand=ctx.rand, bev_w=bev_w, img_w=img_w,
                train_mode=ctx.train_mode))
            return out if keys is None else {k: out[k] for k in keys}

        return self.graphs.call(
            stage, sources, (expand, ctx.train_mode, self.cfg.model.nms_mode),
            [self.avod_fc] + ([self.bev_corr_bottleneck, self.corr_fc]
                              if self.correlates else []), ctx.rand)

    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "val",
                train: bool = False, rand: Optional[Rand] = None
                ) -> Dict[str, torch.Tensor]:
        """The monolithic forward (the JAX ``__call__(batch, train,
        mode)``).

        batch (B samples, F = num_frames frames): points (B, F, P, 3),
        points_valid (B, F, P), image (B, F, Hi, Wi, 3), ground_plane
        (B, 4), p2 (B, 3, 4), orig_image_shape (B, 2); with labels,
        gt_boxes (B, F, G, 7), gt_classes, gt_valid (B, F, G),
        corr_offsets (B, G, 3), corr_coexist (B, G). Both towers run over
        all B*F frames at once. Returns every output of the JAX
        ``__call__`` (with one frame, no corr_pred and no
        final_corr_offsets); ``angle_vectors`` is None for box
        representations without an angle branch. Any other F than
        num_frames raises a ValueError.

        ``mode="train"`` builds the autograd graph, runs the towers
        without the conv-chain kernel and the second-stage BEV crops in
        the gather form, keeps train_nms_size proposals and, on the
        two-pass RPN with GT in the batch, samples the RPN mini-batch
        (``rpn_mb``). ``train=True`` turns on dropout and path drop.
        Other modes run under ``torch.no_grad()``. ``rand`` gives the
        draws (module docstring); it is needed when anything is drawn.
        Under a profiler the call is the span ``dodt/forward``.
        """
        grad = contextlib.nullcontext() if mode == "train" \
            else torch.no_grad()
        with span("dodt/forward"), grad:
            return self._forward(batch, mode, train, rand)

    def _forward(self, batch, mode, train, rand):
        m = self.cfg.model
        points = batch["points"]
        b, f = points.shape[0], points.shape[1]
        if f != self.num_frames:
            raise ValueError(f"{f} frames per sample for a model of "
                             f"num_frames={self.num_frames}")
        dev = points.device
        gps = batch["ground_plane"].to(torch.float32)
        p2 = batch["p2"]
        img_shapes = batch["orig_image_shape"].to(torch.float32)
        train_mode = mode == "train"
        p_img, p_bev = m.path_drop_probabilities
        drop_paths = train and not (p_img == p_bev == 1.0)
        if rand is None and train:
            raise ValueError("forward: dropout and path drop need rand "
                             "(generator_draws)")

        img_mask = bev_mask = torch.ones(b, device=dev)
        if drop_paths:
            img_mask, bev_mask = _path_drop_masks(rand("pathdrop", (b, 3)),
                                                  p_img, p_bev)

        def per_frame(x):                         # (B, ...) -> (B*F, ...)
            return x.repeat_interleave(f, dim=0)

        # m.train_crop_vjp picks the JAX crop VJP's form; every value is
        # the gather's own VJP here, which autograd gives (ops/roi.py)
        mb = None                # sampled on the two-pass route only
        if train_mode and "gt_boxes" in batch:
            mb = {"gt_boxes": batch["gt_boxes"].flatten(0, 1),
                  "gt_classes": batch["gt_classes"].flatten(0, 1),
                  "gt_valid": batch["gt_valid"].flatten(0, 1).bool(),
                  "rand": rand}
        ctx = _TrainCtx(rand=rand if train else None,
                        bev_w=per_frame(bev_mask), img_w=per_frame(img_mask),
                        train_mode=train_mode, mb=mb, monolithic=True)
        enc = self._encode(points.flatten(0, 1),
                           batch["points_valid"].flatten(0, 1),
                           per_frame(gps), batch["image"].flatten(0, 1),
                           per_frame(p2), per_frame(img_shapes), ctx)
        rpn_mb = enc.pop("rpn_mb", None)
        out = {k: v.reshape((b, f) + v.shape[1:]) for k, v in enc.items()}
        if rpn_mb is not None:
            out["rpn_mb"] = {k: v.reshape((b, f) + v.shape[1:])
                             for k, v in rpn_mb.items()}
        out["anchors"] = out["anchors"][:, 0]
        out["img_mask"] = img_mask
        out["bev_mask"] = bev_mask
        with span("dodt/second_stage"):
            out.update(self._run_second_stage(
                (out.pop("bev_feats"), out.pop("img_feats"),
                 out["top_anchors"], out["top_valid"], gps, p2, img_shapes,
                 ctx.bev_w, ctx.img_w), m.expand_proposals_xz, ctx))
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
        if not self.correlates:
            raise ValueError("pair_stage needs the paired model "
                             "(num_frames=2)")
        def pair(key):
            return state_a[key], state_b[key]

        with span("dodt/second_stage"):
            return self._run_second_stage(
                (pair("bev_feats"), pair("img_feats"), pair("top_anchors"),
                 pair("top_valid"), state_a["ground_plane"], state_a["p2"],
                 state_a["orig_image_shape"].to(torch.float32), None, None),
                0.0, keys=FINAL_KEYS)


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
            elif ".GroupNorm_" in name and name.endswith(".weight"):
                p.fill_(1.0)
            else:
                p.zero_()


# ---------------------------------------------------------------------------
# Losses


def compute_losses(cfg: PipelineConfig, outputs: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], rand: Rand
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RPN + AVOD + correlation losses (dt_avod.py:961-1143), batched
    over (sample, frame) instead of vmapped. Mini-batch draws come from
    ``rand`` ("loss_rpn", "loss_avod"; module docstring). Returns (total,
    {rpn_cls, rpn_reg, avod_cls, avod_reg, avod_ang, corr, total})."""
    ku = cfg.dataset.kitti_utils
    mbc = cfg.dataset.mini_batch
    lw = cfg.model.loss
    eps = cfg.model.label_smoothing_epsilon
    ext = ku.bev_extents

    anchors = outputs["anchors"]                          # (B, N, 6)
    b, f = outputs["objectness"].shape[0:2]
    num_classes = outputs["cls_logits"].shape[-1]
    gt_boxes = batch["gt_boxes"].to(torch.float32)        # (B, F, G, 7)
    gt_classes = batch["gt_classes"].long()
    gt_valid = batch["gt_valid"].bool()
    gt_anchors = box_ops.box_3d_to_anchor(gt_boxes, ortho_rotate=True)
    gt_bev, _ = project_to_bev(gt_anchors, ext)

    def smoothed(labels, k):
        return F.one_hot(labels, k).to(torch.float32) * (1 - 2 * eps) + eps

    def ce_loss(logits, labels, sel):
        ce = -(smoothed(labels, logits.shape[-1])
               * F.log_softmax(logits, dim=-1)).sum(-1)
        return (ce * sel).sum(-1) * lw.cls_loss_weight / torch.clamp(
            sel.sum(-1), min=1)

    if "rpn_mb" in outputs:
        # the mini-batch was sampled inside the forward (two-pass RPN)
        mb = outputs["rpn_mb"]
        selw = mb["sel"].to(torch.float32)                # (B, F, S)
        posw = mb["pos"].to(torch.float32)
        rpn_cls = ce_loss(mb["objectness"], mb["pos"].long(), selw)
        rpn_reg = (weighted_smooth_l1(mb["offsets"], mb["offset_targets"],
                                      posw).sum(-1)
                   * lw.reg_loss_weight / torch.clamp(posw.sum(-1), min=1))
    else:
        if outputs["objectness"].shape[2] != anchors.shape[1]:
            raise ValueError("compute_losses on two-pass candidate outputs "
                             "needs the in-forward mini-batch (mode='train' "
                             "with GT in the batch)")
        valid = outputs["anchor_valid"]                   # (B, F, N)
        anchors_bev, _ = project_to_bev(anchors, ext)
        tgt = sampling.assign_targets(anchors_bev[:, None], anchors[:, None],
                                      gt_bev, gt_anchors, gt_classes,
                                      gt_valid)
        max_iou = torch.where(valid, tgt.max_iou, 0.0)
        sel, pos = sampling.sample_mini_batch(
            rand("loss_rpn", (b, f, 2, anchors.shape[1])), max_iou,
            mbc.rpn_mini_batch_size, mbc.rpn_neg_iou_range,
            mbc.rpn_pos_iou_range)
        sel &= valid
        pos &= valid
        posw = pos.to(torch.float32)
        rpn_cls = ce_loss(outputs["objectness"], pos.long(),
                          sel.to(torch.float32))
        rpn_reg = (weighted_smooth_l1(outputs["rpn_offsets"], tgt.offsets,
                                      posw).sum(-1)
                   * lw.reg_loss_weight / torch.clamp(posw.sum(-1), min=1))

    # ---------------- second stage ------------------------------------
    rep = cfg.model.avod.box_representation
    top_anchors = outputs["top_anchors"]                  # (B, F, K, 6)
    top_valid = outputs["top_valid"]
    k = top_anchors.shape[2]
    top_bev, _ = project_to_bev(top_anchors, ext)
    iou = torch.where(gt_valid[:, :, None, :],
                      aligned_iou_matrix(top_bev, gt_bev), -1.0)
    max_iou, gt_index = iou.max(dim=-1)                   # (B, F, K)
    max_iou = torch.where(top_valid, torch.clamp(max_iou, min=0.0), 0.0)
    sel, pos = sampling.sample_mini_batch(
        rand("loss_avod", (b, f, 2, k)), max_iou, mbc.avod_mini_batch_size,
        mbc.avod_neg_iou_range, mbc.avod_pos_iou_range)
    sel &= top_valid
    pos &= top_valid
    posw = pos.to(torch.float32)
    num_pos = torch.clamp(posw.sum(-1), min=1)

    cls_gt = torch.where(pos, _take(gt_classes, gt_index, 2), 0)
    avod_cls = ce_loss(outputs["cls_logits"], cls_gt, sel.to(torch.float32))

    gt_best = _take(gt_boxes, gt_index, 2)                # (B, F, K, 7)
    gp4 = batch["ground_plane"].to(torch.float32)[:, None, None, :]
    # regression targets in the configured representation
    prop_enc = outputs["proposal_enc"]
    if rep == "box_3d":
        gt_enc = box_ops.box_3d_to_anchor(gt_best, ortho_rotate=True)
        off_gt = box_ops.anchor_to_offset(prop_enc, gt_enc)
    else:
        off_gt = encode_proposals(rep, gt_best, None, gp4) - prop_enc
    avod_reg = (weighted_smooth_l1(outputs["box_offsets"], off_gt, posw)
                .sum(-1) * lw.reg_loss_weight / num_pos)
    ang_pred = outputs["angle_vectors"]
    have_angle = float(bool(ANGLE_SIZE[rep]))
    if ang_pred is None:
        ang_pred = top_anchors.new_zeros((b, f, k, 2))
    ang_gt = box_ops.orientation_to_angle_vector(gt_best[..., 6])
    avod_ang = (weighted_smooth_l1(ang_pred, ang_gt, posw).sum(-1)
                * lw.ang_loss_weight / num_pos * have_angle)

    # correlation loss, frame 0 only: targets gathered by the matched GT
    if "corr_pred" in outputs:
        corr_pred = outputs["corr_pred"]
        corr_pred_bf = torch.stack([corr_pred, torch.zeros_like(corr_pred)],
                                   dim=1)
        corr_gt = _take(batch["corr_offsets"].to(torch.float32)[:, None]
                        .expand(b, f, -1, 3), gt_index, 2)
        coexist = _take(batch["corr_coexist"][:, None].expand(b, f, -1),
                        gt_index, 2).to(torch.float32)
        use_corr = torch.tensor([1.0, 0.0], device=posw.device)[:f]
    else:
        corr_pred_bf = corr_gt = top_anchors.new_zeros((b, f, k, 3))
        coexist = top_anchors.new_zeros((b, f, k))
        use_corr = top_anchors.new_zeros(f)
    corr_w = posw * coexist * use_corr[None, :, None]
    corr = (weighted_smooth_l1(corr_pred_bf, corr_gt, corr_w).sum(-1)
            * lw.corr_loss_weight / torch.clamp(corr_w.sum(-1), min=1))

    losses = {"rpn_cls": rpn_cls.mean(), "rpn_reg": rpn_reg.mean(),
              "avod_cls": avod_cls.mean(), "avod_reg": avod_reg.mean(),
              "avod_ang": avod_ang.mean(), "corr": corr.mean()}
    total = sum(losses.values())
    losses["total"] = total
    return total, losses
