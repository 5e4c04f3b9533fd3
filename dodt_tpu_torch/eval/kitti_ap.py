"""KITTI detection AP evaluator (official protocol, bit-parity).

Own implementation of the exact scoring rules of the official KITTI
C++ evaluator, which the reference vendors at scripts/offline_eval/
kitti_native_eval/evaluate_object_3d_offline.cpp (~1000 LoC) and which
is parity-tested against the compiled official binary in
tests/test_ap_parity.py:

  * per-difficulty valid/ignored/other GT partitioning with the
    official boundary conventions (cleanData:382-455),
  * sequential greedy matching with a shared assigned set
    (computeStatistics:457-637) — the recall-threshold pass takes the
    highest-SCORE overlapping candidate (:508-510), the PR pass the
    highest-overlap non-ignored candidate; too-small detections may
    absorb a GT's match without producing a TP (:538-539),
  * DontCare absorption by criterion-0 overlap,
  * thresholds at 41 recall steps, right-monotonized precision, and
    the official 11-of-41-point AP average (saveAndPlotPlots:766-770).

Metrics: image (2D bbox), ground (rotated BEV), 3D.

The C++ twin in dodt_tpu_torch/native/kitti_ap.cpp is the fast batch path;
this module is the readable specification.

The port's copy of dodt_tpu/eval/kitti_ap.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from dodt_tpu_torch.data.kitti import LabelArray
from dodt_tpu_torch.utils.np_iou import (aligned_iou_2d_matrix,
                                   rotated_iou_matrix,
                                   three_d_iou_matrix)

N_SAMPLE_PTS = 41

# difficulty: (min bbox height, max occlusion, max truncation)
DIFFICULTY = {
    0: (40.0, 0, 0.15),   # easy
    1: (25.0, 1, 0.30),   # moderate
    2: (25.0, 2, 0.50),   # hard
}

# neighboring classes evaluated as "ignored" (not FP, not TP)
NEIGHBORS = {
    "Car": ("Van",),
    "Pedestrian": ("Person_sitting",),
    "Cyclist": (),
}


@dataclass
class FrameGt:
    boxes_3d: np.ndarray      # (G, 7)
    bbox_2d: np.ndarray       # (G, 4)
    types: Sequence[str]
    occlusion: np.ndarray
    truncation: np.ndarray
    dontcare: np.ndarray      # (D, 4) 2D regions

    @staticmethod
    def from_labels(labels: LabelArray, dontcare=None) -> "FrameGt":
        return FrameGt(
            boxes_3d=labels.box_3d, bbox_2d=labels.bbox_2d,
            types=list(labels.types), occlusion=labels.occlusion,
            truncation=labels.truncation,
            dontcare=np.zeros((0, 4)) if dontcare is None else dontcare)


@dataclass
class FrameDet:
    boxes_3d: np.ndarray      # (N, 7)
    bbox_2d: np.ndarray       # (N, 4)
    scores: np.ndarray
    types: Sequence[str]


def _classify_gt(gt: FrameGt, current_class: str, difficulty: int):
    """0 = valid, 1 = ignored (neighbor class or too hard), -1 = other
    class. Official cleanData:385-428 semantics: a GT is ignored when
    occlusion/truncation exceed the difficulty or bbox height is <= the
    minimum (boundary inclusive), case-insensitive class match."""
    min_h, max_occ, max_trunc = DIFFICULTY[difficulty]
    cur = current_class.lower()
    neighbors = tuple(n.lower() for n in NEIGHBORS.get(current_class, ()))
    out = []
    for i in range(len(gt.boxes_3d)):
        t = gt.types[i].lower()
        h = gt.bbox_2d[i, 3] - gt.bbox_2d[i, 1]
        ignore = (gt.occlusion[i] > max_occ or
                  gt.truncation[i] > max_trunc or h <= min_h)
        if t == cur and not ignore:
            out.append(0)
        elif t in neighbors or (t == cur and ignore):
            out.append(1)
        else:
            out.append(-1)
    return np.array(out, np.int32)


def _classify_det(det: FrameDet, current_class: str, difficulty: int):
    """0 = valid, 1 = ignored (too small — of ANY class, checked before
    the class test like the official cleanData:445-453), -1 = other
    class."""
    min_h = DIFFICULTY[difficulty][0]
    cur = current_class.lower()
    out = []
    for i in range(len(det.scores)):
        h = abs(det.bbox_2d[i, 1] - det.bbox_2d[i, 3])
        if h < min_h:
            out.append(1)
        elif det.types[i].lower() == cur:
            out.append(0)
        else:
            out.append(-1)
    return np.array(out, np.int32)


def _overlap(metric: str, det: FrameDet, gt: FrameGt) -> np.ndarray:
    """(n_det, n_gt) IoU matrix for the chosen metric — one pairwise
    matrix sweep (np_iou), not a per-detection row loop."""
    nd, ng = len(det.boxes_3d), len(gt.boxes_3d)
    if nd == 0 or ng == 0:
        return np.zeros((nd, ng))
    if metric == "image":
        return aligned_iou_2d_matrix(det.bbox_2d, gt.bbox_2d)
    if metric == "ground":
        return rotated_iou_matrix(det.boxes_3d[:, [0, 2, 3, 4, 6]],
                                  gt.boxes_3d[:, [0, 2, 3, 4, 6]])
    return three_d_iou_matrix(det.boxes_3d, gt.boxes_3d)


_NO_DETECTION = -10000000.0


def _compute_statistics(iou, dc_overlap, scores, ignored_gt, ignored_det,
                        min_overlap, thresh, compute_fp):
    """One frame at one score threshold — official computeStatistics
    (:457-637) semantics, operating on a precomputed (n_det, n_gt) IoU
    matrix and (n_det, n_dc) criterion-0 DontCare overlap matrix.

    Returns (tp, fp, fn, tp_scores). Matching runs sequentially over GT
    in file order with a shared assigned-detection set; small
    (ignored_det==1) detections may absorb a GT's match without
    producing a TP, and ignored GT absorb their best detection.
    """
    n_gt = iou.shape[1]
    n_det = len(scores)
    assigned = np.zeros(n_det, bool)
    if compute_fp:
        ignored_threshold = scores < thresh
    else:
        ignored_threshold = np.zeros(n_det, bool)

    tp = fp = fn = 0
    v = []
    for i in range(n_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(n_det):
            if ignored_det[j] == -1 or assigned[j] or \
                    ignored_threshold[j]:
                continue
            overlap = iou[j, i]
            if overlap <= min_overlap:
                continue
            if not compute_fp:
                # recall-threshold pass: highest-SCORE candidate
                # (official :508-510)
                if scores[j] > valid_detection:
                    det_idx = j
                    valid_detection = scores[j]
            elif (overlap > max_overlap or assigned_ignored_det) and \
                    ignored_det[j] == 0:
                max_overlap = overlap
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = False
            elif valid_detection == _NO_DETECTION and \
                    ignored_det[j] == 1:
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = True
        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != _NO_DETECTION and \
                (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            # absorbed: no TP, no FP, no FN (official :538-539)
            assigned[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            v.append(scores[det_idx])
            assigned[det_idx] = True

    if compute_fp:
        fp = int(np.sum(~assigned & (ignored_det == 0) &
                        ~ignored_threshold))
        # DontCare absorption with criterion-0 overlap (official
        # :572-595); detection order is the official inner loop order
        nstuff = 0
        for k in range(dc_overlap.shape[1]):
            for j in range(n_det):
                if assigned[j] or ignored_det[j] != 0 or \
                        ignored_threshold[j]:
                    continue
                if dc_overlap[j, k] > min_overlap:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
    return tp, fp, fn, v


def evaluate_ap(gts: List[FrameGt], dets: List[FrameDet],
                current_class: str = "Car",
                metric: str = "3d",
                min_iou: float = 0.7,
                use_native: bool | None = None) -> Dict[str, float]:
    """Returns AP (in %) per difficulty {easy, moderate, hard}.

    Dispatches to the C++ evaluator (native/kitti_ap.cpp) when built;
    the Python path below is the specification / test oracle.
    """
    from dodt_tpu_torch import native
    if use_native is None:
        use_native = native.available()
    native.note_route("native" if use_native else "python")
    results = {}
    names = {0: "easy", 1: "moderate", 2: "hard"}
    for difficulty in (0, 1, 2):
        fn = _eval_one_native if use_native else _eval_one
        results[names[difficulty]] = fn(
            gts, dets, current_class, metric, min_iou, difficulty)
    return results


def _eval_one_native(gts, dets, current_class, metric, min_iou,
                     difficulty):
    from dodt_tpu_torch import native

    gt_counts, det_counts, dc_counts = [], [], []
    gt_boxes7, gt_bbox4, ignored_gt, dc_bbox4 = [], [], [], []
    det_boxes7, det_bbox4, det_scores, ignored_det = [], [], [], []
    for gt, det in zip(gts, dets):
        gt_counts.append(len(gt.boxes_3d))
        det_counts.append(len(det.boxes_3d))
        dc = np.asarray(gt.dontcare, np.float64).reshape(-1, 4)
        dc_counts.append(len(dc))
        dc_bbox4.append(dc)
        gt_boxes7.append(np.asarray(gt.boxes_3d, np.float64).reshape(-1, 7))
        gt_bbox4.append(np.asarray(gt.bbox_2d, np.float64).reshape(-1, 4))
        ignored_gt.append(_classify_gt(gt, current_class, difficulty))
        det_boxes7.append(np.asarray(det.boxes_3d,
                                     np.float64).reshape(-1, 7))
        det_bbox4.append(np.asarray(det.bbox_2d,
                                    np.float64).reshape(-1, 4))
        det_scores.append(np.asarray(det.scores, np.float64))
        ignored_det.append(_classify_det(det, current_class, difficulty))

    def cat(parts, width):
        if not parts:
            return np.zeros((0, width))
        return np.concatenate([p.reshape(-1, width) for p in parts])

    return native.kitti_ap_native(
        np.asarray(gt_counts, np.int32), cat(gt_boxes7, 7),
        cat(gt_bbox4, 4),
        np.concatenate(ignored_gt) if ignored_gt
        else np.zeros(0, np.int32),
        np.asarray(dc_counts, np.int32), cat(dc_bbox4, 4),
        np.asarray(det_counts, np.int32), cat(det_boxes7, 7),
        cat(det_bbox4, 4),
        np.concatenate(det_scores) if det_scores else np.zeros(0),
        np.concatenate(ignored_det) if ignored_det
        else np.zeros(0, np.int32),
        metric, min_iou)


def _eval_one(gts, dets, current_class, metric, min_iou, difficulty):
    """One class x difficulty x metric — official eval_class:643-743.

    AP is the official 11-of-41-point average: precisions at recalls
    0, 0.1, ..., 1.0 (every 4th of the 41 samples), right-monotonized
    first (official saveAndPlotPlots:766-770).
    """
    # Per-frame caches: classifications + IoU + DontCare overlaps.
    frame_cache = []
    tp_scores = []
    total_valid_gt = 0
    for gt, det in zip(gts, dets):
        gt_kind = _classify_gt(gt, current_class, difficulty)
        det_kind = _classify_det(det, current_class, difficulty)
        iou = _overlap(metric, det, gt)
        # DontCare absorption uses the metric's criterion-0 overlap
        # (intersection / detection area). KITTI DontCare rows carry
        # only a 2D bbox (dims -1, position -1000), so for the ground
        # and 3d metrics the official overlap is identically 0 — only
        # the image metric can absorb.
        n_det = len(det.scores)
        n_dc = len(gt.dontcare)
        dc_overlap = np.zeros((n_det, n_dc))
        if metric == "image" and n_dc:
            for d in range(n_det):
                for k in range(n_dc):
                    dc_overlap[d, k] = _inside_frac(det.bbox_2d[d],
                                                    gt.dontcare[k])
        frame_cache.append((gt_kind, det_kind, iou, dc_overlap))
        total_valid_gt += int(np.sum(gt_kind == 0))

        _, _, _, v = _compute_statistics(
            iou, dc_overlap, np.asarray(det.scores, float), gt_kind,
            det_kind, min_iou, 0.0, compute_fp=False)
        tp_scores.extend(v)

    if total_valid_gt == 0:
        return 0.0
    thresholds = _get_thresholds(np.sort(tp_scores)[::-1], total_valid_gt)

    precisions = np.zeros(N_SAMPLE_PTS)
    for ti, thresh in enumerate(thresholds):
        tp = fp = fn = 0
        for det, (gt_kind, det_kind, iou, dc_overlap) in zip(
                dets, frame_cache):
            t, f, n, _ = _compute_statistics(
                iou, dc_overlap, np.asarray(det.scores, float), gt_kind,
                det_kind, min_iou, thresh, compute_fp=True)
            tp += t
            fp += f
            fn += n
        denom = tp + fp
        precisions[ti] = tp / denom if denom > 0 else 0.0

    # right-monotonize over the full 41 samples, then the official
    # 11-point average (every 4th sample)
    n_t = len(thresholds)
    for i in range(n_t):
        precisions[i] = np.max(precisions[i:])
    return 100.0 * float(np.sum(precisions[0::4]) / 11.0)


def _inside_frac(box, region):
    x1 = max(box[0], region[0])
    y1 = max(box[1], region[1])
    x2 = min(box[2], region[2])
    y2 = min(box[3], region[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area = (box[2] - box[0]) * (box[3] - box[1])
    return inter / area if area > 0 else 0.0


def _get_thresholds(scores_desc: np.ndarray, n_gt: int) -> np.ndarray:
    """Official threshold selection (cpp getThresholds): walk the
    sorted TP scores, keep one threshold per recall step of 1/40."""
    thresholds = []
    current_recall = 0.0
    n = len(scores_desc)
    for i in range(n):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < n - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) \
                and i < n - 1:
            continue
        thresholds.append(scores_desc[i])
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return np.array(thresholds)
