"""Motion-offset interpolation (MoI) over non-keyframes.

Parity target: reference evaluator_utils.interpolate_non_keyframe_
predicitons:424 + interpolate_trajectory:510 — given detections at two
keyframes (t, t+tau) with predicted correlation offsets, synthesize
detections for the tau-1 intermediate frames by linear interpolation of
[x, z, ry]; births/deaths use the coexist head to decide between
extrapolating through the gap and blanking half of it.

Detections here are dicts (see iou_tracker) plus:
  coexist: float in [0, 1] — probability the object exists in BOTH
  keyframes (the stack model's coexist softmax P(class "both"),
  models/stack.py final_coexist). NOTE the value polarity is the
  INVERSE of the reference's saved flag (there 0 = co-exist,
  interpolate_trajectory:533 branches on coexists <= 0.5); the branch
  structure below is the same, read under P(both):
    unmatched det, coexist > 0.5  -> the model says the object exists
      at the other keyframe too (detector miss): extrapolate through
      the whole gap along the predicted motion;
    unmatched det, coexist <= 0.5 -> true birth/death: blank half the
      gap (reference "trajectory birth/dead, half frames are None").
  Dets without a coexist head default to 0.5 ("unknown"), taking the
  conservative blank-half branch.

The port's copy of dodt_tpu/tracking/moi.py.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from dodt_tpu_torch.utils.np_iou import three_d_iou_matrix


def match_pairs(dets0: List[Dict], dets1: List[Dict]):
    """Greedy best-IoU matching of frame-0 dets (offset-propagated)
    against frame-1 dets. Returns list of (det0 | None, det1 | None)."""
    pairs = []
    n1 = len(dets1)
    consumed = np.zeros(n1, dtype=bool)
    if dets0 and n1:
        # one props x dets1 matrix (matrix-batched exact clip); greedy
        # pops reproduced by masking consumed columns, as in
        # iou_tracker.track_through_ious
        props = []
        for det0 in dets0:
            prop = np.array(det0["box_3d"], np.float64)
            off = det0.get("offsets")
            if off is not None:
                prop[0] += off[0]
                prop[2] += off[1]
                prop[6] += off[2]
            props.append(prop)
        iou_mat = three_d_iou_matrix(
            np.stack(props), np.stack([d["box_3d"] for d in dets1]))
    for i, det0 in enumerate(dets0):
        best_j = None
        if n1 and not consumed.all():
            ious = np.where(consumed, -1.0, iou_mat[i])
            k = int(np.argmax(ious))
            if ious[k] > 0:
                best_j = k
        if best_j is not None:
            consumed[best_j] = True
            pairs.append((det0, dets1[best_j]))
        else:
            pairs.append((det0, None))
    for j in range(n1):
        if not consumed[j]:
            pairs.append((None, dets1[j]))
    return pairs


def interpolate_pair(det0: Optional[Dict], det1: Optional[Dict],
                     num_frames: int) -> List[Optional[Dict]]:
    """Fill `num_frames` slots (keyframe 0 .. keyframe tau inclusive)
    for one matched pair (reference interpolate_trajectory:510)."""
    n = num_frames
    out: List[Optional[Dict]] = []

    def lerped(base, slot_frac, offsets, score):
        obj = copy.deepcopy(base)
        box = np.array(obj["box_3d"], np.float64)
        box[0] += offsets[0] * slot_frac
        box[2] += offsets[1] * slot_frac
        box[6] += offsets[2] * slot_frac
        obj["box_3d"] = box
        obj["score"] = score
        obj["interpolated"] = True
        # the 3D box moved: a cached image-plane box is stale now
        # (consumers re-project from box_3d when bbox_2d is absent)
        obj.pop("bbox_2d", None)
        # interpolated frames sit 1 real frame apart: re-express the
        # tau-span motion as a per-frame step for tracker propagation
        obj["offsets"] = np.asarray(offsets, np.float64) / (n - 1)
        obj["offsets_span"] = 1
        return obj

    if det0 is not None and det1 is not None:
        score = max(det0["score"], det1["score"])
        offsets = np.array(det1["box_3d"], np.float64)[[0, 2, 6]] - \
            np.array(det0["box_3d"], np.float64)[[0, 2, 6]]
        out.append(det0)
        for i in range(n - 2):
            out.append(lerped(det0, (i + 1.0) / (n - 1), offsets, score))
        d1 = copy.deepcopy(det1)
        d1["score"] = score
        out.append(d1)
    elif det0 is None:
        # appears only at frame tau
        coexist = _coexist(det1)
        offsets = np.asarray(det1.get("offsets", np.zeros(3)), np.float64)
        if coexist > 0.5:
            # the model says it existed at frame 0 too (detector miss):
            # extrapolate backwards along its (incoming) motion
            for i in range(n - 1):
                frac = -(n - i - 2.0) / (n - 1)
                out.append(lerped(det1, frac, offsets, det1["score"]))
            out.append(det1)
        else:
            # true birth: the early half of the gap stays blank; the
            # kept half back-extrapolates along the incoming motion
            # (the reference keeps stationary copies,
            # interpolate_trajectory:543-548 — moving them tracks the
            # GT it is about to match and measurably cuts FN/IDS)
            for i in range(n - 1):
                if i <= n / 2:
                    out.append(None)
                else:
                    frac = -(n - i - 2.0) / (n - 1)
                    out.append(lerped(det1, frac, offsets,
                                      det1["score"]))
            out.append(det1)
    else:
        # exists only at frame 0
        coexist = _coexist(det0)
        offsets = np.asarray(det0.get("offsets", np.zeros(3)), np.float64)
        if coexist > 0.5:
            # detector miss at frame tau: extrapolate forward
            out.append(det0)
            for i in range(n - 1):
                out.append(lerped(det0, (i + 1.0) / (n - 1), offsets,
                                  det0["score"]))
        else:
            # true death: the late half of the gap stays blank; the
            # kept half moves along the predicted motion (reference
            # keeps stationary copies, interpolate_trajectory:565-570)
            out.append(det0)
            for i in range(n - 1):
                out.append(lerped(det0, (i + 1.0) / (n - 1), offsets,
                                  det0["score"])
                           if i < n / 2 else None)
    assert len(out) == n
    return out


def _coexist(det: Dict) -> float:
    v = det.get("coexist")
    return 0.5 if v is None else float(v)


def interpolate_non_keyframes(dets0: List[Dict], dets1: List[Dict],
                              num_frames: int,
                              score_threshold: float = 0.1
                              ) -> List[List[Dict]]:
    """Full MoI: match keyframe detections, interpolate the gap.

    Returns per-frame detection lists of length `num_frames`
    (keyframes at both ends). Outputs are in frame-0 coordinates; the
    Evaluator recovers each frame into its own ego coordinates via
    kitti.transform_boxes_3d(inverse=True) before writing/scoring
    (reference recovery_predictions:370, recovery loop :502-506).
    """
    if num_frames == 1:
        return [dets0]
    if num_frames == 2:
        return [dets0, dets1]
    k0 = [d for d in dets0 if d["score"] > score_threshold]
    k1 = [d for d in dets1 if d["score"] > score_threshold]
    frames: List[List[Dict]] = [[] for _ in range(num_frames)]
    for det0, det1 in match_pairs(k0, k1):
        slots = interpolate_pair(det0, det1, num_frames)
        for i, obj in enumerate(slots):
            if obj is not None:
                frames[i].append(obj)
    return frames
