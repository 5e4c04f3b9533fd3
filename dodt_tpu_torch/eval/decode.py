"""Prediction decoding helpers (host-side numpy; the port's copy of
dodt_tpu/eval/decode.py).

box_4ca orientation resolution: the box_4c decode yields a heading from
the quad geometry; the angle-vector branch predicts the true heading.
When they disagree by ~90 degrees the box l/w are swapped, by ~180 the
angle is flipped (reference dt_evaluator.get_avod_predicted_boxes_3d_
and_scores:1183-1214).
"""
from __future__ import annotations

import numpy as np


def resolve_box_4ca_orientation(boxes_3d: np.ndarray,
                                orientations: np.ndarray) -> np.ndarray:
    """boxes_3d (N, 7) from box_4c decode; orientations (N,) from the
    angle-vector head. Returns corrected boxes (N, 7)."""
    out = np.array(boxes_3d, np.float64).copy()
    if len(out) == 0:
        return out
    two_pi = 2 * np.pi
    ang_diff = out[:, 6] - orientations
    ang_diff[ang_diff < -np.pi] += two_pi
    ang_diff[ang_diff > np.pi] -= two_pi

    q1, q2, q3 = 0.25 * np.pi, 0.5 * np.pi, 0.75 * np.pi

    def swap_lw(mask):
        l = out[mask, 3].copy()
        out[mask, 3] = out[mask, 4]
        out[mask, 4] = l

    pos90 = (ang_diff > q1) & (ang_diff < q3)
    swap_lw(pos90)
    out[pos90, 6] += q2

    neg90 = (ang_diff < -q1) & (ang_diff > -q3)
    swap_lw(neg90)
    out[neg90, 6] -= q2

    flip = np.abs(ang_diff) >= q3
    out[flip, 6] += np.pi

    above = out[:, 6] > np.pi
    out[above, 6] -= two_pi
    below = out[:, 6] < -np.pi
    out[below, 6] += two_pi
    return out


def outputs_to_detections(final_boxes_3d, final_orientations,
                          final_scores, final_cls_softmax, final_valid,
                          corr_offsets=None, coexist=None,
                          score_threshold: float = 0.0):
    """Convert one frame's model outputs to detection dicts (the JAX
    package's trackers and scorers read them). Inputs are numpy arrays
    for ONE frame.

    `coexist`: per-detection P(object exists in both keyframes) from a
    coexist head; models without one leave it None -> dets carry 0.5
    ("unknown")."""
    boxes = resolve_box_4ca_orientation(final_boxes_3d,
                                        final_orientations)
    dets = []
    for i in range(len(boxes)):
        if not final_valid[i]:
            continue
        score = float(final_scores[i])
        if score < score_threshold:
            continue
        cls_idx = int(np.argmax(final_cls_softmax[i][1:]))
        det = {"box_3d": boxes[i], "score": score,
               "class_idx": cls_idx,
               "offsets": None if corr_offsets is None
               else np.asarray(corr_offsets[i], np.float64),
               "coexist": 0.5 if coexist is None
               else float(coexist[i])}
        dets.append(det)
    return dets
