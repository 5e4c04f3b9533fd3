"""IoU-association tracker over paired-frame detections.

Parity target: reference evaluator_utils.track_through_ious:642 and
tracking/dt_tracking_eval.track_iou:204 / track_iou_v2:271 — greedy
best-3D-IoU matching of active tracks against detections, using the
predicted correlation offsets to propagate each track's last box before
matching; track confirmation by (max_score >= high_threshold, length >=
t_min); v2 adds a time-to-live for occlusion tolerance.

Detections are dicts:
  {frame_id: int, box_3d: (7,) [x,y,z,l,w,h,ry], score: float,
   offsets: (3,) [dx, dz, dry] predicted motion to the next keyframe,
   info: optional tuple (type, truncation, occlusion, alpha),
   bbox_2d: optional (4,)}

The port's copy of dodt_tpu/tracking/iou_tracker.py.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from dodt_tpu_torch.utils.np_iou import three_d_iou_matrix


def _propagated(box_3d: np.ndarray, offsets,
                scale: float = 1.0) -> np.ndarray:
    out = np.array(box_3d, dtype=np.float64).copy()
    if offsets is not None:
        out[0] += offsets[0] * scale
        out[2] += offsets[1] * scale
        out[6] += offsets[2] * scale
    return out


def track_through_ious(dets_per_frame: List[List[Dict]],
                       high_threshold: float = 0.85,
                       iou_threshold: float = 0.005,
                       t_min: int = 3,
                       ttl: int = 1,
                       frame_gaps: Optional[List[int]] = None
                       ) -> List[Dict]:
    """Greedy IoU tracker with offset propagation.

    Ego-motion alignment (reference `dets_for_ious` second stream,
    evaluator_utils.py:642-646): association IoU is computed in the
    PREVIOUS tracked frame's coordinates — the propagated track box is
    already there, and each candidate det supplies `box_aligned` (its
    box expressed in the previous frame's coordinates; the model's
    frame-B output is natively in frame-A coordinates, or the caller
    applies the known oxts ego transform). The stored trajectory keeps
    `box_3d` in each frame's OWN coordinates (the reference's
    `recovery_coordinate` contract). Without `box_aligned`, `box_3d`
    is used for IoU as well (zero-ego / legacy behavior).

    Args:
      dets_per_frame: detections per tracked frame.
      high_threshold: min max-score for a track to be kept.
      iou_threshold: association threshold.
      t_min: minimum track length.
      ttl: frames a track survives without a match (1 = strict, like
        track_through_ious; >1 = track_iou_v2 occlusion tolerance).
      frame_gaps: real-frame gap between entry i-1 and i (entry 0
        unused). A det's `offsets` span `offsets_span` frames (default:
        the gap, i.e. offsets already match the step); propagation is
        scaled by gap/span so tau-span keyframe offsets propagate
        correctly over 1-frame (MoI-interpolated) steps.

    Returns:
      list of {trajectory: [det...], max_score, start_frame, frames}.
    """
    tracks_active: List[Dict] = []
    tracks_finished: List[Dict] = []

    for frame_num, frame_dets in enumerate(dets_per_frame):
        gap = frame_gaps[frame_num] if frame_gaps is not None and \
            frame_num < len(frame_gaps) else None
        dets = list(frame_dets)
        updated = []
        n_dets = len(dets)
        if n_dets and tracks_active:
            # one tracks x dets IoU matrix per frame (matrix-batched
            # exact clip in np_iou); the greedy best-match pop below
            # is reproduced by masking consumed columns — argmax order
            # over the unconsumed set is identical to list.pop's
            det_boxes = np.stack([
                d["box_aligned"] if d.get("box_aligned")
                is not None else d["box_3d"] for d in dets])
            props = []
            for track in tracks_active:
                last = track["trajectory"][-1]
                span = last.get("offsets_span") or gap
                # with ttl>1 a track may have skipped frames since its
                # last match; accumulate the real-frame gap so the
                # offset propagation covers the whole skip
                eff_gap = None if gap is None else \
                    gap + track.get("pending_gap", 0)
                scale = 1.0 if eff_gap is None or not span \
                    else eff_gap / span
                props.append(_propagated(last["box_3d"],
                                         last.get("offsets"), scale))
            iou_mat = three_d_iou_matrix(np.stack(props), det_boxes)
        consumed = np.zeros(n_dets, dtype=bool)
        for ti, track in enumerate(tracks_active):
            matched = False
            if n_dets and not consumed.all():
                ious = np.where(consumed, -1.0, iou_mat[ti])
                best = int(np.argmax(ious))
                if ious[best] > iou_threshold:
                    consumed[best] = True
                    det = dets[best]
                    track["trajectory"].append(det)
                    track["frames"].append(frame_num)
                    track["max_score"] = max(track["max_score"],
                                             det["score"])
                    track["miss"] = 0
                    track["pending_gap"] = 0
                    updated.append(track)
                    matched = True
            if not matched:
                track["miss"] = track.get("miss", 0) + 1
                if gap is not None:
                    track["pending_gap"] = \
                        track.get("pending_gap", 0) + gap
                # learned-coexist early termination: a track whose last
                # det predicted "will not exist at the next keyframe"
                # (stack coexist head, P(both) < 0.5) must not linger
                # through the ttl window where it could steal a
                # newborn's detection; dets without the head carry 0.5
                # and keep full ttl semantics
                dying = track["trajectory"][-1].get("coexist")
                expired = track["miss"] >= ttl or \
                    (dying is not None and dying < 0.5)
                if not expired:
                    updated.append(track)   # keep alive (v2 semantics)
                elif track["max_score"] >= high_threshold and \
                        len(track["trajectory"]) >= t_min:
                    tracks_finished.append(track)

        new_tracks = [{"trajectory": [det], "max_score": det["score"],
                       "start_frame": frame_num, "frames": [frame_num],
                       "miss": 0}
                      for di, det in enumerate(dets)
                      if not consumed[di]]
        tracks_active = updated + new_tracks

    tracks_finished += [t for t in tracks_active
                        if t["max_score"] >= high_threshold and
                        len(t["trajectory"]) >= t_min]
    return tracks_finished


def trajectories_to_kitti(tracks: List[Dict], classes=("Car",)
                          ) -> List[str]:
    """KITTI tracking format lines:
    frame track_id type trunc occ alpha bbox(4) h w l x y z ry score
    (reference convert_trajectory_to_kitti_format:720)."""
    rows = []
    for tid, track in enumerate(tracks):
        score = track["max_score"]
        for det, frame in zip(track["trajectory"], track["frames"]):
            x, y, z, l, w, h, ry = det["box_3d"]
            obj_type = det.get("type", classes[0])
            bbox = det.get("bbox_2d", (0.0, 0.0, 0.0, 0.0))
            rows.append((frame, tid,
                         f"{frame} {tid} {obj_type} 0 0 -10 "
                         f"{bbox[0]:.6f} {bbox[1]:.6f} {bbox[2]:.6f} "
                         f"{bbox[3]:.6f} {h:.6f} {w:.6f} {l:.6f} "
                         f"{x:.6f} {y:.6f} {z:.6f} {ry:.6f} "
                         f"{score:.6f}"))
    rows.sort(key=lambda r: (r[0], r[1]))
    return [r[2] for r in rows]
