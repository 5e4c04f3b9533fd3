"""Post-detection MOT pipelines over saved keyframe detections.

Parity targets: the reference experiment scripts
  avod/experiments/video_detection.py (track_iou + label interpolation),
  video_detection_iou.py (pure-IoU baseline, no offsets),
  video_detection_kf.py (Kalman + stride interpolation),
  avod/core/tracking/dt_tracking_eval.py (track_iou / track_iou_v2).

Given per-keyframe detection lists (from the Evaluator or decoded from
KITTI txt files), these build tracks, interpolate non-keyframes, and
emit KITTI tracking-format labels + CLEAR-MOT metrics.

The port's copy of dodt_tpu/runtime/video.py.
"""
from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from dodt_tpu_torch.tracking import iou_tracker, kalman, moi, mot_eval


def load_kitti_detections(pred_dir: str) -> Dict[int, Dict[int, List]]:
    """Read `VVFFFF.txt` KITTI detection files into per-video frame
    detection dicts (inverse of kitti_writer)."""
    out: Dict[int, Dict[int, List]] = defaultdict(dict)
    for name in sorted(os.listdir(pred_dir)):
        if not name.endswith(".txt"):
            continue
        stem = name[:-4]
        vid, frame = int(stem[:2]), int(stem[2:])
        dets = []
        with open(os.path.join(pred_dir, name)) as f:
            for line in f:
                p = line.split()
                if len(p) < 16:
                    continue
                h, w, l = float(p[8]), float(p[9]), float(p[10])
                x, y, z = float(p[11]), float(p[12]), float(p[13])
                ry, score = float(p[14]), float(p[15])
                dets.append({
                    "frame_id": frame,
                    "box_3d": np.array([x, y, z, l, w, h, ry]),
                    "bbox_2d": np.array([float(p[4]), float(p[5]),
                                         float(p[6]), float(p[7])]),
                    "score": score, "type": p[0],
                    "offsets": np.zeros(3), "coexist": 0.5})
        out[vid][frame] = dets
    return out


def load_couple_detections(couples_dir: str, classes=("Car",)
                           ) -> Dict[int, Dict[int, List]]:
    """Read the Evaluator's extended per-couple files (see
    eval/kitti_writer.couple_detections_to_lines; reference contract
    dt_evaluator.py:1134-1259 / dt_tracking_eval.decode_tracking_
    file:80) into per-video keyframe detections WITH their predicted
    corr offsets and coexist probabilities — the offline twin of the
    in-memory `video_dets`, so from-files MOT runs use real offsets
    instead of silently degrading to pure-IoU association.

    When consecutive couples share a keyframe (the far frame of couple
    k is the near frame of couple k+1), the near-frame rows win — the
    same overwrite rule as Evaluator.run_checkpoint_once."""
    from dodt_tpu_torch.eval import kitti_writer

    out: Dict[int, Dict[int, List]] = defaultdict(dict)
    seen_near: Dict[int, set] = defaultdict(set)
    for name in sorted(os.listdir(couples_dir)):
        if not name.endswith(".txt") or "_" not in name:
            continue
        stem_a, stem_b = name[:-4].split("_")
        vid = int(stem_a[:2])
        frame_a, frame_b = int(stem_a[2:]), int(stem_b[2:])
        with open(os.path.join(couples_dir, name)) as f:
            frames = kitti_writer.parse_couple_lines(
                [ln for ln in f], classes=classes)
        for frame, dets in frames.items():
            if frame == frame_a:
                seen_near[vid].add(frame)
            elif frame in seen_near[vid]:
                continue   # a near-frame entry already wrote this
            out[vid][frame] = dets
    return out


def dataset_align_fn(dataset):
    """Build an ego-alignment callback for `run_video_pipeline` from a
    KittiTrackingDataset: expresses frame_cur boxes in frame_prev
    coordinates via the oxts poses (reference cal_transformed_ious,
    tracking/tracking_eval.py:104)."""
    from dodt_tpu_torch.data import kitti

    def fn(vid, f_prev, f_cur, boxes):
        o1 = kitti.read_oxts(dataset.oxts_dir, vid, f_prev)
        o2 = kitti.read_oxts(dataset.oxts_dir, vid, f_cur)
        trans, matrix, dyaw = kitti.ego_motion(o1, o2)
        return kitti.transform_boxes_3d(boxes, dataset.calib(vid),
                                        trans, matrix, dyaw)

    return fn


def dataset_ego_fn(dataset):
    """Inverse direction of `dataset_align_fn`: expresses frame_prev
    boxes in frame_cur's own coordinates — the kf_pipeline ego contract
    (the reference KF assigns on ego-transformed IoU,
    kf_tracking.py:281-305)."""
    from dodt_tpu_torch.data import kitti

    def fn(vid, f_prev, f_cur, boxes):
        o1 = kitti.read_oxts(dataset.oxts_dir, vid, f_prev)
        o2 = kitti.read_oxts(dataset.oxts_dir, vid, f_cur)
        trans, matrix, dyaw = kitti.ego_motion(o1, o2)
        return kitti.transform_boxes_3d(boxes, dataset.calib(vid),
                                        trans, matrix, dyaw,
                                        inverse=True)

    return fn


def run_video_pipeline(video_dets: Dict[int, Dict[int, List]],
                       tracker: str = "iou",
                       stride: int = 1,
                       sigma_l: float = 0.1,
                       sigma_h: float = 0.3,
                       sigma_iou: float = 0.1,
                       t_min: int = 1,
                       ttl: int = 1,
                       interpolate: bool = True,
                       align_fn=None,
                       ego_fn=None) -> Dict[int, List]:
    """Track + interpolate each video. Returns KITTI tracking lines per
    video (reference video_detection.py:535-567 defaults:
    sigma_l 0.1, sigma_h 0.3, sigma_iou 0.1, t_min 1).

    align_fn(vid, frame_prev, frame_cur, boxes (N, 7)) -> (N, 7):
    optional ego-motion compensation expressing frame_cur boxes in
    frame_prev coordinates before association IoU (reference
    cal_transformed_ious, tracking/tracking_eval.py:104).

    ego_fn: same signature, opposite direction (frame_prev boxes into
    frame_cur coordinates) — consumed by the Kalman arm to keep its
    filter state in the current frame's coordinates (reference
    kf_tracking.py:281-305 ego-transformed assignment); build with
    `dataset_ego_fn`."""
    out = {}
    for vid, frames in video_dets.items():
        keyframes = sorted(frames)
        if align_fn is not None:
            for i in range(1, len(keyframes)):
                dets = frames[keyframes[i]]
                if not dets:
                    continue
                aligned = align_fn(
                    vid, keyframes[i - 1], keyframes[i],
                    np.stack([d["box_3d"] for d in dets]))
                for d, b in zip(dets, aligned):
                    d["box_aligned"] = b
        gaps = [0] + [keyframes[i] - keyframes[i - 1]
                      for i in range(1, len(keyframes))]
        dets_seq = [[d for d in frames[f] if d["score"] > sigma_l]
                    for f in keyframes]
        if tracker == "iou":
            tracks = iou_tracker.track_through_ious(
                dets_seq, sigma_h, sigma_iou, t_min, ttl=ttl,
                frame_gaps=gaps)
        elif tracker == "kf":
            kf_ego = None
            if ego_fn is not None:
                def kf_ego(i_prev, i_cur, boxes, _vid=vid):
                    return ego_fn(_vid, keyframes[i_prev],
                                  keyframes[i_cur], boxes)
            tracks = kalman.kf_pipeline(dets_seq,
                                        iou_threshold=sigma_iou,
                                        min_hits=t_min,
                                        ego_fn=kf_ego)
        else:
            raise ValueError(tracker)

        if interpolate and stride > 1:
            tracks = _interpolate_tracks(tracks, keyframes, stride)
        else:
            for t in tracks:
                t["abs_frames"] = [keyframes[i] for i in t["frames"]]
        out[vid] = _tracks_to_kitti(tracks)
    return out


def _interpolate_tracks(tracks: List[Dict], keyframes: List[int],
                        stride: int) -> List[Dict]:
    """Fill non-keyframes inside each track by linear interpolation of
    [x, z, ry] between consecutive keyframe detections (reference
    video_detection.label_interpolation:371)."""
    for track in tracks:
        traj = track["trajectory"]
        frames_idx = track["frames"]
        new_traj, new_frames = [], []
        for i in range(len(traj)):
            det = traj[i]
            kf = keyframes[frames_idx[i]]
            new_traj.append(det)
            new_frames.append(kf)
            if i + 1 < len(traj):
                nxt = traj[i + 1]
                kf_next = keyframes[frames_idx[i + 1]]
                gap = kf_next - kf
                for off in range(1, gap):
                    obj = moi.interpolate_pair(det, nxt, gap + 1)[off]
                    if obj is not None:
                        new_traj.append(obj)
                        new_frames.append(kf + off)
        track["trajectory"] = new_traj
        track["abs_frames"] = new_frames
    return tracks


def _tracks_to_kitti(tracks: List[Dict]) -> List[str]:
    rows = []
    for tid, track in enumerate(tracks):
        score = track["max_score"]
        for det, frame in zip(track["trajectory"],
                              track["abs_frames"]):
            x, y, z, l, w, h, ry = det["box_3d"][:7]
            bb = det.get("bbox_2d", np.zeros(4))
            rows.append((frame, tid,
                         f"{frame} {tid} {det.get('type', 'Car')} 0 0 "
                         f"-10 {bb[0]:.4f} {bb[1]:.4f} {bb[2]:.4f} "
                         f"{bb[3]:.4f} {h:.4f} {w:.4f} {l:.4f} "
                         f"{x:.4f} {y:.4f} {z:.4f} {ry:.4f} "
                         f"{score:.4f}"))
    rows.sort(key=lambda r: (r[0], r[1]))
    return [r[2] for r in rows]


def score_tracking(kitti_lines_per_video: Dict[int, List[str]],
                   gt_loader, min_iou: float = 0.5) -> Dict:
    """CLEAR-MOT scores per video + overall; gt_loader(vid, frame) ->
    LabelArray. 'overall' pools every video in ONE accumulator, the
    official scorer's protocol (evaluate_tracking.py pools sequences)
    and the same aggregation Evaluator._run_tracking uses — a
    per-video average would weight a 10-frame clip like a 1000-frame
    one and disagree with the official numbers."""
    results = {}
    pooled = mot_eval.MotEvaluator(min_overlap=min_iou)
    for vid, lines in kitti_lines_per_video.items():
        per_frame = defaultdict(lambda: {"ids": [], "boxes": []})
        max_frame = -1
        for line in lines:
            p = line.split()
            frame, tid = int(p[0]), int(p[1])
            per_frame[frame]["ids"].append(tid)
            per_frame[frame]["boxes"].append(
                (float(p[6]), float(p[7]), float(p[8]), float(p[9])))
            max_frame = max(max_frame, frame)
        gt_frames, pred_frames = [], []
        for f in range(max_frame + 1):
            lab = gt_loader(vid, f)
            gt_frames.append({"ids": list(lab.track_ids),
                              "boxes": list(lab.bbox_2d)})
            pred_frames.append(per_frame[f])
        results[vid] = mot_eval.evaluate_tracking(gt_frames, pred_frames,
                                                  min_iou)
        pooled.add_sequence(gt_frames, pred_frames)
    if results:
        results["overall"] = pooled.results()
    return results
