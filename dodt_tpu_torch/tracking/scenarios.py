"""Hard MOT scenarios — detection-level fixtures that un-saturate the
CLEAR metrics.

The easy fixtures pin MOTA 100 / IDS 0, where a tracker regression
(broken ttl, association-order bug, ID-switch explosion) is invisible;
the reference's own val tables live at MOTA 79.72 with IDS 7 / FM 66
(the reference README.md:196-205). This module builds a deterministic
scenario exercising the tracker's failure modes:

  * a crossing pair whose paths swap-tempt a zero-offset association
    exactly at the crossing (IDS probe),
  * a fast pair moving more than a box length per frame — only offset
    propagation (or a warmed-up motion model) can follow it,
  * a k-frame occlusion gap with a tail shorter than t_min — bridged by
    ttl>1 (track_iou_v2 semantics,
    the reference avod/core/tracking/dt_tracking_eval.py:271),
    dropped by ttl=1 (:204),
  * a mid-sequence birth and a mid-sequence death,
  * a near-miss parallel pair (association must not swap),
  * a low-score object the score gate must drop (ML probe).

Detections are the tracker-level dicts of tracking/iou_tracker.py; GT
frames are the scorer schema of tracking/mot_eval.MotEvaluator. The 2D
boxes on both sides come from the same pinhole projection of the 3D
boxes, so the official 2D-IoU scoring protocol applies unchanged.

The port's copy of dodt_tpu/tracking/scenarios.py.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# pinhole fake camera: u = CU + F*x/z, box width/height scale with 1/z.
# F chosen so every scenario box clears the official 25 px min height.
_F, _CU, _CV = 1200.0, 600.0, 180.0


def project_box(box_3d) -> Tuple[float, float, float, float]:
    """box_3d [x,y,z,l,w,h,ry] -> (x1,y1,x2,y2). Orientation is ignored
    (apparent width = l): the scorer only needs GT and predictions to be
    projected consistently, not photo-realistically."""
    x, y, z, l, w, h, ry = [float(v) for v in box_3d[:7]]
    z = max(z, 1.0)
    u1 = _CU + _F * (x - l / 2.0) / z
    u2 = _CU + _F * (x + l / 2.0) / z
    v2 = _CV + _F * y / z          # y is the box bottom (camera frame)
    v1 = v2 - _F * h / z
    return (u1, v1, u2, v2)


def ego_poses(n_frames: int, speed: float = 0.0,
              yaw_rate: float = 0.0) -> np.ndarray:
    """(n, 3) [tx, tz, yaw] platform poses in world coordinates: the
    ego drives along its own heading at `speed` m/frame while yawing
    `yaw_rate` rad/frame (a moving KITTI platform; the stationary
    scenario is poses == 0)."""
    poses = np.zeros((n_frames, 3))
    tx = tz = 0.0
    for f in range(n_frames):
        yaw = yaw_rate * f
        poses[f] = (tx, tz, yaw)
        tx += speed * np.sin(yaw)
        tz += speed * np.cos(yaw)
    return poses


def _rot(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s], [s, c]])


def boxes_world_to_ego(boxes: np.ndarray, pose) -> np.ndarray:
    """box_3d rows from world coords into the ego frame at `pose`."""
    tx, tz, yaw = pose
    out = np.array(boxes, np.float64).copy()
    d = out[:, [0, 2]] - (tx, tz)
    out[:, [0, 2]] = d @ _rot(yaw)      # == R(yaw)^T applied row-wise
    out[:, 6] -= yaw
    return out


def boxes_ego_to_world(boxes: np.ndarray, pose) -> np.ndarray:
    tx, tz, yaw = pose
    out = np.array(boxes, np.float64).copy()
    out[:, [0, 2]] = out[:, [0, 2]] @ _rot(yaw).T
    out[:, [0, 2]] += (tx, tz)
    out[:, 6] += yaw
    return out


def make_ego_fn(poses: np.ndarray):
    """(i_prev, i_cur, boxes) -> boxes re-expressed in frame i_cur's
    ego coordinates, given boxes in frame i_prev's (the kf_pipeline /
    align contract, both directions derivable by swapping indices)."""
    def fn(i_prev, i_cur, boxes):
        return boxes_world_to_ego(
            boxes_ego_to_world(boxes, poses[i_prev]), poses[i_cur])
    return fn


class _Obj:
    def __init__(self, oid, x0, z0, vx, vz, first=0, last=None,
                 score=0.95, missing=()):
        self.oid = oid
        self.x0, self.z0, self.vx, self.vz = x0, z0, vx, vz
        self.first = first
        self.last = last            # inclusive; None = scenario end
        self.score = score
        self.missing = set(missing)  # frames with GT but no detection

    def box(self, f) -> np.ndarray:
        t = f - self.first
        return np.array([self.x0 + self.vx * t, 1.65,
                         self.z0 + self.vz * t,
                         3.9, 1.6, 1.5, 0.0])


def hard_mot_scenario(n_frames: int = 32, noise: float = 0.05,
                      zero_offsets: bool = False, seed: int = 0,
                      occlusion_gap: Tuple[int, int] = (27, 29),
                      poses: Optional[np.ndarray] = None,
                      aligned: bool = True):
    """Returns (gt_frames, dets_per_frame).

    gt_frames: MotEvaluator schema (ids / 2D boxes / types per frame).
    dets_per_frame: iou_tracker det dicts with per-frame `offsets`
    (offsets_span 1) — the ground-truth motion, zeroed when
    `zero_offsets` (the deliberately-broken-association regression arm).

    `poses`: optional (n_frames, 3) ego poses from `ego_poses` — the
    moving-platform variant. GT 2D boxes and det box_3d are expressed
    in each frame's own ego coordinates (what the sensors see); det
    `offsets` are the object's world motion rotated into the det's
    frame (the model's frame-A-coordinates contract); with `aligned`,
    each det also carries `box_aligned` (its box in the PREVIOUS
    frame's ego coordinates — the Evaluator's _align_dets_to_prev
    contract), and objects that fall behind the platform (ego-relative
    z < 4) leave both GT and detections, like a real camera's FOV.
    Separating this arm from `zero_offsets` isolates "tracker ignores
    ego motion" from "tracker ignores learned offsets" (VERDICT r4
    weak #7).
    """
    g0, g1 = occlusion_gap
    objs = [
        # crossing pair (z 20.0 both): swap-tempts zero-offset greedy
        # association at the crossing frame
        _Obj(0, -18.0, 20.0, +2.2, 0.0),
        _Obj(1, +18.0, 20.0, -2.2, 0.0),
        # occluded: GT present throughout, dets missing g0..g1; the
        # post-gap tail is shorter than t_min=3
        _Obj(2, -10.0, 10.0, 0.0, +0.5,
             missing=range(g0, g1 + 1)),
        # mid-sequence birth / death
        _Obj(3, 8.0, 40.0, 0.0, -0.5, first=10),
        _Obj(4, 12.0, 12.0, 0.0, +0.4, last=21),
        # near-miss parallel pair, 2.5 m apart, identical velocity
        _Obj(5, -1.25, 38.0, 0.0, -0.6),
        _Obj(6, +1.25, 38.0, 0.0, -0.6),
        # low-score object: the σ_h score gate must drop it (ML probe)
        _Obj(7, -14.0, 30.0, +0.3, 0.0, score=0.45),
        # fast pair: 4.4 m/frame > box length — zero-offset IoU with the
        # next detection is 0, only offset propagation follows
        _Obj(8, -18.0, 26.0, +4.4, 0.0),
        _Obj(9, +18.0, 30.0, -4.4, 0.0),
    ]
    rng = np.random.default_rng(seed)
    gt_frames: List[Dict] = []
    dets_per_frame: List[List[Dict]] = []
    for f in range(n_frames):
        pose = poses[f] if poses is not None else (0.0, 0.0, 0.0)
        ids, boxes2d = [], []
        dets: List[Dict] = []
        for o in objs:
            if f < o.first or (o.last is not None and f > o.last):
                continue
            box = o.box(f)                      # world coords
            ego_box = boxes_world_to_ego(box[None], pose)[0]
            if poses is not None and ego_box[2] < 4.0:
                continue                        # behind the platform
            ids.append(o.oid)
            boxes2d.append(project_box(ego_box))
            if f in o.missing:
                continue
            nbox_w = box.copy()                 # noise in world coords
            nbox_w[[0, 2]] += rng.normal(0.0, noise, 2)
            nbox_w[6] += rng.normal(0.0, noise * 0.2)
            nbox = boxes_world_to_ego(nbox_w[None], pose)[0]
            off_xz = np.array([o.vx, o.vz]) @ _rot(pose[2])
            offsets = np.array([off_xz[0], off_xz[1], 0.0])
            det = {
                "frame_id": f,
                "box_3d": nbox,
                "score": o.score,
                "offsets": (np.zeros(3) if zero_offsets else offsets),
                "offsets_span": 1,
                "bbox_2d": project_box(nbox),
                "gt_id": o.oid,   # for debugging only, unused by tracker
            }
            if poses is not None and aligned and f > 0:
                det["box_aligned"] = boxes_world_to_ego(
                    nbox_w[None], poses[f - 1])[0]
            dets.append(det)
        gt_frames.append({"ids": ids, "boxes": boxes2d,
                          "types": ["car"] * len(ids)})
        dets_per_frame.append(dets)
    return gt_frames, dets_per_frame


def birth_death_scenario(n_frames: int = 33, tau: int = 4,
                         noise: float = 0.03, seed: int = 1,
                         coexist_mode: str = "learned"):
    """Birth/death-heavy keyframe scenario for the coexist A/B
    (VERDICT r4 item 3): detections exist only at keyframes (stride
    tau); several objects are born or die MID-GAP, and one persistent
    object has keyframe detector misses. MoI must decide whether an
    unmatched keyframe det extrapolates through the gap or blanks half
    of it — exactly what the stack model's coexist head (reference
    stack_avod_model.py:306-316, consumed by interpolate_trajectory's
    birth/death branches, evaluator_utils.py:529-570) predicts.

    coexist_mode:
      "learned"  — each det carries the TRUE P(exists at the other
                   keyframe of its couple) (a perfect coexist head);
      "constant" — every det claims 1.0 (the pre-r5 live path);
      "none"     — 0.5 (a model without the head).

    Returns (gt_frames, couples) where couples is a list of
    (frame_a, frame_b, dets0, dets1) ready for
    moi.interpolate_non_keyframes — dets are fresh per couple because
    coexist is a per-couple prediction (frame-b dets answer "existed
    at frame a?", the same physical frame's dets answer "exists at
    frame b?" for the next couple)."""
    assert coexist_mode in ("learned", "constant", "none")
    rng = np.random.default_rng(seed)
    keyframes = list(range(0, n_frames, tau))
    objs = [
        # persistent movers
        _Obj(0, -14.0, 18.0, +1.0, +0.3),
        _Obj(1, +12.0, 30.0, -0.8, -0.4),
        _Obj(2, -4.0, 40.0, +0.4, -0.7),
        _Obj(3, +5.0, 14.0, -0.3, +0.6),
        # mid-gap deaths (last frame falls strictly inside a gap)
        _Obj(4, -8.0, 24.0, +0.9, 0.0, last=tau + 1),
        _Obj(5, +9.0, 20.0, -0.6, +0.5, last=3 * tau + 2),
        _Obj(6, -2.0, 34.0, +0.5, -0.5, last=5 * tau + 1),
        # mid-gap births
        _Obj(7, +2.0, 26.0, +0.7, +0.4, first=tau + 2),
        _Obj(8, -11.0, 36.0, +0.8, -0.3, first=3 * tau + 1),
        _Obj(9, +13.0, 16.0, -0.9, +0.5, first=5 * tau + 2),
        # persistent mover the detector misses at two keyframes
        _Obj(10, -6.0, 28.0, +0.6, +0.3,
             missing=(keyframes[3], keyframes[6])),
    ]

    def alive(o, f):
        return o.first <= f and (o.last is None or f <= o.last)

    gt_frames: List[Dict] = []
    for f in range(n_frames):
        ids, boxes2d = [], []
        for o in objs:
            if alive(o, f):
                ids.append(o.oid)
                boxes2d.append(project_box(o.box(f)))
        gt_frames.append({"ids": ids, "boxes": boxes2d,
                          "types": ["car"] * len(ids)})

    def make_det(o, f, other_f):
        box = o.box(f)
        nbox = box.copy()
        nbox[[0, 2]] += rng.normal(0.0, noise, 2)
        if coexist_mode == "learned":
            # the head predicts EXISTENCE at the other keyframe, not
            # detection: a detector miss there still has coexist 1
            coex = 1.0 if alive(o, other_f) else 0.0
        elif coexist_mode == "constant":
            coex = 1.0
        else:
            coex = 0.5
        return {
            "frame_id": f,
            "box_3d": nbox,
            "score": o.score,
            "offsets": np.array([o.vx, o.vz, 0.0]) * tau,
            "offsets_span": tau,
            "bbox_2d": project_box(nbox),
            "coexist": coex,
        }

    couples = []
    for ka, kb in zip(keyframes[:-1], keyframes[1:]):
        dets0 = [make_det(o, ka, kb) for o in objs
                 if alive(o, ka) and ka not in o.missing]
        dets1 = [make_det(o, kb, ka) for o in objs
                 if alive(o, kb) and kb not in o.missing]
        couples.append((ka, kb, dets0, dets1))
    return gt_frames, couples


def run_moi_tracking(gt_frames: List[Dict], couples, n_frames: int,
                     high_threshold: float = 0.85,
                     iou_threshold: float = 0.005,
                     t_min: int = 3) -> Dict:
    """The Evaluator's MoI flow on scenario couples: per couple,
    interpolate the tau-1 non-keyframes (frame-a dets overwrite the
    previous couple's far-frame slot, runtime/evaluator.py rule), then
    run the IoU tracker over every frame and score CLEAR-MOT."""
    from dodt_tpu_torch.tracking import iou_tracker, moi, mot_eval

    frames: Dict[int, List[Dict]] = {}
    for ka, kb, dets0, dets1 in couples:
        filled = moi.interpolate_non_keyframes(dets0, dets1,
                                               kb - ka + 1)
        for off, dets in enumerate(filled):
            if ka + off == kb and kb != n_frames - 1:
                continue   # the next couple's frame-a slot wins
            frames[ka + off] = dets
    dets_seq = [frames.get(f, []) for f in range(n_frames)]
    tracks = iou_tracker.track_through_ious(
        dets_seq, high_threshold, iou_threshold, t_min,
        frame_gaps=[0] + [1] * (n_frames - 1))
    r = mot_eval.evaluate_tracking(
        gt_frames, tracks_to_pred_frames(tracks, n_frames))
    r["n_tracks"] = len(tracks)
    return r


def tracks_to_pred_frames(tracks: List[Dict], n_frames: int
                          ) -> List[Dict]:
    """Tracker output (iou_tracker / kf_pipeline trajectory format) ->
    MotEvaluator pred-frame schema, 2D boxes via the same projection."""
    frames = [{"ids": [], "boxes": []} for _ in range(n_frames)]
    for tid, tr in enumerate(tracks):
        for det, f in zip(tr["trajectory"], tr["frames"]):
            bb = det.get("bbox_2d")
            if bb is None:
                bb = project_box(det["box_3d"])
            frames[f]["ids"].append(tid)
            frames[f]["boxes"].append(bb)
    return frames
