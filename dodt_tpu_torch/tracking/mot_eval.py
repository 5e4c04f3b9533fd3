"""KITTI CLEAR-MOT scorer (MOTA / MOTP / MT / PT / ML / IDS / FM).

Re-implements the exact protocol of the official KITTI tracking scorer
(reference scripts/offline_eval/kitti_tracking_native_eval/python/
evaluate_tracking.py, compute3rdPartyMetrics:375-774), parity-tested
against it in tests/test_tracking.py:

  * per-frame Hungarian association on gated 2D-bbox IoU cost
    (cost 1-IoU, gated at <= min_overlap; :425-454),
  * tracker-detection ignores: neighboring class (van / person_sitting),
    min pixel height, and DontCare-area absorption with
    intersection-over-detection > 0.5 (:497-514),
  * GT ignores by occlusion / truncation / neighboring class, split into
    ignored FN, ignored TP and ignored pairs with the official FP/FN
    accounting (:516-584),
  * trajectory-level id switches / fragmentations and MT/PT/ML on the
    per-appearance match lists (:673-734),
  * MOTA / MOTAL / MODA / MODP / precision / recall / F1 / FAR
    (:736-773).

The official scorer pools statistics over all sequences of a benchmark
run before computing ratios; `MotEvaluator.add_sequence` mirrors that.

The port's copy of dodt_tpu/tracking/mot_eval.py.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment

_MAX_COST = 1e9

# classes absorbed as "neighboring" per evaluated class (official
# evaluate_tracking.py:499-503, 526-534)
_NEIGHBORS = {"car": ("van",), "pedestrian": ("person_sitting",)}


def _iou(a: Sequence[float], b: Sequence[float],
         criterion: str = "union") -> float:
    """2D bbox overlap, official boxoverlap:346-373 ('a' = intersection
    over the first box, used for DontCare absorption)."""
    x1 = max(a[0], b[0])
    y1 = max(a[1], b[1])
    x2 = min(a[2], b[2])
    y2 = min(a[3], b[3])
    w, h = x2 - x1, y2 - y1
    if w <= 0.0 or h <= 0.0:
        return 0.0
    inter = w * h
    aarea = (a[2] - a[0]) * (a[3] - a[1])
    if criterion == "a":
        return inter / float(aarea)
    barea = (b[2] - b[0]) * (b[3] - b[1])
    return inter / float(aarea + barea - inter)


class MotEvaluator:
    """Accumulates official KITTI tracking statistics over sequences.

    Frame schema (per sequence, lists over frames):
      gt:   {"ids": [int], "boxes": [(x1,y1,x2,y2)],
             optional "types": [str], "truncation": [int],
             "occlusion": [int], "dontcare": [(x1,y1,x2,y2)]}
      pred: {"ids": [int], "boxes": [(x1,y1,x2,y2)],
             optional "types": [str]}
    Missing optional fields default to the evaluated class, truncation 0,
    occlusion 0 and no DontCare areas (nothing ignored).
    """

    def __init__(self, min_overlap: float = 0.5, cls: str = "car",
                 max_truncation: int = 0, max_occlusion: int = 2,
                 min_height: float = 25.0):
        self.min_overlap = min_overlap
        self.cls = cls.lower()
        self.max_truncation = max_truncation
        self.max_occlusion = max_occlusion
        self.min_height = min_height

        self.n_gt = 0          # GT dets minus ignored
        self.n_igt = 0
        self.n_tr = 0
        self.n_itr = 0
        self.tp = 0            # incl. ignored TP (official semantics)
        self.itp = 0
        self.fn = 0
        self.ifn = 0
        self.fp = 0
        self.total_cost = 0.0  # sum of IoU over all associations
        self.modp_t: List[float] = []
        self.n_frames = 0
        self.n_gt_trajectories = 0
        # per sequence: (traj dict id -> match list, ignore dict)
        self._seqs: List = []

    # ------------------------------------------------------ sequences

    def add_sequence(self, gt_frames: List[Dict],
                     pred_frames: List[Dict]):
        neighbors = _NEIGHBORS.get(self.cls, ())
        seq_traj: Dict = defaultdict(list)
        seq_ign: Dict = defaultdict(list)
        seen_gt_ids = set()

        for gt, pred in zip(gt_frames, pred_frames):
            g_ids = list(gt["ids"])
            g_boxes = [np.asarray(b, float) for b in gt["boxes"]]
            g_types = [t.lower() for t in
                       gt.get("types", [self.cls] * len(g_ids))]
            g_trunc = list(gt.get("truncation", [0] * len(g_ids)))
            g_occ = list(gt.get("occlusion", [0] * len(g_ids)))
            dc = [np.asarray(b, float) for b in gt.get("dontcare", [])]
            t_ids = list(pred["ids"])
            t_boxes = [np.asarray(b, float) for b in pred["boxes"]]
            t_types = [t.lower() for t in
                       pred.get("types", [self.cls] * len(t_ids))]

            for gid in g_ids:
                if gid not in seen_gt_ids:
                    seen_gt_ids.add(gid)
                    self.n_gt_trajectories += 1

            self.n_frames += 1
            self.n_gt += len(g_ids)
            self.n_tr += len(t_ids)

            # ---- gated Hungarian association (:425-454)
            n_g, n_t = len(g_ids), len(t_boxes)
            ious = np.zeros((n_g, n_t))
            cost = np.full((n_g, n_t), _MAX_COST)
            for i in range(n_g):
                for j in range(n_t):
                    o = _iou(g_boxes[i], t_boxes[j])
                    ious[i, j] = o
                    if 1.0 - o <= self.min_overlap:
                        cost[i, j] = 1.0 - o
            if n_g and n_t:
                rows, cols = linear_sum_assignment(cost)
                assoc = list(zip(rows, cols))
            else:
                assoc = []

            g_match = [-1] * n_g          # matched tracker id per gt
            g_cost = [0.0] * n_g          # IoU of accepted matches
            t_valid = [False] * n_t
            tmptp = 0
            tmpfn = 0
            tmpc = 0.0
            for gid in g_ids:
                seq_traj[gid].append(-1)
                seq_ign[gid].append(False)
            for r, c in assoc:
                if cost[r, c] < _MAX_COST:
                    g_match[r] = t_ids[c]
                    t_valid[c] = True
                    g_cost[r] = ious[r, c]
                    self.total_cost += ious[r, c]
                    tmpc += ious[r, c]
                    seq_traj[g_ids[r]][-1] = t_ids[c]
                    self.tp += 1
                    tmptp += 1
                else:
                    self.fn += 1
                    tmpfn += 1

            # ---- tracker ignores: neighbor class / small / DontCare
            # (:497-514), only for unassociated detections
            nignoredtracker = 0
            ignored_tracker_ids: Dict = {tid: -1 for tid in t_ids}
            for j in range(n_t):
                height = abs(t_boxes[j][1] - t_boxes[j][3])
                if t_valid[j]:
                    continue
                if t_types[j] in neighbors or height <= self.min_height:
                    nignoredtracker += 1
                    ignored_tracker_ids[t_ids[j]] = 1
                    continue
                for d in dc:
                    if _iou(t_boxes[j], d, "a") > 0.5:
                        nignoredtracker += 1
                        ignored_tracker_ids[t_ids[j]] = 1
                        break

            # ---- GT ignores by occlusion/truncation/class (:516-548)
            ignoredfn = 0
            nignoredtp = 0
            nignoredpairs = 0
            for i in range(n_g):
                ignorable = (g_occ[i] > self.max_occlusion or
                             g_trunc[i] > self.max_truncation or
                             g_types[i] in neighbors)
                if not ignorable:
                    continue
                seq_ign[g_ids[i]][-1] = True
                if g_match[i] == -1:
                    ignoredfn += 1
                else:
                    nignoredtp += 1
                    if ignored_tracker_ids[g_match[i]] > 0:
                        nignoredpairs += 1
                    tmpc -= g_cost[i]

            # ---- official accounting (:550-584)
            tmptp -= nignoredtp
            self.itp += nignoredtp
            self.n_gt -= ignoredfn + nignoredtp
            self.n_igt += ignoredfn + nignoredtp
            self.n_itr += nignoredtracker
            tmpfn += n_g - len(assoc) - ignoredfn
            self.fn += n_g - len(assoc) - ignoredfn
            self.ifn += ignoredfn
            self.fp += (n_t - tmptp - nignoredtracker - nignoredtp +
                        nignoredpairs)

            self.modp_t.append(1.0 if tmptp == 0 else tmpc / float(tmptp))

        self._seqs.append((seq_traj, seq_ign))

    # -------------------------------------------------------- results

    def results(self) -> Dict[str, float]:
        """Trajectory pass + final ratios (official :673-774)."""
        id_switches = 0
        fragments = 0
        mt = pt = ml = 0
        n_ignored_tr_total = 0
        for seq_traj, seq_ign in self._seqs:
            for gid, g in seq_traj.items():
                ign_g = seq_ign[gid]
                if all(ign_g):
                    n_ignored_tr_total += 1
                    continue
                if all(m == -1 for m in g):
                    ml += 1
                    continue
                last_id = g[0]
                tracked = 1 if g[0] >= 0 else 0
                f = 0
                for f in range(1, len(g)):
                    if ign_g[f]:
                        last_id = -1
                        continue
                    if (last_id != g[f] and last_id != -1 and
                            g[f] != -1 and g[f - 1] != -1):
                        id_switches += 1
                    if (f < len(g) - 1 and g[f - 1] != g[f] and
                            last_id != -1 and g[f] != -1 and
                            g[f + 1] != -1):
                        fragments += 1
                    if g[f] != -1:
                        tracked += 1
                        last_id = g[f]
                if (len(g) > 1 and g[f - 1] != g[f] and last_id != -1
                        and g[f] != -1 and not ign_g[f]):
                    fragments += 1
                ratio = tracked / float(len(g) - sum(ign_g))
                if ratio > 0.8:
                    mt += 1
                elif ratio < 0.2:
                    ml += 1
                else:
                    pt += 1

        n_traj = self.n_gt_trajectories - n_ignored_tr_total
        if n_traj <= 0:
            mt_r = pt_r = ml_r = 0.0
        else:
            mt_r = mt / float(n_traj)
            pt_r = pt / float(n_traj)
            ml_r = ml / float(n_traj)

        if (self.fp + self.tp) == 0 or (self.tp + self.fn) == 0:
            recall = precision = 0.0
        else:
            recall = self.tp / float(self.tp + self.fn)
            precision = self.tp / float(self.fp + self.tp)
        f1 = (0.0 if (recall + precision) == 0 else
              2.0 * precision * recall / (precision + recall))
        far = (0.0 if self.n_frames == 0 else
               self.fp / float(self.n_frames))

        if self.n_gt == 0:
            mota = moda = motal = -float("inf")
        else:
            mota = 1.0 - (self.fn + self.fp + id_switches) / float(self.n_gt)
            moda = 1.0 - (self.fn + self.fp) / float(self.n_gt)
            ids_term = (id_switches if id_switches == 0 else
                        math.log10(id_switches))
            motal = 1.0 - (self.fn + self.fp + ids_term) / float(self.n_gt)
        motp = (float("inf") if self.tp == 0 else
                self.total_cost / float(self.tp))
        modp = (0.0 if self.n_frames == 0 else
                sum(self.modp_t) / float(self.n_frames))

        return {
            "MOTA": 100.0 * mota,
            "MOTP": 100.0 * motp,
            "MOTAL": 100.0 * motal,
            "MODA": 100.0 * moda,
            "MODP": 100.0 * modp,
            "MT": 100.0 * mt_r,
            "PT": 100.0 * pt_r,
            "ML": 100.0 * ml_r,
            "IDS": id_switches,
            "FM": fragments,
            "TP": self.tp, "FP": self.fp, "FN": self.fn,
            "recall": 100.0 * recall,
            "precision": 100.0 * precision,
            "F1": 100.0 * f1,
            "FAR": far,
        }


def evaluate_tracking(gt_frames: List[Dict], pred_frames: List[Dict],
                      min_iou: float = 0.5, cls: str = "car",
                      **kwargs) -> Dict[str, float]:
    """Score a single sequence (official protocol; `min_iou` keeps the
    historical name — it is the official min_overlap gate)."""
    ev = MotEvaluator(min_overlap=min_iou, cls=cls, **kwargs)
    ev.add_sequence(gt_frames, pred_frames)
    return ev.results()
