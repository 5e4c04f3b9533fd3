"""Evaluation runtime: checkpoint -> predictions -> AP + MOT metrics
(PyTorch port of dodt_tpu/runtime/evaluator.py).

Per checkpoint, the val couples (or N-frame stacks) run through the
model's monolithic forward in batches of ``cfg.eval.batch_size``; each
couple's first and last frame are decoded into detection dicts
(``dodt_tpu_torch.eval.decode``), the Stack model's learned coexist
beside frame 0's.
On the host follow the KITTI prediction files per frame and per couple,
far-keyframe recovery into each frame's own coordinates, MoI fill of the
frames between keyframes when ``data_stride > 1``, detection AP
(``eval.kitti_ap``, the native library when built), the IoU tracker and
the MOT scorer (``tracking/``), and ``results_{step}.json``.
``repeated_checkpoint_run`` polls the checkpoint directory like the
reference evaluator. A single-frame dataset (no couples) takes the
detection-only evaluation: per-sample KITTI files and AP, no tracking.

The evaluator runs on ``device`` (the card unless the caller asks for
the CPU) and moves the model there. With a ``mesh`` (parallel/mesh.py)
it runs in every rank: the padded couple axis splits over the data
ranks, each forwards its rows with the replicated parameters, the
``final_*`` outputs (static shapes) are gathered over the data group and
decoded on every rank, so every rank returns the same results; only
global rank 0 writes files. ``val_health`` stays unsharded, as in JAX.
``stage_seconds`` sums the wall time of each
stage over the evaluator's runs: sample loading, the forward (ending in
the copy of its outputs to the host), file writing with recovery and
MoI, AP, tracking with MOT scoring, and ``val_health``; the
detection-only evaluation has no tracking or val_health stage.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from dodt_tpu_torch import native
from dodt_tpu_torch.config import PipelineConfig
from dodt_tpu_torch.data import kitti
from dodt_tpu_torch.eval import decode as decode_lib
from dodt_tpu_torch.eval import kitti_ap, kitti_writer
from dodt_tpu_torch.models.dt_avod import (FINAL_KEYS, Rand,
                                           generator_draws)
from dodt_tpu_torch.ops import boxes as box_ops
from dodt_tpu_torch.parallel import mesh as mesh_lib
from dodt_tpu_torch.runtime.trainer import CheckpointIO, model_losses
from dodt_tpu_torch.tracking import iou_tracker, moi, mot_eval
from dodt_tpu_torch.utils.np_iou import rotated_iou_matrix

AP_METRICS = (("image", "AP_2D"), ("ground", "AP_BEV"), ("3d", "AP_3D"))
# what the evaluator copies to the host: the decoded detections, and the
# Stack model's coexist of frame 0's (models without one lack the key, as
# the single-frame model lacks final_corr_offsets)
FETCH_KEYS = FINAL_KEYS + ("final_coexist",)


class Evaluator:
    def __init__(self, cfg: PipelineConfig, model, dataset, ckpt_dir: str,
                 output_dir: str, mesh: Optional[mesh_lib.Mesh] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.writes = mesh is None or torch.distributed.get_rank() == 0
        self.model = model.to(self.device)
        self.dataset = dataset
        self.ckpt = CheckpointIO(ckpt_dir)
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._evaluated: set = set()
        self._oxts_cache: Dict = {}
        self.stage_seconds: Dict[str, float] = defaultdict(float)
        # MoI stride evaluation by default (reference DtEvaluatorStride),
        # in the one-shot and the polling path alike
        self.interpolate = cfg.dataset.data_stride > 1
        # the native AP evaluator; without a compiler the Python route
        # serves
        native.build()

    # ---------------------------------------------------------- core

    def _load(self, idx: int) -> dict:
        if hasattr(self.dataset, "load_stack"):
            return self.dataset.load_stack(idx, augs=())
        return self.dataset.load_couple(idx, augs=())

    def _device_batch(self, samples) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.stack([s[k] for s in samples]),
                                   device=self.device)
                for k in samples[0] if isinstance(samples[0][k], np.ndarray)}

    def _forward(self, samples) -> Dict[str, np.ndarray]:
        """The val-mode forward of ``samples`` padded to
        ``cfg.eval.batch_size`` (on a mesh, then to a multiple of the data
        ranks) by repeating the last one; only FETCH_KEYS come back to
        the host."""
        target = max(self.cfg.eval.batch_size, 1, len(samples))
        if self.mesh is not None:
            target += (-target) % self.mesh.num_data
        padded = samples + [samples[-1]] * (target - len(samples))
        if self.mesh is not None:
            padded = padded[mesh_lib.batch_sharding(self.mesh, target)]
        out = self.model(self._device_batch(padded), mode="val")
        out = {k: out[k] for k in FETCH_KEYS if k in out}
        if self.mesh is not None:
            out = {k: mesh_lib.all_gather_cat(v, self.mesh.data_group,
                                              self.mesh)
                   for k, v in out.items()}
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _write(self, path: str, lines):
        """A KITTI file, written by the one writing rank."""
        if self.writes:
            kitti_writer.write_kitti_file(path, lines)

    def _write_results(self, step, results: Dict):
        if self.writes:
            with open(os.path.join(self.output_dir,
                                   f"results_{step}.json"), "w") as f:
                json.dump(results, f, indent=2)

    @torch.no_grad()
    def predict_couples(self, idxs: List[int]) -> List[Dict]:
        """Run the model on a batch of val couples; per couple, return
        detection dicts for the first and last frame in frame-0
        coordinates. The batch is padded to ``cfg.eval.batch_size`` by
        repeating the last sample; padded outputs are dropped. Only the
        final outputs come back to the host."""
        t0 = time.perf_counter()
        samples = [self._load(i) for i in idxs]
        t1 = time.perf_counter()
        out = self._forward(samples)
        t2 = time.perf_counter()
        self.stage_seconds["load"] += t1 - t0
        self.stage_seconds["forward"] += t2 - t1
        thr = self.cfg.eval.kitti_score_threshold
        n_frames = out["final_boxes_3d"].shape[1]
        results = []
        def frame0(key, b, f):
            return out[key][b] if f == 0 and key in out else None

        for b, (idx, sample) in enumerate(zip(idxs, samples)):
            dets = [decode_lib.outputs_to_detections(
                out["final_boxes_3d"][b, f], out["final_orientations"][b, f],
                out["final_scores"][b, f], out["final_cls_softmax"][b, f],
                out["final_valid"][b, f],
                corr_offsets=frame0("final_corr_offsets", b, f),
                coexist=frame0("final_coexist", b, f),
                score_threshold=thr) for f in (0, n_frames - 1)]
            results.append({"sample": sample, "dets": dets,
                            "couple": self.dataset.couples[idx]})
        return results

    def predict_couple(self, idx: int) -> Dict:
        """Single-couple convenience wrapper, padded to the configured
        eval batch size."""
        return self.predict_couples([idx])[0]

    # --------------------------------------------- val health metrics

    @torch.no_grad()
    def val_health(self, max_couples: Optional[int] = None,
                   rand: Optional[Rand] = None) -> Dict:
        """Val losses (train-mode losses, dropout off) and RPN proposal
        recall: the share of frame-0 GT boxes whose best BEV rotated IoU
        with a top proposal exceeds 0.3 / 0.5. The losses are the model's
        own (``loss_builder``). Every chunk of ``cfg.eval.batch_size``
        couples takes the same draws, as the JAX evaluator's fixed key
        gives: ``rand``, or a generator seeded 0.

        The proposals are read at ``[b, 0]`` as the JAX evaluator reads
        them (evaluator.py:210): frame 0's for the (B, F, K, 6) proposals
        of DtAvodNet, but only the top proposal of the Stack model's
        shared (B, K, 6) ones (ROADMAP C13, reproduced by design)."""
        loss_fn = model_losses(self.model)
        bsz = max(self.cfg.eval.batch_size, 1)
        n = len(self.dataset.couples)
        if max_couples is not None:
            n = min(n, max_couples)
        loss_sums: Dict[str, float] = defaultdict(float)
        hits = {0.3: 0, 0.5: 0}
        total_gt = 0
        for start in range(0, n, bsz):
            idxs = list(range(start, min(start + bsz, n)))
            samples = [self._load(i) for i in idxs]
            padded = samples + [samples[-1]] * (bsz - len(samples))
            batch = self._device_batch(padded)
            draws = rand or generator_draws(
                torch.Generator(self.device).manual_seed(0))
            out = self.model(batch, mode="train", train=False, rand=draws)
            _, losses = loss_fn(self.cfg, out, batch, draws)
            for k, v in losses.items():
                # a chunk's loss is its batch mean (padding repeats the
                # last sample, skewing only the last partial chunk)
                loss_sums[k] += float(v) * len(idxs)
            props_all = box_ops.anchors_to_box_3d(
                out["top_anchors"], fix_lw=True).cpu().numpy()
            top_valid = out["top_valid"].cpu().numpy()
            for b, sample in enumerate(samples):
                props = props_all[b, 0][top_valid[b, 0]]
                gt = sample["gt_boxes"][0][sample["gt_valid"][0]]
                total_gt += len(gt)
                if not len(props) or not len(gt):
                    continue
                best = rotated_iou_matrix(
                    gt[:, [0, 2, 3, 4, 6]],
                    props[:, [0, 2, 3, 4, 6]]).max(axis=1)
                for thr in hits:
                    hits[thr] += int(np.sum(best > thr))
        return {
            "val_losses": {k: v / max(n, 1) for k, v in loss_sums.items()},
            "proposal_recall": {f"iou_{t}": hits[t] / max(total_gt, 1)
                                for t in sorted(hits)},
            "num_couples": n, "num_gt": total_gt,
        }

    # ------------------------------------------------ one checkpoint

    def _ap_both_passes(self, gts, det_frames):
        """(AP per class with Car at min IoU 0.7 and the others at 0.5, as
        the official evaluator's CLASS_NAMES/MIN_OVERLAP; every class at
        0.5, the reference's evaluate_object_3d_offline_05_iou run, the
        non-Car classes reusing their first pass)."""
        first = {cls_name: {name: kitti_ap.evaluate_ap(
            gts, det_frames, cls_name, metric,
            0.7 if cls_name == "Car" else 0.5)
            for metric, name in AP_METRICS}
            for cls_name in self.cfg.dataset.classes}
        second = dict(first)
        if "Car" in first:
            second["Car"] = {name: kitti_ap.evaluate_ap(
                gts, det_frames, "Car", metric, 0.5)
                for metric, name in AP_METRICS}
        return first, second

    def run_checkpoint_once(self, step: Optional[int] = None,
                            interpolate: Optional[bool] = None) -> Dict:
        """Evaluate one checkpoint. With interpolation (default: on
        whenever data_stride > 1, overridable per call or via
        ``self.interpolate``) MoI fills the tau-1 non-keyframes per
        couple and writes per-frame files (reference
        DtEvaluatorStride)."""
        if interpolate is None:
            interpolate = self.interpolate
        params = self.ckpt.restore_params(
            step, prefer_ema=self.cfg.train.optimizer.use_moving_average)
        if params is None:
            raise FileNotFoundError("no checkpoint")
        step = step if step is not None else self.ckpt.latest_step()
        self.model.load_state_dict(params, strict=True)

        if not hasattr(self.dataset, "couples"):
            return self._run_detection_only(step)

        pred_dir = os.path.join(self.output_dir,
                                f"predictions_{step}", "data")
        os.makedirs(pred_dir, exist_ok=True)
        # extended per-couple files carrying corr offsets + coexist so
        # offline MOT runs reconstruct the full in-memory contract
        # (reference dt_evaluator.py:1134-1259 writes these columns)
        couples_dir = os.path.join(self.output_dir,
                                   f"predictions_{step}", "couples")
        os.makedirs(couples_dir, exist_ok=True)

        # per-video collections for tracking
        video_dets: Dict[int, Dict[int, List]] = defaultdict(dict)
        video_img_size: Dict[int, tuple] = {}
        gts: List[kitti_ap.FrameGt] = []
        det_frames: List[kitti_ap.FrameDet] = []

        n = len(self.dataset.couples)
        bsz = max(self.cfg.eval.batch_size, 1)
        secs = self.stage_seconds

        def chunks():
            for start in range(0, n, bsz):
                idxs = list(range(start, min(start + bsz, n)))
                yield from zip(idxs, self.predict_couples(idxs))

        for idx, res in chunks():
            t0 = time.perf_counter()
            cp = self.dataset.couples[idx]
            dets0 = res["dets"][0]
            calib = self.dataset.calib(cp.video_id)
            img_size = (int(res["sample"]["orig_image_shape"][1]),
                        int(res["sample"]["orig_image_shape"][0]))
            tau = cp.frame_b - cp.frame_a
            for d in dets0:
                # predicted corr offsets span the couple's frame gap
                d["offsets_span"] = tau

            # ---- detection AP bookkeeping (frame 0 only, like
            # dt_evaluator.py:296-300)
            raw0 = self.dataset.raw_labels(cp.video_id, cp.frame_a)
            dc0 = np.array([t == "DontCare" for t in raw0.types], bool)
            gts.append(kitti_ap.FrameGt.from_labels(
                raw0.select(~dc0), dontcare=raw0.bbox_2d[dc0]))
            det_frames.append(self._frame_det(dets0, calib, img_size))

            # ---- KITTI txt files
            self._write(
                os.path.join(pred_dir,
                             f"{cp.video_id:02d}{cp.frame_a:04d}.txt"),
                self._kitti_lines(dets0, calib, img_size))
            video_dets[cp.video_id][cp.frame_a] = dets0
            video_img_size[cp.video_id] = img_size

            # ---- far keyframe: the model emits frame-B boxes in frame-A
            # coordinates; recover them into frame B's own (reference
            # recovery_coordinate, evaluator_utils.py:401). The next
            # couple's own frame-A detections overwrite this entry and
            # file; it stands only for each video's last keyframe.
            dets_b = None
            if cp.frame_b > cp.frame_a:
                dets_b = self._recover_dets(
                    res["dets"][1], calib, cp.video_id, cp.frame_a,
                    cp.frame_b)
                self._write(
                    os.path.join(pred_dir,
                                 f"{cp.video_id:02d}{cp.frame_b:04d}.txt"),
                    self._kitti_lines(dets_b, calib, img_size))
                video_dets[cp.video_id][cp.frame_b] = dets_b

            # extended couple file: keyframe dets with offsets/coexist
            by_frame = {cp.frame_a: dets0}
            if dets_b is not None:
                by_frame[cp.frame_b] = dets_b
            self._write(
                os.path.join(couples_dir, f"{cp.name}.txt"),
                kitti_writer.couple_detections_to_lines(
                    by_frame, classes=self.cfg.dataset.classes))

            # ---- MoI: synthesise the tau-1 intermediate frames, then
            # recover each from frame-A coordinates into its own frame
            # (reference recovery loop, evaluator_utils.py:502-506)
            if interpolate and cp.frame_b > cp.frame_a + 1:
                frames = moi.interpolate_non_keyframes(
                    dets0, res["dets"][1], tau + 1,
                    self.cfg.eval.kitti_score_threshold)
                for off in range(1, tau):
                    frame_no = cp.frame_a + off
                    recovered = self._recover_dets(
                        frames[off], calib, cp.video_id, cp.frame_a,
                        frame_no)
                    self._write(
                        os.path.join(pred_dir,
                                     f"{cp.video_id:02d}{frame_no:04d}.txt"),
                        self._kitti_lines(recovered, calib, img_size))
                    video_dets[cp.video_id][frame_no] = recovered
            secs["write"] += time.perf_counter() - t0

        # ---- AP per class at both passes
        t0 = time.perf_counter()
        ap_per_class, ap_05_per_class = self._ap_both_passes(gts, det_frames)
        ap = ap_per_class[self.cfg.dataset.classes[0]]
        t1 = time.perf_counter()
        secs["ap"] += t1 - t0

        # ---- tracking
        mot = self._run_tracking(video_dets, video_img_size)
        secs["tracking"] += time.perf_counter() - t1

        results = {"step": int(step), "ap": ap,
                   "ap_per_class": ap_per_class,
                   "ap_05_per_class": ap_05_per_class, "mot": mot}

        # ---- val health: per-checkpoint val losses + proposal recall
        # (reference dt_evaluator.py:764-810)
        if self.cfg.eval.val_health:
            t0 = time.perf_counter()
            results["val_health"] = self.val_health()
            secs["val_health"] += time.perf_counter() - t0
        self._write_results(step, results)
        self._evaluated.add(int(step))
        return results

    def _run_detection_only(self, step) -> Dict:
        """Single-frame evaluation over KittiDataset samples (the
        reference's AVOD evaluator loop, evaluator.py): per-sample KITTI
        files and official-protocol AP at both IoU passes, no MOT, in the
        JAX evaluator's order of operations (evaluator.py:402-490)."""
        pred_dir = os.path.join(self.output_dir,
                                f"predictions_{step}", "data")
        os.makedirs(pred_dir, exist_ok=True)
        thr = self.cfg.eval.kitti_score_threshold
        gts: List[kitti_ap.FrameGt] = []
        det_frames: List[kitti_ap.FrameDet] = []
        names = list(self.dataset.sample_names)
        bsz = max(self.cfg.eval.batch_size, 1)
        secs = self.stage_seconds
        for start in range(0, len(names), bsz):
            t0 = time.perf_counter()
            idxs = range(start, min(start + bsz, len(names)))
            samples = [self.dataset.load_sample(i, augs=()) for i in idxs]
            t1 = time.perf_counter()
            out = self._forward(samples)
            t2 = time.perf_counter()
            secs["load"] += t1 - t0
            secs["forward"] += t2 - t1
            for b, (i, sample) in enumerate(zip(idxs, samples)):
                name = names[i]
                dets = decode_lib.outputs_to_detections(
                    out["final_boxes_3d"][b, 0],
                    out["final_orientations"][b, 0],
                    out["final_scores"][b, 0],
                    out["final_cls_softmax"][b, 0], out["final_valid"][b, 0],
                    score_threshold=thr)
                calib = kitti.read_calibration(self.dataset.calib_dir, name)
                img_size = (int(sample["orig_image_shape"][1]),
                            int(sample["orig_image_shape"][0]))
                raw = kitti.read_labels(self.dataset.label_dir, name,
                                        keep_dontcare=True)
                dc = np.array([t == "DontCare" for t in raw.types], bool)
                gts.append(kitti_ap.FrameGt.from_labels(
                    raw.select(~dc), dontcare=raw.bbox_2d[dc]))
                det_frames.append(self._frame_det(dets, calib, img_size))
                self._write(
                    os.path.join(pred_dir, f"{name}.txt"),
                    self._kitti_lines(dets, calib, img_size))
            secs["write"] += time.perf_counter() - t2

        t0 = time.perf_counter()
        ap_per_class, ap_05_per_class = self._ap_both_passes(gts, det_frames)
        secs["ap"] += time.perf_counter() - t0
        results = {"step": int(step),
                   "ap": ap_per_class[self.cfg.dataset.classes[0]],
                   "ap_per_class": ap_per_class,
                   "ap_05_per_class": ap_05_per_class}
        self._write_results(step, results)
        self._evaluated.add(int(step))
        return results

    # ------------------------------------------- ego-motion recovery

    def _oxts(self, video_id: int, frame: int):
        key = (video_id, frame)
        if key not in self._oxts_cache:
            try:
                self._oxts_cache[key] = kitti.read_oxts(
                    self.dataset.oxts_dir, video_id, frame)
            except (OSError, IndexError, ValueError):
                self._oxts_cache[key] = None   # no pose: zero ego
        return self._oxts_cache[key]

    def _ego(self, video_id: int, frame_from: int, frame_to: int):
        """(trans, matrix, dyaw) expressing frame_to coords in
        frame_from coords, or None for identity/unknown."""
        if frame_from == frame_to:
            return None
        o_from = self._oxts(video_id, frame_from)
        o_to = self._oxts(video_id, frame_to)
        if o_from is None or o_to is None:
            return None
        trans, matrix, dyaw = kitti.ego_motion(o_from, o_to)
        if kitti.is_identity_ego(trans, matrix, dyaw):
            return None
        return trans, matrix, dyaw

    def _recover_dets(self, dets, calib, video_id: int,
                      frame_base: int, frame_own: int):
        """Copy det dicts whose box_3d is in frame_base coordinates,
        recovering box_3d into frame_own's own coordinates (reference
        recovery_coordinate, evaluator_utils.py:401). Identity ego ->
        boxes pass through bit-identical."""
        ego = self._ego(video_id, frame_base, frame_own)
        if not dets or ego is None:
            return [dict(d) for d in dets]
        trans, matrix, dyaw = ego
        boxes = np.stack([d["box_3d"] for d in dets])
        rec = kitti.transform_boxes_3d(boxes, calib, trans, matrix,
                                       dyaw, inverse=True)
        out = []
        for d, b in zip(dets, rec):
            nd = dict(d)
            nd["box_3d"] = b
            out.append(nd)
        return out

    def _align_dets_to_prev(self, vid: int, frames: Dict[int, List],
                            order, calib):
        """Set box_aligned on every det: its box expressed in the
        previous tracked frame's coordinates, so the tracker's
        association IoU is ego-compensated (the reference's dets_for_ious
        second stream, evaluator_utils.py:642-646; the same known oxts
        transform also covers the MoI frames)."""
        for i in range(1, len(order)):
            dets = frames[order[i]]
            if not dets:
                continue
            ego = self._ego(vid, order[i - 1], order[i])
            if ego is None:
                for d in dets:
                    d["box_aligned"] = None
                continue
            trans, matrix, dyaw = ego
            boxes = np.stack([d["box_3d"] for d in dets])
            aligned = kitti.transform_boxes_3d(boxes, calib, trans,
                                               matrix, dyaw)
            for d, b in zip(dets, aligned):
                d["box_aligned"] = b

    def _frame_det(self, dets, calib, img_size) -> kitti_ap.FrameDet:
        boxes, bbs, scores, types = [], [], [], []
        for d in dets:
            bb = kitti_writer.project_box_to_image(d["box_3d"], calib,
                                                   img_size)
            if bb is None:
                continue
            boxes.append(d["box_3d"])
            bbs.append(bb)
            scores.append(d["score"])
            types.append(self.cfg.dataset.classes[d["class_idx"]])
        if not boxes:
            return kitti_ap.FrameDet(np.zeros((0, 7)), np.zeros((0, 4)),
                                     np.zeros(0), [])
        return kitti_ap.FrameDet(np.stack(boxes), np.stack(bbs),
                                 np.asarray(scores), types)

    def _kitti_lines(self, dets, calib, img_size):
        if not dets:
            return []
        boxes = np.stack([d["box_3d"] for d in dets])
        scores = np.array([d["score"] for d in dets])
        cls = np.array([d["class_idx"] for d in dets])
        return kitti_writer.predictions_to_kitti_lines(
            boxes, scores, cls, calib, img_size,
            classes=self.cfg.dataset.classes,
            score_threshold=self.cfg.eval.kitti_score_threshold)

    def _run_tracking(self, video_dets, video_img_size=None) -> Dict:
        """Track per video and score with the official-protocol MOT
        scorer: GT includes DontCare regions, neighbouring classes and
        truncation/occlusion for the official ignore rules; 'overall'
        pools all videos in one accumulator (as the official scorer
        pools its sequences) rather than averaging per-video scores."""
        ev = self.cfg.eval
        cls = self.cfg.dataset.classes[0].lower()
        # GT classes the official loader keeps for this eval class
        allowed = {cls} | set(mot_eval._NEIGHBORS.get(cls, ()))
        raw_labels = getattr(self.dataset, "raw_labels",
                             self.dataset.labels)
        all_results = {}
        pooled = mot_eval.MotEvaluator(cls=cls)
        for vid, frames in video_dets.items():
            order = sorted(frames)
            img_size = (video_img_size or {}).get(vid, (1242, 375))
            calib = self.dataset.calib(vid)
            # ego-compensated association: express each frame's boxes
            # in the previous tracked frame's coordinates
            self._align_dets_to_prev(vid, frames, order, calib)
            gaps = [0] + [order[i] - order[i - 1]
                          for i in range(1, len(order))]
            dets_seq = [[d for d in frames[f]
                         if d["score"] >= ev.track_lth] for f in order]
            tracks = iou_tracker.track_through_ious(
                dets_seq, ev.track_hth, ev.track_liou, ev.track_tmin,
                frame_gaps=gaps)
            # score vs GT tracking labels
            gt_frames, pred_frames = [], []
            for fi, f in enumerate(order):
                lab = raw_labels(vid, f)
                keep = np.array([t.lower() in allowed
                                 for t in lab.types], bool)
                dontcare = [b for t, b in zip(lab.types, lab.bbox_2d)
                            if t == "DontCare"]
                gt_frames.append({
                    "ids": list(lab.track_ids[keep]),
                    "boxes": list(lab.bbox_2d[keep]),
                    "types": [t.lower() for t in lab.types[keep]],
                    "truncation": list(lab.truncation[keep].astype(int)),
                    "occlusion": list(lab.occlusion[keep].astype(int)),
                    "dontcare": dontcare})
                ids, boxes = [], []
                for tid, tr in enumerate(tracks):
                    if fi in tr["frames"]:
                        det = tr["trajectory"][tr["frames"].index(fi)]
                        # clip to the real image so pred and GT 2D boxes
                        # live in the same coordinate contract
                        bb = kitti_writer.project_box_to_image(
                            det["box_3d"], calib, img_size)
                        if bb is not None:
                            ids.append(tid)
                            boxes.append(bb)
                pred_frames.append({"ids": ids, "boxes": boxes})
            all_results[vid] = mot_eval.evaluate_tracking(
                gt_frames, pred_frames, cls=cls)
            pooled.add_sequence(gt_frames, pred_frames)
        if all_results:
            all_results["overall"] = pooled.results()
        return all_results

    # ------------------------------------------------------- polling

    def run_latest_checkpoints(self):
        results = []
        for step in self.ckpt.all_steps():
            if step not in self._evaluated:
                results.append(self.run_checkpoint_once(step))
        return results

    def repeated_checkpoint_run(self, max_wait_rounds: int = 10000,
                                stop_at_step: Optional[int] = None):
        """Poll the checkpoint dir like the reference evaluator
        (dt_evaluator.py:461: poll every eval_wait_interval seconds,
        skip already-evaluated checkpoints)."""
        interval = self.cfg.eval.eval_wait_interval
        results = []
        for _ in range(max_wait_rounds):
            new = self.run_latest_checkpoints()
            results.extend(new)
            if stop_at_step is not None and \
                    any(r["step"] >= stop_at_step for r in results):
                break
            if not new:
                time.sleep(interval)
        return results
