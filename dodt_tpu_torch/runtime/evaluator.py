"""The device half of the evaluator (PyTorch port of
dodt_tpu/runtime/evaluator.py's ``predict_couples`` / ``predict_couple``
and ``val_health``).

A batch of val couples (or N-frame stacks) runs through one monolithic
forward; per couple, the first and last frame's final outputs are
decoded into detection dicts by the shared host decoder
(``dodt_tpu.eval.decode``), so AP and MOT scoring run on the port's
outputs through the JAX package's host scorers.

Not ported yet (ROADMAP): checkpoint restore, ``run_checkpoint_once`` and
the polling loop over the trainer's checkpoints. One card needs no mesh,
so there is no ``mesh`` argument.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from dodt_tpu_torch.config import PipelineConfig
from dodt_tpu_torch.eval import decode as decode_lib
from dodt_tpu_torch.utils.np_iou import rotated_iou_matrix
from dodt_tpu_torch.models.dt_avod import (FINAL_KEYS, Rand,
                                           compute_losses, generator_draws)
from dodt_tpu_torch.ops import boxes as box_ops


class Evaluator:
    def __init__(self, cfg: PipelineConfig, model, dataset):
        self.cfg = cfg
        self.model = model
        self.dataset = dataset
        self.device = next(model.parameters()).device

    def _load(self, idx: int) -> dict:
        if hasattr(self.dataset, "load_stack"):
            return self.dataset.load_stack(idx, augs=())
        return self.dataset.load_couple(idx, augs=())

    def _device_batch(self, samples) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.stack([s[k] for s in samples]),
                                   device=self.device)
                for k in samples[0] if isinstance(samples[0][k], np.ndarray)}

    def predict_couples(self, idxs: List[int]) -> List[Dict]:
        """Run the model on a batch of val couples; per couple, return
        detection dicts for the first and last frame in frame-0
        coordinates. The batch is padded to ``cfg.eval.batch_size`` by
        repeating the last sample; padded outputs are dropped. Only the
        final outputs come back to the host."""
        samples = [self._load(i) for i in idxs]
        target = max(self.cfg.eval.batch_size, 1, len(samples))
        padded = samples + [samples[-1]] * (target - len(samples))
        out = self.model(self._device_batch(padded), mode="val")
        out = {k: out[k].cpu().numpy() for k in FINAL_KEYS}
        thr = self.cfg.eval.kitti_score_threshold
        n_frames = out["final_boxes_3d"].shape[1]
        results = []
        for b, (idx, sample) in enumerate(zip(idxs, samples)):
            dets = [decode_lib.outputs_to_detections(
                out["final_boxes_3d"][b, f], out["final_orientations"][b, f],
                out["final_scores"][b, f], out["final_cls_softmax"][b, f],
                out["final_valid"][b, f],
                corr_offsets=out["final_corr_offsets"][b] if f == 0 else None,
                score_threshold=thr) for f in (0, n_frames - 1)]
            results.append({"sample": sample, "dets": dets,
                            "couple": self.dataset.couples[idx]})
        return results

    def predict_couple(self, idx: int) -> Dict:
        """Single-couple convenience wrapper, padded to the configured
        eval batch size."""
        return self.predict_couples([idx])[0]

    @torch.no_grad()
    def val_health(self, max_couples: Optional[int] = None,
                   rand: Optional[Rand] = None) -> Dict:
        """Val losses (train-mode losses, dropout off) and RPN proposal
        recall: the share of frame-0 GT boxes whose best BEV rotated IoU
        with a top proposal exceeds 0.3 / 0.5. Every chunk of
        ``cfg.eval.batch_size`` couples takes the same draws, as the JAX
        evaluator's fixed key gives: ``rand``, or a generator seeded 0."""
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
            _, losses = compute_losses(self.cfg, out, batch, draws)
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
