"""The device half of the evaluator (PyTorch port of
dodt_tpu/runtime/evaluator.py's ``predict_couples`` / ``predict_couple``).

A batch of val couples (or N-frame stacks) runs through one monolithic
forward; per couple, the first and last frame's final outputs are
decoded into detection dicts by the shared host decoder
(``dodt_tpu.eval.decode``), so AP and MOT scoring run on the port's
outputs through the JAX package's host scorers.

Not ported yet (ROADMAP): checkpoint restore, ``run_checkpoint_once`` and
the polling loop, which need the trainer's checkpoint format, and
``val_health``, which needs the train-mode losses. One card needs no
mesh, so there is no ``mesh`` argument.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from dodt_tpu.config import PipelineConfig
from dodt_tpu.eval import decode as decode_lib
from dodt_tpu_torch.models.dt_avod import FINAL_KEYS


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

    def predict_couples(self, idxs: List[int]) -> List[Dict]:
        """Run the model on a batch of val couples; per couple, return
        detection dicts for the first and last frame in frame-0
        coordinates. The batch is padded to ``cfg.eval.batch_size`` by
        repeating the last sample; padded outputs are dropped. Only the
        final outputs come back to the host."""
        samples = [self._load(i) for i in idxs]
        target = max(self.cfg.eval.batch_size, 1, len(samples))
        padded = samples + [samples[-1]] * (target - len(samples))
        batch = {k: torch.as_tensor(np.stack([s[k] for s in padded]),
                                    device=self.device)
                 for k in padded[0] if isinstance(padded[0][k], np.ndarray)}
        out = self.model(batch, mode="val")
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
