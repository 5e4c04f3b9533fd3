"""Streaming predictor: one keyframe at a time, with the previous
frame's state kept on the device (PyTorch port of
dodt_tpu/runtime/predictor.py).

Each keyframe is encoded once (towers + RPN); its features and proposals
stay resident and the pair stage (correlation + second stage) runs
against the cached previous keyframe when the next one lands.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dodt_tpu_torch.utils.metrics import latency_stats, span
from dodt_tpu_torch.ops.warp import transform_anchors_xz, warp_bev_features


class StreamingPredictor:
    def __init__(self, model, device="cuda"):
        """Runs on ``device``, the card unless the caller asks for the
        CPU, and moves the model there."""
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self.encode_times: List[float] = []
        self.pair_times: List[float] = []

    def reset(self):
        self._state = None

    def warp_state(self, state: Dict[str, torch.Tensor], a2: torch.Tensor,
                   b2: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Express a frame state in another frame's BEV coordinates.
        (a2, b2) map the state's own (x, z) into the destination frame;
        features resample through the inverse map, boxes move forward."""
        bev_extents = self.model.cfg.dataset.kitti_utils.bev_extents
        inv_a = torch.linalg.inv(a2)
        inv_b = -(inv_a @ b2)
        out = dict(state)
        out["bev_feats"] = torch.stack([
            warp_bev_features(f, inv_a, inv_b, bev_extents)
            for f in state["bev_feats"]])
        out["top_anchors"] = transform_anchors_xz(state["top_anchors"], a2,
                                                  b2)
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def push_keyframe(self, frame_batch: Dict[str, np.ndarray],
                      fetch: bool = True,
                      ego_to_prev=None) -> Optional[Dict]:
        """Feed one keyframe (arrays with leading batch axis 1). Returns
        the pair detections once two keyframes are buffered (the result
        covers the previous keyframe + this one), else None.

        ``ego_to_prev = (a2, b2)`` maps this frame's camera (x, z) into
        the previous keyframe's; the new frame's BEV features and
        proposals are then warped into the previous frame's coordinates
        for the pair stage.

        With fetch=False the outputs stay on the device as tensors and
        nothing waits for the device; with fetch=True they come back as
        numpy arrays and the step's wall time is recorded.

        Under a profiler the call is the span ``dodt/keyframe``, with
        ``dodt/upload``, ``dodt/encode``, ``dodt/warp``, ``dodt/pair``
        and ``dodt/fetch`` inside it.
        """
        with span("dodt/keyframe"):
            with span("dodt/upload"):
                batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                         for k, v in frame_batch.items()}
            t0 = time.perf_counter()
            with span("dodt/encode"):
                state = self.model.encode_frame(batch)
            prev, self._state = self._state, state
            if prev is None:
                if fetch:
                    self._sync()
                    self.encode_times.append(time.perf_counter() - t0)
                return None
            if ego_to_prev is not None:
                with span("dodt/warp"):
                    a2, b2 = (torch.as_tensor(np.asarray(v, np.float32),
                                              device=self.device)
                              for v in ego_to_prev)
                    state = self.warp_state(state, a2, b2)
            with span("dodt/pair"):
                out = self.model.pair_stage(prev, state)
            if not fetch:
                return out
            with span("dodt/fetch"):
                host = {k: v.cpu().numpy() for k, v in out.items()}
            self.pair_times.append(time.perf_counter() - t0)
            return host

    def latency_stats(self) -> Dict:
        """``encode_cold``: the stream's first encode, which includes the
        kernels' first-use build and load, so it is start-up cost;
        ``pair``: the steady encode + pair step per keyframe, first
        sample dropped; ``pair_cold`` when there is only one sample."""
        out = {}
        if self.encode_times:
            out["encode_cold"] = latency_stats(self.encode_times)
        if len(self.pair_times) > 1:
            out["pair"] = latency_stats(self.pair_times[1:])
        elif self.pair_times:
            out["pair_cold"] = latency_stats(self.pair_times)
        return out
