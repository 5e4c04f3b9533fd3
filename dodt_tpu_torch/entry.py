"""The flagship forward as a ``(fn, args)`` pair: the port's twin of the
repository's ``__graft_entry__.entry``, at its sizes (``cars_dt_tracking``
with 32768 points per frame, one couple made from ``RandomState(0)``).

``fn(params, batch)`` runs the val-mode forward of ``DtAvodNet`` with
``params`` (a state dict of Flax-initialised weights from a fixed seed)
and returns (final_boxes_3d, final_scores). The multi-chip dry run waits
for the port's mesh.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from dodt_tpu_torch.config import PipelineConfig, cars_dt_tracking
from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params

MAX_POINTS = 32768


def synthetic_batch_full(cfg: PipelineConfig, rng: np.random.RandomState
                         ) -> Dict[str, np.ndarray]:
    """One couple of uniform points over the KITTI area (both frames the
    same scan), a uniform image and the KITTI camera."""
    p = cfg.dataset.max_points
    h, w = cfg.dataset.image_shape
    pts = np.stack([
        rng.uniform(-40, 40, p),
        rng.uniform(-1.0, 2.0, p),
        rng.uniform(0, 70, p)], axis=1).astype(np.float32)
    return {
        "points": np.stack([pts, pts])[None],
        "points_valid": np.ones((1, 2, p), bool),
        "image": rng.uniform(0, 255, (1, 2, h, w, 3)).astype(np.float32),
        "ground_plane": np.array([[0.0, -1.0, 0.0, 1.65]], np.float32),
        "p2": np.array([[[721.5, 0, 609.5, 44.9],
                         [0, 721.5, 172.8, 0.2],
                         [0, 0, 1.0, 0.003]]], np.float32),
        "orig_image_shape": np.array([[375, 1242]], np.int32),
    }


def entry(device="cuda") -> Tuple[Callable, Tuple[Dict[str, torch.Tensor],
                                                 Dict[str, torch.Tensor]]]:
    """(fn, (params, batch)) for the flagship val forward on ``device``
    (the card unless the caller asks for the CPU)."""
    cfg = cars_dt_tracking()
    cfg.dataset.max_points = MAX_POINTS
    model = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             synthetic_batch_full(cfg, np.random.RandomState(0)).items()}
    params = {k: v.detach() for k, v in model.named_parameters()}

    def fn(params, batch):
        out = torch.func.functional_call(model, params, (batch,),
                                         {"mode": "val"})
        return out["final_boxes_3d"], out["final_scores"]

    return fn, (params, batch)
