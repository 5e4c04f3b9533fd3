"""Entry points of the port, the twins of the repository's
``__graft_entry__``:

``entry()``: the flagship forward as a ``(fn, args)`` pair, at
``__graft_entry__.entry``'s sizes (``cars_dt_tracking`` with 32768 points
per frame, one couple made from ``RandomState(0)``). ``fn(params,
batch)`` runs the val-mode forward of ``DtAvodNet`` with ``params`` (a
state dict of Flax-initialised weights from a fixed seed) and returns
(final_boxes_3d, final_scores).

``dryrun_multichip(n)``: one data x tensor parallel train step and ``n``
data-parallel inference streams over ``n`` gloo CPU ranks (spawned
processes; the card's machine has one card), at the tiny sizes of
``tiny_cfg`` and ``synthetic_batch`` (copies of ``__graft_entry__``'s
``_tiny_cfg`` and ``_synthetic_batch``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dodt_tpu_torch.config import (FeatureExtractorConfig, PipelineConfig,
                                   cars_dt_tracking, unittest_pipeline)
from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
from dodt_tpu_torch.parallel import launch

MAX_POINTS = 32768
TINY_CLUSTERS = ((3.9, 1.6, 1.5),)


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


# ---------------------------------------------------------------------------
# Multi-rank dry run


def tiny_cfg() -> PipelineConfig:
    """``unittest_pipeline`` cut to a 16 m x 16 m area at 0.2 m voxels,
    1024 points, 32-wide heads and towers of 4 and 8 channels."""
    cfg = unittest_pipeline()
    cfg.dataset.kitti_utils.area_extents = (
        (-8.0, 8.0), (-3.0, 3.0), (0.0, 16.0))
    cfg.dataset.kitti_utils.voxel_size = 0.2
    cfg.dataset.kitti_utils.anchor_strides = (2.0, 2.0)
    cfg.dataset.max_points = 1024
    cfg.dataset.max_gt_boxes = 4
    cfg.dataset.image_shape = (32, 96)
    cfg.dataset.mini_batch.rpn_mini_batch_size = 32
    cfg.dataset.mini_batch.avod_mini_batch_size = 32
    cfg.model.rpn.train_nms_size = 16
    cfg.model.rpn.test_nms_size = 16
    cfg.model.rpn.cls_fc_sizes = (32, 32)
    cfg.model.rpn.reg_fc_sizes = (32, 32)
    cfg.model.rpn.corr_fc_sizes = (32, 32)
    cfg.model.avod.nms_size = 8
    cfg.model.avod.fc_layer_sizes = (32, 32)
    cfg.model.bev_extractor = FeatureExtractorConfig(
        conv1=(1, 4), conv2=(1, 4), conv3=(1, 8), conv4=(1, 8))
    cfg.model.img_extractor = FeatureExtractorConfig(
        conv1=(1, 4), conv2=(1, 4), conv3=(1, 8), conv4=(1, 8))
    return cfg


def synthetic_batch(cfg: PipelineConfig, batch_size: int,
                    rng: np.random.RandomState) -> Dict[str, np.ndarray]:
    """``batch_size`` couples of uniform points over the area, uniform
    images and two GT cars per frame, drawn from ``rng``."""
    ae = np.asarray(cfg.dataset.kitti_utils.area_extents)
    p = cfg.dataset.max_points
    h, w = cfg.dataset.image_shape
    g = cfg.dataset.max_gt_boxes

    def one():
        return np.stack([
            rng.uniform(ae[0][0], ae[0][1], p),
            rng.uniform(-0.5, 2.0, p),
            rng.uniform(ae[2][0], ae[2][1], p)], axis=1).astype(np.float32)

    boxes = np.zeros((batch_size, 2, g, 7), np.float32)
    boxes[..., 2] = 8.0
    boxes[..., 3:6] = [3.9, 1.6, 1.5]
    boxes[:, :, :, 1] = 1.65
    valid = np.zeros((batch_size, 2, g), bool)
    valid[:, :, :2] = True
    return {
        "points": np.stack([np.stack([one(), one()])
                            for _ in range(batch_size)]),
        "points_valid": np.ones((batch_size, 2, p), bool),
        "image": rng.uniform(0, 255, (batch_size, 2, h, w, 3)
                             ).astype(np.float32),
        "ground_plane": np.tile(
            np.array([[0.0, -1.0, 0.0, 1.65]], np.float32),
            (batch_size, 1)),
        "p2": np.tile(np.array([[[200.0, 0, 80, 0],
                                 [0, 200.0, 24, 0],
                                 [0, 0, 1.0, 0]]], np.float32),
                      (batch_size, 1, 1)),
        "orig_image_shape": np.tile(np.array([[48, 160]], np.int32),
                                    (batch_size, 1)),
        "gt_boxes": boxes,
        "gt_classes": np.ones((batch_size, 2, g), np.int32) * valid,
        "gt_valid": valid,
        "gt_track_ids": np.where(valid, np.arange(g, dtype=np.int32), -1),
        "corr_offsets": np.zeros((batch_size, g, 3), np.float32),
        "corr_coexist": valid[:, 0],
    }


def _dryrun_rank(n: int) -> Dict[str, float]:
    """One rank of ``dryrun_multichip``: the DP x TP step (model = 2 when
    n is even and at least 4), then the data-parallel streams, each
    checked on rank 0 against its single-rank forward (atol 1e-5, as
    JAX's dry run)."""
    cfg = tiny_cfg()
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    model = DtAvodNet(cfg, TINY_CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    res = launch.train_steps(cfg, model, [synthetic_batch(cfg, n_data, rng)],
                             mesh_shape=(n_data, n_model), device="cpu")
    losses = res["losses"][0]
    if not all(np.isfinite(v) for v in losses.values()):
        raise FloatingPointError(f"dryrun_multichip: losses {losses}")
    if n_model > 1 and not any(res["sharded"].values()):
        raise AssertionError("the TP rule sharded no leaf")

    # serving: n independent streams, one per rank, params replicated
    infer = synthetic_batch(cfg, n, rng)
    model.load_state_dict(res["state"]["params"])
    keys = ("final_boxes_3d", "final_scores")
    out = launch.forward(cfg, model, infer, keys, mesh_shape=(n, 1),
                         device="cpu")
    if dist.get_rank() == 0:
        for s in (0, n - 1):
            one = launch.forward(cfg, model, {k: v[s:s + 1] for k, v in
                                              infer.items()}, keys,
                                 device="cpu")
            for k in keys:
                np.testing.assert_allclose(out["outputs"][k][s],
                                           one["outputs"][k][0], atol=1e-5,
                                           err_msg=f"stream {s} {k}")
    return losses


def dryrun_multichip(n_devices: int) -> None:
    """One DP x TP train step over ``n_devices`` gloo CPU ranks, then
    ``n_devices`` data-parallel inference streams, each equal to its
    single-rank forward; raises if a rank fails."""
    losses = launch.spawn(_dryrun_rank, n_devices, n_devices)[0]
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    print("dryrun_multichip ok:", losses, "mesh:",
          {"data": n_devices // n_model, "model": n_model})
    print("dryrun_multichip infer ok:",
          f"{n_devices} data-parallel streams, per-stream outputs match "
          f"single-rank")
