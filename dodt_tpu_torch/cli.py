"""Command-line entry points of the port (dodt_tpu/cli.py's commands and
arguments):

  python -m dodt_tpu_torch.cli train --config cfg.json --ckpt_dir out/ckpt
  python -m dodt_tpu_torch.cli evaluate --config cfg.json --ckpt_dir out/ckpt
  python -m dodt_tpu_torch.cli infer --config cfg.json --ckpt_dir out/ckpt
  python -m dodt_tpu_torch.cli demo --config cfg.json --output_dir demo_out

The config's ``model_name`` picks the dataset and the model family and
its ``data_stride`` the stride evaluation, as in the JAX CLI. Every
command runs on ``--device`` (``cuda`` unless asked for ``cpu``; the
JAX CLI's ``--platform``); without a card the default raises.

``train`` over several ranks builds the ('data', 'model') mesh, as the
JAX CLI does when it sees more than one device, with ``--num_model`` the
tensor-parallel width of the FC trunks and the other ranks on 'data'
(``--batch_size`` is the global batch):

  torchrun --nproc_per_node N -m dodt_tpu_torch.cli train \
      --config cfg.json --ckpt_dir out/ckpt --num_model M --batch_size B

(``--device cpu`` goes before ``train``; torchrun's ``--standalone``
picks a free local port for the rendezvous.) torchrun's environment
starts the process group (NCCL on ``cuda``, each rank on the card of its
LOCAL_RANK; gloo on ``cpu``); a caller that has started one already
(``parallel.launch.spawn``) keeps it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def _build(cfg_path, split):
    """Dataset and model by cfg.model.model_name:
      avod_model           -> single-frame KittiDataset, DtAvodNet(1)
      dt_avod_model        -> paired-frame KittiTrackingDataset
      stack_avod_model     -> N-frame KittiTrackingStackDataset
    The clusters come from the dataset's own labels (per-class size
    priors for an unlabeled split)."""
    from dodt_tpu_torch.config import PipelineConfig, cars_dt_tracking
    from dodt_tpu_torch.data.clusters import get_clusters

    cfg = PipelineConfig.load(cfg_path) if cfg_path else cars_dt_tracking()
    name = cfg.model.model_name
    if name == "avod_model":
        from dodt_tpu_torch.data.detection import KittiDataset
        from dodt_tpu_torch.models.dt_avod import DtAvodNet
        ds = KittiDataset(cfg.dataset, split=split)
        model = DtAvodNet(cfg, get_clusters(ds, cfg), num_frames=1)
    elif name == "stack_avod_model":
        from dodt_tpu_torch.data.stack import KittiTrackingStackDataset
        from dodt_tpu_torch.models.stack import StackAvodNet
        ds = KittiTrackingStackDataset(cfg.dataset, split=split)
        model = StackAvodNet(cfg, get_clusters(ds, cfg))
    else:
        from dodt_tpu_torch.data.tracking import KittiTrackingDataset
        from dodt_tpu_torch.models.dt_avod import DtAvodNet
        ds = KittiTrackingDataset(cfg.dataset, split=split)
        model = DtAvodNet(cfg, get_clusters(ds, cfg))
    return cfg, ds, model


def _train_mesh(args):
    """(mesh, device) for ``train``: the mesh over every rank when the
    world holds more than one (torchrun's environment starts the group
    unless the caller has), else none."""
    import torch.distributed as dist
    from dodt_tpu_torch.parallel.mesh import make_mesh

    device = torch.device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized() and world > 1:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized() or dist.get_world_size() == 1:
        if args.num_model > 1:
            raise ValueError(f"--num_model {args.num_model} needs a mesh "
                             "of as many ranks at least (torchrun "
                             "--nproc_per_node)")
        return None, device
    return make_mesh(num_model=args.num_model), device


def cmd_train(args):
    from dodt_tpu_torch.models.dt_avod import init_params
    from dodt_tpu_torch.runtime.trainer import SEED, Trainer

    cfg, ds, model = _build(args.config, "train")
    mesh, device = _train_mesh(args)
    # Flax's initialisers from a fixed seed; a checkpoint in ckpt_dir wins
    init_params(model, torch.Generator().manual_seed(SEED))
    trainer = Trainer(cfg, model, ds, args.ckpt_dir, mesh=mesh,
                      batch_size=args.batch_size, device=device)
    _, history = trainer.train(max_steps=args.max_steps)
    if trainer.writes:
        print(json.dumps(history[-5:], indent=2))
        if trainer.metrics.path:
            print(f"train metrics trail: {trainer.metrics.path}")


def cmd_evaluate(args):
    from dodt_tpu_torch.eval import reporting
    from dodt_tpu_torch.runtime.evaluator import Evaluator

    cfg, ds, model = _build(args.config, args.split)
    ev = Evaluator(cfg, model, ds, args.ckpt_dir, args.output_dir,
                   device=args.device)
    # MoI stride evaluation: fill the tau-1 non-keyframes per couple at
    # save time, in the one-shot and the polling path alike
    ev.interpolate = args.interpolate or cfg.dataset.data_stride > 1
    if args.repeat:
        results = ev.repeated_checkpoint_run()
    else:
        results = [ev.run_checkpoint_once(args.step)]
    print(json.dumps(results[-1], indent=2, default=float))
    # the joined train/eval table when the trainer's metrics trail sits
    # beside the checkpoints
    tm = reporting.load_train_metrics(
        os.path.join(args.ckpt_dir, "train_metrics.jsonl"))
    print(reporting.format_table(results, train_metrics=tm or None))


def cmd_infer(args):
    from dodt_tpu_torch.runtime.evaluator import Evaluator
    from dodt_tpu_torch.runtime.trainer import CheckpointIO

    cfg, ds, model = _build(args.config, args.split)
    ev = Evaluator(cfg, model, ds, args.ckpt_dir, args.output_dir,
                   device=args.device)
    params = CheckpointIO(args.ckpt_dir).restore_params(args.step)
    if params is None:
        raise FileNotFoundError(f"no checkpoint in {args.ckpt_dir}")
    ev.model.load_state_dict(params)

    def sync():
        if ev.device.type == "cuda":
            torch.cuda.synchronize(ev.device)

    times = []
    for idx in range(min(len(ds.couples), args.max_samples)):
        sync()
        t0 = time.perf_counter()
        ev.predict_couple(idx)
        sync()
        times.append(time.perf_counter() - t0)
    times = np.array(times[1:])  # the first call warms up
    print(json.dumps({
        "mean_s": float(times.mean()), "median_s": float(np.median(times)),
        "min_s": float(times.min()), "max_s": float(times.max()),
        "fps_pairs": float(1.0 / times.mean()),
    }))


def cmd_demo(args):
    """Qualitative demos: a BEV map with its GT boxes, the anchor grid
    over it, and per-class label statistics of the split."""
    from dodt_tpu_torch import viz
    from dodt_tpu_torch.ops.anchors import tile_anchors_3d
    from dodt_tpu_torch.ops.voxel import bev_maps_from_points

    cfg, ds, _ = _build(args.config, args.split)
    os.makedirs(args.output_dir, exist_ok=True)
    ku = cfg.dataset.kitti_utils
    bg = ku.bev_generator
    dev = torch.device(args.device)
    sample = ds.load_couple(args.sample)
    gp = torch.as_tensor(sample["ground_plane"], device=dev)

    maps = bev_maps_from_points(
        torch.as_tensor(sample["points"][0], device=dev),
        torch.as_tensor(sample["points_valid"][0], device=dev), gp,
        ku.area_extents, ku.voxel_size, bg.height_lo, bg.height_hi,
        bg.num_slices)
    features = maps.features.cpu().numpy()
    gt = sample["gt_boxes"][0][sample["gt_valid"][0]]
    bev_png = viz.draw_bev(features, ku.area_extents, gt_boxes=gt,
                           path=os.path.join(args.output_dir,
                                             "bev_sample.png"))

    # anchor grid: every 250th anchor footprint over the BEV
    anchors3d = tile_anchors_3d(ku.area_extents,
                                np.asarray([[3.9, 1.6, 1.52]], np.float32),
                                ku.anchor_strides, gp).cpu().numpy()
    anchor_png = viz.draw_bev(
        features, ku.area_extents, pred_boxes=anchors3d[::250],
        path=os.path.join(args.output_dir, "anchor_grid.png"))

    # per-class counts and mean sizes over the split's labelled frames
    stats = {}
    seen = set()
    for cp in ds.couples:
        for frame in (cp.frame_a, cp.frame_b):
            if (cp.video_id, frame) in seen:
                continue
            seen.add((cp.video_id, frame))
            lab = ds.labels(cp.video_id, frame)
            for i, t in enumerate(lab.types):
                s = stats.setdefault(t, {"count": 0,
                                         "lwh_sum": np.zeros(3)})
                s["count"] += 1
                s["lwh_sum"] += lab.box_3d[i, 3:6]
    out_stats = {t: {"count": s["count"],
                     "mean_lwh": (s["lwh_sum"] / max(s["count"], 1)
                                  ).round(3).tolist()}
                 for t, s in stats.items()}
    with open(os.path.join(args.output_dir, "dataset_stats.json"),
              "w") as f:
        json.dump(out_stats, f, indent=2)
    print(json.dumps({"bev": bev_png, "anchors": anchor_png,
                      "stats": out_stats}, indent=2))


def main(argv=None):
    p = argparse.ArgumentParser("dodt_tpu_torch")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; raises without a "
                        "card) or cpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--config", default=None)
    t.add_argument("--ckpt_dir", required=True)
    t.add_argument("--batch_size", type=int, default=1)
    t.add_argument("--max_steps", type=int, default=None)
    t.add_argument("--num_model", type=int, default=1,
                   help="tensor-parallel width for the FC trunks over "
                        "the ranks (torchrun); the rest form 'data'")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluate")
    e.add_argument("--config", default=None)
    e.add_argument("--ckpt_dir", required=True)
    e.add_argument("--output_dir", default="eval_out")
    e.add_argument("--split", default="val")
    e.add_argument("--step", type=int, default=None)
    e.add_argument("--repeat", action="store_true")
    e.add_argument("--interpolate", action="store_true",
                   help="MoI-fill non-keyframes (auto when "
                        "data_stride > 1)")
    e.set_defaults(fn=cmd_evaluate)

    i = sub.add_parser("infer")
    i.add_argument("--config", default=None)
    i.add_argument("--ckpt_dir", required=True)
    i.add_argument("--output_dir", default="infer_out")
    i.add_argument("--split", default="val")
    i.add_argument("--step", type=int, default=None)
    i.add_argument("--max_samples", type=int, default=200)
    i.set_defaults(fn=cmd_infer)

    d = sub.add_parser("demo")
    d.add_argument("--config", default=None)
    d.add_argument("--output_dir", default="demo_out")
    d.add_argument("--split", default="train")
    d.add_argument("--sample", type=int, default=0)
    d.set_defaults(fn=cmd_demo)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
