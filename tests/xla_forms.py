"""The form jitted XLA gives each quotient of the BEV rasterization and of
the per-anchor occupancy filter in a compiled JAX program.

XLA's algebraic simplifier rewrites a quotient by a constant into a
multiply by the constant's f32 reciprocal; a program that constant-folds
the rasterization (its points closed over, not passed) evaluates the
quotient at compile time instead. ``quotient_sites`` reads a compiled
program's HLO text and returns, for every instruction that a Python ``/``
traced into (``.../div`` in its metadata) over the points or the cells,
its opcode and its constant operand. The plane offset's multiply-adds are
contracted into FMAs after HLO, so they do not show here (ROADMAP C24):
the audit holds each val forward's ``bev_input`` on a tilted ground plane
against the port's rasterization instead.

Run it to audit every jitted JAX program that rasterizes, at full width
on the CPU (val forward and make_train_step of the paired, single-frame
and Stack models, and encode_frame; about 8 minutes):
``JAX_PLATFORMS=cpu python tests/xla_forms.py``.
"""
import re
from collections import Counter

_INSTR = re.compile(r"^\s*(?:ROOT )?%(\S+) = (\S+) ([\w-]+)\((.*?)\)(.*)$")
_SHAPE = re.compile(r"\[([\d,]*)\]")


def _instructions(hlo):
    out = {}
    for line in hlo.splitlines():
        m = _INSTR.match(line)
        if m:
            name, shape, op, args, rest = m.groups()
            out[name] = (shape, op, args, rest)
    return out


def _constant(instrs, name, depth=3):
    """The scalar value of a constant operand (through broadcasts)."""
    if name not in instrs or depth == 0:
        return None
    shape, op, args, _ = instrs[name]
    if op == "constant":
        return args
    if op in ("broadcast", "bitcast", "reshape", "copy"):
        return _constant(instrs, args.split(",")[0].strip().lstrip("%"),
                         depth - 1)
    return None


def quotient_sites(hlo, sizes):
    """Counter of (opcode, constant) over the instructions that a traced
    ``/`` became, whose shape holds one of ``sizes`` (the point count, the
    cell count, the anchor count)."""
    instrs = _instructions(hlo)
    found = Counter()
    for name, (shape, op, args, rest) in instrs.items():
        if op not in ("multiply", "divide") or '/div"' not in rest:
            continue
        dims = _SHAPE.search(shape)
        dims = [int(d) for d in dims.group(1).split(",") if d] if dims \
            else []
        if not set(dims) & set(sizes):
            continue
        operands = [a.strip().lstrip("%") for a in args.split(",")]
        consts = [c for c in (_constant(instrs, a) for a in operands)
                  if c is not None]
        found[op, consts[0] if consts else None] += 1
    return found


def _audit():                                          # pragma: no cover
    import copy
    import functools
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    from dodt_tpu import config as cfg_mod
    from dodt_tpu.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu.models import dt_avod as jdt
    from dodt_tpu.models import stack as jstack
    from dodt_tpu.runtime import trainer as jtrain
    import torch
    from dodt_tpu_torch.data.synthetic_scan import make_batch
    from dodt_tpu_torch.ops import voxel as tvoxel
    from test_torch_full_width_train import TILTED
    from test_torch_full_width_encode import MAX_POINTS, frames

    from chip_smoke import stack_batch

    def with_gt(cfg, batch, f):
        g = cfg.dataset.max_gt_boxes
        batch = dict(batch)
        batch.update(gt_boxes=np.zeros((1, f, g, 7), np.float32),
                     gt_valid=np.zeros((1, f, g), bool),
                     gt_classes=np.zeros((1, f, g), np.int32))
        if f == 2:
            batch.update(corr_offsets=np.zeros((1, g, 3), np.float32),
                         corr_coexist=np.ones((1, g), bool))
        return batch

    def programs():
        cfg = cfg_mod.cars_dt_tracking()
        cfg.dataset.max_points = MAX_POINTS
        cfg.model.tower_dtype = "float32"
        pair = with_gt(cfg, make_batch(cfg, np.random.RandomState(0)), 2)
        yield "paired", cfg, jdt.DtAvodNet(
            cfg=cfg, cluster_sizes=DEFAULT_CAR_CLUSTERS), pair
        cfg1 = cfg_mod.cars_single_frame()
        cfg1.dataset.max_points = MAX_POINTS
        one = {k: (v[:, :1] if v.ndim > 1 and v.shape[1] == 2 and
                   k not in ("ground_plane", "orig_image_shape", "p2")
                   else v) for k, v in pair.items()
               if not k.startswith("corr_")}
        yield "single-frame", cfg1, jdt.DtAvodNet(
            cfg=cfg1, cluster_sizes=DEFAULT_CAR_CLUSTERS, num_frames=1), one
        # anchor strides off the BEV pixel lattice: the per-anchor RPN
        # and its occupancy filter (tests/test_torch_single_frame.py)
        cfg2 = copy.deepcopy(cfg1)
        cfg2.dataset.kitti_utils.anchor_strides = (0.75, 0.75)
        yield "single-frame per-anchor", cfg2, jdt.DtAvodNet(
            cfg=cfg2, cluster_sizes=DEFAULT_CAR_CLUSTERS, num_frames=1), one
        cfgs = cfg_mod.cars_dt_tracking(data_stride=3)
        cfgs.model.model_name = "stack_avod_model"
        cfgs.dataset.max_points = MAX_POINTS
        yield "stack", cfgs, jstack.StackAvodNet(
            cfg=cfgs, cluster_sizes=DEFAULT_CAR_CLUSTERS), stack_batch(pair)

    for name, cfg, model, batch in programs():
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        ku = cfg.dataset.kitti_utils
        key = jax.random.PRNGKey(0)
        rngs = {"params": key, "dropout": key, "pathdrop": key}
        params = jax.jit(model.init, static_argnames=("train", "mode"))(
            rngs, batch, train=False, mode="val")["params"]
        n_anchors = jax.eval_shape(functools.partial(
            model.apply, train=False, mode="val"), {"params": params},
            batch)["anchors"].shape[1]
        n_points = batch["points"].shape[1] * MAX_POINTS

        def report(what, compiled):
            text = compiled.as_text()
            raster = quotient_sites(text, (MAX_POINTS, n_points, 700 * 800))
            # the per-anchor occupancy filter's cell quotients (the voxel
            # size's reciprocal, 10); other quotients over the anchors
            # (box encodings, IoUs) are not the filter's
            cells = {k: v for k, v in quotient_sites(
                text, (n_anchors,)).items() if k[1] in ("10", "0.1")}
            print(name, what, "rasterization", dict(raster),
                  "anchor cells", cells, flush=True)
        val = jax.jit(model.apply, static_argnames=("train", "mode")).lower(
            {"params": params}, batch, train=False, mode="val").compile()
        report("val forward", val)
        # the val forward's bev_input on a tilted ground plane (the plane
        # offset's FMAs) against the port's rasterization; the Stack
        # returns no BEV input
        tilted = dict(batch, ground_plane=jnp.asarray(TILTED[None]))
        out = val({"params": params}, tilted)
        if "bev_input" in out:
            want = np.asarray(out["bev_input"])[0]
            got = np.stack([tvoxel.bev_maps_from_points(
                torch.from_numpy(np.array(p)),
                torch.from_numpy(np.array(v)), torch.from_numpy(TILTED),
                ku.area_extents, ku.voxel_size, ku.bev_generator.height_lo,
                ku.bev_generator.height_hi,
                ku.bev_generator.num_slices).features.numpy()
                for p, v in zip(batch["points"][0], batch["points_valid"][0])])
            print(name, "val forward bev_input on a tilted plane: port apart "
                  "in", int((want != got).sum()), "of", want.size, flush=True)
        tx = jtrain.make_optimizer(cfg, jtrain.frozen_mask_from_subtrees(
            params, ()))
        state = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                                  params=params, opt_state=tx.init(params),
                                  ema_params=None)
        step = jtrain.make_train_step(cfg, model).lower(
            state, batch, jax.random.PRNGKey(1)).compile()
        report("make_train_step", step)
        if name == "paired":
            frame = {k: jnp.asarray(v) for k, v in
                     frames(make_batch(cfg, np.random.RandomState(0)))[0]
                     .items()}
            enc = jax.jit(lambda p, b: model.apply(
                {"params": p}, b, method=model.encode_frame)).lower(
                    params, frame).compile()
            report("encode_frame", enc)


if __name__ == "__main__":                             # pragma: no cover
    _audit()
