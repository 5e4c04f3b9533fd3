"""Flax parameter tree <-> the port's state dict (dodt_tpu_torch.convert),
and the port's independence from JAX."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dodt_tpu import config as cfg_mod
from dodt_tpu.data.clusters import DEFAULT_CAR_CLUSTERS
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu_torch.convert import (config_from_json, flax_to_state_dict,
                                    state_dict_to_flax)
from dodt_tpu_torch.models import dt_avod as tdt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _abstract_params(cfg, clusters, n_points, image_shape):
    """The full DtAvodNet param tree as shapes, without computing it."""
    h, w = image_shape
    batch = {
        "points": jnp.zeros((1, 2, n_points, 3)),
        "points_valid": jnp.zeros((1, 2, n_points), bool),
        "image": jnp.zeros((1, 2, h, w, 3)),
        "ground_plane": jnp.zeros((1, 4)), "p2": jnp.zeros((1, 3, 4)),
        "orig_image_shape": jnp.zeros((1, 2), jnp.int32)}
    model = jdt.DtAvodNet(cfg=cfg, cluster_sizes=clusters)
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key, "pathdrop": key}, batch,
        train=False, mode="val"))["params"]


def _leaves(tree):
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_flagship_param_tree_maps_onto_the_port():
    """Every leaf of the full-width cars_dt_tracking tree has exactly one
    state-dict entry of the port's full-width model, in torch layout,
    and the port has no parameter the tree lacks."""
    cfg = cfg_mod.cars_dt_tracking()
    cfg.dataset.max_points = 64
    tree = _abstract_params(cfg, DEFAULT_CAR_CLUSTERS, 64,
                            cfg.dataset.image_shape)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   tree)
    sd = flax_to_state_dict(zeros)
    want = {k: tuple(v.shape) for k, v in
            tdt.DtAvodNet(config_from_json(cfg), DEFAULT_CAR_CLUSTERS).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert len(sd) == len(_leaves(tree))
    assert "bev_vgg_pyr.conv1_0_kernel" in sd            # flat s2d stem
    assert sd["bev_corr_bottleneck.weight"].shape == (1, 121)


def test_round_trip_is_exact():
    """flax -> state dict -> model -> state dict -> flax returns every
    array bit for bit, with conv kernels HWIO <-> OIHW and Dense kernels
    transposed."""
    cfg = cfg_mod.unittest_pipeline()
    clusters = ((3.9, 1.6, 1.52),)
    tree = _abstract_params(cfg, clusters, 256, cfg.dataset.image_shape)
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), tree)
    sd = flax_to_state_dict(params)
    model = tdt.DtAvodNet(config_from_json(cfg), clusters)
    model.load_state_dict(sd, strict=True)
    back = state_dict_to_flax(model.state_dict())
    want, got = _leaves(params), _leaves(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    k = params["bev_vgg_pyr"]["conv3_0"]["kernel"]           # (3, 3, ci, co)
    np.testing.assert_array_equal(
        sd["bev_vgg_pyr.conv3_0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    d = params["avod_fc"]["fc0"]["kernel"]                   # (in, out)
    np.testing.assert_array_equal(sd["avod_fc.fc0.weight"].numpy(), d.T)
    assert "bev_bottleneck.GroupNorm_0.weight" in sd         # flax "scale"


PORTED_HOST_MODULES = (
    "dodt_tpu_torch.data.augment", "dodt_tpu_torch.data.clusters",
    "dodt_tpu_torch.data.detection", "dodt_tpu_torch.data.kitti",
    "dodt_tpu_torch.data.stack", "dodt_tpu_torch.data.synthetic",
    "dodt_tpu_torch.data.tracking", "dodt_tpu_torch.eval.kitti_ap",
    "dodt_tpu_torch.eval.kitti_writer", "dodt_tpu_torch.native",
    "dodt_tpu_torch.tracking.iou_tracker", "dodt_tpu_torch.tracking.moi",
    "dodt_tpu_torch.tracking.mot_eval", "dodt_tpu_torch.utils.np_iou",
    # the entry points and their host copies
    "dodt_tpu_torch.cli", "dodt_tpu_torch.entry",
    # the mesh and the last ported ops and helpers
    "dodt_tpu_torch.parallel.mesh", "dodt_tpu_torch.parallel.launch",
    "dodt_tpu_torch.ops.label_offset", "dodt_tpu_torch.utils.metrics",
    "dodt_tpu_torch.runtime.video", "dodt_tpu_torch.viz",
    "dodt_tpu_torch.eval.reporting", "dodt_tpu_torch.tracking.kalman",
    "dodt_tpu_torch.tracking.scenarios",
    "dodt_tpu_torch.utils.format_checker")


@pytest.mark.parametrize("probe", ["jax", "flax", "orbax", "optax",
                                   "dodt_tpu", "bench", "__graft_entry__"])
def test_port_imports_no_jax(probe):
    """Importing every dodt_tpu_torch module, chip_smoke.py and
    bench_torch.py leaves JAX, Flax, orbax and optax out of sys.modules,
    and the JAX package (dodt_tpu, dodt_tpu.*) and bench.py too: the port
    keeps its own copies of the host modules it needs. A fresh
    interpreter, so this process's imports don't count. A Trainer is
    built from the port's own config and checkpoints: its checkpoints,
    metrics logger and optimiser must not reach for any of them, nor an
    Evaluator (which builds the native AP library); the walk covers
    every host module copied for the evaluator."""
    code = (
        "import importlib, pkgutil, sys, tempfile\n"
        "import dodt_tpu_torch, chip_smoke, bench_torch\n"
        "names = {m.name for m in pkgutil.walk_packages(\n"
        "    dodt_tpu_torch.__path__, 'dodt_tpu_torch.')}\n"
        "for name in sorted(names):\n"
        "    importlib.import_module(name)\n"
        f"assert {set(PORTED_HOST_MODULES)!r} <= names, names\n"
        "import torch\n"
        "from dodt_tpu_torch.config import unittest_pipeline\n"
        "from dodt_tpu_torch.runtime import evaluator, trainer\n"
        "cfg = unittest_pipeline()\n"
        "model = torch.nn.Linear(2, 2)\n"
        "tr = trainer.Trainer(cfg, model, None, tempfile.mkdtemp(),\n"
        "                      device='cpu')\n"
        "tr.ckpt.save(1, trainer.create_train_state(cfg, model))\n"
        "assert tr.ckpt.restore_params(1)\n"
        "evaluator.Evaluator(cfg, model, None, tr.ckpt.dir,\n"
        "                    tempfile.mkdtemp(), device='cpu')\n"
        f"found = [m for m in sys.modules if m == {probe!r}\n"
        f"         or m.startswith({probe!r} + '.')]\n"
        "print(found, file=sys.stderr)\n"
        "sys.exit(1 if found else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_native_build_writes_nothing_beside_the_sources():
    """native.build() compiles into build/native/ at the repository root
    and leaves dodt_tpu_torch/ as it was."""
    from dodt_tpu_torch import native
    pkg = os.path.join(REPO, "dodt_tpu_torch")

    def files():
        return {os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
                if "__pycache__" not in d}
    before = files()
    assert native.build(force=True)
    assert files() == before
    for name in native.FLAGS:
        path = native.library_path(name)
        assert path.parent == Path(REPO, "build", "native")
        assert path.is_file()


@pytest.mark.parametrize("module", ["dodt_tpu_torch.parallel",
                                    "dodt_tpu_torch.parallel.mesh",
                                    "dodt_tpu_torch.parallel.launch",
                                    "dodt_tpu_torch.entry"])
def test_mesh_and_entry_reach_no_jax(module):
    """The mesh, its rank launcher and the entry points (the twins of
    __graft_entry__'s) import nothing of JAX, of the JAX package or of
    __graft_entry__, and neither does a rank they spawn: a fresh
    interpreter imports the module, builds a one-rank mesh over a gloo
    group and reads sys.modules."""
    code = (
        "import importlib, os, sys, tempfile\n"
        f"importlib.import_module({module!r})\n"
        "import torch.distributed as dist\n"
        "from dodt_tpu_torch.parallel import mesh\n"
        "f = os.path.join(tempfile.mkdtemp(), 'rendezvous')\n"
        "dist.init_process_group('gloo', init_method='file://' + f,\n"
        "                        world_size=1, rank=0)\n"
        "m = mesh.make_mesh(num_model=1)\n"
        "assert m.shape == {'data': 1, 'model': 1}\n"
        "dist.destroy_process_group()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'dodt_tpu',\n"
        "        '__graft_entry__', 'bench')]\n"
        "print(bad, file=sys.stderr)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_make_mesh_without_a_process_group_raises():
    """The mesh takes the caller's process group: none, no mesh (nothing
    falls back to one rank)."""
    from dodt_tpu_torch.parallel import mesh
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh()
