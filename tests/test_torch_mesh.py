"""The port's mesh (dodt_tpu_torch/parallel) on gloo CPU ranks against the
port's meshless run and against the JAX package, at __graft_entry__'s
tiny sizes (and the unit-test pipeline's for the Trainer, the Evaluator
and the CLI).

The multi-rank sides run in two ``launch.spawn`` calls (4 ranks, then
2), each rank running several programs in turn (``launch.sequence``),
plus the dry run's own spawn: fresh processes that import the port and
torch only (never this module, its conftest or JAX), one CPU thread
each, a rendezvous file in a directory of their own and a deadline
after which every rank is stopped and the test fails. The meshless sides
run in this process on one thread too, through the same rank programs
(``mesh_shape=None``), so both sides sum in one order where the mesh
does not change it.

Randomness: the JAX step draws from pinned keys (tests/test_torch_train
.py's ``JaxDraws``); the port's meshless step records the uniforms it
asks for (global shapes) and every rank replays them through
``table_draws``, keeping its rows (``mesh.shard_draws``).

Tolerances: a mesh step against the meshless port step, losses 1e-5
relative and parameters 1e-5 relative + 1e-6 absolute (the data
all-reduce and the TP input-gradient all-reduce change only the order of
float32 sums); against JAX, test_torch_train.py's (losses 2e-5 relative,
parameters 1e-5 relative + 1e-6 absolute under momentum). Forward
outputs 1e-5 relative + 1e-6 absolute. Adam, in the Trainer checks:
its moments mu and nu are linear and quadratic in the gradients, so
they are held by value (1e-5 relative + 1e-5 of the state's largest, the
f32 sums' rounding); the losses at 1e-5 relative; the params and EMA at
1e-5 relative + 1e-6 absolute, except where the reference's RMS gradient
sqrt(nu) is below NOISE (1e-5) of the state's largest: Adam divides mu
by sqrt(nu), so an element whose gradient is its rounding noise (here
the bottleneck convs' biases, ahead of a one-group GroupNorm) moves by
up to lr either way, and is held to 1e-6 + 2 lr per step taken.
Evaluator results (AP, MOT) and its files are held equal.
"""
import dataclasses
import filecmp
import json
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from dodt_tpu import config as jcfg
from dodt_tpu.data import synthetic
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.parallel import mesh as jmesh
from dodt_tpu.runtime import trainer as jtrain
from dodt_tpu_torch import cli, convert, entry
from dodt_tpu_torch.data.stack import KittiTrackingStackDataset
from dodt_tpu_torch.data.tracking import KittiTrackingDataset
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.models.stack import StackAvodNet
from dodt_tpu_torch.parallel import launch
from dodt_tpu_torch.runtime.trainer import CheckpointIO, create_train_state
from test_torch_train import KEYS, JaxDraws

CLUSTERS = entry.TINY_CLUSTERS
DEADLINE_S = 240.0
NOISE = 1e-5
FINALS = ("final_boxes_3d", "final_scores", "final_cls_softmax",
          "final_valid", "final_corr_offsets", "objectness", "rpn_offsets")


class _Recorder:
    """A ``rand`` that forwards to ``rand`` and keeps each draw by name."""

    def __init__(self, rand):
        self.rand, self.table = rand, {}

    def __call__(self, name, shape):
        assert name not in self.table, f"{name} drawn twice in one step"
        u = self.rand(name, shape)
        self.table[name] = u.numpy().copy()
        return u


def _tiny():
    """JAX's tiny config, params and 4-couple batch, and the port's
    copies of them (entry.tiny_cfg and entry.synthetic_batch are held
    equal to __graft_entry__'s)."""
    jc = graft._tiny_cfg()
    jc.train.optimizer.name = "momentum"
    jc.train.optimizer.initial_lr = 1e-3
    jc.train.optimizer.use_moving_average = True
    jc.train.optimizer.moving_average_decay = 0.5
    cfg = convert.config_from_json(jc)
    ref = entry.tiny_cfg()
    ref.train = cfg.train
    assert ref.to_json() == cfg.to_json()
    batch = graft._synthetic_batch(jc, 4, np.random.RandomState(0))
    mine = entry.synthetic_batch(cfg, 4, np.random.RandomState(0))
    assert batch.keys() == mine.keys()
    for k in batch:
        np.testing.assert_array_equal(mine[k], batch[k], err_msg=k)
    jmodel = jdt.DtAvodNet(cfg=jc, cluster_sizes=CLUSTERS)
    params = jtrain.create_train_state(
        jc, jmodel, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0)).params
    params = jax.tree_util.tree_map(np.asarray, params)
    model = tdt.DtAvodNet(cfg, CLUSTERS)
    model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return jc, cfg, jmodel, params, model, batch


def _jax_step(jc, jmodel, params, batch):
    """JAX's unsharded step from ``params`` (momentum state zero, EMA the
    params) with the pinned keys; returns (losses, state, loss key)."""
    rng = jax.random.PRNGKey(42)
    tx = jtrain.make_optimizer(jc, jtrain.frozen_mask_from_subtrees(
        params, ()))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params), ema_params=params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "make_rng",
                   lambda self, name="params": KEYS[name])
        state, losses = jtrain.make_train_step(jc, jmodel)(
            state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return losses, state, jax.random.split(jax.random.fold_in(rng, 0), 3)[2]


def _grad_norm(cfg, model, batch, rand):
    """The global gradient norm of the step's losses (the clip's input)."""
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    model.zero_grad()
    out = model(tb, mode="train", train=True, rand=rand)
    total, _ = tdt.compute_losses(cfg, out, tb, rand)
    total.backward()
    norm = float(torch.sqrt(sum(torch.sum(p.grad * p.grad)
                                for p in model.parameters()
                                if p.grad is not None)))
    model.zero_grad()
    return norm


def _jax_sharded(params):
    """The port's names of the kernels JAX's rule shards on a (4, 2)
    mesh of the conftest's 8 virtual devices."""
    rule = jmesh.param_shardings(params, jmesh.make_mesh(num_data=4,
                                                         num_model=2))
    leaves = jax.tree_util.tree_leaves_with_path(
        rule, is_leaf=lambda x: hasattr(x, "spec"))
    return {".".join([p.key for p in path[:-1]] + ["weight"])
            for path, s in leaves if s.spec != jax.sharding.PartitionSpec()}


def _pipeline(root):
    """unittest_pipeline over the fixture: checkpoints every 3 steps,
    Adam with EMA, eval batch 4."""
    jc = jcfg.unittest_pipeline()
    jc.dataset.dataset_dir = root
    jc.dataset.video_train_ids = (0,)
    jc.train.checkpoint_interval = 3
    jc.train.optimizer.use_moving_average = True
    jc.train.optimizer.moving_average_decay = 0.5
    jc.eval.batch_size = 4
    cfg = convert.config_from_json(jc)
    model = tdt.DtAvodNet(cfg, CLUSTERS)
    tdt.init_params(model, torch.Generator().manual_seed(0))
    return jc, cfg, model


def _stack(root):
    """The Stack model over the fixture's three-frame stacks, momentum."""
    jc = jcfg.unittest_pipeline()
    jc.model.model_name = "stack_avod_model"
    jc.dataset.dataset_dir = root
    jc.dataset.video_train_ids = (0,)
    jc.dataset.data_stride = 2
    jc.train.optimizer.name = "momentum"
    jc.train.optimizer.initial_lr = 1e-3
    cfg = convert.config_from_json(jc)
    ds = KittiTrackingStackDataset(cfg.dataset, split="train")
    batch = {k: np.asarray(v) for k, v in ds.next_batch(4, augment=False)
             .items() if not isinstance(v, list)}
    model = StackAvodNet(cfg, CLUSTERS)
    tdt.init_params(model, torch.Generator().manual_seed(0))
    return cfg, model, batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every meshless reference (JAX's and the port's), then the 4-rank
    spawn [(2, 2) step of the tiny batch with JAX's draws, (2, 2) TP
    forward, (2, 2) Stack step, (2, 2) Trainer to step 3] and the 2-rank
    spawn [(1, 2) Trainer resumed from the meshless step-3 checkpoint to
    step 4, Evaluator with data = 2, the CLI's train --num_model 2]."""
    tmp = tmp_path_factory.mktemp("mesh")
    root = str(tmp / "kitti")
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=6,
                                     ego_speed=0.3)
    jc, cfg, jmodel, params, model, batch = _tiny()
    jl, jstate, loss_key = _jax_step(jc, jmodel, params, batch)
    pjc, pcfg, pmodel = _pipeline(root)
    scfg, smodel, sbatch = _stack(root)
    ds = lambda: KittiTrackingDataset(pcfg.dataset, split="train")  # noqa
    eval_ds = KittiTrackingDataset(pcfg.dataset, split="trainval")
    ck = CheckpointIO(str(tmp / "eval_ckpt"))
    ck.save(1, create_train_state(pcfg, pmodel))
    cli_cfg = str(tmp / "cfg.json")
    pjc.save(cli_cfg)
    argv = ["--device", "cpu", "train", "--config", cli_cfg,
            "--max_steps", "2"]
    out = {"cfg": cfg, "pcfg": pcfg, "jax": (jl, jstate),
           "jax_sharded": _jax_sharded(params), "tmp": tmp, "argv": argv}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rec = _Recorder(JaxDraws(loss_key))
        out["norm"] = _grad_norm(cfg, model, batch, rec)
        table = rec.table
        out["meshless"] = launch.train_steps(cfg, model, [batch], [table],
                                             device="cpu")
        free = dataclasses.replace(cfg.train.optimizer, grad_clip_norm=1e9)
        out["unclipped"] = launch.train_steps(
            dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, optimizer=free)), model, [batch], [table],
            device="cpu")
        out["forward"] = launch.forward(cfg, model, batch, FINALS,
                                        device="cpu")
        out["stack"] = launch.train_steps(scfg, smodel, [sbatch],
                                          device="cpu")
        out["trainer"] = launch.trainer_run(pcfg, pmodel, ds(),
                                            str(tmp / "one"), 3, 2,
                                            device="cpu")
        shutil.copytree(tmp / "one", tmp / "one_to_mesh")
        out["trainer5"] = launch.trainer_run(pcfg, pmodel, ds(),
                                             str(tmp / "one"), 5, 2,
                                             device="cpu")
        out["evaluate"] = launch.evaluate(pcfg, pmodel, eval_ds, ck.dir,
                                          str(tmp / "eval_one"), [0, 1, 2], 1,
                                          device="cpu")
        cli.main(argv + ["--ckpt_dir", str(tmp / "cli_one")])
    finally:
        torch.set_num_threads(threads)
    four = launch.spawn(launch.sequence, 4, [
        (launch.train_steps, (cfg, model, [batch], [table], (2, 2), "cpu")),
        (launch.forward, (cfg, model, batch, FINALS, (2, 2), "cpu")),
        (launch.train_steps, (scfg, smodel, [sbatch], None, (2, 2), "cpu")),
        (launch.trainer_run, (pcfg, pmodel, ds(), str(tmp / "mesh"), 3, 2,
                              (2, 2), "cpu"))], timeout_s=DEADLINE_S)
    for key, i in (("mesh", 0), ("mesh_forward", 1), ("mesh_stack", 2),
                   ("mesh_trainer", 3)):
        out[key] = [r[i] for r in four]
    shutil.copytree(tmp / "mesh", tmp / "mesh_to_one")
    torch.set_num_threads(1)
    try:
        out["resumed_one"] = launch.trainer_run(pcfg, pmodel, ds(),
                                                str(tmp / "mesh_to_one"), 5, 2,
                                                device="cpu")
    finally:
        torch.set_num_threads(threads)
    two = launch.spawn(launch.sequence, 2, [
        (launch.trainer_run, (pcfg, pmodel, ds(), str(tmp / "one_to_mesh"),
                              5, 2, (1, 2), "cpu")),
        (launch.evaluate, (pcfg, pmodel, eval_ds, ck.dir,
                           str(tmp / "eval_mesh"), [0, 1, 2], 1, (2, 1),
                           "cpu")),
        (cli.main, (argv + ["--ckpt_dir", str(tmp / "cli_mesh"),
                            "--num_model", "2"],))], timeout_s=DEADLINE_S)
    out["resumed_mesh"] = [r[0] for r in two]
    out["mesh_evaluate"] = [r[1] for r in two]
    return out


def _close_states(got, want, rtol=1e-5, atol=1e-6, what=""):
    for part in ("params", "ema_params"):
        for k in want[part]:
            np.testing.assert_allclose(got[part][k].numpy(),
                                       want[part][k].numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{what} {part} {k}")


def _sharded(rule):
    names = {k for k, v in rule.items() if v}
    assert names, "the TP rule shards nothing: the check would be vacuous"
    return names


def test_mesh_step_matches_meshless(runs):
    """The (2, 2) step: every rank's losses, gathered params and EMA equal
    the meshless step's; the rule sharded the FC trunks, as JAX's does."""
    ref = runs["meshless"]
    for r, res in enumerate(runs["mesh"]):
        for k, v in ref["losses"][0].items():
            np.testing.assert_allclose(res["losses"][0][k], v, rtol=1e-5,
                                       err_msg=f"rank {r} {k}")
        _close_states(res["state"], ref["state"], what=f"rank {r}")
        assert res["reduced_bytes"] > 0 and res["bytes_moved"] > 0
    assert _sharded(runs["mesh"][0]["sharded"]) == runs["jax_sharded"]
    _same_over_ranks(runs["mesh"])


def test_mesh_step_matches_jax(runs):
    """The (2, 2) step against JAX's unsharded step on the same params and
    JAX's draws (JAX's sharded step equals its unsharded one,
    tests/test_parallel.py)."""
    jl, jstate = runs["jax"]
    want = {"params": convert.flax_to_state_dict(jstate.params),
            "ema_params": convert.flax_to_state_dict(jstate.ema_params)}
    for res in runs["mesh"]:
        for k, v in jl.items():
            np.testing.assert_allclose(res["losses"][0][k], float(v),
                                       rtol=2e-5, err_msg=k)
        _close_states(res["state"], want, what="vs JAX")


def test_global_norm_clip_across_shards(runs):
    """The step's gradient norm exceeds grad_clip_norm (1.0) at these
    sizes and weights without scaling the loss, so the clip scales it
    (the unclipped step differs); the mesh, whose norm sums the sharded
    leaves over the model ranks, gives the clipped step."""
    assert runs["norm"] > runs["cfg"].train.optimizer.grad_clip_norm
    ref, free = runs["meshless"]["state"], runs["unclipped"]["state"]
    moved = max(float((ref["params"][k] - free["params"][k]).abs().max())
                for k in ref["params"])
    assert moved > 1e-5
    for res in runs["mesh"]:
        _close_states(res["state"], ref, what="clipped")


def test_tp_forward_matches_replicated(runs):
    """The val forward with the FC trunks sharded over 'model' and the
    couples over 'data' (2, 2) equals the replicated meshless forward:
    the RPN's scores and offsets over every anchor and the final
    detections."""
    want = runs["forward"]["outputs"]
    for res in runs["mesh_forward"]:
        _sharded(res["sharded"])
        assert res["bytes_moved"] > 0
        for k in FINALS:
            np.testing.assert_allclose(res["outputs"][k], want[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_stack_mesh_step_matches_meshless(runs):
    """The Stack model's heads (models/stack.py) under the same rule: one
    momentum step of 4 three-frame stacks on a (2, 2) mesh equals the
    meshless step (compute_stack_losses' draws sharded by rows too)."""
    want = runs["stack"]
    for res in runs["mesh_stack"]:
        _sharded(res["sharded"])
        for k, v in want["losses"][0].items():
            np.testing.assert_allclose(res["losses"][0][k], v, rtol=1e-5,
                                       err_msg=k)
        for k, v in want["state"]["params"].items():
            np.testing.assert_allclose(res["state"]["params"][k].numpy(),
                                       v.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def _adam_close(got, want, lr, steps, what):
    """Adam's tolerance (module docstring): mu and nu by value; the params
    and EMA at 1e-5 relative + 1e-6 absolute, save the elements whose
    reference RMS gradient (sqrt(nu)) is below NOISE of the state's
    largest, which may move by up to 2 lr per step either way."""
    nu = want["opt_state"]["nu"]
    for part in ("mu", "nu"):
        ref = want["opt_state"][part]
        scale = max(float(v.abs().max()) for v in ref.values())
        for k, v in ref.items():
            np.testing.assert_allclose(
                got["opt_state"][part][k].numpy(), v.numpy(), rtol=1e-5,
                atol=1e-5 * scale, err_msg=f"{what} {part} {k}")
    floor = NOISE * max(float(v.max()) for v in nu.values()) ** 0.5
    for part in ("params", "ema_params"):
        for k, v in want[part].items():
            noise = (nu[k].sqrt() <= floor).numpy()
            g, w = got[part][k].numpy(), v.numpy()
            np.testing.assert_allclose(g[~noise], w[~noise], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{what} {part} {k}")
            np.testing.assert_allclose(g[noise], w[noise], rtol=0,
                                       atol=1e-6 + 2 * lr * steps,
                                       err_msg=f"{what} {part} {k} (noise)")


def _same_over_ranks(results):
    """Every rank's gathered state equals rank 0's bit for bit: the
    replicated leaves get one update on every rank."""
    want = results[0]["state"]
    for r, res in enumerate(results[1:], 1):
        for part in ("params", "ema_params"):
            if want[part] is None:
                continue
            for k, v in want[part].items():
                assert torch.equal(res["state"][part][k], v), (r, part, k)


def test_trainer_steps_match_meshless(runs):
    """Three Trainer steps on the (2, 2) mesh (each rank its couple of the
    global batch of 2, the FC trunks, their Adam moments and EMA
    sharded): the logged losses per step and the final state equal the
    meshless Trainer's, and the ranks' states equal each other's."""
    one = runs["trainer"]
    lr = runs["pcfg"].train.optimizer.initial_lr
    for r, res in enumerate(runs["mesh_trainer"]):
        assert [h["step"] for h in res["history"]] == [1, 2, 3]
        for ha, hb in zip(one["history"], res["history"]):
            for k in ha:
                np.testing.assert_allclose(hb[k], ha[k], rtol=1e-5,
                                           err_msg=f"rank {r} {k}")
        _adam_close(res["state"], one["state"], lr, 3, f"rank {r}")
    _same_over_ranks(runs["mesh_trainer"])


def test_trainer_checkpoints_cross_mesh(runs):
    """Global rank 0 alone wrote the mesh's checkpoint, full tensors in
    the meshless format: a meshless Trainer resumes from it, and a (1, 2)
    mesh Trainer from a meshless one, both for two steps equal to the
    meshless run's steps 4 and 5 (losses, Adam's moments, params, EMA)."""
    ck = CheckpointIO(str(runs["tmp"] / "mesh"))
    assert ck.all_steps() == [3]
    assert sorted(os.listdir(os.path.join(ck.dir, "3"))) == [ck.FILE]
    saved = ck.restore_params(3)
    for k, v in runs["trainer"]["state"]["params"].items():
        assert saved[k].shape == v.shape, k
    want = runs["trainer5"]
    lr = runs["pcfg"].train.optimizer.initial_lr
    for what, res in (("meshless from mesh", runs["resumed_one"]),
                      *(("mesh from meshless", r)
                        for r in runs["resumed_mesh"])):
        assert [h["step"] for h in res["history"]] == [4, 5], what
        for ha, hb in zip(want["history"][3:], res["history"]):
            for k in ha:
                np.testing.assert_allclose(hb[k], ha[k], rtol=1e-5,
                                           err_msg=f"{what} {k}")
        _adam_close(res["state"], want["state"], lr, 5, what)
    _same_over_ranks(runs["resumed_mesh"])


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files
                or cmp.funny_files), (a, b, cmp.left_only, cmp.right_only,
                                      cmp.diff_files)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, (mismatch, errors)
    for d in cmp.common_dirs:
        _same_tree(os.path.join(a, d), os.path.join(b, d))


def test_evaluator_on_data_mesh_matches_meshless(runs):
    """Evaluator with data = 2: predict_couples over 3 couples (padded to
    the eval batch of 4, 2 per rank) and run_checkpoint_once give every
    rank the meshless evaluator's detections and results (AP and MOT
    equal), and rank 0's files equal the meshless files byte for byte."""
    want = runs["evaluate"]
    for r, res in enumerate(runs["mesh_evaluate"]):
        assert json.dumps(res["results"]) == json.dumps(want["results"]), \
            f"rank {r}"
        for a, b in zip(want["predictions"], res["predictions"]):
            assert a["couple"] == b["couple"]
            for da, db in zip(a["dets"], b["dets"]):
                assert len(da) == len(db)
                for x, y in zip(da, db):
                    np.testing.assert_allclose(y["box_3d"], x["box_3d"],
                                               rtol=1e-5, atol=1e-5)
                    np.testing.assert_allclose(y["score"], x["score"],
                                               rtol=1e-5, atol=1e-5)
    assert any(len(d) for p in want["predictions"] for d in p["dets"])
    _same_tree(str(runs["tmp"] / "eval_one"), str(runs["tmp"] / "eval_mesh"))


def test_cli_train_under_two_ranks(runs):
    """``cli.main(["train", "--num_model", "2", ...])`` in each of 2 ranks
    (the process group the caller started) trains on a (1, 2) mesh and
    writes the meshless CLI's checkpoint; without the ranks
    --num_model 2 raises."""
    tmp = runs["tmp"]
    with pytest.raises(ValueError, match="num_model"):
        cli.main(runs["argv"] + ["--ckpt_dir", str(tmp / "x"),
                                 "--num_model", "2"])
    pcfg = runs["pcfg"]
    template = create_train_state(pcfg, tdt.DtAvodNet(pcfg, CLUSTERS))
    want, got = (CheckpointIO(str(tmp / d)).restore_state(template, 2)
                 .__dict__ for d in ("cli_one", "cli_mesh"))
    _adam_close(got, want, pcfg.train.optimizer.initial_lr, 2, "cli")


def test_dryrun_multichip_runs():
    """The twin of __graft_entry__.dryrun_multichip: a (2, 2) DP x TP step
    and 4 data-parallel streams, each equal to its single-rank forward."""
    entry.dryrun_multichip(4)
