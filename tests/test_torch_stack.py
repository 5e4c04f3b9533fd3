"""The Stack model through the port (``StackAvodNet``,
``compute_stack_losses``, ``KittiTrackingStackDataset``, the Trainer's and
the evaluator's Stack routes) against the JAX package, on the CPU in
float32, on tests/test_stack.py's setup: one ego-motion video of six
frames at data_stride 2 (stacks of three frames), 3072 anchors.

Randomness as in tests/test_torch_train.py: the JAX model's keys are
pinned and the port takes the uniforms they give; compute_stack_losses'
mini-batch draws are the ones its key splits into (``StackDraws``).

Tolerances: outputs 1e-5 relative + 2e-5 absolute, decoded metric boxes
and angles 1e-3 absolute (box_4c decoding amplifies rounding), masks,
indices and NMS picks equal; losses 2e-5 relative; gradients 3e-4 of each
leaf's largest gradient or 1e-5 of the model's largest, whichever is
larger (every anchor's crop and three frames' points feed the towers'
gradients, summed in other orders: up to 1.8e-4 of a leaf; the image
bottleneck's GroupNorm scale sums a whole map's terms that cancel to
4e-3 of the model's largest gradient, 1.3e-3 apart relative); the two
biases ahead of a one-channel GroupNorm, whose exact gradient is 0,
below 1e-4 of the model's largest gradient; parameters after one SGD
step 1e-5 relative + 1e-6 absolute; results and files as
tests/test_torch_evaluator.py holds them, but for the Stack's
rounding-sensitive numbers: MOTP and MODP (mean 2D IoUs in percent, of
boxes 1e-4 m apart) to 1e-4, and the couple files' coexist column to
1e-5 plus its printed 1e-6.
"""
import copy
import dataclasses
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.data import stack as jstack_data
from dodt_tpu.data import synthetic
from dodt_tpu.models import stack as jstack
from dodt_tpu.runtime import trainer as jtrain
from dodt_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from dodt_tpu_torch import convert
from dodt_tpu_torch.convert import config_from_json, flax_to_state_dict
from dodt_tpu_torch.data import stack as tstack_data
from dodt_tpu_torch.models import dt_avod as tdt_avod
from dodt_tpu_torch.models import stack as tstack
from dodt_tpu_torch.ops import nms as tnms
from dodt_tpu_torch.runtime import trainer as ttrain
from dodt_tpu_torch.runtime.evaluator import Evaluator
from test_torch_evaluator import (_assert_couple_lines, _assert_frame_lines,
                                  _assert_results_equal, _port_checkpoint,
                                  _read_lines)
from test_torch_train import KEYS, LOSS_KEY, JaxDraws, _pair

CLUSTERS = ((3.9, 1.6, 1.52),)
EXACT = ("anchor_valid", "top_valid", "final_indices", "final_valid")
LOOSE = ("final_boxes_3d", "pred_boxes_3d", "final_orientations",
         "proposal_4c")
STACK_KEYS = {"anchors", "anchor_valid", "objectness", "rpn_offsets",
              "top_anchors", "top_scores", "top_valid", "proposal_4c",
              "cls_logits", "box_offsets", "angle_vectors",
              "coexist_logits", "corr_pred", "pred_boxes_3d",
              "final_indices", "final_valid", "final_boxes_3d",
              "final_orientations", "final_cls_softmax", "final_scores",
              "final_corr_offsets", "final_coexist"}
NOISE_LEAVES = ("int_bev_bottleneck.Conv_0.bias",
                "img_bottleneck.Conv_0.bias")


class StackDraws(JaxDraws):
    """JaxDraws plus compute_stack_losses' mini-batch draws: its key split
    into (B, F + 1) keys, the first per sample for the RPN, the others
    per frame for the second stage."""

    def __init__(self, frames, loss_key=LOSS_KEY):
        super().__init__(loss_key)
        self.frames = frames

    def __call__(self, name, shape):
        if name not in ("stack_loss_rpn", "stack_loss_avod"):
            return super().__call__(name, shape)
        b, n = shape[0], shape[-1]
        keys = jax.random.split(self.loss_key, b * (self.frames + 1)
                                ).reshape(b, self.frames + 1, 2)
        if name == "stack_loss_rpn":
            out = np.stack([_pair(keys[i, 0], n) for i in range(b)])
        else:
            out = np.stack([[_pair(keys[i, 1 + f], n)
                             for f in range(self.frames)] for i in range(b)])
        return torch.from_numpy(np.array(out, np.float32))


@pytest.fixture(autouse=True)
def pinned_keys(monkeypatch):
    monkeypatch.setattr(fnn.Module, "make_rng",
                        lambda self, name="params": KEYS[name])


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port(cfg, params=None):
    model = tstack.StackAvodNet(config_from_json(cfg), CLUSTERS)
    if params is not None:
        model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def _eval_cfg(cfg):
    cfg = copy.deepcopy(cfg)
    cfg.eval.batch_size = 4                  # the last chunk is padded
    cfg.eval.track_lth = cfg.eval.track_hth = 0.0
    cfg.eval.track_tmin = 1
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_stack_torch"))
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=6,
                                     ego_speed=0.5)
    cfg = cfg_mod.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.kitti_utils.area_extents = (
        (-16.0, 16.0), (-3.0, 3.0), (0.0, 48.0))
    cfg.dataset.kitti_utils.anchor_strides = (1.0, 1.0)
    cfg.dataset.max_points = 4096
    cfg.dataset.video_train_ids = (0,)
    cfg.dataset.data_stride = 2          # stacks of 3 frames
    ds = jstack_data.KittiTrackingStackDataset(cfg.dataset, split="train")
    batch = {k: np.asarray(v) for k, v in ds.next_batch(
        2, shuffle=False).items() if not isinstance(v, list)}
    model = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(model.init, static_argnames=("train", "mode"))(
        {"params": rng, "dropout": rng, "pathdrop": rng}, _jb(batch),
        train=False, mode="val")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return cfg, params, batch, root


def test_stack_tree_converts_one_to_one(setup):
    """The Flax tree's top-level modules are the port's; the converted
    tree loads with strict=True (the 1x1 Conv_0 of stack_corr in
    Bottleneck.Conv_0's layout)."""
    cfg, params, _, _ = setup
    assert set(params) == {"avod_fc", "bev_vgg_pyr", "img_bottleneck",
                           "img_vgg_pyr", "int_bev_bottleneck",
                           "int_bev_vgg_pyr", "rpn_cls", "rpn_reg",
                           "stack_corr"}
    model = _port(cfg, params)
    assert {k.split(".")[0] for k in model.state_dict()} == set(params)
    assert model.stack_corr.Conv_0.weight.shape == (256, 16, 1, 1)
    assert tstack.StackAvodNet.loss_builder() is tstack.compute_stack_losses


# anchor strides on the BEV pixel lattice, and off it (per-anchor RPN)
ROUTES = {"lattice": None, "per_anchor": (0.75, 0.75)}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def outputs(request, setup):
    cfg, params, batch, _ = setup
    if ROUTES[request.param]:
        cfg = copy.deepcopy(cfg)
        cfg.dataset.kitti_utils.anchor_strides = ROUTES[request.param]
    jmodel = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    # op by op, as tests/test_torch_single_frame.py runs the per-anchor
    # route (jit fuses its matmul crop into other multiply-adds)
    want = jmodel.apply({"params": params}, _jb(batch), train=False,
                        mode="val")
    model = _port(cfg, params).eval()
    assert (model.lattice is None) == (request.param == "per_anchor")
    got = model(_tb(batch), mode="val")
    g = model.graphs
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()},
            (g.captures, g.replays, g.eager, len(g._entries)))


def test_stack_forward_returns_every_jax_output(outputs):
    want, got, _ = outputs
    assert set(got) == set(want) == STACK_KEYS
    for k in STACK_KEYS:
        assert got[k].shape == want[k].shape, k
    assert got["final_boxes_3d"].shape[:2] == (2, 3)
    assert got["final_coexist"].shape == (2, 16)
    assert got["final_valid"].sum() > 0


@pytest.mark.parametrize("key", sorted(STACK_KEYS))
def test_stack_forward_output_matches_jax(outputs, key):
    want, got, _ = outputs
    w, g = want[key], got[key]
    if key in EXACT or w.dtype == bool or np.issubdtype(w.dtype,
                                                        np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-3 if key in LOOSE else 2e-5)


def test_stack_second_stage_runs_eagerly_on_the_cpu(outputs):
    """On the CPU the Stack's second stage runs eagerly: its graph cache
    captures, replays and counts nothing (the outputs are the ones the
    tests above hold against JAX; the card's replays are in
    tests/test_torch_cuda.py)."""
    assert outputs[2] == (0, 0, 0, 0)


@pytest.mark.parametrize("mode", ["fast", "greedy"])
def test_stack_forward_honours_nms_mode(setup, mode, monkeypatch):
    """With nms_mode "fast" or "greedy" every output of the Stack's val
    forward matches JAX's StackAvodNet in that mode, at the tolerances
    above. Both NMS calls (the RPN's and the final per-frame one) take
    the mode; with "fast" the final call's picks differ from the exact
    NMS on the same inputs, and the final picks of the whole forward
    differ from its "exact" forward, so a final NMS left on exact fails
    here. (JAX is jitted: this route is the lattice one.)"""
    cfg, params, batch, _ = setup
    cfg = copy.deepcopy(cfg)
    cfg.model.nms_mode = mode
    jmodel = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    want = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, train=False, mode="val"))(params, _jb(batch))
    calls = []

    def spy(m):
        def nms(*args):
            calls.append((m, args, tnms.nms_bev_mode(m)(*args)))
            return calls[-1][2]
        return nms

    # both NMS calls are in the selections the Stack shares with DtAvodNet
    monkeypatch.setattr(tdt_avod, "nms_bev_mode", spy)
    model = _port(cfg, params).eval()
    got = model(_tb(batch), mode="val")
    assert [c[0] for c in calls] == [mode, mode]
    for key in sorted(STACK_KEYS):
        w, g = np.asarray(want[key]), got[key].numpy()
        if key in EXACT or w.dtype == bool or np.issubdtype(w.dtype,
                                                            np.integer):
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=key,
                                       atol=1e-3 if key in LOOSE else 2e-5)
    if mode == "fast":
        _, args, (f_idx, f_valid) = calls[1]
        e_idx, e_valid = tnms.nms_bev_exact(*args)
        assert not (torch.equal(e_idx, f_idx)
                    and torch.equal(e_valid, f_valid))
        model.cfg.model.nms_mode = "exact"
        exact = model(_tb(batch), mode="val")
        assert not (torch.equal(exact["final_indices"], got["final_indices"])
                    and torch.equal(exact["final_valid"], got["final_valid"]))


# ------------------------------------------------------------------ losses

@pytest.fixture(scope="module")
def train_batch(setup):
    """The fixture batch with its GT moved onto the first proposals of
    the JAX forward (slightly shifted): per frame and merged, half the
    tracks in both keyframes (with motion targets), the others in one;
    every loss term is then non-zero."""
    cfg, params, batch, _ = setup
    jmodel = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    val = jax.jit(jmodel.apply, static_argnames=("train", "mode"))(
        {"params": params}, _jb(batch), train=False, mode="val")
    g = batch["merged_boxes"].shape[1]
    top = np.asarray(val["top_anchors"])[:, :g]
    boxes = np.array(jstack.box_ops.anchors_to_box_3d(jnp.asarray(top),
                                                      fix_lw=True))
    boxes[..., 0] += 0.05
    b, f = batch["gt_boxes"].shape[:2]
    out = dict(batch)
    out["gt_boxes"] = np.repeat(boxes[:, None], f, 1).astype(np.float32)
    out["gt_valid"] = np.ones((b, f, g), bool)
    out["gt_classes"] = np.ones((b, f, g), np.int32)
    out["merged_boxes"] = boxes.astype(np.float32)
    out["merged_valid"] = np.ones((b, g), bool)
    out["merged_classes"] = np.ones((b, g), np.int32)
    out["coexist"] = np.tile(np.float32([0, 0, -1, 1]), (b, g // 4))
    out["corr_offsets"] = np.random.RandomState(0).uniform(
        -0.5, 0.5, (b, g, 3)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def loss_run(setup, train_batch):
    cfg, params, _, _ = setup
    batch = train_batch
    jmodel = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)

    def loss(p):
        out = jmodel.apply({"params": p}, _jb(batch), train=False,
                           mode="train")
        total, losses = jstack.compute_stack_losses(cfg, out, _jb(batch),
                                                    LOSS_KEY)
        return total, losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "make_rng",
                   lambda self, name="params": KEYS[name])
        (_, jl), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
    model = _port(cfg, params)
    out = model(_tb(batch), mode="train", train=False, rand=StackDraws(3))
    total, tl = tstack.compute_stack_losses(config_from_json(cfg), out,
                                            _tb(batch), StackDraws(3))
    total.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return jl, convert.flax_to_state_dict(jg), tl, grads


def test_stack_losses_match_jax(loss_run):
    """compute_stack_losses on the train-mode forward (dropout off), JAX's
    draws injected: the same eight keys, every term non-zero."""
    jl, _, tl, _ = loss_run
    assert set(tl) == set(jl) == {"rpn_cls", "rpn_reg", "avod_cls",
                                  "avod_reg", "avod_ang", "coexist",
                                  "corr", "total"}
    for k in jl:
        assert float(jl[k]) > 0, k
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=2e-5,
                                   err_msg=k)


def test_stack_param_grads_match_jax(loss_run):
    _, jg, _, grads = loss_run
    jg = {k: v.numpy() for k, v in jg.items()}
    assert set(grads) == set(jg)
    top = max(np.abs(v).max() for v in jg.values())
    for k, g in grads.items():
        w = jg[k]
        if k in NOISE_LEAVES:
            assert np.abs(g).max() < 1e-4 * top, k
            assert np.abs(w).max() < 1e-4 * top, k
            continue
        assert np.abs(g - w).max() <= max(3e-4 * np.abs(w).max(),
                                          1e-5 * top), k
    assert np.abs(grads["stack_corr.Conv_0.weight"]).max() > 0


def test_stack_train_step_matches_jax(setup, train_batch):
    """One make_train_step of each package (SGD, dropout and path drop
    on), the port's loss taken from StackAvodNet.loss_builder as the JAX
    trainer takes it: the losses and every parameter after the step."""
    cfg, params, _, _ = setup
    cfg = copy.deepcopy(cfg)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, path_drop_probabilities=(0.8, 0.8)))
    opt = cfg.train.optimizer
    opt.name, opt.initial_lr = "sgd", 1e-3
    jmodel = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    tx = jtrain.make_optimizer(cfg, jtrain.frozen_mask_from_subtrees(
        params, ()))
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                               opt_state=tx.init(params), ema_params=None)
    rng = jax.random.PRNGKey(42)
    jstate, jl = jtrain.make_train_step(cfg, jmodel)(
        jstate, _jb(train_batch), rng)
    model = _port(cfg, params)
    tstate = ttrain.create_train_state(config_from_json(cfg), model)
    samp = jax.random.split(jax.random.fold_in(rng, 0), 3)[2]
    tstate, tl = ttrain.make_train_step(config_from_json(cfg), model)(
        tstate, _tb(train_batch), StackDraws(3, samp))
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=2e-5,
                                   err_msg=k)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params))
    for k, w in want.items():
        np.testing.assert_allclose(tstate.params[k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_stack_trainer_runs_two_steps(setup, tmp_path):
    """Trainer.train over the port's KittiTrackingStackDataset: the
    Stack losses (coexist among them) logged for two finite steps and a
    checkpoint that loads into a fresh model."""
    cfg, params, _, _ = setup
    cfg = config_from_json(cfg)
    cfg.train.checkpoint_interval = 2
    ds = tstack_data.KittiTrackingStackDataset(cfg.dataset, split="train")
    model = tstack.StackAvodNet(cfg, CLUSTERS)
    model.load_state_dict(flax_to_state_dict(params))
    tr = ttrain.Trainer(cfg, model, ds, str(tmp_path), device="cpu")
    state, hist = tr.train(max_steps=2, log_every=1)
    assert state.step == 2 and [h["step"] for h in hist] == [1, 2]
    assert "coexist" in hist[-1]
    assert all(np.isfinite(h[k]) for h in hist for k in h)
    fresh = tstack.StackAvodNet(cfg, CLUSTERS)
    fresh.load_state_dict(tr.ckpt.restore_params(2), strict=True)


# --------------------------------------------------------------- evaluator

@pytest.fixture(scope="module")
def stack_eval(tmp_path_factory, setup):
    """Both evaluators over the fixture's six trainval stacks (eval batch
    4: the second chunk padded), from the same JAX train state."""
    cfg, _, batch, _ = setup
    cfg = _eval_cfg(cfg)
    cfg.eval.val_health = True
    tmp = tmp_path_factory.mktemp("eval_stack")
    jmodel = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    state = jtrain.create_train_state(cfg, jmodel, _jb(batch),
                                      jax.random.PRNGKey(3))
    jtrain.CheckpointIO(str(tmp / "ckpt_jax")).save(
        1, state._replace(step=np.int32(1)))
    jds = jstack_data.KittiTrackingStackDataset(cfg.dataset,
                                                split="trainval")
    jev = JaxEvaluator(cfg, jmodel, jds, ckpt_dir=str(tmp / "ckpt_jax"),
                       output_dir=str(tmp / "jax"))
    params = jax.tree_util.tree_map(np.asarray, jev.ckpt.restore_params(1))
    tds = tstack_data.KittiTrackingStackDataset(
        config_from_json(cfg).dataset, split="trainval")
    _port_checkpoint(str(tmp / "ckpt_port"), 1, params)
    ev = Evaluator(config_from_json(cfg), _port(cfg).eval(), tds,
                   str(tmp / "ckpt_port"), str(tmp / "port"), device="cpu")
    return cfg, jev, params, ev, tmp, tds


def test_stack_predictions_carry_coexist_like_jax(stack_eval):
    """predict_couples: frame 0's detections carry the learned coexist
    (final_coexist) and the motion offsets, as the JAX evaluator's do;
    the far frame's carry neither (coexist 0.5, "unknown")."""
    _, jev, params, ev, _, _ = stack_eval
    ev.model.load_state_dict(flax_to_state_dict(params))
    idxs = [0, 1, 2]
    want, got = jev.predict_couples(params, idxs), ev.predict_couples(idxs)
    n = 0
    for g, w in zip(got, want):
        for f, (gf, wf) in enumerate(zip(g["dets"], w["dets"])):
            assert len(gf) == len(wf)
            for gd, wd in zip(gf, wf):
                n += f == 0
                assert gd["class_idx"] == wd["class_idx"]
                np.testing.assert_allclose(gd["box_3d"], wd["box_3d"],
                                           atol=1e-4)
                for key in ("score", "coexist"):     # far frame: 0.5
                    np.testing.assert_allclose(gd[key], wd[key], atol=1e-5)
                if f == 0:
                    np.testing.assert_allclose(gd["offsets"], wd["offsets"],
                                               atol=1e-5)
                    assert 0.0 <= gd["coexist"] <= 1.0
    assert n > 0


@pytest.fixture(scope="module")
def stack_runs(stack_eval):
    _, jev, _, ev, tmp, tds = stack_eval
    # the JAX val_health's loss key, PRNGKey(0), as the port's draws
    val_health = ev.val_health
    ev.val_health = lambda: val_health(
        rand=StackDraws(3, jax.random.PRNGKey(0)))
    return (jev.run_checkpoint_once(1), ev.run_checkpoint_once(1),
            str(tmp / "jax"), str(tmp / "port"), tds)


OVERLAPS = ("MOTP", "MODP")        # mean 2D IoUs of the matched boxes


def _without_overlaps(results):
    out = dict(results)
    out["mot"] = {v: {k: x for k, x in r.items() if k not in OVERLAPS}
                  for v, r in results["mot"].items()}
    return out


def test_stack_run_checkpoint_once_matches_jax(stack_runs):
    """AP at both passes and MOT per video and overall, the JAX results
    keys with val_health."""
    want, got, _, _, _ = stack_runs
    _assert_results_equal(_without_overlaps(got), _without_overlaps(want))
    for vid, res in want["mot"].items():
        for k in OVERLAPS:
            np.testing.assert_allclose(got["mot"][vid][k], res[k],
                                       atol=1e-4, err_msg=f"mot/{vid}/{k}")
    assert set(got) == set(want) == {"step", "ap", "ap_per_class",
                                     "ap_05_per_class", "mot", "val_health"}


def test_stack_val_health_reproduces_c13(stack_runs):
    """val_health with the Stack model: the losses are the Stack loss
    family's (1e-5 relative) and the proposal recall equals JAX's, which
    reads the shared (B, K, 6) proposals at [b, 0], the top proposal
    alone (ROADMAP C13, reproduced by design)."""
    want, got, _, _, _ = stack_runs
    w, g = want["val_health"], got["val_health"]
    assert set(g["val_losses"]) == set(w["val_losses"])
    assert "coexist" in g["val_losses"]
    for k, v in w["val_losses"].items():
        np.testing.assert_allclose(g["val_losses"][k], v, rtol=1e-5,
                                   err_msg=k)
    assert g["num_gt"] == w["num_gt"] > 0
    assert g["proposal_recall"] == w["proposal_recall"]


def test_stack_prediction_files_match_jax(stack_runs):
    _, _, jdir, tdir, ds = stack_runs
    n_lines = 0
    def couple_lines(got, want, name):
        # the coexist column (13) is the Stack's learned P(both)
        _assert_couple_lines([g[:13] + g[14:] for g in got],
                             [w[:13] + w[14:] for w in want], name)
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g[13]), float(w[13]),
                                       atol=1e-5 + 1e-6, err_msg=name)

    for sub, check in (("data", _assert_frame_lines),
                       ("couples", couple_lines)):
        jsub = os.path.join(jdir, "predictions_1", sub)
        tsub = os.path.join(tdir, "predictions_1", sub)
        names = sorted(os.listdir(jsub))
        assert sorted(os.listdir(tsub)) == names
        for name in names:
            got = _read_lines(os.path.join(tsub, name))
            check(got, _read_lines(os.path.join(jsub, name)), name)
            n_lines += len(got)
    assert n_lines > 0
