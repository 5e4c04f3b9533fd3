"""Training through the port (dodt_tpu_torch) against the JAX package, on
the CPU in float32, from the same seeded inputs and converted Flax
parameters.

Randomness: the port takes its uniform draws as tensors (``rand``,
dodt_tpu_torch/models/dt_avod.py), the JAX model from keys. The tests
pin the JAX keys (``flax.linen.Module.make_rng`` returns one fixed key
per stream; ``compute_losses`` and the train step take theirs
explicitly) and hand the port the uniforms those keys give, so both
packages drop, path-drop and sample exactly the same units and anchors.

The fixture is tests/test_torch_forward.py's (2 couples, 3072 anchors:
fusion_top_k 8192 takes the single-pass RPN, 1024 the two-pass one with
the in-forward mini-batch). Its GT boxes are moved onto proposals of the
JAX forward, so the second stage has positives and every loss term is
non-zero.

Tolerances: outputs 1e-5 relative + 2e-5 absolute (f32 summation
order; decoded metric boxes and angles 1e-3 absolute, as box_4c decoding
amplifies rounding); losses 2e-5 relative; masks, indices and sampled
sets equal; gradients 1e-4 of each leaf's largest gradient, except the
three biases ahead of a one-channel GroupNorm, whose exact gradient is 0
(both packages give rounding noise there, held below 1e-4 of the
model's largest gradient); parameters after three optimiser steps 1e-5
relative + 1e-6 absolute under sgd and momentum. Adam and rmsprop
normalise every element's gradient, so an element whose gradient is
near its rounding noise takes a step of either sign: their parameters
are held to 1e-6 + 0.1 lr (adam) and 1e-6 + 2 lr (rmsprop, whose first
steps are +-3.16 lr for every element and so separate the trajectories
most; the losses at every step still agree to 2e-5), and the three
zero-gradient biases only to the largest move the optimiser allows.
"""
import copy
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.data import synthetic, tracking
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.runtime import evaluator as jeval
from dodt_tpu.runtime import trainer as jtrain
from dodt_tpu_torch import convert
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.runtime import evaluator as teval
from dodt_tpu_torch.runtime import trainer as ttrain

CLUSTERS = ((3.9, 1.6, 1.52),)
_pc = convert.config_from_json        # the JAX config as the port's
KEYS = {"sampling": jax.random.PRNGKey(11), "dropout": jax.random.PRNGKey(12),
        "pathdrop": jax.random.PRNGKey(13)}
LOSS_KEY = jax.random.PRNGKey(5)
EXACT = ("anchor_valid", "img_mask", "bev_mask", "top_valid",
         "final_indices", "final_valid")
# zero exact gradient: a bias ahead of GroupNorm over one channel
NOISE_LEAVES = ("bev_bottleneck.Conv_0.bias", "img_bottleneck.Conv_0.bias",
                "bev_corr_bottleneck.bias")
LOOSE = ("final_boxes_3d", "pred_boxes_3d", "proposal_boxes_3d",
         "final_orientations", "pred_orientations", "proposal_enc")


def _pair(key, n):
    kp, kn = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(kp, (n,))),
                     np.asarray(jax.random.uniform(kn, (n,)))])


class JaxDraws:
    """The port's ``rand``: the uniforms the JAX model draws from the
    pinned keys (``sampling``/``dropout``/``pathdrop``) and from
    compute_losses' ``loss_key``."""

    def __init__(self, loss_key=LOSS_KEY):
        self.loss_key = loss_key

    def __call__(self, name, shape):
        if name == "rpn_mb":        # split(make_rng("sampling"), B*F)
            m, _, n = shape
            keys = jax.random.split(KEYS["sampling"], m)
            out = np.stack([_pair(k, n) for k in keys])
        elif name in ("loss_rpn", "loss_avod"):
            b, f, _, n = shape      # split(rng, B*F*2).reshape(B, F, 2)
            keys = jax.random.split(self.loss_key, b * f * 2).reshape(
                b, f, 2, 2)
            i = 0 if name == "loss_rpn" else 1
            out = np.stack([[_pair(keys[bb, ff, i], n) for ff in range(f)]
                            for bb in range(b)])
        else:                       # flax Dropout's bernoulli, path drop
            key = KEYS["pathdrop" if name == "pathdrop" else "dropout"]
            out = np.asarray(jax.random.uniform(key, shape))
        return torch.from_numpy(np.array(out, np.float32))


@pytest.fixture(autouse=True)
def pinned_keys(monkeypatch):
    monkeypatch.setattr(fnn.Module, "make_rng",
                        lambda self, name="params": KEYS[name])


def _configured(cfg, fusion_top_k, **model):
    cfg = copy.deepcopy(cfg)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **model,
        rpn=dataclasses.replace(cfg.model.rpn, fusion_top_k=fusion_top_k)))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port(cfg, params):
    model = tdt.DtAvodNet(_pc(cfg), CLUSTERS)
    model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    return model


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_train_torch"))
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=4,
                                     ego_speed=0.5)
    cfg = cfg_mod.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.kitti_utils.area_extents = (
        (-16.0, 16.0), (-3.0, 3.0), (0.0, 48.0))
    cfg.dataset.kitti_utils.anchor_strides = (1.0, 1.0)
    cfg.dataset.max_points = 4096
    cfg.dataset.video_train_ids = (0,)
    ds = tracking.KittiTrackingDataset(cfg.dataset, split="train")
    batch = ds.next_batch(2, shuffle=False, augment=False)
    batch = {k: np.asarray(v) for k, v in batch.items()
             if not isinstance(v, list)}
    model = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(model.init, static_argnames=("train", "mode"))(
        {"params": rng, "dropout": rng, "pathdrop": rng}, _jb(batch),
        train=False, mode="val")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    # GT on the first proposals of each frame (slightly shifted): the
    # second stage gets positives, the correlation loss targets
    val = jax.jit(model.apply, static_argnames=("train", "mode"))(
        {"params": params}, _jb(batch), train=False, mode="val")
    top = np.asarray(val["top_anchors"])[:, :, :8]
    boxes = np.array(jdt.box_ops.anchors_to_box_3d(jnp.asarray(top),
                                                   fix_lw=True))
    boxes[..., 0] += 0.05
    g = batch["gt_boxes"].shape[2]
    batch["gt_boxes"] = np.zeros_like(batch["gt_boxes"])
    batch["gt_boxes"][:, :, :min(g, 8)] = boxes[:, :, :g]
    batch["gt_valid"] = np.zeros_like(batch["gt_valid"])
    batch["gt_valid"][:, :, :min(g, 8)] = True
    batch["gt_classes"] = batch["gt_valid"].astype(np.int32)
    rs = np.random.RandomState(0)
    batch["corr_offsets"] = rs.uniform(-0.5, 0.5, batch["corr_offsets"].shape
                                       ).astype(np.float32)
    batch["corr_coexist"] = np.ones_like(batch["corr_coexist"])
    return cfg, params, batch, ds


def _jax_losses(cfg, params, batch, train):
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)

    def loss(p):
        out = jmodel.apply({"params": p}, _jb(batch), train=train,
                           mode="train")
        total, losses = jdt.compute_losses(cfg, out, _jb(batch), LOSS_KEY)
        return total, (losses, out)

    (_, (losses, out)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return losses, out, grads


@pytest.fixture(scope="module", params=[8192, 1024],
                ids=["single_pass", "two_pass"])
def train_run(request, fixture):
    """JAX and the port at train=False, mode="train": outputs, losses and
    every parameter's gradient."""
    cfg0, params, batch, _ = fixture
    cfg = _configured(cfg0, request.param)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "make_rng",
                   lambda self, name="params": KEYS[name])
        jl, jout, jg = _jax_losses(cfg, params, batch, False)
    model = _port(cfg, params)
    out = model(_tb(batch), mode="train", train=False, rand=JaxDraws())
    total, losses = tdt.compute_losses(_pc(cfg), out, _tb(batch), JaxDraws())
    total.backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    return (jl, jout, convert.flax_to_state_dict(jg)), (losses, out, grads)


def _check_outputs(want, got):
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        if isinstance(w, dict):
            _check_outputs(w, got[k])
            continue
        w, g = np.asarray(w), got[k].detach().numpy()
        assert g.shape == w.shape, k
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer) or \
                k in EXACT or k in ("sel", "pos"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-3 if k in LOOSE else 2e-5,
                                       err_msg=k)


def test_train_forward_matches_jax(train_run):
    """Every output of ``__call__(train=False, mode="train")``, rpn_mb
    included on the two-pass route (objectness and offsets over the
    candidates and the sampled mini-batch, train_nms_size proposals)."""
    (_, jout, _), (_, out, _) = train_run
    assert set(out) == set(jout)
    _check_outputs(jout, out)
    k_train = 64                       # unittest_pipeline train_nms_size
    assert out["top_anchors"].shape[2] == k_train
    assert ("rpn_mb" in out) == (out["objectness"].shape[2] != 3072)


def test_losses_match_jax(train_run):
    """compute_losses: the same seven keys, every term non-zero."""
    (jl, _, _), (losses, _, _) = train_run
    assert set(losses) == set(jl) == {"rpn_cls", "rpn_reg", "avod_cls",
                                      "avod_reg", "avod_ang", "corr",
                                      "total"}
    for k in jl:
        assert float(jl[k]) > 0, k
        np.testing.assert_allclose(losses[k].item(), float(jl[k]),
                                   rtol=2e-5, err_msg=k)


def test_param_grads_match_jax(train_run):
    """d total / d every parameter (torch layout) against
    jax.value_and_grad; the correlation bottleneck (kernel B3's weights)
    gets a non-zero gradient."""
    (_, _, jg), (_, _, grads) = train_run
    jg = {k: v.numpy() for k, v in jg.items()}
    assert set(grads) == set(jg)
    assert np.abs(grads["bev_corr_bottleneck.weight"]).max() > 0
    for k, g in grads.items():
        w = jg[k]
        if k in NOISE_LEAVES:
            top = max(np.abs(v).max() for v in jg.values())
            assert np.abs(g).max() < 1e-4 * top, k
            assert np.abs(w).max() < 1e-4 * top, k
            continue
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 1e-4 * scale, (k, scale)


def test_train_forward_with_dropout_and_path_drop_matches_jax(fixture):
    """train=True: the same dropout masks (flax Dropout's bernoulli from
    the pinned key) and path-drop flips, on the two-pass route."""
    cfg0, params, batch, _ = fixture
    cfg = _configured(cfg0, 1024, path_drop_probabilities=(0.6, 0.6))
    jl, jout, _ = _jax_losses(cfg, params, batch, True)
    out = _port(cfg, params)(_tb(batch), mode="train", train=True,
                             rand=JaxDraws())
    _, losses = tdt.compute_losses(_pc(cfg), out, _tb(batch), JaxDraws())
    _check_outputs(jout, out)
    for k in jl:
        np.testing.assert_allclose(losses[k].item(), float(jl[k]),
                                   rtol=2e-5, err_msg=k)


@pytest.mark.parametrize("p", [(0.9, 0.9), (0.2, 0.5), (0.0, 0.0)])
def test_path_drop_masks_match_jax(p):
    rnd = np.random.RandomState(1).rand(64, 3).astype(np.float32)
    want = jdt._path_drop_masks(jnp.asarray(rnd), *p)
    got = tdt._path_drop_masks(torch.from_numpy(rnd), *p)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("keep_prob", [0.5, 0.7, 1.0])
def test_dropout_matches_flax(keep_prob):
    """The port's dropout with the uniforms of a key equals flax's
    Dropout(1 - keep_prob) with that key."""
    x = np.random.RandomState(2).randn(37, 19).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = fnn.Dropout(1.0 - keep_prob).apply(
        {}, jnp.asarray(x), deterministic=False, rng=key)
    got = tdt.dropout(torch.from_numpy(x), keep_prob, lambda n, s:
                      torch.from_numpy(np.asarray(
                          jax.random.uniform(key, s))), "fc")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_mode_runs_no_eval_kernel_route(fixture, monkeypatch):
    """Train mode turns both eval-only kernels' dispatch off, as JAX does:
    the towers skip the conv chain (B1) and the second-stage BEV crop
    takes the gather form, never the window (B2), even for a card."""
    from dodt_tpu_torch.models import backbone
    cfg0, params, batch, _ = fixture
    cfg = _configured(cfg0, 1024)
    model = _port(cfg, params)

    def no_chain(*a, **k):
        raise AssertionError("conv chain dispatched in train mode")
    monkeypatch.setattr(backbone, "conv_chain", no_chain)
    model(_tb(batch), mode="train", train=False, rand=JaxDraws())
    with pytest.raises(AssertionError, match="train mode"):
        model(_tb(batch), mode="val")
    cuda = torch.device("cuda")
    maps = torch.rand(2, 80, 96, 16)
    boxes = torch.tensor([[[0.1, 0.1, 0.3, 0.4]]] * 2)
    train_crop = tdt.bev_crop_fn(7, 64, True, maps.shape[1:], cuda)
    want = torch.stack([tdt.crop_and_resize(m, b, 7)
                        for m, b in zip(maps, boxes)])
    torch.testing.assert_close(train_crop(maps, boxes), want, rtol=0,
                               atol=0)
    eval_crop = tdt.bev_crop_fn(7, 64, False, maps.shape[1:], cuda)
    assert eval_crop(maps, boxes).dtype == torch.bfloat16   # window form


def test_remat_towers_keeps_gradients(fixture):
    """remat_towers (torch.utils.checkpoint) recomputes the towers in the
    backward: the gradients are the same."""
    cfg0, params, batch, _ = fixture
    grads = []
    for remat in (False, True):
        cfg = _configured(cfg0, 1024, remat_towers=remat)
        model = _port(cfg, params)
        out = model(_tb(batch), mode="train", train=False, rand=JaxDraws())
        tdt.compute_losses(_pc(cfg), out, _tb(batch), JaxDraws())[0].backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------- optimiser

def _toy(seed):
    rs = np.random.RandomState(seed)
    params = {"rpn_cls": {"fc6": {"kernel": rs.randn(5, 4)
                                  .astype(np.float32),
                                  "bias": rs.randn(4).astype(np.float32)}},
              "bev_vgg_pyr": {"conv1_0": {"kernel": rs.randn(3, 3, 2, 3)
                                          .astype(np.float32)}}}
    grads = [jax.tree_util.tree_map(lambda a: (rs.randn(*a.shape) * s)
                                    .astype(np.float32), params)
             for s in (0.1, 3.0, 0.5)]   # the second step is clipped
    return params, grads


@pytest.mark.parametrize("name", ["adam", "momentum", "rmsprop", "sgd"])
def test_optimizer_matches_optax(name):
    """Three updates of the port's optimiser against make_optimizer's
    optax chain, with a frozen subtree whose moments are non-zero (it
    still moves under adam/momentum/rmsprop, as in optax), a clipped
    step and the staircase decay crossing a boundary. Optax defaults
    differ from torch's (rmsprop decay 0.9, eps in the sqrt; momentum
    without dampening); exact to f32 rounding (1e-6 relative)."""
    cfg = cfg_mod.unittest_pipeline()
    opt = cfg.train.optimizer
    opt.name, opt.initial_lr, opt.decay_steps = name, 0.1, 2
    cfg.train.frozen_subtrees = ("bev_vgg_pyr",)
    params, grads = _toy(0)
    mask = jtrain.frozen_mask_from_subtrees(params,
                                            cfg.train.frozen_subtrees)
    tx = jtrain.make_optimizer(cfg, mask)
    jstate = tx.init(params)
    sd = convert.flax_to_state_dict(params)
    port = ttrain.make_optimizer(_pc(cfg), ttrain.frozen_mask_from_subtrees(
        sd, cfg.train.frozen_subtrees))
    tstate = port.init(sd)
    # moments left over from earlier unfrozen training
    warm = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.3), params)
    jstate = convert._fill_optax(jstate, {
        "count": 0, "schedule_count": 0,
        **{k: convert.flax_to_state_dict(warm)
           for k in ("mu", "nu", "trace")}})
    tstate.update({k: convert.flax_to_state_dict(warm) for k in tstate
                   if k in ("mu", "nu", "trace")})
    jp, tp = params, sd
    for g in grads:
        upd, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = port.update(convert.flax_to_state_dict(g), tstate)
        tp = {k: v + tupd[k] for k, v in tp.items()}
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             jp))
    for k in want:
        np.testing.assert_allclose(tp[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    moved = not np.allclose(tp["bev_vgg_pyr.conv1_0.weight"].numpy(),
                            sd["bev_vgg_pyr.conv1_0.weight"].numpy())
    # zero gradients move a leaf only through momentum-like state
    assert moved == (name in ("adam", "momentum"))


def test_lr_schedule_matches_optax():
    cfg = cfg_mod.unittest_pipeline()
    opt = cfg.train.optimizer
    opt.initial_lr, opt.decay_steps, opt.decay_factor = 1e-3, 7, 0.8
    for staircase in (True, False):
        opt.staircase = staircase
        want = jtrain.make_lr_schedule(cfg)
        got = ttrain.make_lr_schedule(_pc(cfg))
        for c in (0, 1, 6, 7, 8, 20, 1000):
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6)
    assert got(0) == np.float32(1e-3)


# ---------------------------------------------------------------- steps

def _check_params(got, tree, start, cfg, steps):
    """Params (or EMA) after ``steps`` updates against JAX's (module
    docstring's tolerances)."""
    want = convert.flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                             tree))
    name = cfg.train.optimizer.name
    lr = cfg.train.optimizer.initial_lr
    # the largest move of one element in one step, in units of lr
    bound = {"adam": 1.0, "rmsprop": 1.0 / np.sqrt(0.1)}.get(name)
    lr_tol = {"adam": 0.1, "rmsprop": 2.0}.get(name, 0.0) * lr
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        if bound and k in NOISE_LEAVES:
            p0 = start[k].numpy()
            for p in (g, w):
                assert np.abs(p - p0).max() <= steps * lr * bound * 1.001, k
            continue
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 + lr_tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["adam", "momentum", "rmsprop", "sgd"])
def test_train_steps_match_jax(fixture, name):
    """Three steps of make_train_step against JAX's (dropout, path drop
    and sampling on; draws from JAX's keys: the pinned model streams and
    the loss key split(fold_in(rng, step), 3)[2]), with frozen subtrees
    and EMA: params, EMA and losses per step.

    Steadied against two near-tie amplifiers (ROADMAP C10). Each port
    step starts from JAX's state before that step, converted: the
    port's multithreaded CPU weight gradients sum in a varying order,
    and adam and rmsprop turn those last-bit differences into whole
    steps of either sign for near-zero gradients, so two steps of drift
    moved a loss by up to 2.7e-4 relative from run to run. And the RPN
    scores every anchor in one pass (fusion_top_k above the anchor
    count): the two-pass form sorts its candidates by score before the
    head's dropout, whose masks follow the slot, so two candidates a
    few ulps apart (3e-6 relative, within the two frameworks' f32
    differences) swap masks and move a loss by 1.7e-4. The two-pass
    train forward with dropout is held at the fixture's parameters
    (test_train_forward_with_dropout_and_path_drop_matches_jax)."""
    cfg0, params, batch, _ = fixture
    cfg = _configured(cfg0, 8192, path_drop_probabilities=(0.8, 0.8))
    opt = cfg.train.optimizer
    opt.name, opt.initial_lr, opt.decay_steps = name, 1e-3, 2
    opt.use_moving_average, opt.moving_average_decay = True, 0.5
    cfg.train.frozen_subtrees = ("img_vgg_pyr",)
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    tx = jtrain.make_optimizer(cfg, jtrain.frozen_mask_from_subtrees(
        params, cfg.train.frozen_subtrees))
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=jax.tree_util.tree_map(jnp.asarray,
                                                             params),
                               opt_state=tx.init(params),
                               ema_params=params)
    jstep = jtrain.make_train_step(cfg, jmodel)
    model = _port(cfg, params)
    tstep = ttrain.make_train_step(_pc(cfg), model)
    assert ttrain.create_train_state(_pc(cfg), model).opt_state.keys() == \
        convert.train_state_from_flax(jstate).opt_state.keys()
    rng = jax.random.PRNGKey(42)
    sd = convert.flax_to_state_dict(params)
    for s in range(3):
        tstate = convert.train_state_from_flax(jstate)
        assert tstate.step == s
        jstate, jl = jstep(jstate, _jb(batch), rng)
        samp = jax.random.split(jax.random.fold_in(rng, s), 3)[2]
        tstate, tl = tstep(tstate, _tb(batch), JaxDraws(samp))
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]),
                                       rtol=2e-5, err_msg=f"{k} step {s}")
        # every parameter (and EMA entry) is within s + 1 steps of the
        # start: the bound for the zero-gradient leaves
        _check_params(tstate.params, jstate.params, sd, cfg, s + 1)
        _check_params(tstate.ema_params, jstate.ema_params, sd, cfg, s + 1)
    assert tstate.step == int(jstate.step) == 3
    frozen = [k for k in tstate.params if k.startswith("img_vgg_pyr.")]
    assert all(torch.equal(tstate.params[k], sd[k]) for k in frozen)


# ---------------------------------------------------------------- runtime

class _Stream:
    """An in-memory dataset: next_batch returns the fixture batch with
    points jittered by a counter, so each step sees another batch."""

    def __init__(self, batch):
        self.batch, self.n = batch, 0

    def next_batch(self, batch_size, augment=True):
        out = dict(self.batch)
        out["points"] = self.batch["points"] + np.float32(0.01 * self.n)
        out["sample_name"] = [f"s{self.n}"]
        self.n += 1
        return out


def _small_train_cfg(cfg0, tmp):
    cfg = _configured(cfg0, 1024)
    cfg.train.checkpoint_interval = 2
    cfg.train.optimizer.use_moving_average = True
    return cfg


def test_resumed_run_equals_uninterrupted(fixture, tmp_path):
    """Trainer.train to step 4 in one go against to step 2, then a new
    Trainer on the same directory (and data stream) to step 4: the final
    params, moments and EMA are equal bit for bit. One CPU thread: the
    multithreaded CPU conv weight gradients sum in a varying order."""
    cfg0, params, batch, _ = fixture
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _resume(cfg0, params, batch, tmp_path)
    finally:
        torch.set_num_threads(threads)


def _resume(cfg0, params, batch, tmp_path):
    cfg = _small_train_cfg(cfg0, tmp_path)
    a = ttrain.Trainer(_pc(cfg), _port(cfg, params), _Stream(batch),
                       str(tmp_path / "a"), metrics_path=None,
                       device="cpu")
    state_a, hist = a.train(max_steps=4, log_every=2, prefetch=0)
    assert [h["step"] for h in hist] == [2, 4]
    stream = _Stream(batch)
    ttrain.Trainer(_pc(cfg), _port(cfg, params), stream, str(tmp_path / "b"),
                   metrics_path=None, device="cpu").train(max_steps=2,
                                                          prefetch=0)
    b = ttrain.Trainer(_pc(cfg), _port(cfg, params), stream, str(tmp_path / "b"),
                       device="cpu")
    state_b, _ = b.train(max_steps=4, log_every=2, prefetch=0)
    assert b.ckpt.all_steps() == [2, 4] and state_b.step == 4
    for tree_a, tree_b in ((state_a.params, state_b.params),
                           (state_a.ema_params, state_b.ema_params),
                           (state_a.opt_state["mu"],
                            state_b.opt_state["mu"])):
        for k in tree_a:
            assert torch.equal(tree_a[k], tree_b[k]), k
    assert len(b.metrics.history) == 1           # step 4's window


def test_trainer_prefetch_and_logging(fixture, tmp_path):
    """The prefetch thread feeds the loop; window-averaged losses go to
    train_metrics.jsonl; batches left in the queue carry over."""
    import json
    cfg0, params, batch, _ = fixture
    cfg = _small_train_cfg(cfg0, tmp_path)
    tr = ttrain.Trainer(_pc(cfg), _port(cfg, params), _Stream(batch),
                        str(tmp_path), device="cpu")
    state, hist = tr.train(max_steps=2, log_every=1, prefetch=2)
    assert state.step == 2 and len(hist) == 2
    lines = [json.loads(x) for x in
             open(tmp_path / "train_metrics.jsonl").read().splitlines()]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["total"]) for x in lines)
    assert tr._spare_batches                  # prefetched, not dropped


def test_debug_nans_stops_on_a_non_finite_loss(fixture, tmp_path):
    cfg0, params, batch, _ = fixture
    cfg = _small_train_cfg(cfg0, tmp_path)
    cfg.train.debug_nans = True
    bad = dict(batch)
    bad["corr_offsets"] = np.full_like(batch["corr_offsets"], np.nan)
    tr = ttrain.Trainer(_pc(cfg), _port(cfg, params), _Stream(bad),
                        str(tmp_path), metrics_path=None, device="cpu")
    with pytest.raises((FloatingPointError, RuntimeError)):
        tr.train(max_steps=1, prefetch=0)


def _state(seed, ema=True):
    rs = np.random.RandomState(seed)
    params = {"bev_vgg_pyr.w": torch.tensor(rs.randn(3), dtype=torch.float32),
              "rpn_cls.b": torch.tensor(rs.randn(2), dtype=torch.float32)}
    cfg = cfg_mod.unittest_pipeline()
    opt = ttrain.make_optimizer(_pc(cfg)).init(params)
    return ttrain.TrainState(step=seed, params=params, opt_state=opt,
                             ema_params={k: v * 2 for k, v in params.items()}
                             if ema else None)


def test_checkpoint_io(tmp_path):
    """Steps list anew (a second CheckpointIO sees the first's writes);
    prefer_ema; max_to_keep; a state without EMA restores into a
    template with one as params only."""
    a = ttrain.CheckpointIO(str(tmp_path / "a"), max_to_keep=2)
    reader = ttrain.CheckpointIO(str(tmp_path / "a"))
    assert reader.latest_step() is None and a.restore_params() is None
    for s in (1, 2, 3):
        a.save(s, _state(s))
    assert reader.all_steps() == [2, 3]
    st = _state(3)
    assert torch.equal(reader.restore_params(prefer_ema=True)["rpn_cls.b"],
                       st.ema_params["rpn_cls.b"])
    assert torch.equal(reader.restore_params(2)["rpn_cls.b"],
                       _state(2).params["rpn_cls.b"])
    full = reader.restore_state(_state(0))
    assert full.step == 3 and full.opt_state["count"] == 0
    a.save(4, _state(4, ema=False))
    partial = reader.restore_state(_state(0))
    assert partial.step == 4 and torch.equal(
        partial.ema_params["rpn_cls.b"], _state(0).ema_params["rpn_cls.b"])


def test_restore_subtrees_rules(tmp_path):
    """None: every shared top-level subtree; a tuple: exactly those,
    KeyError on a name missing on either side; (): nothing."""
    src = ttrain.CheckpointIO(str(tmp_path / "src"))
    src.save(1, _state(1))
    dst = ttrain.CheckpointIO(str(tmp_path / "dst"))
    mine = _state(7).params
    mine["corr_fc.w"] = torch.zeros(2)
    got = dst.restore_subtrees(mine, str(tmp_path / "src"))
    assert torch.equal(got["rpn_cls.b"], _state(1).params["rpn_cls.b"])
    assert torch.equal(got["corr_fc.w"], mine["corr_fc.w"])
    got = dst.restore_subtrees(mine, str(tmp_path / "src"), ("rpn_cls",))
    assert torch.equal(got["bev_vgg_pyr.w"], mine["bev_vgg_pyr.w"])
    got = dst.restore_subtrees(mine, str(tmp_path / "src"), ())
    assert all(got[k] is mine[k] for k in mine)
    with pytest.raises(KeyError, match="corr_fc"):
        dst.restore_subtrees(mine, str(tmp_path / "src"), ("corr_fc",))
    with pytest.raises(FileNotFoundError):
        dst.restore_subtrees(mine, str(tmp_path / "empty"))


def test_init_or_restore_pretrained(fixture, tmp_path):
    """pretrained_full_state continues the source's step, moments and
    EMA; pretrained subtrees replace only those params and reset the EMA
    to them."""
    cfg0, params, batch, _ = fixture
    cfg = _small_train_cfg(cfg0, tmp_path)
    src = ttrain.Trainer(_pc(cfg), _port(cfg, params), _Stream(batch),
                         str(tmp_path / "src"), metrics_path=None,
                         device="cpu")
    src_state, _ = src.train(max_steps=1, prefetch=0)
    cfg.train.pretrained_checkpoint = str(tmp_path / "src")
    cfg.train.pretrained_full_state = True
    full = ttrain.Trainer(_pc(cfg), _port(cfg, params), _Stream(batch),
                          str(tmp_path / "full"),
                          device="cpu").init_or_restore()
    assert full.step == 1
    for k in src_state.params:
        assert torch.equal(full.opt_state["nu"][k],
                           src_state.opt_state["nu"][k])
    cfg.train.pretrained_full_state = False
    cfg.train.pretrained_subtrees = ("rpn_cls",)
    part = ttrain.Trainer(_pc(cfg), _port(cfg, params), _Stream(batch),
                          str(tmp_path / "part"),
                          device="cpu").init_or_restore()
    sd = convert.flax_to_state_dict(params)
    assert part.step == 0
    for k in sd:
        want = src_state.params[k] if k.startswith("rpn_cls.") else sd[k]
        assert torch.equal(part.params[k], want), k
        assert torch.equal(part.ema_params[k], want), k


def test_jax_checkpoint_resumes_in_port(fixture, tmp_path):
    """A JAX TrainState after one step, saved by orbax and restored, is
    converted (params, Adam mu/nu/count, EMA) and continues in the port
    for two steps equal to JAX's own two steps; converted back, it fills
    the JAX optimiser state exactly."""
    cfg0, params, batch, _ = fixture
    cfg = _configured(cfg0, 1024, path_drop_probabilities=(1.0, 1.0))
    cfg.train.optimizer.use_moving_average = True
    cfg.train.optimizer.initial_lr = 1e-3
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    tx = jtrain.make_optimizer(cfg, jtrain.frozen_mask_from_subtrees(
        params, ()))
    jstate = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree_util.tree_map(jnp.asarray, params),
        opt_state=tx.init(params), ema_params=params)
    jstep = jtrain.make_train_step(cfg, jmodel)
    rng = jax.random.PRNGKey(42)
    jstate, _ = jstep(jstate, _jb(batch), rng)
    ck = jtrain.CheckpointIO(str(tmp_path / "jax"))
    ck.save(1, jstate)
    restored = ck.restore_state(jstate)
    tstate = convert.train_state_from_flax(
        jax.tree_util.tree_map(np.asarray, restored))
    assert tstate.step == 1 and tstate.opt_state["count"] == 1
    model = _port(cfg, params)
    tstep = ttrain.make_train_step(_pc(cfg), model)
    for s in (1, 2):
        jstate, _ = jstep(jstate, _jb(batch), rng)
        samp = jax.random.split(jax.random.fold_in(rng, s), 3)[2]
        tstate, _ = tstep(tstate, _tb(batch), JaxDraws(samp))
    _check_params(tstate.params, jstate.params,
                  convert.flax_to_state_dict(params), cfg, 3)
    # back to JAX's layout: JAX's tree structure, and back again exactly
    back = convert.train_state_to_flax(tstate, jstate.opt_state)
    assert int(back["step"]) == 3
    assert (jax.tree_util.tree_structure(back["opt_state"])
            == jax.tree_util.tree_structure(jstate.opt_state))
    again = convert.train_state_from_flax(jtrain.TrainState(**back))
    assert again.opt_state["count"] == int(jstate.opt_state[1][1][0].count)
    for k in ("mu", "nu"):
        want = convert.flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, getattr(jstate.opt_state[1][1][0], k)))
        for leaf, v in tstate.opt_state[k].items():
            assert torch.equal(again.opt_state[k][leaf], v)
            if leaf not in NOISE_LEAVES:       # moments of noise: no match
                w = want[leaf].numpy()
                np.testing.assert_allclose(v.numpy(), w, rtol=1e-4,
                                           atol=1e-4 * np.abs(w).max(),
                                           err_msg=f"{k} {leaf}")


def test_val_health_matches_jax(fixture, tmp_path):
    """Evaluator.val_health: val losses (1e-5 relative) and proposal
    recall (equal) against the JAX evaluator's, couples padded to the
    eval batch size."""
    cfg0, params, _, ds = fixture
    cfg = _configured(cfg0, 1024)
    cfg.eval.batch_size = 2
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    jev = jeval.Evaluator(cfg, jmodel, ds, ckpt_dir=str(tmp_path / "c"),
                          output_dir=str(tmp_path / "o"))
    want = jev.val_health(params, max_couples=3)
    ev = teval.Evaluator(_pc(cfg), _port(cfg, params), ds,
                         str(tmp_path / "c"), str(tmp_path / "port"),
                         device="cpu")
    got = ev.val_health(max_couples=3,
                        rand=JaxDraws(jax.random.PRNGKey(0)))
    assert got["num_couples"] == want["num_couples"] == 3
    assert got["num_gt"] == want["num_gt"]
    assert got["proposal_recall"] == want["proposal_recall"]
    assert set(got["val_losses"]) == set(want["val_losses"])
    for k, v in want["val_losses"].items():
        np.testing.assert_allclose(got["val_losses"][k], v, rtol=1e-5,
                                   err_msg=k)
