"""The flagship's train step at full width on the CPU: the port against
the JAX train program, as ``dodt_tpu.runtime.trainer.make_train_step``
jits it.

Inputs: ``cars_dt_tracking()`` at 65536 points on bench.py's couple, the
Flax init with key 0 (tests/test_torch_full_width_encode.py's helpers).
GT: 8 boxes on the first proposals of JAX's val forward (f32 towers),
shifted 0.05 m in x as tests/test_torch_train.py's fixture places them,
and 4 on non-empty anchors, shifted alike, so that the RPN mini-batch
holds positives; seeded correlation offsets. Draws: test_torch_train.py's
``JaxDraws``, with JAX's keys pinned.

The JAX programs take the batch as an argument, as make_train_step's jit
does. A program that closes over the batch (test_torch_train.py's
``_jax_losses``) lets XLA fold the rasterization at compile time, and
that folding takes the true quotient for the x cell: 10 values of
bench's couple apart from the train step's maps (ROADMAP C24).

(a) ``bev_input`` bit-equal to the train program's, on bench's couple
    and on the couple over a tilted ground plane (XLA contracts the plane
    offset into FMAs, as the port's ``plane_offset`` does; rounding each
    product parts the heights there); the quotients of both compiled train
    programs' rasterization are multiplies by f32 reciprocals, as in the
    val program (tests/xla_forms.py).
(b) f32 towers, ``train=False, mode="train"``, against the jitted
    ``value_and_grad`` of the forward and ``compute_losses``. Near-tied
    scores (f32 summation order in the towers) swap places: the pass-1
    scores order the 8192 fusion candidates, whose set is the same, and
    the fused scores order the 1024 NMS proposals, whose set is the same
    but a few of whose slots hold another proposal. The second stage's
    mini-batch draws are indexed by slot. The proposals differ by up to
    1.4e-4 m, which moves the image crops of proposals near the camera
    by a fraction of a pixel of features that span 85, so the second
    stage's outputs, the AVOD losses and the gradients part more than
    at small width. They are held twice: as they come, to the bounds
    below, and with the port's second stage run again on JAX's proposal
    values (each of the port's proposals moved to JAX's slot and given
    JAX's coordinates, its gradient path kept), to bounds close to
    test_torch_train.py's small-width ones.
(c) ``make_train_step`` of both packages from one state, ``train=True``
    (path drop and the second stage's dropout from JAX's keys; the RPN
    head's dropout off, so that the proposals stay on the GT boxes and
    every loss term is non-zero: with it on, no proposal reaches the
    second stage's 0.65 IoU): one SGD step at lr 1 without clipping, so
    the update is minus the gradient; and on the port one Adam step,
    held to optax's Adam (make_optimizer's chain) applied to the JAX
    step's gradient.
(d) bf16 towers (the flagship's): the RPN's losses and mini-batch, and
    the proposals under C23's set rule.
"""
import contextlib
import copy
import ctypes
import functools
import gc

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.runtime import trainer as jtrain
from dodt_tpu_torch import convert
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.ops import voxel as tvoxel
from dodt_tpu_torch.runtime import trainer as ttrain
from test_torch_full_width_encode import (bench_batch, flax_params,
                                          full_width_cfg, jax_model,
                                          jax_tree, port_model, torch_tree)
from test_torch_full_width_forward import set_share
from test_torch_train import KEYS, LOSS_KEY, NOISE_LEAVES, JaxDraws
from xla_forms import quotient_sites

LOSS_KEYS = ("rpn_cls", "rpn_reg", "avod_cls", "avod_reg", "avod_ang",
             "corr", "total")
RPN_LOSSES = ("rpn_cls", "rpn_reg")
EXACT = ("bev_input", "anchors", "anchor_valid", "img_mask", "bev_mask",
         "top_valid")
K_FUSE = 8192
TILTED = np.float32([-0.0077, -0.9999, 0.0116, 1.6512])
# the rasterization's quotients over the points and cells (x and z cell,
# slice, height) and the density's: multiplies by f32 reciprocals of 0.1, 0.5 and
# log 16; the one divide is the plane distance's, by the normal's norm
RECIPROCALS = {("multiply", "10"), ("multiply", "2"),
               ("multiply", "0.360673755")}

# Bounds, each with the value measured on the CPU (ROADMAP C24).
# (b) as the outputs come: losses relative (largest avod_reg 2.3e-4,
# total 2.1e-4, avod_ang 8.1e-5; the RPN's 1.1e-6); gradients as a share
# of their leaf's largest (largest 7.8e-2, avod_fc.fc0.weight), or of the
# model's largest (bev_bottleneck.GroupNorm_0.bias: 2.2e-4; its own
# share 1.66: the sum over the map of a gradient that the image crops'
# coordinates carry); slots holding another proposal than JAX's, per
# frame (10 and 10 of 1024)
RAW_LOSS_RTOL = 1e-3
RAW_GRAD_SHARE = 0.25
RAW_GRAD_MODEL = 1e-3
MAX_SWAPPED = 32
# (b) the candidates' (objectness, offsets) rows as sets (largest
# distance 7.4e-5) and the RPN mini-batch's head outputs (2.8e-5 of 2.2)
RPN_ATOL = 2e-4
# (b) on JAX's proposals: the second stage's outputs (measured
# cls_logits 2.8e-4, box_offsets 2.8e-4, angle_vectors 2.0e-4,
# pred_boxes_3d 4.4e-4 m, pred_orientations 2.4e-4, corr_pred 4.2e-7,
# final_boxes_3d 2.9e-4, final_orientations 5.3e-5, final_cls_softmax and
# final_scores 3.5e-5, final_corr_offsets 2.0e-7)
# and the gradients (largest share 1.26e-3, img_vgg_pyr.conv4_0.weight)
JP_ATOL = {"cls_logits": 1e-3, "box_offsets": 1e-3, "angle_vectors": 1e-3,
           "pred_boxes_3d": 2e-3, "pred_orientations": 1e-3,
           "corr_pred": 1e-5, "final_boxes_3d": 2e-3,
           "final_orientations": 1e-3, "final_cls_softmax": 2e-4,
           "final_scores": 2e-4, "final_corr_offsets": 1e-5}
JP_GRAD_SHARE = 5e-3
# (c) SGD: losses relative (largest 1.9e-5, avod_cls) and updates as a
# share of their leaf's largest (2.3e-3, avod_fc.out0.weight); Adam: the
# share of the elements, the zero-gradient leaves apart, that move
# otherwise than optax by more than ADAM_TOL lr (9.7e-6 of 25.1M, with
# those leaves)
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_SHARE = 1e-2
ADAM_TOL = 0.1
ADAM_OFF = 1e-4
# (d) the RPN's losses relative (rpn_cls 1.1e-4, rpn_reg 6.7e-4)
BF16_RPN_RTOL = 5e-3


def release():
    """Hand the freed heap back to the system between the file's stages
    (each holds some GiB while it runs; glibc keeps freed pages otherwise),
    so the file stays within 8 GiB."""
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


@contextlib.contextmanager
def pinned_keys():
    """JAX's model streams from test_torch_train.py's fixed KEYS."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "make_rng",
                   lambda self, name="params": KEYS[name])
        yield


@functools.lru_cache(maxsize=None)
def train_batch():
    """bench's couple with the GT of the module docstring, numpy."""
    cfg = full_width_cfg()
    batch = dict(bench_batch())
    val = jax.jit(jax_model(cfg).apply, static_argnames=("train", "mode"))(
        {"params": flax_params()}, jax_tree(batch), train=False, mode="val")
    on_props = np.asarray(val["top_anchors"])[:, :, :8]
    valid = np.nonzero(np.asarray(val["anchor_valid"])[0].all(0))[0]
    pick = valid[np.linspace(0, len(valid) - 1, 6).astype(int)[1:-1]]
    on_anchors = np.broadcast_to(np.asarray(val["anchors"])[0, pick],
                                 (1, 2, len(pick), 6))
    boxes = np.array(jdt.box_ops.anchors_to_box_3d(
        jnp.asarray(np.concatenate([on_props, on_anchors], 2)),
        fix_lw=True))
    boxes[..., 0] += 0.05
    g, n = cfg.dataset.max_gt_boxes, boxes.shape[2]
    batch["gt_boxes"] = np.zeros((1, 2, g, 7), np.float32)
    batch["gt_boxes"][:, :, :n] = boxes
    batch["gt_valid"] = np.zeros((1, 2, g), bool)
    batch["gt_valid"][:, :, :n] = True
    batch["gt_classes"] = batch["gt_valid"].astype(np.int32)
    batch["corr_offsets"] = np.random.RandomState(0).uniform(
        -0.5, 0.5, (1, g, 3)).astype(np.float32)
    batch["corr_coexist"] = np.ones((1, g), bool)
    return batch


def port_bev(batch):
    """The port's (F, H, W, S + 1) BEV input of each frame."""
    ku = full_width_cfg().dataset.kitti_utils
    bg = ku.bev_generator
    return torch.stack([tvoxel.bev_maps_from_points(
        torch.from_numpy(p), torch.from_numpy(v),
        torch.from_numpy(batch["ground_plane"][0]), ku.area_extents,
        ku.voxel_size, bg.height_lo, bg.height_hi, bg.num_slices).features
        for p, v in zip(batch["points"][0], batch["points_valid"][0])])


def jax_train_program(cfg, train):
    """jit(value_and_grad) of the train-mode forward and the losses, the
    batch an argument: (params, batch) -> ((total, (losses, out)),
    grads)."""
    jm = jax_model(cfg)

    def loss(params, batch):
        out = jm.apply({"params": params}, batch, train=train, mode="train")
        total, losses = jdt.compute_losses(cfg, out, batch, LOSS_KEY)
        return total, (losses, out)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy()
    return None if tree is None else np.asarray(tree)


def state_dict_of(tree):
    return {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def proposal_order(want, got, tol=1e-3):
    """(B, F, K) slot of the port's proposal that matches JAX's in each
    slot (largest difference over the six anchor values within tol): a
    permutation per frame row."""
    b, f, k, _ = want.shape
    perm = np.empty((b, f, k), np.int64)
    for i in range(b):
        for j in range(f):
            d = np.abs(want[i, j][:, None] - got[i, j][None]).max(-1)
            perm[i, j] = d.argmin(1)
            assert d[np.arange(k), perm[i, j]].max() <= tol
            assert len(set(perm[i, j].tolist())) == k
    return perm


def raster_sites(compiled):
    """``quotient_sites`` of a compiled program over the points and cells
    of bench's couple."""
    return quotient_sites(compiled.as_text(), (65536, 2 * 65536, 700 * 800))


def nearest_in_score_order(want, got, window=16):
    """For each row of want (objectness then offsets), the smallest
    largest-difference to a row of got among the ``window`` rows on each
    side of its place when both are sorted by fused score: near-tied
    candidates swap only with close neighbours."""
    def by_score(rows):
        return rows[np.argsort(rows[:, 1] - rows[:, 0], kind="stable")]
    w, g = by_score(want), by_score(got)
    best = np.full(len(w), np.inf)
    for o in range(-window, window + 1):
        lo, hi = max(0, -o), min(len(w), len(g) - o)
        d = np.abs(w[lo:hi] - g[lo + o:hi + o]).max(-1)
        best[lo:hi] = np.minimum(best[lo:hi], d)
    return best


def loss_rel(want, got, keys=LOSS_KEYS):
    return {k: abs(float(got[k]) - float(want[k]))
            / max(abs(float(want[k])), 1e-30) for k in keys}


def port_losses_and_grads(model, out, batch, keep_graph=False):
    """compute_losses of the outputs and every parameter's gradient."""
    total, losses = tdt.compute_losses(model.cfg, out, batch, JaxDraws())
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(total, params, retain_graph=keep_graph,
                                allow_unused=True)
    return to_numpy(losses), {
        n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
        for n, p, g in zip(names, params, grads)}


def run_f32():
    """(a) and (b): JAX's train program (f32 towers) and the port's
    forward, losses and gradients, also with the port's second stage run
    again on JAX's proposal values (the ``_jp`` keys: each proposal of the
    port moved to JAX's slot and given JAX's coordinates, its gradient
    path kept); the BEV input of the couple on a tilted plane."""
    release()
    cfg = full_width_cfg()
    batch = train_batch()
    with pinned_keys():
        compiled = jax_train_program(cfg, train=False).lower(
            flax_params(), jax_tree(batch)).compile()
        (_, (jl, jout)), jg = compiled(flax_params(), jax_tree(batch))
    want = {"losses": to_numpy(dict(jl)), "out": to_numpy(dict(jout)),
            "grads": state_dict_of(jg), "sites": raster_sites(compiled)}
    tilted = {**batch, "ground_plane": TILTED[None]}
    want["tilted_bev"] = np.asarray(
        compiled(flax_params(), jax_tree(tilted))[0][1][1]["bev_input"])[0]
    del compiled, jl, jout, jg
    release()
    model = port_model(cfg)
    second_stage = model._second_stage
    again = {}

    def both(bev_bf, img_bf, top_anchors, *args, **kw):
        perm = proposal_order(want["out"]["top_anchors"],
                              top_anchors.detach().numpy())
        moved = torch.take_along_dim(top_anchors,
                                     torch.from_numpy(perm)[..., None], 2)
        jax_top = torch.from_numpy(want["out"]["top_anchors"].copy())
        again["top_anchors"] = moved + (jax_top - moved).detach()
        again["perm"] = perm
        again.update(second_stage(bev_bf, img_bf, again["top_anchors"],
                                  *args, **kw))
        return second_stage(bev_bf, img_bf, top_anchors, *args, **kw)
    model._second_stage = both
    tb = torch_tree(batch)
    out = model(tb, mode="train", train=False, rand=JaxDraws())
    del model._second_stage
    perm = again.pop("perm")
    out_jp = {**out, **again}
    losses, grads = port_losses_and_grads(model, out, tb, keep_graph=True)
    losses_jp, grads_jp = port_losses_and_grads(model, out_jp, tb)
    got = {"losses": losses, "out": to_numpy(out), "grads": grads,
           "losses_jp": losses_jp, "out_jp": to_numpy(out_jp),
           "grads_jp": grads_jp, "perm": perm,
           "tilted_bev": port_bev(tilted).numpy()}
    return want, got


def fresh(tree):
    """JAX arrays that own their memory (a donated train state must not
    alias the cached numpy weights)."""
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def run_step():
    """(c): one make_train_step of each package from the Flax weights,
    train=True, SGD at lr 1 without clipping; then the port's step under
    the flagship's optimiser (Adam, lr 1e-4, global-norm clip 1) against
    that optax chain applied to the JAX step's gradient."""
    release()
    cfg = full_width_cfg()
    sgd = copy.deepcopy(cfg)
    opt = sgd.train.optimizer
    opt.name, opt.initial_lr, opt.grad_clip_norm = "sgd", 1.0, 1e30
    sgd.model.rpn.keep_prob = 1.0
    batch, params = train_batch(), flax_params()
    tx = jtrain.make_optimizer(sgd, jtrain.frozen_mask_from_subtrees(
        params, ()))
    jstate = jtrain.TrainState(step=jnp.zeros((), jnp.int32),
                               params=fresh(params),
                               opt_state=tx.init(params), ema_params=None)
    start = convert.train_state_from_flax(
        jax.tree_util.tree_map(np.array, jstate))
    rng = jax.random.PRNGKey(42)
    with pinned_keys():
        compiled = jtrain.make_train_step(sgd, jax_model(sgd)).lower(
            jstate, jax_tree(batch), rng).compile()
        jnew, jl = compiled(jstate, jax_tree(batch), rng)
    sites = raster_sites(compiled)
    del compiled, jstate
    release()
    jgrad_tree = jax.tree_util.tree_map(lambda p, n: p - np.asarray(n),
                                        params, jnew.params)
    samp = jax.random.split(jax.random.fold_in(rng, 0), 3)[2]
    model = port_model(sgd)
    tnew, tl = ttrain.make_train_step(convert.config_from_json(sgd), model)(
        start, torch_tree(batch), JaxDraws(samp))
    got = {"losses": to_numpy(tl), "grads": {
        k: start.params[k].numpy() - v.numpy()
        for k, v in tnew.params.items()}}
    want = {"losses": to_numpy(dict(jl)), "grads": state_dict_of(jgrad_tree),
            "sites": sites}
    del jnew, tnew
    release()
    adam = jtrain.make_optimizer(cfg, jtrain.frozen_mask_from_subtrees(
        params, ()))
    upd, _ = adam.update(jgrad_tree, adam.init(params), params)
    want["adam"] = state_dict_of(upd)
    pcfg = convert.config_from_json(cfg)
    state = ttrain.create_train_state(pcfg, model)
    anew, _ = ttrain.make_train_step(pcfg, model)(state, torch_tree(batch),
                                                   JaxDraws(samp))
    got["adam"] = {k: v.numpy() - state.params[k].numpy()
                   for k, v in anew.params.items()}
    return want, got


def run_bf16():
    """(d): the bf16-tower forward in train mode and the losses, jitted
    JAX and the port (no gradients)."""
    release()
    cfg = full_width_cfg("bfloat16")
    batch = train_batch()
    jm = jax_model(cfg)

    def losses(params, batch):
        out = jm.apply({"params": params}, batch, train=False, mode="train")
        return jdt.compute_losses(cfg, out, batch, LOSS_KEY)[1], out
    with pinned_keys():
        jl, jout = jax.jit(losses)(flax_params(), jax_tree(batch))
    model = port_model(cfg)
    with torch.no_grad():
        out = model(torch_tree(batch), mode="train", train=False,
                    rand=JaxDraws())
        _, tl = tdt.compute_losses(model.cfg, out, torch_tree(batch),
                                   JaxDraws())
    return ({"losses": to_numpy(dict(jl)), "out": to_numpy(dict(jout))},
            {"losses": to_numpy(tl), "out": to_numpy(out)})


@pytest.fixture(scope="module")
def f32_run():
    return run_f32()


@pytest.fixture(scope="module")
def step_run():
    return run_step()


@pytest.fixture(scope="module")
def bf16_run():
    return run_bf16()


# ------------------------------------------------------------------ (a)

def test_train_bev_input_is_bit_equal(f32_run):
    """Both frames' BEV input (700 x 800 x 6) of the train program, bit
    for bit."""
    want, got = f32_run
    w, g = want["out"]["bev_input"], got["out"]["bev_input"]
    assert g.shape == w.shape == (1, 2, 700, 800, 6)
    np.testing.assert_array_equal(g, w)


def test_train_bev_input_on_a_tilted_plane_is_bit_equal(f32_run):
    """The couple over a tilted ground plane through the same compiled
    program: the heights and slices of the plane offset's FMAs."""
    want, got = f32_run
    assert (want["tilted_bev"][..., :5] > 0).sum() > 10000
    np.testing.assert_array_equal(got["tilted_bev"], want["tilted_bev"])


@pytest.mark.parametrize("run", ["value_and_grad", "make_train_step"])
def test_train_programs_multiply_by_reciprocals(f32_run, step_run, run):
    """Every quotient of the compiled rasterization is a multiply by an
    f32 reciprocal, as in the val program: none divides by a constant."""
    sites = (f32_run if run == "value_and_grad" else step_run)[0]["sites"]
    assert set(sites) == RECIPROCALS | {("divide", None)}, sites
    assert sites["divide", None] == 1


# ------------------------------------------------------------------ (b)

def test_train_outputs_exact(f32_run):
    """Masks, anchors, the RPN mini-batch's selection and the final
    counts equal JAX's; the RPN mini-batch holds positives."""
    want, got = f32_run
    w, g = want["out"], got["out"]
    assert set(g) == set(w)
    for k in EXACT:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for k in ("sel", "pos"):
        np.testing.assert_array_equal(g["rpn_mb"][k], w["rpn_mb"][k],
                                      err_msg=k)
    assert (w["rpn_mb"]["pos"].sum(-1) > 0).all()
    np.testing.assert_array_equal(g["final_valid"].sum(-1),
                                  w["final_valid"].sum(-1))


def test_train_rpn_matches_as_sets(f32_run):
    """The RPN mini-batch's head outputs in place, the 8192 candidates'
    (objectness, offsets) rows as sets, within RPN_ATOL."""
    want, got = f32_run
    w, g = want["out"], got["out"]
    for k in ("objectness", "offsets", "offset_targets"):
        np.testing.assert_allclose(g["rpn_mb"][k], w["rpn_mb"][k], rtol=0,
                                   atol=RPN_ATOL, err_msg=k)
    rows = [np.concatenate([o["objectness"][0, :, :K_FUSE],
                            o["rpn_offsets"][0, :, :K_FUSE]], -1)
            for o in (w, g)]
    for f in range(2):
        nearest = nearest_in_score_order(rows[0][f], rows[1][f])
        assert nearest.max() <= RPN_ATOL, (f, nearest.max())


def test_train_proposals_and_finals_match_as_sets(f32_run):
    """JAX's 1024 proposals each have a port proposal within 1e-3 (m, and
    in score); at most MAX_SWAPPED slots hold another proposal; every
    valid final has a port final within 1e-2."""
    want, got = f32_run
    w, g = want["out"], got["out"]
    for f in range(2):
        def rows(o, boxes, scores):
            return np.concatenate([o[boxes][0, f], o[scores][0, f][:, None]],
                                  -1)
        assert set_share(rows(w, "top_anchors", "top_scores"),
                         w["top_valid"][0, f],
                         rows(g, "top_anchors", "top_scores"),
                         g["top_valid"][0, f], 1e-3) == 1.0
        assert (got["perm"][0, f] != np.arange(1024)).sum() <= MAX_SWAPPED
        assert set_share(rows(w, "final_boxes_3d", "final_scores"),
                         w["final_valid"][0, f],
                         rows(g, "final_boxes_3d", "final_scores"),
                         g["final_valid"][0, f], 1e-2) == 1.0


def test_train_losses_match(f32_run):
    """The seven losses, every one non-zero: as they come within
    RAW_LOSS_RTOL, on JAX's proposals within test_torch_train.py's 2e-5
    (measured 9.8e-6, avod_ang)."""
    want, got = f32_run
    assert set(got["losses"]) == set(want["losses"]) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        assert float(want["losses"][k]) > 0, k
    for key, rtol in (("losses", RAW_LOSS_RTOL), ("losses_jp", 2e-5)):
        rel = loss_rel(want["losses"], got[key])
        assert max(rel.values()) <= rtol, (key, rel)


def test_train_second_stage_on_jax_proposals_matches(f32_run):
    """The port's second stage on JAX's proposal values: every output in
    JAX's slot within JP_ATOL, the finals' indices and mask equal."""
    want, got = f32_run
    w, g = want["out"], got["out_jp"]
    for k, atol in JP_ATOL.items():
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol,
                                   err_msg=k)
    for k in ("final_indices", "final_valid"):
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_gradients_match(f32_run):
    """Every parameter's gradient: as it comes within RAW_GRAD_SHARE of
    its leaf's largest (or RAW_GRAD_MODEL of the model's largest); on
    JAX's proposals within JP_GRAD_SHARE. The zero-gradient leaves below
    1e-4 of the model's largest (test_torch_train.py's rule)."""
    want, got = f32_run
    jg = want["grads"]
    assert set(got["grads"]) == set(jg)
    top = max(np.abs(v).max() for v in jg.values())
    for key in ("grads", "grads_jp"):
        for k, w in jg.items():
            g = got[key][k]
            if k in NOISE_LEAVES:
                assert np.abs(g).max() < 1e-4 * top, (key, k)
                assert np.abs(w).max() < 1e-4 * top, k
                continue
            err, scale = np.abs(g - w).max(), np.abs(w).max()
            if key == "grads":
                assert err <= max(RAW_GRAD_SHARE * scale,
                                  RAW_GRAD_MODEL * top), (k, err, scale)
            else:
                assert err <= JP_GRAD_SHARE * scale, (k, err, scale)


# ------------------------------------------------------------------ (c)

def test_train_step_sgd_matches_jax(step_run):
    """make_train_step, train=True, SGD at lr 1: the seven losses within
    STEP_LOSS_RTOL, every update (minus the gradient) within
    STEP_GRAD_SHARE of its leaf's largest."""
    want, got = step_run
    rel = loss_rel(want["losses"], got["losses"])
    assert max(rel.values()) <= STEP_LOSS_RTOL, rel
    for k in LOSS_KEYS:
        assert float(want["losses"][k]) > 0, k
    top = max(np.abs(v).max() for v in want["grads"].values())
    for k, w in want["grads"].items():
        err = np.abs(got["grads"][k] - w).max()
        if k in NOISE_LEAVES:
            assert err < 1e-4 * top, k
        else:
            assert err <= STEP_GRAD_SHARE * np.abs(w).max(), k


def test_train_step_adam_matches_optax(step_run):
    """The port's step under the flagship's Adam against optax's chain on
    the JAX step's gradient: Adam's first step moves an element by lr
    times the sign of its gradient, so the elements whose gradient is
    rounding noise (the zero-gradient leaves) take either sign; every
    other element within ADAM_TOL lr."""
    want, got = step_run
    lr = full_width_cfg().train.optimizer.initial_lr
    off = n = 0
    for k, w in want["adam"].items():
        err = np.abs(got["adam"][k] - w)
        assert err.max() <= 2 * lr * 1.001, k
        if k not in NOISE_LEAVES:
            off += int((err > ADAM_TOL * lr).sum())
            n += err.size
    assert off <= ADAM_OFF * n, off


# ------------------------------------------------------------------ (d)

def test_bf16_rpn_matches(bf16_run):
    """bf16 towers: bev_input and the RPN mini-batch's selection equal,
    the RPN's losses within BF16_RPN_RTOL, at least 0.98 of JAX's
    proposals with a port proposal within 5e-2 (C23's set rule)."""
    want, got = bf16_run
    w, g = want["out"], got["out"]
    np.testing.assert_array_equal(g["bev_input"], w["bev_input"])
    np.testing.assert_array_equal(g["top_valid"], w["top_valid"])
    for k in ("sel", "pos"):
        np.testing.assert_array_equal(g["rpn_mb"][k], w["rpn_mb"][k],
                                      err_msg=k)
    rel = loss_rel(want["losses"], got["losses"], RPN_LOSSES)
    assert max(rel.values()) <= BF16_RPN_RTOL, rel
    for f in range(2):
        def rows(o):
            return np.concatenate([o["top_anchors"][0, f],
                                   o["top_scores"][0, f][:, None]], -1)
        share = set_share(rows(w), w["top_valid"][0, f], rows(g),
                          g["top_valid"][0, f], 5e-2)
        assert share >= 0.98, (f, share)
