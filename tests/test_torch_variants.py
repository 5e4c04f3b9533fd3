"""The port's model variants against the JAX ``DtAvodNet``, on the CPU
in float32, from the same seeded inputs and weights: every box
representation (box_3d, box_4c, box_4ca, box_8c, box_8co), every trunk
fusion (early/concat, late/max, deep/mean, and late/deep with concat in
the trunk test), the plain tower, GroupNorm towers and a two-class head
(the people preset's classes and mini-batch ranges), as
tests/test_model_variants.py runs them for JAX.

Five configurations cover them, each built once: its Flax parameter tree
is traced with ``jax.eval_shape`` (no JAX init), filled with seeded
numpy weights and loaded into the port with ``strict=True``. The JAX
``apply`` (jitted, val mode) and the port's forward take the same batch
of one fixture couple; ``compute_losses`` takes JAX's draws
(test_torch_train.py's ``JaxDraws``) on GT moved onto the proposals, so
the second stage has positives.

Tolerances: test_torch_forward.py's (f32 summation order: 1e-5 on
features and logits, the stated metric bounds on decoded boxes; masks,
indices and NMS picks equal); losses 2e-5 relative. The trunk's
gradients agree to 1e-5 of each leaf's largest.
"""
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.data import synthetic, tracking
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu_torch import convert
from dodt_tpu_torch.models import dt_avod as tdt
from test_torch_forward import ATOL, EXACT, KEYS
from test_torch_train import KEYS as JAX_KEYS
from test_torch_train import LOSS_KEY, JaxDraws

CAR = ((3.9, 1.6, 1.52),)
PEOPLE = ((0.8, 0.6, 1.73), (1.76, 0.6, 1.73))


def _people(cfg):
    """The people preset's head on the unittest config: two classes with
    one cluster each and its mini-batch IoU ranges."""
    p = cfg_mod.people_dt_tracking()
    cfg.dataset.classes = p.dataset.classes
    cfg.dataset.num_clusters = p.dataset.num_clusters
    cfg.dataset.mini_batch = copy.deepcopy(p.dataset.mini_batch)
    cfg.dataset.mini_batch.rpn_mini_batch_size = 64
    cfg.dataset.mini_batch.avod_mini_batch_size = 64


def _plain(cfg):
    for ext in (cfg.model.bev_extractor, cfg.model.img_extractor):
        ext.pyramid = False
        ext.conv4 = (2, 32)


def _gn(cfg):
    cfg.model.bev_extractor.norm = "gn"
    cfg.model.img_extractor.norm = "gn"


# name -> (box representation, (avod fusion_method, fusion_type), towers
# and head); the RPN fuses by concat where the trunk does, else mean
VARIANTS = {
    "box_3d-concat-early-plain": ("box_3d", ("concat", "early"), [_plain]),
    "box_4c-max-late-gn": ("box_4c", ("max", "late"), [_gn]),
    "box_4ca-mean-deep-people": ("box_4ca", ("mean", "deep"), [_people]),
    "box_8c-max-late-plain": ("box_8c", ("max", "late"), [_plain]),
    "box_8co-mean-deep-gn-people": ("box_8co", ("mean", "deep"),
                                    [_gn, _people]),
}
# The plain tower's image bottleneck is the one-channel GroupNorm of a
# map whose mean is 12x its deviation, where the one-pass f32 variance
# E[x^2] - E[x]^2 cancels: on this fixture JAX's output there is 1.6e-3
# from a float64 evaluation (the port's 3.8e-5), and the RPN's scores,
# offsets and proposals, and the crops at those proposals, carry it
PLAIN_ATOL = {"objectness": 1e-3, "rpn_offsets": 1e-3, "top_scores": 1e-4,
              "top_anchors": 1e-3, "proposal_boxes_3d": 1e-3,
              "proposal_enc": 1e-3, "pred_boxes_3d": 1e-3,
              "box_offsets": 1e-4, "cls_logits": 1e-4}
# GroupNorm towers give features up to 5.7 (the flagship's stay near 1)
# into the 392-wide first trunk layer: the second stage's outputs differ
# by f32 summation order up to 4e-5 on this fixture
GN_ATOL = {"cls_logits": 5e-5, "box_offsets": 5e-5, "corr_pred": 5e-5}


def base_config(root):
    cfg = cfg_mod.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.kitti_utils.area_extents = (
        (-16.0, 16.0), (-3.0, 3.0), (0.0, 48.0))
    cfg.dataset.kitti_utils.anchor_strides = (1.0, 1.0)
    cfg.dataset.max_points = 4096
    cfg.dataset.video_train_ids = (0,)
    return cfg


def seeded_params(shapes, seed):
    """Seeded weights of a Flax tree's shapes, with Flax's initial
    statistics: kernels LeCun-normal, biases 0, GroupNorm scales 1. (With
    random biases ahead of a GroupNorm, its one-pass f32 variance E[x^2]
    - E[x]^2 loses digits in JAX's sums that the port keeps, beyond these
    tolerances; tests/test_torch_backbone.py holds every tower leaf
    random.)"""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        if len(s.shape) > 1:
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif path[-1].key == "scale":
            a = np.ones(s.shape)
        else:
            a = np.zeros(s.shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


TOWERS = ("bev_vgg_pyr", "int_bev_vgg_pyr", "img_vgg_pyr")


def jax_val_forward(jmodel, params, batch):
    """The JAX val forward (jitted) and its towers' outputs, by module
    name."""
    def apply(p, b):
        return jmodel.apply({"params": p}, b, train=False, mode="val",
                            capture_intermediates=lambda mdl, _: (
                                mdl.name in TOWERS),
                            mutable=["intermediates"])
    out, state = jax.jit(apply)(params, _jb(batch))
    towers = {n: v["__call__"][0] for n, v in state["intermediates"].items()
              if n in TOWERS}
    return out, towers


def feed_towers(model, towers, monkeypatch, module=tdt):
    """The port's towers (in ``module``'s forward) give the JAX towers'
    outputs. With the plain or GroupNorm towers the two packages' towers
    differ by f32 rounding (a GroupNorm tower at the fixture's image
    size: 3.0e-5 from a float64 run for JAX, 7.6e-6 for the port, on
    values up to 5.7), which the RPN's one-channel GroupNorm amplifies
    into near-tie swaps of NMS picks; tests/test_torch_backbone.py holds
    the towers themselves, at the fixture's widths and with every leaf
    random."""
    names = {id(m): n for n, m in model.named_children()}

    def tower_forward(remat, tower, x, fused):
        return torch.from_numpy(np.array(towers[names[id(tower)]],
                                         np.float32))

    monkeypatch.setattr(module, "tower_forward", tower_forward)


def run_variant(cfg, clusters, batch, seed=0, monkeypatch=None,
                params=None):
    """The JAX and the port's val forward of ``cfg`` on ``batch`` with
    seeded weights (or ``params``): (JAX outputs, port outputs, params,
    port model). With ``monkeypatch``, the port's towers give JAX's
    outputs."""
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=clusters)
    if params is None:
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda b: jmodel.init(
            {"params": key}, b, train=False, mode="val"), _jb(batch))
        params = seeded_params(shapes["params"], seed)
    want, towers = jax_val_forward(jmodel, params, batch)
    model = tdt.DtAvodNet(convert.config_from_json(cfg), clusters)
    model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    if monkeypatch is not None:
        feed_towers(model, towers, monkeypatch)
    got = model.eval()(_tb(batch), mode="val")
    return want, got, params, model


def assert_output_matches(key, want, got, atol=ATOL):
    """test_torch_forward.py's bounds, plus 1e-5 relative on every float:
    the variants' logits and offsets reach 2-4 (the flagship's stay
    under 1)."""
    w, g = want[key], got[key]
    if w is None:
        assert g is None, key
        return
    w, g = np.asarray(w), g.numpy()
    assert g.shape == w.shape, key
    if key in EXACT:
        np.testing.assert_array_equal(g, w, err_msg=key)
    else:
        np.testing.assert_allclose(g, w, atol=atol.get(key, 1e-5),
                                   rtol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_variants_torch"))
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=4,
                                     ego_speed=1.0)
    cfg = base_config(root)
    ds = tracking.KittiTrackingDataset(cfg.dataset, split="train")
    batch = ds.next_batch(1, shuffle=False, augment=False)
    return cfg, {k: np.asarray(v) for k, v in batch.items()
                 if not isinstance(v, list)}


def _gt_on_proposals(batch, top_anchors, n_classes):
    """GT on the first proposals of each frame, slightly shifted, with
    the classes taken in turn (tests/test_torch_train.py's fixture)."""
    batch = dict(batch)
    top = np.asarray(top_anchors)[:, :, :8]
    boxes = np.array(jdt.box_ops.anchors_to_box_3d(jnp.asarray(top),
                                                   fix_lw=True))
    boxes[..., 0] += 0.05
    boxes[..., 6] += 0.1                  # off the axes: box_3d's ortho
    g = batch["gt_boxes"].shape[2]
    n = min(g, 8)
    batch["gt_boxes"] = np.zeros_like(batch["gt_boxes"])
    batch["gt_boxes"][:, :, :n] = boxes[:, :, :n]
    batch["gt_valid"] = np.zeros_like(batch["gt_valid"])
    batch["gt_valid"][:, :, :n] = True
    batch["gt_classes"] = np.where(
        batch["gt_valid"], 1 + np.arange(g) % n_classes, 0).astype(np.int32)
    rs = np.random.RandomState(0)
    batch["corr_offsets"] = rs.uniform(-0.5, 0.5, batch["corr_offsets"].shape
                                       ).astype(np.float32)
    batch["corr_coexist"] = np.ones_like(batch["corr_coexist"])
    return batch


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request, fixture):
    rep, (method, ftype), edits = VARIANTS[request.param]
    cfg = copy.deepcopy(fixture[0])
    cfg.model.avod.box_representation = rep
    cfg.model.avod.fusion_method = method
    cfg.model.avod.fusion_type = ftype
    cfg.model.rpn.fusion_method = "concat" if method == "concat" else "mean"
    for edit in edits:
        edit(cfg)
    clusters = PEOPLE if _people in edits else CAR
    with pytest.MonkeyPatch.context() as mp:
        want, got, params, model = run_variant(
            cfg, clusters, fixture[1],
            monkeypatch=mp if {_plain, _gn} & set(edits) else None)

    batch = _gt_on_proposals(fixture[1], want["top_anchors"],
                             len(cfg.dataset.classes))
    jl = jax.jit(lambda o, b: jdt.compute_losses(cfg, o, b, LOSS_KEY)[1])(
        want, _jb(batch))
    _, tl = tdt.compute_losses(convert.config_from_json(cfg), got,
                               _tb(batch), JaxDraws())
    return {"name": request.param, "cfg": cfg, "params": params,
            "model": model, "want": want, "got": got,
            "losses": (jl, tl)}


@pytest.mark.parametrize("key", sorted(KEYS))
def test_variant_forward_matches_jax(variant, key):
    ext = variant["cfg"].model.bev_extractor
    atol = {**ATOL, **(GN_ATOL if ext.norm == "gn" else {}),
            **({} if ext.pyramid else PLAIN_ATOL)}
    assert set(variant["got"]) == set(variant["want"]) == KEYS
    assert_output_matches(key, variant["want"], variant["got"], atol)


def test_variant_shapes(variant):
    """The representation's branch widths and the class count reach the
    outputs (tests/test_model_variants.py's checks)."""
    cfg, got = variant["cfg"], variant["got"]
    rep = cfg.model.avod.box_representation
    assert got["box_offsets"].shape[-1] == tdt.OFFSETS_SIZE[rep]
    assert (got["angle_vectors"] is None) == (tdt.ANGLE_SIZE[rep] == 0)
    n_cls = len(cfg.dataset.classes) + 1
    assert got["cls_logits"].shape[-1] == n_cls
    assert got["final_cls_softmax"].shape[-1] == n_cls
    assert got["final_valid"].sum() > 0
    assert np.isfinite(got["final_boxes_3d"].numpy()).all()


def test_variant_losses_match_jax(variant):
    jl, tl = variant["losses"]
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=2e-5,
                                   atol=1e-7, err_msg=k)
    assert tl["avod_reg"].item() > 0
    have_angle = tdt.ANGLE_SIZE[
        variant["cfg"].model.avod.box_representation] > 0
    assert (tl["avod_ang"].item() > 0) == have_angle


def test_variant_tree_converts_both_ways(variant):
    """The seeded Flax tree loaded with strict=True (the fixture); the
    port's state dict maps back to the same tree, leaf for leaf."""
    back = convert.state_dict_to_flax(variant["model"].state_dict())
    want = jax.tree_util.tree_flatten_with_path(variant["params"])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


# ------------------------------------------------------------ trunk


@pytest.mark.parametrize("method,ftype", [("max", "late"), ("mean", "deep"),
                                          ("concat", "late"),
                                          ("concat", "deep")])
def test_trunk_gradients_match_jax(method, ftype, monkeypatch):
    """AvodTrunk with dropout (JAX's draws) and path-drop weights: the
    outputs and the gradients of a weighted sum with respect to every
    parameter and both inputs."""
    monkeypatch.setattr(fnn.Module, "make_rng",
                        lambda self, name="params": JAX_KEYS[name])
    rng = np.random.RandomState(4)
    m, d_bev, d_img = 12, 20, 20
    sizes, out_dims = (16, 8), (3, 10, 2)
    bev = rng.randn(m, d_bev).astype(np.float32)
    img = rng.randn(m, d_img).astype(np.float32)
    wb = (rng.rand(m, 1) > 0.3).astype(np.float32)
    wi = (rng.rand(m, 1) > 0.3).astype(np.float32)
    wts = [rng.randn(m, d).astype(np.float32) for d in out_dims]
    jt = jdt.AvodTrunk(sizes, out_dims, 0.7, ftype, method)
    shapes = jax.eval_shape(lambda: jt.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(bev), jnp.asarray(img),
        jnp.asarray(wb), jnp.asarray(wi), False))["params"]
    params = seeded_params(shapes, 1)

    def jloss(p, b, i):
        outs = jt.apply({"params": p}, b, i, jnp.asarray(wb), jnp.asarray(wi),
                        True)
        return sum((o * w).sum() for o, w in zip(outs, wts)), outs

    (_, jouts), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                has_aux=True))(
        params, jnp.asarray(bev), jnp.asarray(img))

    tt = tdt.AvodTrunk(d_bev, d_img, sizes, out_dims, ftype, method,
                       torch.float32, 0.7)
    tt.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    tb_, ti_ = (torch.tensor(bev, requires_grad=True),
                torch.tensor(img, requires_grad=True))
    touts = tt(tb_, ti_, torch.tensor(wb), torch.tensor(wi), JaxDraws())
    sum((o * torch.tensor(w)).sum() for o, w in zip(touts, wts)).backward()
    for o, w in zip(touts, jouts):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5)
    grads = {k: p.grad.numpy() for k, p in tt.named_parameters()}
    grads["bev"], grads["img"] = tb_.grad.numpy(), ti_.grad.numpy()
    want = convert.flax_to_state_dict(jg[0])
    want = {k: v.numpy() for k, v in want.items()}
    want["bev"], want["img"] = np.asarray(jg[1]), np.asarray(jg[2])
    assert set(grads) == set(want)
    for k, w in want.items():
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(grads[k], w, atol=1e-5 * scale, rtol=0,
                                   err_msg=k)


# ------------------------------------------------------------ Stack


def test_stack_model_takes_the_variant_towers(fixture, monkeypatch):
    """StackAvodNet with plain GroupNorm towers (all three): the seeded
    Flax tree loads with strict=True and the val forward matches JAX's
    (its towers fed JAX's outputs, as above) at the stated
    tolerances."""
    from dodt_tpu.data import stack as jstack_data
    from dodt_tpu.models import stack as jstack
    from dodt_tpu_torch.models import stack as tstack
    from test_torch_stack import STACK_KEYS

    cfg = copy.deepcopy(fixture[0])
    cfg.model.model_name = "stack_avod_model"
    cfg.dataset.data_stride = 2                  # stacks of 3 frames
    _plain(cfg)
    _gn(cfg)
    ds = jstack_data.KittiTrackingStackDataset(cfg.dataset, split="train")
    batch = {k: np.asarray(v) for k, v in ds.next_batch(
        1, shuffle=False).items() if not isinstance(v, list)}
    jmodel = jstack.StackAvodNet(cfg=cfg, cluster_sizes=CAR)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False, mode="val"),
        _jb(batch))["params"]
    params = seeded_params(shapes, 2)
    want, towers = jax_val_forward(jmodel, params, batch)
    model = tstack.StackAvodNet(convert.config_from_json(cfg), CAR)
    model.load_state_dict(convert.flax_to_state_dict(params), strict=True)
    feed_towers(model, towers, monkeypatch, tstack)
    got = model.eval()(_tb(batch), mode="val")
    assert set(got) == set(want) == STACK_KEYS
    atol = {**ATOL, **GN_ATOL, **PLAIN_ATOL}
    for key in sorted(STACK_KEYS):
        assert_output_matches(key, want, got, atol)
