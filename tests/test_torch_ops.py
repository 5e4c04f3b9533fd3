"""The port's ops (dodt_tpu_torch.ops) against the JAX package's, on the
CPU, from the same seeded numpy inputs. Tolerances are stated per test:
integer-valued results (masks, indices, counts) must be equal, float
results agree to float32 rounding of differently ordered sums."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.ops import anchors as janc
from dodt_tpu.ops import boxes as jbox
from dodt_tpu.ops import dense_rpn as jdense
from dodt_tpu.ops import iou as jiou
from dodt_tpu.ops import nms as jnms
from dodt_tpu.ops import projection as jproj
from dodt_tpu.ops import roi as jroi
from dodt_tpu.ops import voxel as jvox
from dodt_tpu.ops import warp as jwarp
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.ops import anchors as tanc
from dodt_tpu_torch.ops import boxes as tbox
from dodt_tpu_torch.ops import dense_rpn as tdense
from dodt_tpu_torch.ops import iou as tiou
from dodt_tpu_torch.ops import nms as tnms
from dodt_tpu_torch.ops import projection as tproj
from dodt_tpu_torch.ops import roi as troi
from dodt_tpu_torch.ops import voxel as tvox
from dodt_tpu_torch.ops import warp as twarp

AREA = ((-8.0, 8.0), (-5.0, 3.0), (0.0, 12.0))
BEV_EXTENTS = [[-8.0, 8.0], [0.0, 12.0]]
GP = np.array([0.02, -1.0, 0.01, 1.65], np.float32)
P2 = np.array([[721.5, 0, 609.5, 44.9], [0, 721.5, 172.8, 0.2],
               [0, 0, 1.0, 0.003]], np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _boxes_3d(rng, n):
    return np.stack([rng.uniform(-6, 6, n), rng.uniform(0.5, 2.0, n),
                     rng.uniform(2, 10, n), rng.uniform(3, 5, n),
                     rng.uniform(1.4, 2.0, n), rng.uniform(1.3, 1.8, n),
                     rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


def _anchors(rng, n):
    return np.stack([rng.uniform(-6, 6, n), rng.uniform(0.5, 2.0, n),
                     rng.uniform(4, 10, n), rng.uniform(1.5, 5, n),
                     rng.uniform(1.3, 1.8, n), rng.uniform(1.5, 5, n)],
                    -1).astype(np.float32)


# ---------------------------------------------------------------- voxel

def test_bev_maps_match_jax():
    """Scatter-max/sum rasterization: equal heights and density to f32
    rounding, identical occupancy; points outside the extents, outside
    the height band and invalid ones are dropped in both."""
    rng = np.random.RandomState(0)
    n = 3000
    pts = np.stack([rng.uniform(-9, 9, n), rng.uniform(-1, 2.5, n),
                    rng.uniform(-1, 13, n)], -1).astype(np.float32)
    valid = rng.rand(n) > 0.1
    args = dict(area_extents=AREA, voxel_size=0.1, height_lo=-0.2,
                height_hi=2.3, num_slices=5)
    want = jvox.bev_maps_from_points(jnp.asarray(pts), jnp.asarray(valid),
                                     jnp.asarray(GP), **args)
    got = tvox.bev_maps_from_points(t(pts), t(valid), t(GP), **args)
    close(got.features, want.features, atol=1e-6)
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(want.occupancy))
    assert got.occupancy.sum() > 100


# ---------------------------------------------------------------- boxes

@pytest.mark.parametrize("ortho", [False, True])
def test_box_3d_to_anchor_matches_jax(ortho):
    b = _boxes_3d(np.random.RandomState(1), 64)
    close(tbox.box_3d_to_anchor(t(b), ortho_rotate=ortho),
          jbox.box_3d_to_anchor(jnp.asarray(b), ortho_rotate=ortho))


def test_anchor_codecs_match_jax():
    rng = np.random.RandomState(2)
    anc = _anchors(rng, 64)
    off = (rng.randn(64, 6) * 0.2).astype(np.float32)
    close(tbox.anchors_to_box_3d(t(anc), fix_lw=True),
          jbox.anchors_to_box_3d(jnp.asarray(anc), fix_lw=True))
    close(tbox.offset_to_anchor(t(anc), t(off)),
          jbox.offset_to_anchor(jnp.asarray(anc), jnp.asarray(off)))
    vec = rng.randn(64, 2).astype(np.float32)
    close(tbox.angle_vector_to_orientation(t(vec)),
          jbox.angle_vector_to_orientation(jnp.asarray(vec)))


def test_box_4c_codec_matches_jax():
    """box_3d -> box_4c -> (perturbed) -> box_3d, the box_4ca decode."""
    rng = np.random.RandomState(3)
    b = _boxes_3d(rng, 64)
    gp = np.broadcast_to(GP, (64, 4))
    enc_t = tbox.box_3d_to_box_4c(t(b), t(gp))
    enc_j = jbox.box_3d_to_box_4c(jnp.asarray(b), jnp.asarray(gp))
    close(enc_t, enc_j, atol=2e-5)
    off = (rng.randn(64, 10) * 0.1).astype(np.float32)
    close(tbox.box_4c_to_box_3d(enc_t + t(off), t(gp)),
          jbox.box_4c_to_box_3d(enc_j + off, jnp.asarray(gp)), atol=5e-5)


# ---------------------------------------------------------------- projection

def test_projections_match_jax():
    anc = _anchors(np.random.RandomState(4), 128)
    shape = np.array([375.0, 1242.0], np.float32)
    for got, want in zip(tproj.project_to_bev(t(anc), BEV_EXTENTS),
                         jproj.project_to_bev(jnp.asarray(anc),
                                              BEV_EXTENTS)):
        close(got, want)
    for got, want in zip(
            tproj.project_to_image_space(t(anc), t(P2), t(shape)),
            jproj.project_to_image_space(jnp.asarray(anc), jnp.asarray(P2),
                                         jnp.asarray(shape))):
        close(got, want, atol=1e-3, rtol=1e-5)     # pixels, from 1e3 values
    bx = np.random.RandomState(5).rand(7, 4).astype(np.float32)
    close(tproj.reorder_boxes_yx(t(bx)), jproj.reorder_boxes_yx(bx))


# ---------------------------------------------------------------- anchors

def test_anchor_grid_and_integral_match_jax():
    sizes = np.array([[3.9, 1.6, 1.52], [1.0, 0.6, 1.7]], np.float32)
    got = tanc.tile_anchors_3d(AREA, sizes, (0.5, 0.5), t(GP))
    want = janc.tile_anchors_3d(np.asarray(AREA), sizes, (0.5, 0.5),
                                jnp.asarray(GP))
    close(got, want)
    occ = (np.random.RandomState(6).rand(160, 120) > 0.9).astype(np.float32)
    np.testing.assert_array_equal(
        tanc.integral_image_2d(t(occ)).numpy(),
        np.asarray(janc.integral_image_2d(jnp.asarray(occ))))


# ---------------------------------------------------------------- dense rpn

@pytest.fixture(scope="module")
def lattice_pair():
    clusters = ((3.9, 1.6, 1.52), (1.0, 0.6, 1.7))
    args = (AREA, (0.5, 0.5), clusters, (120, 160), 0.1, 3)
    return (tdense.build_bev_lattice(*args), jdense.build_bev_lattice(*args),
            clusters)


def test_lattice_matches_jax(lattice_pair):
    tl, jl, _ = lattice_pair
    for f in ("nz", "nx", "period", "n_cfg", "crop_size"):
        assert getattr(tl, f) == getattr(jl, f)
    for f in ("row_off", "row_frac", "col_off", "col_frac", "mask_x_off",
              "mask_z_off"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    assert tdense.build_bev_lattice(AREA, (0.45, 0.45), ((3.9, 1.6, 1.5),),
                                    (120, 160), 0.1, 3) is None


def test_dense_bev_rois_match_jax(lattice_pair):
    """Row pass + column pass with static weights, edge clamp by index
    clipping: equal to the JAX slices to f32 rounding."""
    tl, jl, _ = lattice_pair
    fm = np.random.RandomState(7).randn(120, 160, 2).astype(np.float32)
    got = tdense.dense_bev_rois(t(fm), tl)
    want = jdense.dense_bev_rois(jnp.asarray(fm), jl)
    assert got.shape == want.shape
    close(got, want, atol=1e-6)


def test_dense_anchor_mask_matches_jax(lattice_pair):
    """Integer counts: equal, against the lattice and the per-anchor
    integral-image filter alike."""
    tl, jl, clusters = lattice_pair
    occ = (np.random.RandomState(8).rand(160, 120) > 0.97).astype(np.float32)
    ii = np.asarray(janc.integral_image_2d(jnp.asarray(occ)))
    got = tdense.dense_occupancy_counts(t(ii), tl).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jdense.dense_occupancy_counts(jnp.asarray(ii), jl)))
    anc = jbox.box_3d_to_anchor(janc.tile_anchors_3d(
        np.asarray(AREA), np.asarray(clusters, np.float32), (0.5, 0.5),
        jnp.asarray(GP)))
    per_anchor = janc.empty_anchor_mask(jnp.asarray(ii), anc, BEV_EXTENTS,
                                        0.1)
    np.testing.assert_array_equal(
        tdense.dense_empty_anchor_mask(t(ii), tl).numpy(),
        np.asarray(per_anchor))


# ---------------------------------------------------------------- roi

@pytest.mark.parametrize("c,method", [(32, "gather"), (1, "matmul"),
                                      (1, "auto")])
def test_crop_and_resize_matches_jax(c, method):
    rng = np.random.RandomState(9)
    img = rng.randn(30, 40, c).astype(np.float32)
    lo = rng.uniform(-0.1, 0.8, (300, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0, 0.4, (300, 2))],
                           -1).astype(np.float32)
    got = troi.crop_and_resize(t(img), t(boxes), 3, method=method)
    want = jroi.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), 3,
                                method=method)
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("n,s,shape", [(8192, 3, (180, 600, 1)),
                                       (300, 7, (350, 400, 32)),
                                       (300, 7, (350, 400, 1)),
                                       (10, 3, (20, 20, 1))])
def test_auto_method_matches_jax(n, s, shape):
    assert troi.auto_method(n, s, shape, 4) == jroi.auto_method(n, s, shape,
                                                                4)


def test_aligned_iou_matches_jax():
    rng = np.random.RandomState(10)
    lo = rng.rand(50, 2)
    bx = np.concatenate([lo, lo + rng.rand(50, 2) * 0.3], -1).astype(
        np.float32)
    bx[3] = bx[3, [2, 3, 0, 1]]                       # degenerate box
    close(tiou.aligned_iou_matrix(t(bx), t(bx[:20])),
          jiou.aligned_iou_matrix(jnp.asarray(bx), jnp.asarray(bx[:20])))


# ---------------------------------------------------------------- nms

@pytest.mark.parametrize("thresh,max_out", [(0.3, 40), (0.01, 20)])
def test_exact_nms_matches_jax(thresh, max_out):
    """Same indices and validity, including score ties (lower index
    first) and the padding slots past the kept set."""
    rng = np.random.RandomState(11)
    n = 200
    lo = rng.rand(n, 2)
    bx = np.concatenate([lo, lo + rng.uniform(0.02, 0.2, (n, 2))],
                        -1).astype(np.float32)
    scores = np.round(rng.rand(n), 2).astype(np.float32)   # many ties
    valid = rng.rand(n) > 0.2
    gi, gv = tnms.nms_bev_exact(t(bx), t(scores), t(valid), max_out, thresh)
    wi, wv = jnms.nms_bev_exact(jnp.asarray(bx), jnp.asarray(scores),
                                jnp.asarray(valid), max_out, thresh)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    # batched leading axes run every row to its own fixpoint
    gi2, gv2 = tnms.nms_bev_exact(t(np.stack([bx, bx[::-1]])),
                                  t(np.stack([scores, scores[::-1]])),
                                  t(np.stack([valid, valid[::-1]])),
                                  max_out, thresh)
    np.testing.assert_array_equal(gi2[0].numpy(), gi.numpy())
    wi_r, _ = jnms.nms_bev_exact(jnp.asarray(bx[::-1].copy()),
                                 jnp.asarray(scores[::-1].copy()),
                                 jnp.asarray(valid[::-1].copy()), max_out,
                                 thresh)
    np.testing.assert_array_equal(gi2[1].numpy(), np.asarray(wi_r))
    ti, tv = tnms.top_k_prefilter(t(scores), t(valid), 50)
    ji, jv = jnms.top_k_prefilter(jnp.asarray(scores), jnp.asarray(valid),
                                  50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("mode", ["greedy", "fast"])
@pytest.mark.parametrize("thresh,max_out", [(0.3, 40), (0.01, 20),
                                            (0.5, 150)])
def test_nms_modes_match_jax(mode, thresh, max_out):
    """The greedy oracle (nms_bev) and fast NMS (nms_bev_fast) against
    JAX: the same indices and validity on boxes with exact score ties
    (lower index first), padding slots included, and per row under
    batched leading axes."""
    rng = np.random.RandomState(12)
    n = 200
    lo = rng.rand(n, 2)
    bx = np.concatenate([lo, lo + rng.uniform(0.02, 0.2, (n, 2))],
                        -1).astype(np.float32)
    scores = np.round(rng.rand(n), 2).astype(np.float32)   # many ties
    valid = rng.rand(n) > 0.2
    fn_t, fn_j = tnms.nms_bev_mode(mode), jnms.nms_bev_mode(mode)
    rows = [(bx, scores, valid), (bx[::-1].copy(), scores[::-1].copy(),
                                  valid[::-1].copy())]
    gi, gv = fn_t(*(t(np.stack(a)) for a in zip(*rows)), max_out, thresh)
    for r, (b_, s_, v_) in enumerate(rows):
        wi, wv = fn_j(jnp.asarray(b_), jnp.asarray(s_), jnp.asarray(v_),
                      max_out, thresh)
        np.testing.assert_array_equal(gv[r].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi[r].numpy(), np.asarray(wi))
    # at full capacity greedy keeps exactly the fixpoint's set, fast a
    # subset of it
    fi, fv = fn_t(t(bx), t(scores), t(valid), n, thresh)
    ei, ev = tnms.nms_bev_exact(t(bx), t(scores), t(valid), n, thresh)
    kept, exact = set(fi[fv].tolist()), set(ei[ev].tolist())
    assert kept == exact if mode == "greedy" else kept < exact


def test_nms_bev_mode_rejects_unknown_modes():
    assert tnms.nms_bev_mode("exact") is tnms.nms_bev_exact
    with pytest.raises(ValueError) as got:
        tnms.nms_bev_mode("Greedy")
    with pytest.raises(ValueError) as want:
        jnms.nms_bev_mode("Greedy")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def nms_model_inputs(tmp_path_factory):
    """test_torch_variants.py's fixture config and one couple, and
    seeded weights of its tree (the NMS mode changes no parameter)."""
    from dodt_tpu.data import synthetic, tracking
    import test_torch_variants as tv

    root = str(tmp_path_factory.mktemp("kitti_nms_modes"))
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=4,
                                     ego_speed=1.0)
    cfg = tv.base_config(root)
    ds = tracking.KittiTrackingDataset(cfg.dataset, split="train")
    batch = {k: np.asarray(v) for k, v in ds.next_batch(
        1, shuffle=False, augment=False).items() if not isinstance(v, list)}
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=tv.CAR)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, b, train=False, mode="val"),
        tv._jb(batch))["params"]
    return cfg, batch, tv.seeded_params(shapes, 0)


@pytest.mark.parametrize("mode", ["greedy", "fast", "typo"])
def test_forward_honours_nms_mode(mode, nms_model_inputs):
    """DtAvodNet and StackAvodNet pick their NMS by the config's
    nms_mode as JAX does: every output of the val forward against JAX's
    with "greedy" and "fast" (test_torch_variants.py's harness), and an
    unknown mode raises before any NMS runs."""
    import copy
    from dodt_tpu_torch.convert import config_from_json
    from dodt_tpu_torch.models import stack as tstack
    from test_torch_forward import KEYS
    import test_torch_variants as tv

    cfg0, batch, params = nms_model_inputs
    cfg = copy.deepcopy(cfg0)
    cfg.model.nms_mode = mode
    if mode == "typo":
        for net in (tdt.DtAvodNet(config_from_json(cfg), tv.CAR),
                    tstack.StackAvodNet(config_from_json(cfg), tv.CAR)):
            tdt.init_params(net, torch.Generator().manual_seed(0))
            with pytest.raises(ValueError, match="nms_mode"):
                net.eval()(tv._tb(batch), mode="val")
        return
    want, got, _, model = tv.run_variant(cfg, tv.CAR, batch, params=params)
    for key in sorted(KEYS):
        tv.assert_output_matches(key, want, got)
    # greedy picks the default's boxes (its empty slots hold index 0);
    # fast picks others on this batch
    model.cfg.model.nms_mode = "exact"
    exact = model(tv._tb(batch), mode="val")
    same = (torch.equal(exact["top_valid"], got["top_valid"])
            and torch.equal(exact["top_anchors"], got["top_anchors"])
            and torch.equal(exact["final_valid"], got["final_valid"]))
    assert same == (mode == "greedy")


# ---------------------------------------------------------------- warp

def test_warp_matches_jax_gather4():
    rng = np.random.RandomState(12)
    feats = rng.randn(60, 80, 4).astype(np.float32)
    th = 0.05
    a2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                  np.float32)
    b2 = np.array([0.3, 1.2], np.float32)
    got = twarp.warp_bev_features(t(feats), t(a2), t(b2), BEV_EXTENTS)
    want = jwarp.warp_bev_features(jnp.asarray(feats), a2, b2, BEV_EXTENTS,
                                   method="gather4")
    close(got, want, atol=1e-5)
    anc = _anchors(rng, 32)
    close(twarp.transform_anchors_xz(t(anc), t(a2), t(b2)),
          jwarp.transform_anchors_xz(jnp.asarray(anc), a2, b2))


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("hw,out", [((7, 9), (14, 18)),
                                    ((35, 40), (70, 80))])
def test_resize_to_matches_jax_image_resize(hw, out):
    """The 2x RPN-bottleneck upsample: F.interpolate(bilinear,
    align_corners=False) against jax.image.resize("bilinear"),
    edge pixels included, to f32 rounding (1e-6)."""
    x = np.random.RandomState(13).randn(1, *hw, 1).astype(np.float32)
    close(tdt._resize_to(t(x), out), jdt._resize_to(jnp.asarray(x), out),
          atol=1e-6)


# ---------------------------------------------------------------- losses

from dodt_tpu.ops import losses as jloss          # noqa: E402
from dodt_tpu.ops import sampling as jsamp        # noqa: E402
from dodt_tpu_torch.ops import losses as tloss    # noqa: E402
from dodt_tpu_torch.ops import sampling as tsamp  # noqa: E402


def test_losses_match_jax():
    """All five loss functions, f32: 1e-6 relative."""
    rng = np.random.RandomState(21)
    pred = rng.randn(40, 6).astype(np.float32) * 2
    tgt = rng.randn(40, 6).astype(np.float32) * 2
    w = rng.rand(40).astype(np.float32)
    logits = rng.randn(40, 3).astype(np.float32)
    labels = rng.randint(0, 3, 40)
    onehot = np.eye(3, dtype=np.float32)[labels]
    bin_t = rng.randint(0, 2, (40, 3)).astype(np.float32)
    bin_w = rng.rand(40, 3).astype(np.float32)
    pairs = [
        (tloss.weighted_smooth_l1(t(pred), t(tgt), t(w)),
         jloss.weighted_smooth_l1(pred, tgt, w)),
        (tloss.weighted_softmax(t(logits), t(onehot), 0.7),
         jloss.weighted_softmax(logits, onehot, 0.7)),
        (tloss.weighted_sigmoid(t(logits), t(bin_t), t(bin_w)),
         jloss.weighted_sigmoid(logits, bin_t, bin_w)),
        (tloss.weighted_l2_localization(t(pred), t(tgt), t(w)),
         jloss.weighted_l2_localization(pred, tgt, w)),
        (tloss.label_smoothing_onehot(t(labels), 3, 0.01),
         jloss.label_smoothing_onehot(jnp.asarray(labels), 3, 0.01)),
    ]
    for got, want in pairs:
        close(got, want, atol=1e-6, rtol=1e-6)


def test_box_codecs_for_losses_match_jax():
    rng = np.random.RandomState(22)
    a, g = _anchors(rng, 50), _anchors(rng, 50)
    close(tbox.anchor_to_offset(t(a), t(g)), jbox.anchor_to_offset(a, g))
    ry = rng.uniform(-np.pi, np.pi, 50).astype(np.float32)
    close(tbox.orientation_to_angle_vector(t(ry)),
          jbox.orientation_to_angle_vector(ry))


# ---------------------------------------------------------------- sampling

def _key_draws(key, n):
    """The (2, n) uniforms JAX's balanced_sample draws from ``key``."""
    kp, kn = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(kp, (n,))),
                     np.asarray(jax.random.uniform(kn, (n,)))])


def test_assign_targets_matches_jax():
    """Best-GT IoU, index, class and offsets per anchor, with padded GT
    rows; batched over two rows against JAX per row. Indices equal,
    floats 1e-5."""
    rng = np.random.RandomState(23)
    anc = _anchors(rng, 300)
    anc[:, 3:] = [4.0, 1.5, 1.8]
    gt = _boxes_3d(rng, 6)
    gt[:2, 0:3] = anc[:2, 0:3]                     # some exact hits
    gt_anc = np.asarray(jbox.box_3d_to_anchor(gt, ortho_rotate=True))
    abev = np.asarray(jproj.project_to_bev(anc, BEV_EXTENTS)[0])
    gbev = np.asarray(jproj.project_to_bev(gt_anc, BEV_EXTENTS)[0])
    cls = rng.randint(1, 3, 6).astype(np.int32)
    valid = np.array([True] * 4 + [False] * 2)
    valid2 = np.array([False, True] * 3)
    got = tsamp.assign_targets(t(abev), t(anc), t(np.stack([gbev, gbev])),
                               t(np.stack([gt_anc, gt_anc])),
                               t(np.stack([cls, cls])),
                               t(np.stack([valid, valid2])))
    for r, v in enumerate((valid, valid2)):
        want = jsamp.assign_targets(abev, anc, gbev, gt_anc, cls, v)
        assert float(want.max_iou.max()) > 0.5
        close(got.max_iou[r], want.max_iou)
        close(got.offsets[r], want.offsets, atol=1e-5)
        np.testing.assert_array_equal(got.class_idx[r].numpy(),
                                      np.asarray(want.class_idx))
        matched = np.asarray(want.max_iou) > 0
        np.testing.assert_array_equal(got.gt_index[r].numpy()[matched],
                                      np.asarray(want.gt_index)[matched])


@pytest.mark.parametrize("count", [0, 3, 40, 1000])
def test_rank_mask_matches_jax(count):
    rng = np.random.RandomState(24)
    mask = rng.rand(500) < 0.3
    key = jax.random.PRNGKey(count)
    u = np.asarray(jax.random.uniform(key, (500,)))
    want = jsamp._rank_mask(key, jnp.asarray(mask), count)
    got = tsamp._rank_mask(t(u), t(mask), count)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == min(count, int(mask.sum()))


@pytest.mark.parametrize("neg_range,pos_range,size", [
    ((0.0, 0.3), (0.5, 1.0), 64),       # RPN ranges
    ((0.0, 0.55), (0.65, 1.0), 1024),   # AVOD ranges, all eligible taken
    ((0.1, 0.3), (0.5, 1.0), 64),       # neg_lo > 0
    ((0.9, 0.95), (0.99, 1.0), 64),     # neg_lo > 0, nothing eligible
])
def test_sample_mini_batch_matches_jax(neg_range, pos_range, size):
    """With the draws of JAX's keys, the port samples exactly JAX's
    anchors, per row of a batch."""
    rng = np.random.RandomState(25)
    ious = np.where(rng.rand(3, 700) < 0.5, 0.0, rng.rand(3, 700)
                    ).astype(np.float32)
    ious[2] = np.minimum(ious[2], 0.5)                 # no positives
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    u = np.stack([_key_draws(k, 700) for k in keys])
    sel, pos = tsamp.sample_mini_batch(t(u), t(ious), size, neg_range,
                                       pos_range)
    for r in range(3):
        w_sel, w_pos = jsamp.sample_mini_batch(keys[r], jnp.asarray(ious[r]),
                                               size, neg_range, pos_range)
        np.testing.assert_array_equal(sel[r].numpy(), np.asarray(w_sel))
        np.testing.assert_array_equal(pos[r].numpy(), np.asarray(w_pos))
        assert int(pos[r].sum()) <= size // 2


# ---------------------------------------------------------------- crop VJP

def _crop_case(n, c, seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(24, 40, c).astype(np.float32)
    lo = rng.uniform(-0.1, 0.85, (n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.02, 0.3, (n, 2))],
                           -1).astype(np.float32)
    cot = rng.randn(n, 7, 7, c).astype(np.float32)
    return img, boxes, cot


@pytest.mark.parametrize("method", ["gather_mmbwd", "auto_train"])
@pytest.mark.parametrize("n,c,chunked", [(300, 8, False), (1024, 8, True),
                                         (1000, 4, True), (600, 1, False)],
                         ids=["small", "chunked", "n_not_512k", "thin"])
def test_crop_gradients_match_jax_train_vjp(monkeypatch, method, n, c,
                                            chunked):
    """The port's training crop (gather forward, autograd backward)
    against jax.vjp of JAX's crop_and_resize with its matmul-form VJP:
    the gradients w.r.t. the map and the boxes, 1e-4 of their range
    (f32 sums in another order). ``chunked`` shrinks JAX's chunk
    threshold, as tests/test_ops.py does, so its VJP scans 512-proposal
    chunks; at n % 512 != 0 JAX falls back to the unchunked form. Some
    boxes clamp at the map edge."""
    if chunked:
        monkeypatch.setattr(jroi, "_BWD_CHUNK_BYTES", 0)
    img, boxes, cot = _crop_case(n, c, 26 + n)
    out, vjp = jax.vjp(lambda im, bx: jroi.crop_and_resize(
        im, bx, 7, method=method), jnp.asarray(img), jnp.asarray(boxes))
    w_img, w_box = vjp(jnp.asarray(cot))
    ti, tb = t(img).requires_grad_(), t(boxes).requires_grad_()
    got = troi.crop_and_resize(ti, tb, 7, method=method)
    close(got.detach(), out)
    (got * t(cot)).sum().backward()
    for g, w in ((ti.grad, w_img), (tb.grad, w_box)):
        w = np.asarray(w)
        close(g, w, atol=1e-4 * np.abs(w).max(), rtol=1e-4)
