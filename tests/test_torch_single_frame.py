"""The single-frame detector through the port (``DtAvodNet(num_frames=1)``,
the per-anchor RPN, ``KittiDataset``, the detection-only evaluation and
the staged training flow) against the JAX package, on the CPU in
float32, on tests/test_single_frame.py's setup: three samples of the
synthetic KITTI object fixture, 3072 anchors (fusion_top_k 8192 takes the
single-pass RPN, 1024 the two-pass one).

Tolerances as tests/test_torch_forward.py's (f32 summation order: 1e-5
on features and logits, 1e-4 on metric boxes, boxes 1e-5 relative;
masks, indices and NMS picks equal) and tests/test_torch_train.py's
(losses 2e-5 relative). The evaluator's files and results are held as
tests/test_torch_evaluator.py holds them.
"""
import copy
import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.data import detection as jdetection
from dodt_tpu.data import synthetic
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.ops import anchors as janchors
from dodt_tpu.ops.dense_rpn import build_bev_lattice
from dodt_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from dodt_tpu.runtime.trainer import CheckpointIO as JaxCheckpointIO
from dodt_tpu.runtime.trainer import create_train_state
from dodt_tpu_torch import config as tcfg
from dodt_tpu_torch.convert import config_from_json, flax_to_state_dict
from dodt_tpu_torch.data import detection as tdetection
from dodt_tpu_torch.data import synthetic as tsynth
from dodt_tpu_torch.data import tracking as ttracking
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.ops import anchors as tanchors
from dodt_tpu_torch.runtime import trainer as ttrain
from dodt_tpu_torch.runtime.evaluator import Evaluator
from test_torch_evaluator import (_assert_frame_lines, _port_checkpoint,
                                  _read_lines)
from test_torch_train import KEYS, LOSS_KEY, JaxDraws

CLUSTERS = ((3.9, 1.6, 1.52),)
EXACT = ("anchor_valid", "img_mask", "bev_mask", "top_valid",
         "final_indices", "final_valid")
ATOL = {"bev_input": 1e-6, "anchors": 1e-5, "top_anchors": 1e-4,
        "proposal_boxes_3d": 1e-4, "proposal_enc": 1e-4,
        "pred_boxes_3d": 1e-4, "pred_orientations": 1e-4,
        "final_boxes_3d": 2e-3, "final_orientations": 1e-4,
        "final_scores": 1e-4}
# every output of the JAX one-frame __call__: the pair's but the
# correlation head's
KEYS_1F = {"anchors", "anchor_valid", "bev_input", "img_mask", "bev_mask",
           "objectness", "rpn_offsets", "top_anchors", "top_scores",
           "top_valid", "proposal_boxes_3d", "proposal_enc", "cls_logits",
           "box_offsets", "angle_vectors", "pred_boxes_3d",
           "pred_orientations", "final_indices", "final_valid",
           "final_boxes_3d", "final_orientations", "final_cls_softmax",
           "final_scores"}
# anchor strides off the BEV pixel lattice: the per-anchor RPN
OFF_LATTICE = (0.75, 0.75)


def _cfg(root):
    cfg = cfg_mod.unittest_pipeline()
    cfg.model.model_name = "avod_model"
    cfg.dataset.dataset_dir = root
    cfg.dataset.kitti_utils.area_extents = (
        (-16.0, 16.0), (-3.0, 3.0), (0.0, 48.0))
    cfg.dataset.kitti_utils.anchor_strides = (1.0, 1.0)
    cfg.dataset.max_points = 8192
    return cfg


def _configured(cfg, fusion_top_k=8192, strides=None):
    cfg = copy.deepcopy(cfg)
    if strides is not None:
        cfg.dataset.kitti_utils.anchor_strides = strides
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rpn=dataclasses.replace(cfg.model.rpn,
                                           fusion_top_k=fusion_top_k)))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port(cfg, params):
    model = tdt.DtAvodNet(config_from_json(cfg), CLUSTERS, num_frames=1)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_object_torch"))
    synthetic.write_detection_fixture(root, num_frames=3)
    cfg = _cfg(root)
    ds = jdetection.KittiDataset(cfg.dataset, split="train")
    batch = ds.next_batch(2, shuffle=False, augment=False)
    batch = {k: np.asarray(v) for k, v in batch.items()
             if not isinstance(v, list)}
    model = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS, num_frames=1)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(model.init, static_argnames=("train", "mode"))(
        {"params": rng, "dropout": rng, "pathdrop": rng}, _jb(batch),
        train=False, mode="val")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return cfg, params, batch, root


def test_one_frame_tree_is_the_detector(setup):
    """The one-frame model's parameters are exactly the seven
    DETECTOR_SUBTREES, and its state dict loads the converted Flax tree
    with strict=True; the paired model adds only the correlation
    branch."""
    cfg, params, _, _ = setup
    assert set(params) == set(cfg_mod.DETECTOR_SUBTREES)
    model = _port(cfg, params)
    assert {k.split(".")[0] for k in model.state_dict()} == set(
        tcfg.DETECTOR_SUBTREES)
    pair = tdt.DtAvodNet(config_from_json(cfg), CLUSTERS)
    assert {k.split(".")[0] for k in pair.state_dict()} - set(
        tcfg.DETECTOR_SUBTREES) == {"bev_corr_bottleneck", "corr_fc"}
    assert tdt.DtAvodNet.loss_builder() is tdt.compute_losses


# (fusion_top_k, anchor strides): the single-pass and two-pass RPN on the
# lattice, and the per-anchor RPN off it
ROUTES = {"single_pass": (8192, None), "two_pass": (1024, None),
          "per_anchor": (8192, OFF_LATTICE),
          "per_anchor_two_pass": (1024, OFF_LATTICE)}


@pytest.fixture(scope="module", params=sorted(ROUTES))
def outputs(request, setup):
    cfg0, params, batch, _ = setup
    cfg = _configured(cfg0, *ROUTES[request.param])
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS, num_frames=1)
    # the lattice routes jitted, as the JAX package runs them (the BEV
    # rasterization's quotients are multiplies by the reciprocals there,
    # as in the port); the per-anchor routes op by op: under jit XLA
    # fuses their matmul crop into other multiply-adds, which moves an
    # RPN logit by up to 2e-5 and, on the two-pass route, reorders
    # near-tied candidates
    apply = jmodel.apply
    if not request.param.startswith("per_"):
        apply = jax.jit(apply, static_argnames=("train", "mode"))
    want = apply({"params": params}, _jb(batch), train=False, mode="val")
    model = _port(cfg, params)
    assert (model.lattice is None) == (request.param.startswith("per_"))
    got = model(_tb(batch), mode="val")
    want = {k: np.asarray(v) for k, v in want.items()}
    return (want, _ties_in_jax_order(want, {k: v.numpy()
                                            for k, v in got.items()}),
            request.param)


def _ties_in_jax_order(want, got):
    """got with the final detections of each run of valid JAX final
    scores that are equal to the last bit put in JAX's order. JAX breaks
    such a tie by proposal index alone; the port may round the tied
    scores one ulp apart (within final_scores' 1e-4) and so order them
    otherwise. A run is reordered only where it holds the same proposal
    indices as JAX's; every other position is left as it is."""
    ws, wv, wi = (want[k] for k in ("final_scores", "final_valid",
                                    "final_indices"))
    gi = got["final_indices"]
    k_final = ws.shape[-1]
    perm = np.broadcast_to(np.arange(k_final), ws.shape).copy()
    for b, f in np.ndindex(ws.shape[:2]):
        start = 0
        while start < k_final:
            end = start + 1
            while (end < k_final and wv[b, f, end]
                   and ws[b, f, end] == ws[b, f, start]):
                end += 1
            pos = {int(i): start + j
                   for j, i in enumerate(gi[b, f, start:end])}
            if (wv[b, f, start] and end - start > 1
                    and sorted(pos) == sorted(wi[b, f, start:end].tolist())):
                perm[b, f, start:end] = [pos[int(i)]
                                         for i in wi[b, f, start:end]]
            start = end
    out = dict(got)
    for k, v in got.items():
        if k.startswith("final_"):
            idx = perm.reshape(perm.shape + (1,) * (v.ndim - 3))
            out[k] = np.take_along_axis(v, idx, axis=2)
    return out


def test_one_frame_forward_returns_every_jax_output(outputs):
    want, got, route = outputs
    assert set(got) == set(want) == KEYS_1F
    for k in KEYS_1F:
        assert got[k].shape == want[k].shape, k
    assert got["final_valid"].sum() > 0
    assert got["anchor_valid"].shape[:2] == (2, 1)
    n = got["anchors"].shape[1]
    assert n == (3072 if not route.startswith("per_") else 43 * 64 * 2)


@pytest.mark.parametrize("key", sorted(KEYS_1F))
def test_one_frame_forward_output_matches_jax(outputs, key):
    want, got, _ = outputs
    w, g = want[key], got[key]
    if key in EXACT:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=ATOL.get(key, 1e-5),
                                   rtol=1e-5 if key.endswith("boxes_3d")
                                   else 0)


@pytest.mark.parametrize("density", [1, 3])
def test_empty_anchor_mask_matches_jax(density):
    """The per-anchor occupancy filter on a seeded occupancy grid with
    anchors off the lattice, some reaching past the grid's edges:
    counts and mask equal."""
    rs = np.random.RandomState(7)
    occ = (rs.rand(320, 480) < 0.002).astype(np.float32)
    area = np.array([[-16.0, 16.0], [-3.0, 3.0], [0.0, 48.0]])
    anchors = np.array(jdt.box_ops.box_3d_to_anchor(
        janchors.tile_anchors_3d(area, np.array(CLUSTERS), OFF_LATTICE,
                                 jnp.array([0.0, -1.0, 0.0, 1.65]))))
    anchors[:50, 3] *= 40.0                     # past the grid's edges
    ext = [[-16.0, 16.0], [0.0, 48.0]]
    ii = janchors.integral_image_2d(jnp.asarray(occ))
    want_counts = np.asarray(janchors.bev_occupancy_counts(
        ii, jnp.asarray(anchors), ext, 0.1))
    want = np.asarray(janchors.empty_anchor_mask(
        ii, jnp.asarray(anchors), ext, 0.1, density))
    tii = tanchors.integral_image_2d(torch.from_numpy(occ))
    got_counts = tanchors.bev_occupancy_counts(
        tii, torch.from_numpy(anchors), ext, 0.1).numpy()
    got = tanchors.empty_anchor_mask(tii, torch.from_numpy(anchors), ext,
                                     0.1, density).numpy()
    np.testing.assert_array_equal(got_counts, want_counts)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)
    assert build_bev_lattice(area, OFF_LATTICE, CLUSTERS, (480, 320), 0.1,
                             3) is None


# ------------------------------------------------------------------ losses

@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(fnn.Module, "make_rng",
                        lambda self, name="params": KEYS[name])


@pytest.mark.parametrize("route", ["single_pass", "per_anchor"])
def test_one_frame_losses_match_jax(setup, pinned, route):
    """compute_losses on the train-mode forward (dropout off) with JAX's
    draws injected: the same seven keys to 2e-5, and no correlation loss
    without a pair."""
    cfg0, params, batch, _ = setup
    cfg = _configured(cfg0, *ROUTES[route])
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS, num_frames=1)

    @jax.jit
    def run(p, b):
        out = jmodel.apply({"params": p}, b, train=False, mode="train")
        return jdt.compute_losses(cfg, out, b, LOSS_KEY)[1]

    want = run(params, _jb(batch))
    model = _port(cfg, params)
    out = model(_tb(batch), mode="train", train=False, rand=JaxDraws())
    assert "corr_pred" not in out
    _, got = tdt.compute_losses(config_from_json(cfg), out, _tb(batch),
                                JaxDraws())
    assert set(got) == set(want)
    assert float(got["corr"]) == float(want["corr"]) == 0.0
    assert float(want["rpn_cls"]) > 0
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_one_frame_model_rejects_a_pair(setup, mode):
    """The pair model rejects one frame (tests/test_torch_forward.py);
    the one-frame model rejects two, in either mode, and has no
    pair_stage."""
    cfg, params, batch, _ = setup
    model = _port(cfg, params)
    pair = {k: torch.cat([v, v], 1) if v.dim() > 2 and k != "p2" else v
            for k, v in _tb(batch).items()}
    with pytest.raises(ValueError, match="2 frames per sample for a model "
                       "of num_frames=1"):
        model(pair, mode=mode, rand=JaxDraws())
    with pytest.raises(ValueError, match="num_frames=2"):
        model.pair_stage({}, {})


# --------------------------------------------------------------- evaluator

@pytest.fixture(scope="module")
def detection_runs(tmp_path_factory, setup):
    """Both evaluators' run_checkpoint_once over the object fixture
    (three samples, eval batch 2: the last batch padded), from the same
    JAX train state's parameters."""
    cfg, _, batch, root = setup
    cfg = copy.deepcopy(cfg)
    cfg.eval.batch_size = 2
    tmp = tmp_path_factory.mktemp("eval_single_frame")
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS, num_frames=1)
    state = create_train_state(cfg, jmodel, _jb(batch),
                               jax.random.PRNGKey(3))
    JaxCheckpointIO(str(tmp / "ckpt_jax")).save(
        1, state._replace(step=np.int32(1)))
    jds = jdetection.KittiDataset(cfg.dataset, split="val")
    jev = JaxEvaluator(cfg, jmodel, jds, ckpt_dir=str(tmp / "ckpt_jax"),
                       output_dir=str(tmp / "jax"))
    want = jev.run_checkpoint_once(1)
    params = jax.tree_util.tree_map(np.asarray, jev.ckpt.restore_params(1))
    _port_checkpoint(str(tmp / "ckpt_port"), 1, params)
    tds = tdetection.KittiDataset(config_from_json(cfg).dataset, split="val")
    ev = Evaluator(config_from_json(cfg),
                   tdt.DtAvodNet(config_from_json(cfg), CLUSTERS,
                                 num_frames=1),
                   tds, str(tmp / "ckpt_port"), str(tmp / "port"),
                   device="cpu")
    got = ev.run_checkpoint_once()
    return want, got, str(tmp / "jax"), str(tmp / "port"), tds, ev


def test_detection_results_match_jax(detection_runs):
    """results_{step}.json: AP at both passes, every class, metric and
    difficulty (1e-6), no MOT; the stages timed."""
    want, got, jdir, tdir, _, ev = detection_runs
    with open(os.path.join(jdir, "results_1.json")) as f:
        want_disk = json.load(f)
    with open(os.path.join(tdir, "results_1.json")) as f:
        got_disk = json.load(f)
    for g, w in ((got, want), (got_disk, want_disk)):
        assert g.keys() == w.keys() == {"step", "ap", "ap_per_class",
                                        "ap_05_per_class"}
        assert g["step"] == w["step"] == 1
        assert g["ap"].keys() == w["ap"].keys()
        for key in ("ap_per_class", "ap_05_per_class"):
            for cls, metrics in w[key].items():
                for metric, by_diff in metrics.items():
                    for diff, v in by_diff.items():
                        np.testing.assert_allclose(
                            g[key][cls][metric][diff], v, atol=1e-6,
                            err_msg=f"{key}/{cls}/{metric}/{diff}")
    assert set(ev.stage_seconds) == {"load", "forward", "write", "ap"}


def test_detection_prediction_files_match_jax(detection_runs):
    """One file per sample, line for line."""
    _, _, jdir, tdir, ds, _ = detection_runs
    jsub = os.path.join(jdir, "predictions_1", "data")
    tsub = os.path.join(tdir, "predictions_1", "data")
    names = sorted(os.listdir(jsub))
    assert names == sorted(os.listdir(tsub)) == sorted(
        f"{n}.txt" for n in ds.sample_names)
    n_lines = 0
    for name in names:
        got = _read_lines(os.path.join(tsub, name))
        _assert_frame_lines(got, _read_lines(os.path.join(jsub, name)), name)
        n_lines += len(got)
    assert n_lines > 0


# ------------------------------------------------------------ staged flow

class _GtOnProposals:
    """An in-memory dataset: the tracking fixture's first couple with its
    GT moved onto the model's first proposals (slightly shifted) and
    marked co-existing, so the second stage has positives and the
    correlation loss a target; points jittered by a counter."""

    def __init__(self, batch, model):
        out = model(_tb(batch), mode="val")
        g = batch["gt_boxes"].shape[2]
        top = out["top_anchors"][:, :, :g]
        boxes = tdt.box_ops.anchors_to_box_3d(top, fix_lw=True).numpy()
        boxes[..., 0] += 0.05
        self.batch = dict(batch)
        self.batch["gt_boxes"] = boxes.astype(np.float32)
        self.batch["gt_valid"] = out["top_valid"][:, :, :g].numpy()
        self.batch["gt_classes"] = self.batch["gt_valid"].astype(np.int32)
        self.batch["corr_offsets"] = np.random.RandomState(0).uniform(
            -0.5, 0.5, batch["corr_offsets"].shape).astype(np.float32)
        self.batch["corr_coexist"] = self.batch["gt_valid"][:, 0].copy()
        self.n = 0

    def next_batch(self, batch_size, augment=True):
        out = dict(self.batch)
        out["points"] = self.batch["points"] + np.float32(0.01 * self.n)
        self.n += 1
        return out


def _base_cfg(root):
    cfg = tcfg.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.kitti_utils.area_extents = (
        (-16.0, 16.0), (-3.0, 3.0), (0.0, 48.0))
    cfg.dataset.kitti_utils.anchor_strides = (1.0, 1.0)
    cfg.dataset.max_points = 4096
    cfg.dataset.video_train_ids = (0,)
    cfg.train.checkpoint_interval = 2
    return cfg


def test_staged_flow_through_the_port(tmp_path):
    """The reference's three-stage recipe through the port's Trainer
    (tests/test_staged_training.py's flow): a one-frame pretrain on the
    object fixture; the paired model with the seven detector subtrees
    restored and frozen, bit for bit before and after two steps, while
    the correlation branch trains; then the joint finetune continuing
    the full state (step, moments) with the detector moving again."""
    obj_root, trk_root = str(tmp_path / "obj"), str(tmp_path / "trk")
    tsynth.write_detection_fixture(obj_root, num_frames=3)
    tsynth.write_tracking_fixture(trk_root, num_videos=1, num_frames=4,
                                  ego_speed=0.5)
    torch.manual_seed(0)

    cfg1 = _base_cfg(obj_root)
    cfg1.model.model_name = "avod_model"
    ds1 = tdetection.KittiDataset(cfg1.dataset, split="train")
    model1 = tdt.DtAvodNet(cfg1, CLUSTERS, num_frames=1)
    tdt.init_params(model1, torch.Generator().manual_seed(0))
    pre_dir = str(tmp_path / "pretrain")
    state1, hist1 = ttrain.Trainer(cfg1, model1, ds1, pre_dir,
                                   device="cpu").train(max_steps=2,
                                                       log_every=1)
    assert all(np.isfinite(h["total"]) for h in hist1)
    assert hist1[-1]["corr"] == 0.0
    pre = state1.params
    assert {k.split(".")[0] for k in pre} == set(tcfg.DETECTOR_SUBTREES)

    staged = tcfg.cars_dt_tracking_staged(pre_dir)
    cfg2 = _base_cfg(trk_root)
    for k in ("pretrained_checkpoint", "pretrained_subtrees",
              "frozen_subtrees"):
        setattr(cfg2.train, k, getattr(staged.train, k))
    # no dropout and no path drop: the train-mode proposals are the ones
    # the GT was moved onto
    cfg2.model.rpn.keep_prob = cfg2.model.avod.keep_prob = 1.0
    cfg2.model.path_drop_probabilities = (1.0, 1.0)
    model2 = tdt.DtAvodNet(cfg2, CLUSTERS)
    tdt.init_params(model2, torch.Generator().manual_seed(1))
    ds2 = ttracking.KittiTrackingDataset(cfg2.dataset, split="train")
    couple = {k: v for k, v in ds2.next_batch(1, augment=False).items()
              if isinstance(v, np.ndarray)}
    ck2 = str(tmp_path / "staged")
    t2 = ttrain.Trainer(cfg2, model2, None, ck2, device="cpu")
    state2 = t2.init_or_restore()
    for k, v in pre.items():
        assert torch.equal(state2.params[k], v), k
    model2.load_state_dict(state2.params)
    t2.dataset = _GtOnProposals(couple, model2)
    state2b, hist2 = t2.train(max_steps=2, log_every=1)
    assert all(np.isfinite(h["total"]) for h in hist2)
    assert max(h["corr"] for h in hist2) > 0
    for k, v in pre.items():
        assert torch.equal(state2b.params[k], v), k
    for name in ("bev_corr_bottleneck", "corr_fc"):
        moved = max(float((state2b.params[k] - state2.params[k]).abs().max())
                    for k in state2.params if k.startswith(name + "."))
        assert moved > 0, name

    ft = tcfg.cars_dt_tracking_finetune(ck2)
    cfg3 = _base_cfg(trk_root)
    for k in ("pretrained_checkpoint", "pretrained_full_state",
              "frozen_subtrees"):
        setattr(cfg3.train, k, getattr(ft.train, k))
    model3 = tdt.DtAvodNet(cfg3, CLUSTERS)
    t3 = ttrain.Trainer(cfg3, model3, t2.dataset, str(tmp_path / "ft"),
                        device="cpu")
    state3 = t3.init_or_restore()
    assert state3.step == 2 and state3.opt_state["count"] == 2
    for k, v in state2b.params.items():
        assert torch.equal(state3.params[k], v), k
    state3b, hist3 = t3.train(max_steps=3, log_every=1)
    assert state3b.step == 3 and np.isfinite(hist3[-1]["total"])
    assert max(float((state3b.params[k] - pre[k]).abs().max())
               for k in pre) > 0
