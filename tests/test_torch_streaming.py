"""The port's streaming slice against the JAX package's: the same Flax
parameters (converted), the same fixture frames, the JAX
StreamingPredictor against the port's, on the static arm and the
ego-motion arm, on the CPU in float32.

The fixture (tests/test_streaming.py's) has 3072 anchors, so the default
fusion_top_k = 8192 takes the single-pass RPN; fusion_top_k = 1024 takes
the two-pass branch the flagship runs. Tolerances: the port agrees to
f32 summation-order rounding (boxes in metres 1e-4, scores and
correlation offsets 1e-5); masks, tie order and NMS picks are equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.data import synthetic, tracking
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.runtime.predictor import StreamingPredictor as JaxPredictor
from dodt_tpu_torch.convert import config_from_json, flax_to_state_dict
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.runtime.predictor import StreamingPredictor

CLUSTERS = ((3.9, 1.6, 1.52),)
TH = 0.02
EGO = (np.array([[np.cos(TH), -np.sin(TH)], [np.sin(TH), np.cos(TH)]],
                np.float32), np.array([0.1, 0.8], np.float32))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_stream_torch"))
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
    batch = ds.next_batch(1, shuffle=False, augment=False)
    batch = {k: np.asarray(v) for k, v in batch.items()
             if not isinstance(v, list)}
    model = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(model.init, static_argnames=("train", "mode"))(
        {"params": rng, "dropout": rng, "pathdrop": rng},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False,
        mode="val")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    frames = [{"points": batch["points"][:, i],
               "points_valid": batch["points_valid"][:, i],
               "image": batch["image"][:, i],
               "ground_plane": batch["ground_plane"], "p2": batch["p2"],
               "orig_image_shape": batch["orig_image_shape"]}
              for i in range(2)]
    return cfg, params, frames


def _configured(cfg, fusion_top_k):
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, rpn=dataclasses.replace(cfg.model.rpn,
                                           fusion_top_k=fusion_top_k)))
    return cfg


@pytest.fixture(scope="module", params=[8192, 1024],
                ids=["single_pass", "two_pass"])
def runs(request, fixture):
    """Push f0, f1 (static arm), then f0 with ego motion (ego arm: the
    pair (f1, f0 warped into f1's frame)) through both predictors."""
    cfg0, params, frames = fixture
    cfg = _configured(cfg0, request.param)
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    tmodel = tdt.DtAvodNet(config_from_json(cfg), CLUSTERS)
    tmodel.load_state_dict(flax_to_state_dict(params), strict=True)
    tmodel.eval()
    jp, tp = JaxPredictor(jmodel, params), StreamingPredictor(tmodel, device="cpu")
    out = {}
    for name, frame, ego in (("first", frames[0], None),
                             ("static", frames[1], None),
                             ("ego", frames[0], EGO)):
        out[name] = (jp.push_keyframe(frame, fetch=False, ego_to_prev=ego),
                     tp.push_keyframe(frame, fetch=True, ego_to_prev=ego))
    states = (jax.jit(lambda v, b: jmodel.apply(
        v, b, method=jmodel.encode_frame))({"params": params}, frames[0]),
        tmodel.encode_frame({k: torch.as_tensor(v)
                             for k, v in frames[0].items()}))
    return out, states, tp


@pytest.mark.parametrize("arm", ["static", "ego"])
def test_pair_outputs_match_jax(runs, arm):
    out, _, _ = runs
    want, got = out[arm]
    assert out["first"] == (None, None)
    np.testing.assert_array_equal(got["final_valid"],
                                  np.asarray(want["final_valid"]))
    assert got["final_valid"].sum() > 0
    np.testing.assert_allclose(got["final_boxes_3d"],
                               np.asarray(want["final_boxes_3d"]),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got["final_scores"],
                               np.asarray(want["final_scores"]), atol=1e-5)
    np.testing.assert_allclose(got["final_corr_offsets"],
                               np.asarray(want["final_corr_offsets"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["final_orientations"],
                               np.asarray(want["final_orientations"]),
                               atol=1e-4)


def test_frame_state_matches_jax(runs):
    _, (want, got), tp = runs
    np.testing.assert_allclose(got["bev_feats"].numpy(),
                               np.asarray(want["bev_feats"]), atol=1e-5)
    np.testing.assert_allclose(got["img_feats"].numpy(),
                               np.asarray(want["img_feats"]), atol=1e-5)
    np.testing.assert_array_equal(got["top_valid"].numpy(),
                                  np.asarray(want["top_valid"]))
    np.testing.assert_allclose(got["top_anchors"].numpy(),
                               np.asarray(want["top_anchors"]), atol=1e-4)
    # the predictor timed its two pair steps and its cold encode
    assert len(tp.pair_times) == 2 and len(tp.encode_times) == 1


@pytest.fixture(scope="module")
def latency(fixture):
    """Both predictors' latency_stats() after each of three
    push_keyframe(fetch=True) calls (single-pass config)."""
    cfg, params, frames = fixture
    jp = JaxPredictor(jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS), params)
    tmodel = tdt.DtAvodNet(config_from_json(cfg), CLUSTERS)
    tmodel.load_state_dict(flax_to_state_dict(params), strict=True)
    tp = StreamingPredictor(tmodel.eval(), device="cpu")
    stats = []
    for frame in (frames[0], frames[1], frames[0]):
        jp.push_keyframe(frame, fetch=True)
        tp.push_keyframe(frame, fetch=True)
        stats.append((jp.latency_stats(), tp.latency_stats()))
    return stats


@pytest.mark.parametrize("pushes,keys", [
    (1, {"encode_cold"}), (2, {"encode_cold", "pair_cold"}),
    (3, {"encode_cold", "pair"})])
def test_latency_stats_match_jax(latency, pushes, keys):
    """Same keys as the JAX predictor's, the same sample count under
    each, and the same statistics in each."""
    want, got = latency[pushes - 1]
    assert set(got) == set(want) == keys
    for k in keys:
        assert set(got[k]) == set(want[k])
        assert got[k]["n"] == want[k]["n"]


@pytest.mark.parametrize("entry", ["predictor", "trainer", "evaluator"])
def test_entry_points_run_on_the_card_by_default(entry, tmp_path):
    """StreamingPredictor, Trainer and Evaluator take the card unless the
    caller passes device="cpu": without a card the default raises
    (torch's own error) instead of running on the CPU; with one, the
    model lands on it."""
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.runtime.evaluator import Evaluator
    from dodt_tpu_torch.runtime.trainer import Trainer
    cfg = unittest_pipeline()
    make = {
        "predictor": lambda m, **kw: StreamingPredictor(m, **kw),
        "trainer": lambda m, **kw: Trainer(cfg, m, None, str(tmp_path),
                                           metrics_path=None, **kw),
        "evaluator": lambda m, **kw: Evaluator(cfg, m, None, str(tmp_path),
                                               str(tmp_path / "out"), **kw),
    }[entry]
    on_cpu = make(torch.nn.Linear(2, 2), device="cpu")
    assert next(on_cpu.model.parameters()).device.type == "cpu"
    model = torch.nn.Linear(2, 2)
    if torch.cuda.is_available():
        assert next(make(model).model.parameters()).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make(model)
        assert next(model.parameters()).device.type == "cpu"
