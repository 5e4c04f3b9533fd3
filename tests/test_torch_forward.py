"""The port's monolithic pair forward (``DtAvodNet.forward``) against the
JAX ``DtAvodNet.__call__(train=False, mode="val")``: the same Flax
parameters (converted), the same batch of B = 2 fixture couples, every
output key, on the CPU in float32.

The fixture (tests/test_streaming.py's) has 3072 anchors: the default
fusion_top_k = 8192 takes the single-pass RPN, 1024 the two-pass branch.
The two-pass case also sets expand_proposals_xz = 0.3, which only the
monolithic forward applies. A third case runs the correlation at
max_displacement 5 and stride_2 2 (D = 5, the fixture's weights), where
the JAX model's blur reads B one pixel off the centred grid (ROADMAP
C20). Tolerances: f32 summation-order rounding
(1e-5 on features and logits, 1e-4 on metric boxes); masks, tie order,
NMS picks and indices are equal. The final outputs are held as
tests/test_streaming.py holds the JAX streaming path against __call__.
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
from dodt_tpu_torch.convert import config_from_json, flax_to_state_dict
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.runtime.predictor import StreamingPredictor

CLUSTERS = ((3.9, 1.6, 1.52),)
EXACT = ("anchor_valid", "img_mask", "bev_mask", "top_valid",
         "final_indices", "final_valid")
ATOL = {"bev_input": 1e-6, "anchors": 1e-5, "top_anchors": 1e-4,
        "proposal_boxes_3d": 1e-4, "proposal_enc": 1e-4,
        "pred_boxes_3d": 1e-4, "pred_orientations": 1e-4,
        "final_boxes_3d": 2e-3, "final_orientations": 1e-4,
        "final_scores": 1e-4, "final_corr_offsets": 1e-3}
KEYS = {"anchors", "anchor_valid", "bev_input", "img_mask", "bev_mask",
        "objectness", "rpn_offsets", "top_anchors", "top_scores",
        "top_valid", "proposal_boxes_3d", "proposal_enc", "cls_logits",
        "box_offsets", "angle_vectors", "pred_boxes_3d", "pred_orientations",
        "final_indices", "final_valid", "final_boxes_3d",
        "final_orientations", "final_cls_softmax", "final_scores",
        "corr_pred", "final_corr_offsets"}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_forward_torch"))
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
        {"params": rng, "dropout": rng, "pathdrop": rng},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False,
        mode="val")
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return cfg, params, batch


def _configured(cfg, fusion_top_k, expand, correlation=None):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, expand_proposals_xz=expand,
        rpn=dataclasses.replace(cfg.model.rpn, fusion_top_k=fusion_top_k),
        correlation=correlation or cfg.model.correlation))


def _torch_model(cfg, params):
    model = tdt.DtAvodNet(config_from_json(cfg), CLUSTERS)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[
    (8192, 0.0), (1024, 0.3),
    (8192, 0.0, cfg_mod.CorrelationConfig(max_displacement=5, padding=5,
                                          stride_2=2))],
    ids=["single_pass", "two_pass_expand", "single_pass_stride_2"])
def outputs(request, fixture):
    cfg0, params, batch = fixture
    cfg = _configured(cfg0, *request.param)
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    want = jax.jit(jmodel.apply, static_argnames=("train", "mode"))(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        train=False, mode="val")
    got = _torch_model(cfg, params)(_tensors(batch), mode="val")
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def test_forward_returns_every_jax_output(outputs):
    want, got = outputs
    assert set(got) == set(want) == KEYS
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
    assert got["final_valid"].sum() > 0
    b, f = got["anchor_valid"].shape[:2]
    assert (b, f) == (2, 2)


@pytest.mark.parametrize("key", sorted(KEYS))
def test_forward_output_matches_jax(outputs, key):
    want, got = outputs
    w, g = want[key], got[key]
    if key in EXACT:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=ATOL.get(key, 1e-5),
                                   rtol=1e-5 if key.endswith("boxes_3d")
                                   else 0)


@pytest.mark.parametrize("fusion_top_k", [8192, 1024])
def test_forward_matches_port_streaming(fixture, fusion_top_k):
    """For each couple of the batch, the port's StreamingPredictor on its
    two frames gives the forward's final outputs (expand 0, as the
    streaming path has no expansion): the same computation, so to f32
    rounding (1e-5, boxes 1e-4)."""
    cfg0, params, batch = fixture
    model = _torch_model(_configured(cfg0, fusion_top_k, 0.0), params)
    mono = model(_tensors(batch))
    for i in range(2):
        pred = StreamingPredictor(model, device="cpu")
        for f in range(2):
            out = pred.push_keyframe({
                "points": batch["points"][i:i + 1, f],
                "points_valid": batch["points_valid"][i:i + 1, f],
                "image": batch["image"][i:i + 1, f],
                "ground_plane": batch["ground_plane"][i:i + 1],
                "p2": batch["p2"][i:i + 1],
                "orig_image_shape": batch["orig_image_shape"][i:i + 1]})
        assert set(out) == set(tdt.FINAL_KEYS)
        np.testing.assert_array_equal(out["final_valid"],
                                      mono["final_valid"][i:i + 1].numpy())
        for k in ("final_boxes_3d", "final_orientations"):
            np.testing.assert_allclose(out[k], mono[k][i:i + 1].numpy(),
                                       atol=1e-4)
        for k in ("final_scores", "final_cls_softmax", "final_corr_offsets"):
            np.testing.assert_allclose(out[k], mono[k][i:i + 1].numpy(),
                                       atol=1e-5)


def _one_frame(batch):
    return {k: v[:, :1] if v.dim() > 2 and k != "p2" else v
            for k, v in batch.items()}


# the paired model takes two frames per sample, in either mode; one frame
# is DtAvodNet(num_frames=1)'s (tests/test_torch_single_frame.py)
@pytest.mark.parametrize("change,match", [
    (lambda batch: (_one_frame(batch), "train"), "num_frames=2"),
    (lambda batch: (_one_frame(batch), "val"), "num_frames=2"),
])
def test_forward_unported_paths_raise(fixture, change, match):
    cfg, params, batch = fixture
    b, mode = change(_tensors(batch))
    with pytest.raises(ValueError, match=match):
        _torch_model(cfg, params)(b, mode=mode)


def test_bench_torch_needs_a_card_and_knows_h100_peaks():
    """bench_torch.py measures only on a card; its MFU peak comes from
    the card's name, and an unknown card gives no peak (mfu null)."""
    import bench_torch
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main()
    assert bench_torch.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert bench_torch.peak_flops("NVIDIA H100 PCIe") == 756e12
    assert bench_torch.peak_flops("NVIDIA H100 NVL") == 835e12
    assert bench_torch.peak_flops("NVIDIA A100-SXM4-80GB") is None
