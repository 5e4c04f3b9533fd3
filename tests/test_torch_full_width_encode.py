"""The flagship at full width on the CPU: the port's ``encode_frame`` and
``pair_stage`` against the JAX ones, jitted as the JAX package runs them.

``cars_dt_tracking()`` at ``max_points = 65536`` (bench.py's cut) with
f32 towers, the inputs of bench.py's ``make_batch`` (the port's copy,
``data/synthetic_scan.py``, seed 0; the points as they are, none moved
off a cell edge), the weights of Flax ``init`` with key 0, converted.
The frame state holds 89.6k anchors' RPN, 300 proposals, (350, 400, 32)
BEV and (180, 600, 32) image features.

(a) ``encode_frame`` of each frame: the BEV rasterization bit-equal (the
    port divides by the voxel size, the slice height and log 16 as XLA
    does, ROADMAP C22), the proposal masks exact, the features and
    proposals within the f32 bounds below (summation order in the
    towers; the image features span about 85).
(b) ``pair_stage`` fed JAX's own two frame states, so that both second
    stages see the same proposals: every output within the f32 bounds
    below, the final mask exact.

tests/test_torch_full_width_forward.py holds the monolithic forward and
tests/test_torch_full_width_stream.py the streaming predictor; they
build their inputs and weights with the helpers here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.data.clusters import DEFAULT_CAR_CLUSTERS
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.ops import voxel as jvoxel
from dodt_tpu_torch.convert import config_from_json, flax_to_state_dict
from dodt_tpu_torch.data.synthetic_scan import make_batch
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.ops import voxel as tvoxel

MAX_POINTS = 65536
FRAME_KEYS = ("points", "points_valid", "image")
# (a): largest |port - JAX| over each state tensor (measured, frames 0 /
# 1: bev_feats 3.7e-7 / 4.0e-7 of a 0.29 / 0.32 range, img_feats 1.1e-4
# of 85 / 80, top_anchors 7.3e-5 / 1.4e-4 m)
ENCODE_ATOL = {"bev_feats": 2e-6, "img_feats": 1e-3, "top_anchors": 5e-4}
# (b): every pair-stage output on JAX's states (measured: boxes 2.6e-4 m,
# orientations 5.8e-5, softmax and scores 3.5e-5, correlation offsets
# 3.1e-7); the image crops' boxes come from a 3 x 4 projection summed in
# another order, which perspective scales up near the camera
PAIR_ATOL = {"final_boxes_3d": 1e-3, "final_orientations": 2e-4,
             "final_cls_softmax": 1e-4, "final_scores": 1e-4,
             "final_corr_offsets": 1e-5}


def full_width_cfg(tower_dtype="float32"):
    cfg = cfg_mod.cars_dt_tracking()
    cfg.dataset.max_points = MAX_POINTS
    cfg.model.tower_dtype = tower_dtype
    return cfg


@functools.lru_cache(maxsize=None)
def bench_batch():
    """make_batch's couple (B = 1, F = 2), numpy."""
    return make_batch(full_width_cfg(), np.random.RandomState(0))


def frames(batch):
    """The couple's two frames, each with a leading batch axis of 1."""
    return [{**{k: batch[k][:, i] for k in FRAME_KEYS},
             **{k: batch[k] for k in batch if k not in FRAME_KEYS}}
            for i in range(2)]


@functools.lru_cache(maxsize=None)
def flax_params():
    """Flax init of the paired model with key 0 (the weights do not
    depend on the tower dtype), as numpy."""
    model = jdt.DtAvodNet(cfg=full_width_cfg(),
                          cluster_sizes=DEFAULT_CAR_CLUSTERS)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(model.init, static_argnames=("train", "mode"))(
        {"params": key, "dropout": key, "pathdrop": key},
        jax_tree(bench_batch()), train=False, mode="val")
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def jax_model(cfg):
    return jdt.DtAvodNet(cfg=cfg, cluster_sizes=DEFAULT_CAR_CLUSTERS)


def port_model(cfg):
    model = tdt.DtAvodNet(config_from_json(cfg), DEFAULT_CAR_CLUSTERS)
    model.load_state_dict(flax_to_state_dict(flax_params()), strict=True)
    return model.eval()


def jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def numpy_tree(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


def bev_inputs(cfg, batch):
    """(F, H, W, S + 1) BEV input of each frame: jitted JAX, as the
    model rasterizes, and the port's."""
    ku = cfg.dataset.kitti_utils
    bg = ku.bev_generator
    pts, val = batch["points"][0], batch["points_valid"][0]
    gp = np.broadcast_to(batch["ground_plane"], (len(pts), 4))
    want = jax.jit(jax.vmap(functools.partial(
        jvoxel.bev_maps_from_points,
        area_extents=np.asarray(ku.area_extents, np.float32),
        voxel_size=ku.voxel_size, height_lo=bg.height_lo,
        height_hi=bg.height_hi, num_slices=bg.num_slices)))(pts, val, gp)
    got = [tvoxel.bev_maps_from_points(
        torch.from_numpy(p), torch.from_numpy(v), torch.from_numpy(g.copy()),
        ku.area_extents, ku.voxel_size, bg.height_lo, bg.height_hi,
        bg.num_slices).features for p, v, g in zip(pts, val, gp)]
    return np.asarray(want.features), torch.stack(got).numpy()


@pytest.fixture(scope="module")
def states():
    """Each frame's state: JAX's encode_frame (jitted) and the port's."""
    cfg = full_width_cfg()
    jmodel = jax_model(cfg)
    encode = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, method=jmodel.encode_frame))
    model = port_model(cfg)
    want, got = [], []
    for frame in frames(bench_batch()):
        want.append(numpy_tree(encode(flax_params(), jax_tree(frame))))
        got.append(numpy_tree(model.encode_frame(torch_tree(frame))))
    return want, got


def test_full_width_bev_input_is_bit_equal():
    """Both frames' BEV maps (700 x 800 x 6 of 65536 points each) equal
    JAX's bit for bit; the true quotient puts 10 cells elsewhere."""
    want, got = bev_inputs(full_width_cfg(), bench_batch())
    assert want.shape == got.shape == (2, 700, 800, 6)
    assert (want[..., 5] > 0).sum() > 10000
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("key", ["bev_feats", "img_feats", "top_anchors",
                                 "top_valid", "ground_plane", "p2",
                                 "orig_image_shape"])
@pytest.mark.parametrize("frame", [0, 1])
def test_full_width_encode_frame_matches_jax(states, frame, key):
    want, got = (s[frame][key] for s in states)
    assert got.shape == want.shape
    if key in ENCODE_ATOL:
        np.testing.assert_allclose(got, want, rtol=0, atol=ENCODE_ATOL[key])
    else:
        np.testing.assert_array_equal(got, want)
    if key == "top_valid":
        assert want.sum() == 300


@pytest.fixture(scope="module")
def pair_outputs(states):
    """pair_stage of JAX's two frame states, jitted JAX and the port."""
    cfg = full_width_cfg()
    jmodel = jax_model(cfg)
    jstates, _ = states
    want = jax.jit(lambda p, a, b: jmodel.apply(
        {"params": p}, a, b, method=jmodel.pair_stage))(
            flax_params(), *(jax_tree(s) for s in jstates))
    got = port_model(cfg).pair_stage(*(torch_tree(s) for s in jstates))
    return numpy_tree(want), numpy_tree(got)


@pytest.mark.parametrize("key", sorted(tdt.FINAL_KEYS))
def test_full_width_pair_stage_on_jax_states_matches_jax(pair_outputs, key):
    want, got = pair_outputs
    assert set(got) == set(want) == set(tdt.FINAL_KEYS)
    w, g = want[key], got[key]
    assert g.shape == w.shape
    if key == "final_valid":
        np.testing.assert_array_equal(g, w)
        assert 0 < w.sum() < w.size
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=PAIR_ATOL[key])
