"""The flagship's streaming path at full width on the CPU: the port's
``StreamingPredictor.push_keyframe`` against JAX's (jitted: its encode
and its fused encode + pair step), two keyframes of bench.py's couple on
the static arm and on the ego-motion arm (bench.py's moving platform,
0.5 degrees of yaw and (0.05, 3.6) m, so the warp runs at full width),
f32 towers, tests/test_torch_full_width_encode.py's inputs and weights.

* Every keyframe's BEV rasterization inside the port's predictor is
  bit-equal to jitted JAX's (ROADMAP C22).
* Each cached frame state after a push: (a)'s rules
  (tests/test_torch_full_width_encode.py), for both frames.
* (b)'s rules on the pair: the port's ``warp_state`` (ego arm) and
  ``pair_stage`` fed JAX's two cached states give JAX's pair outputs,
  the final mask exact, every other output within (b)'s bounds. On the
  ego arm XLA contracts the warp's sample coordinates into fused
  multiply-adds (up to 1.8e-4 px apart): measured boxes 1.9e-4 m,
  orientations 1.1e-4, softmax and scores 7.3e-5, correlation offsets
  3.4e-7 (static arm: (b)'s numbers).
* The port's own pair outputs, from its own states, against JAX's under
  the forward's f32 rule (tests/test_torch_full_width_forward.py): at
  least 0.95 of JAX's valid finals matched within 1e-2, counts within 2.
  Measured: 1.000 / 0.972 static, 1.000 / 1.000 ego, counts equal.
"""
import numpy as np
import pytest
import torch

from dodt_tpu.runtime.predictor import StreamingPredictor as JaxPredictor
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.runtime.predictor import StreamingPredictor
from test_torch_full_width_encode import (ENCODE_ATOL, PAIR_ATOL,
                                          bench_batch, bev_inputs,
                                          flax_params, frames,
                                          full_width_cfg, jax_model,
                                          numpy_tree, port_model,
                                          torch_tree)
from test_torch_full_width_forward import set_share, with_scores

ARMS = ("static", "ego")


def ego_motion():
    """bench.py's moving platform: 1.2 m/frame x tau=3, 0.5 deg yaw."""
    th = np.radians(0.5)
    a2 = np.array([[np.cos(th), -np.sin(th)],
                   [np.sin(th), np.cos(th)]], np.float32)
    return a2, np.array([0.05, 3.6], np.float32)


@pytest.fixture(scope="module")
def streams():
    """Per arm: JAX's cached states and pair output, the port's, and the
    BEV maps the port's predictor rasterized."""
    cfg = full_width_cfg()
    jpred = JaxPredictor(jax_model(cfg), flax_params())
    model = port_model(cfg)
    pred = StreamingPredictor(model, device="cpu")
    rasterized = []
    rasterize = tdt.bev_maps_from_points

    def spy(*args, **kwargs):
        maps = rasterize(*args, **kwargs)
        rasterized.append(maps.features.numpy())
        return maps

    out = {}
    tdt.bev_maps_from_points = spy
    try:
        for arm in ARMS:
            ego = ego_motion() if arm == "ego" else None
            jpred.reset()
            pred.reset()
            res = {"jax_states": [], "states": []}
            for i, frame in enumerate(frames(bench_batch())):
                res["jax_out"] = jpred.push_keyframe(frame,
                                                     ego_to_prev=ego)
                res["out"] = pred.push_keyframe(frame, ego_to_prev=ego)
                res["jax_states"].append(numpy_tree(jpred._state))
                res["states"].append(numpy_tree(pred._state))
            out[arm] = res
    finally:
        tdt.bev_maps_from_points = rasterize
    return model, out, rasterized


def test_full_width_stream_rasterizes_as_jax(streams):
    _, _, rasterized = streams
    want, _ = bev_inputs(full_width_cfg(), bench_batch())
    assert len(rasterized) == 2 * len(ARMS)
    for i, got in enumerate(rasterized):
        np.testing.assert_array_equal(got, want[i % 2])


@pytest.mark.parametrize("key", sorted(ENCODE_ATOL) + ["top_valid"])
@pytest.mark.parametrize("arm", ARMS)
def test_full_width_stream_states_match_jax(streams, arm, key):
    _, out, _ = streams
    for want, got in zip(out[arm]["jax_states"], out[arm]["states"]):
        if key in ENCODE_ATOL:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=ENCODE_ATOL[key])
        else:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arm", ARMS)
def test_full_width_stream_pair_on_jax_states_matches_jax(streams, arm):
    model, out, _ = streams
    res = out[arm]
    prev, cur = (torch_tree(s) for s in res["jax_states"])
    if arm == "ego":
        cur = StreamingPredictor(model, device="cpu").warp_state(
            cur, *(torch.from_numpy(v) for v in ego_motion()))
    got = numpy_tree(model.pair_stage(prev, cur))
    want = res["jax_out"]
    assert set(got) == set(want) == set(tdt.FINAL_KEYS)
    np.testing.assert_array_equal(got["final_valid"], want["final_valid"])
    assert 0 < want["final_valid"].sum()
    for key, atol in PAIR_ATOL.items():
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("arm", ARMS)
def test_full_width_stream_pair_matches_jax_as_sets(streams, arm):
    _, out, _ = streams
    want, got = out[arm]["jax_out"], out[arm]["out"]
    for f in range(2):
        nw = int(want["final_valid"][0, f].sum())
        ng = int(got["final_valid"][0, f].sum())
        assert nw > 0 and abs(ng - nw) <= 2, (ng, nw)
        share = set_share(
            with_scores(want, "final_boxes_3d", "final_scores", f),
            want["final_valid"][0, f],
            with_scores(got, "final_boxes_3d", "final_scores", f),
            got["final_valid"][0, f], 1e-2)
        assert share >= 0.95, share
