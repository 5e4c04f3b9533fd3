"""The flagship's monolithic pair forward at full width on the CPU: the
port's ``DtAvodNet.forward(mode="val")`` against the jitted JAX
``__call__``, on tests/test_torch_full_width_encode.py's inputs and
weights (bench.py's couple, 65536 points a frame, Flax init with key 0).

With the flagship's bf16 towers the two packages round the towers'
activations at the same places but sum in other orders, so about a
tenth of the BEV features end up one bf16 ulp apart, the proposals move
by up to 5e-2 m and the random-weight second stage and its NMS pick
other finals. The forward is therefore held at both tower dtypes:

* both: ``bev_input`` bit-equal (ROADMAP C22: the true quotient puts
  points that lie on a cell edge in the neighbouring cell, 448 values
  apart);
* f32 towers: per frame, at least 0.99 of JAX's valid top proposals
  have a port proposal within 1e-2 (m, over the six anchor values) and
  1e-2 in score, at least 0.95 of JAX's valid final detections a port
  final within 1e-2 (m and rad over the seven box values) and 1e-2 in
  score, and the valid final counts within 2. Measured: 1.000 / 1.000,
  1.000 / 0.972 and equal counts (35, 36); with the true quotient
  0.980 / 0.940 and 0.886 / 0.722;
* bf16 towers: at least 0.98 of JAX's valid top proposals have a port
  proposal within 5e-2 m and 1e-2 in score, and the valid final counts
  are within a fifth of JAX's. Measured: 0.993 / 0.993, counts 31 / 39
  against 34 / 33 (with the true quotient 0.990 / 0.987, 34 / 35); the
  finals match as sets only 0.06 / 0.00 within 1e-2 and 0.50 / 0.52
  within 0.5.
"""
import jax
import numpy as np
import pytest

from test_torch_full_width_encode import (bench_batch, flax_params,
                                          full_width_cfg, jax_model,
                                          jax_tree, numpy_tree, port_model,
                                          torch_tree)

# tower dtype: (proposal tolerance, top share, final share or None,
# largest difference of the valid final counts as a share of JAX's or
# an absolute count)
RULES = {"float32": (1e-2, 0.99, 0.95, 2),
         "bfloat16": (5e-2, 0.98, None, 0.2)}


def set_share(want, want_valid, got, got_valid, tol):
    """Share of want's valid rows with a valid row of got within tol (max
    abs over the last axis); rows may come in another order."""
    w, g = want[want_valid], got[got_valid]
    if len(w) == 0:
        return 1.0
    if len(g) == 0:
        return 0.0
    d = np.abs(w[:, None, :] - g[None, :, :]).max(-1)
    return float((d.min(1) <= tol).mean())


def with_scores(out, boxes, scores, f):
    return np.concatenate([out[boxes][0, f], out[scores][0, f][:, None]], -1)


@pytest.fixture(scope="module", params=sorted(RULES))
def outputs(request):
    cfg = full_width_cfg(request.param)
    jmodel = jax_model(cfg)
    want = jax.jit(jmodel.apply, static_argnames=("train", "mode"))(
        {"params": flax_params()}, jax_tree(bench_batch()), train=False,
        mode="val")
    got = port_model(cfg)(torch_tree(bench_batch()), mode="val")
    return numpy_tree(want), numpy_tree(got), request.param


def test_full_width_forward_keys_and_shapes(outputs):
    want, got, _ = outputs
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    assert want["top_anchors"].shape == (1, 2, 300, 6)
    assert want["anchors"].shape[1] > 89000


def test_full_width_forward_bev_input_is_bit_equal(outputs):
    want, got, _ = outputs
    np.testing.assert_array_equal(got["bev_input"], want["bev_input"])


@pytest.mark.parametrize("frame", [0, 1])
def test_full_width_forward_top_proposals_match_as_sets(outputs, frame):
    want, got, dtype = outputs
    tol, min_share, _, _ = RULES[dtype]
    share = set_share(
        with_scores(want, "top_anchors", "top_scores", frame),
        want["top_valid"][0, frame],
        with_scores(got, "top_anchors", "top_scores", frame),
        got["top_valid"][0, frame], tol)
    assert want["top_valid"][0, frame].sum() == 300
    assert share >= min_share, share


@pytest.mark.parametrize("frame", [0, 1])
def test_full_width_forward_final_detections_match(outputs, frame):
    want, got, dtype = outputs
    tol, _, min_share, count_diff = RULES[dtype]
    nw = int(want["final_valid"][0, frame].sum())
    ng = int(got["final_valid"][0, frame].sum())
    assert nw > 0
    if isinstance(count_diff, float):
        count_diff = count_diff * nw
    assert abs(ng - nw) <= count_diff, (ng, nw)
    if min_share is not None:
        share = set_share(
            with_scores(want, "final_boxes_3d", "final_scores", frame),
            want["final_valid"][0, frame],
            with_scores(got, "final_boxes_3d", "final_scores", frame),
            got["final_valid"][0, frame], tol)
        assert share >= min_share, share
