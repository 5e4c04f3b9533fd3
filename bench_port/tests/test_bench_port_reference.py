"""The frozen reference agrees with the port's plain path at
``unittest_pipeline()`` sizes on the CPU: the val forward of both
models, the streaming encode, warp and pair stage, and the train step
(losses, every gradient, the Adam update) on the same draws."""
import json

import pytest
import torch

from harness import check, inputs
from harness.weights import load_into, make_weights

MIX = {"pool": 2, "valid_points": 3000, "cars": [1, 2], "car_points": 50}


def build(num_frames):
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    cfg = unittest_pipeline()
    config = {"pipeline": json.loads(cfg.to_json()),
              "cluster_sizes": [list(c) for c in DEFAULT_CAR_CLUSTERS],
              "num_frames": num_frames}
    port = DtAvodNet(cfg, DEFAULT_CAR_CLUSTERS, num_frames=num_frames)
    weights = make_weights([(n, p.shape) for n, p in port.named_parameters()],
                           2 ** 31 + 9, torch.device("cpu"),
                           {"rpn_reg.out.weight": 0.01})
    load_into(port, weights)
    _, ref = check.reference(config, weights, torch.device("cpu"))
    return cfg, config, port.eval(), ref, weights


def close(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    torch.testing.assert_close(torch.as_tensor(b), torch.as_tensor(a),
                               rtol=1e-5, atol=1e-5, msg=what)


@pytest.mark.parametrize("num_frames", [1, 2])
def test_val_forward_matches_the_port(num_frames):
    cfg, config, port, ref, _ = build(num_frames)
    couple = inputs.couple_pool(5, MIX, cfg.dataset.max_points,
                                cfg.dataset.image_shape,
                                cfg.dataset.max_gt_boxes)[0]
    batch = check.on(couple, "cpu")
    if num_frames == 1:
        per_frame = ("points", "points_valid", "image", "gt_boxes",
                     "gt_classes", "gt_valid", "gt_track_ids")
        batch = {k: (v[:, :1] if k in per_frame else v)
                 for k, v in batch.items()}
    with torch.no_grad():
        a, b = port(batch, mode="val"), ref(batch, mode="val")
    assert a.keys() == b.keys()
    for k in a:
        close(a[k], b[k], k)


def test_stream_path_matches_the_predictor():
    from dodt_tpu_torch.runtime.predictor import StreamingPredictor
    from reference.model import warp_state
    cfg, config, port, ref, _ = build(2)
    frames = inputs.frame_pool(6, MIX, cfg.dataset.max_points,
                               cfg.dataset.image_shape)
    ego = inputs.ego_motion(0.5, [0.05, 3.6])
    pred = StreamingPredictor(port, device="cpu")
    pred.push_keyframe(frames[0])
    got = pred.push_keyframe(frames[1], ego_to_prev=ego)
    with torch.no_grad():
        sa = ref.encode_frame(check.on(frames[0], "cpu"))
        sb = ref.encode_frame(check.on(frames[1], "cpu"))
        a2, b2 = (torch.as_tensor(v) for v in ego)
        want = ref.pair_stage(sa, warp_state(ref.cfg, sb, a2, b2))
    for k in got:
        close(got[k], want[k], k)


def test_train_step_matches_make_train_step():
    from dodt_tpu_torch.models.dt_avod import generator_draws
    from dodt_tpu_torch.runtime.trainer import (create_train_state,
                                                make_train_step)
    from reference import optim
    cfg, config, port, ref, weights = build(2)
    couple = check.on(inputs.couple_pool(7, MIX, cfg.dataset.max_points,
                                         cfg.dataset.image_shape,
                                         cfg.dataset.max_gt_boxes)[0], "cpu")
    draws = []
    gen = generator_draws(torch.Generator().manual_seed(3))

    def rand(name, shape):
        draws.append((name, gen(name, shape)))
        return draws[-1][1]
    state = create_train_state(cfg, port)
    new, losses = make_train_step(cfg, port)(state, couple, rand)
    params, opt, ref_losses, grads, _ = optim.train_step(
        ref.cfg, ref, dict(weights), optim.adam_init(weights), couple,
        check.replay(draws))
    for k in losses:
        close(losses[k], ref_losses[k], k)
    for k in params:
        close(new.params[k], params[k], k)
        close(new.opt_state["mu"][k], opt["mu"][k], k)
    assert any(float(g.abs().max()) > 0 for g in grads.values())


def test_forcing_its_own_selection_changes_nothing():
    """The reference at the selection its own NMS made gives its own
    outputs, every proposal matched."""
    cfg, config, port, ref, _ = build(2)
    batch = check.on(inputs.couple_pool(8, MIX, cfg.dataset.max_points,
                                        cfg.dataset.image_shape,
                                        cfg.dataset.max_gt_boxes)[0], "cpu")
    with torch.no_grad():
        own = ref(batch, mode="val")
        forced = ref(batch, mode="val",
                     proposals=(own["top_anchors"], own["top_valid"]))
    assert bool(forced["forced_hit"].all())
    for k in own:
        close(own[k], forced[k], k)
