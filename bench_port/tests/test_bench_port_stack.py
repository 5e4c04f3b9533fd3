"""The Stack model's cell on the CPU at ``unittest_pipeline()`` sizes with
F = 4 frames: the reference (``reference/stack.py``) agrees with the
port's ``StackAvodNet`` on the val forward, following its own selection
changes nothing, the family builds both alike, the float8 control reads
not correct, and a traced run reports the cell's per-layer metrics."""
import json
import os

import torch

from conftest import BENCH, run_cell
from harness import check
from harness.cells import family_of, load_entry
from harness.weights import load_into, make_weights
from test_bench_port_control import tiny_control

CELL = "cars_stack.stack_detect"
FRAMES = 4
MIX = {"pool": 2, "valid_points": 3000, "cars": [1, 2], "car_points": 50,
       "speed": [0.0, 15.0], "hz": 10.0}
# what a CPU run has to read: the spans (no device trace, no peak)
TRACED = ("idle_ms.integrate", "idle_ms.stack_corr", "idle_ms.rasterize",
          "idle_ms.towers", "idle_ms.rpn", "idle_ms.second_stage",
          "syncs_per_keyframe")


def stack_entry():
    return load_entry(os.path.dirname(BENCH), "stack")


def build():
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.data.clusters import DEFAULT_CAR_CLUSTERS
    from dodt_tpu_torch.models.stack import StackAvodNet
    cfg = unittest_pipeline()
    cfg.model.model_name = "stack_avod_model"
    config = {"pipeline": json.loads(cfg.to_json()), "family": "stack",
              "cluster_sizes": [list(c) for c in DEFAULT_CAR_CLUSTERS],
              "num_frames": FRAMES}
    port = StackAvodNet(cfg, DEFAULT_CAR_CLUSTERS)
    weights = make_weights([(n, p.shape) for n, p in port.named_parameters()],
                           2 ** 31 + 13, torch.device("cpu"),
                           {"rpn_reg.out.weight": 0.01,
                            "avod_fc.out1.weight": 0.01})
    load_into(port, weights)
    _, ref = check.reference(config, weights, torch.device("cpu"))
    stacks = stack_entry().stack_pool(11, MIX, FRAMES, cfg.dataset.max_points,
                                      cfg.dataset.image_shape)
    return cfg, port.eval(), ref, stacks


def close(a, b, what):
    torch.testing.assert_close(torch.as_tensor(b), torch.as_tensor(a),
                               rtol=1e-5, atol=1e-5, msg=what)


def test_val_forward_matches_the_port():
    cfg, port, ref, stacks = build()
    for stack in stacks:
        batch = check.on(stack, "cpu")
        with torch.no_grad():
            a, b = port(batch, mode="val"), ref(batch, mode="val")
        assert bool(a["final_valid"].any())
        assert a.keys() <= b.keys()
        for k in a:
            close(a[k], b[k], k)


def test_forcing_its_own_selection_changes_nothing():
    cfg, port, ref, stacks = build()
    batch = check.on(stacks[0], "cpu")
    with torch.no_grad():
        own = ref(batch, mode="val")
        forced = ref(batch, mode="val",
                     proposals=(own["top_anchors"], own["top_valid"]))
    assert bool(forced["forced_hit"].all())
    for k in own:
        close(own[k], forced[k], k)


def test_the_stacks_move_their_cars_and_redraw_the_clutter():
    mix = dict(MIX, speed=[10.0, 10.0])
    stack = stack_entry().stack_pool(12, mix, FRAMES, 4096, (90, 300))[0]
    pts, valid = stack["points"][0], stack["points_valid"][0]
    assert pts.shape == (FRAMES, 4096, 3) and valid[:, :3000].all()
    assert not valid[:, 3000:].any()
    assert all((pts[0] != pts[t]).any() for t in range(1, FRAMES))
    assert stack["image"].shape == (1, FRAMES, 90, 300, 3)
    boxes = torch.zeros(2, 7)
    boxes[:, 6] = torch.tensor([0.0, -torch.pi / 2])
    step = stack_entry().moved(boxes.numpy(), 10.0, 0.1)
    torch.testing.assert_close(torch.as_tensor(step[:, [0, 2]]),
                               torch.tensor([[1.0, 0.0], [0.0, 1.0]]),
                               atol=1e-6, rtol=0)


def test_family_builds_the_models_a_direct_build_does():
    from dodt_tpu_torch.config import PipelineConfig
    from dodt_tpu_torch.models.stack import StackAvodNet
    from reference.config import PipelineConfig as RefConfig
    from reference.stack import StackAvodNet as RefNet
    config = json.load(open(os.path.join(BENCH, "configs",
                                         "cars_stack.json")))
    family = family_of(config)
    text = json.dumps(config["pipeline"])
    clusters = tuple(map(tuple, config["cluster_sizes"]))
    cfg, rcfg = PipelineConfig.from_json(text), RefConfig.from_json(text)
    shapes = [(n, tuple(p.shape)) for n, p in
              family.program(cfg, config).named_parameters()]
    assert shapes == [(n, tuple(p.shape)) for n, p in
                      StackAvodNet(cfg, clusters).named_parameters()]
    assert shapes == [(n, tuple(p.shape)) for n, p in
                      family.reference(rcfg, config).named_parameters()]
    assert shapes == [(n, tuple(p.shape)) for n, p in
                      RefNet(rcfg, clusters).named_parameters()]
    assert config["num_frames"] == cfg.dataset.data_stride + 1 == FRAMES


def test_control_at_test_sizes_reads_not_correct(tiny_root, capsys):
    tiny_control(tiny_root, ["--workload", CELL, "--seeds", "5"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["control_correct"] is False, line


def test_a_traced_cpu_run_reports_the_cells_metrics(tiny_root):
    res, err = run_cell(tiny_root, CELL, trace=1)
    assert res["correct"], err
    assert res["checks"]["bev_gap"]["value"] == 0.0
    for name in TRACED:
        assert res["metrics"][name]["value"] >= 0, name
