"""The port's named spans (``utils/metrics.span``): under a profiler the
streaming predictor, the train loop and the Stack forward mark their
layers with ``dodt/`` events nested as the work is; with no profiler a
span is the one shared null context. On the CPU at
``unittest_pipeline()`` sizes, random weights."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dodt_tpu_torch.config import unittest_pipeline
from dodt_tpu_torch.data import synthetic, tracking
from dodt_tpu_torch.models import dt_avod
from dodt_tpu_torch.runtime.predictor import StreamingPredictor
from dodt_tpu_torch.runtime.trainer import Trainer
from dodt_tpu_torch.utils import metrics

CLUSTERS = ((3.9, 1.6, 1.52),)
TH = 0.02
EGO = (np.array([[np.cos(TH), -np.sin(TH)], [np.sin(TH), np.cos(TH)]],
                np.float32), np.array([0.1, 0.8], np.float32))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_spans_torch"))
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=4,
                                     ego_speed=0.5)
    cfg = unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.kitti_utils.area_extents = (
        (-16.0, 16.0), (-3.0, 3.0), (0.0, 48.0))
    cfg.dataset.kitti_utils.anchor_strides = (1.0, 1.0)
    cfg.dataset.max_points = 4096
    cfg.dataset.video_train_ids = (0,)
    ds = tracking.KittiTrackingDataset(cfg.dataset, split="train")
    model = dt_avod.DtAvodNet(cfg, CLUSTERS)
    dt_avod.init_params(model, torch.Generator().manual_seed(0))
    return cfg, ds, model


def spans(prof):
    """(name, thread, start, end) of every ``dodt/`` event."""
    return [(e.name, e.thread, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.name.startswith("dodt/")]


def inside(events, outer, inner):
    """The ``inner`` spans that lie inside some ``outer`` span."""
    return [i for i in events if i[0] == inner and any(
        o[0] == outer and o[1] == i[1] and o[2] <= i[2] and i[3] <= o[3]
        for o in events)]


def test_keyframe_spans_nest_as_the_work(setup):
    cfg, ds, model = setup
    batch = ds.next_batch(1, shuffle=False, augment=False)
    frames = [{"points": batch["points"][:, i],
               "points_valid": batch["points_valid"][:, i],
               "image": batch["image"][:, i],
               "ground_plane": batch["ground_plane"], "p2": batch["p2"],
               "orig_image_shape": batch["orig_image_shape"]}
              for i in range(2)]
    pred = StreamingPredictor(model, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for f in frames:
            pred.push_keyframe(f, fetch=True, ego_to_prev=EGO)
    ev = spans(prof)
    assert sum(e[0] == "dodt/keyframe" for e in ev) == 2
    for name in ("upload", "encode", "warp", "pair", "fetch"):
        assert inside(ev, "dodt/keyframe", "dodt/" + name), name
    for name in ("rasterize", "towers", "rpn"):
        assert inside(ev, "dodt/encode", "dodt/" + name), name
    assert inside(ev, "dodt/rpn", "dodt/nms")
    assert inside(ev, "dodt/nms", "dodt/nms_pass")
    assert inside(ev, "dodt/pair", "dodt/second_stage")
    assert inside(ev, "dodt/second_stage", "dodt/correlation")


def test_train_step_spans_nest_as_the_work(setup, tmp_path):
    cfg, ds, model = setup
    trainer = Trainer(cfg, model, ds, str(tmp_path), metrics_path=None,
                      device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train(max_steps=1, log_every=1)
    ev = spans(prof)
    assert sum(e[0] == "dodt/train_step" for e in ev) == 1
    for name in ("data_wait", "forward", "losses", "backward", "optimizer",
                 "log", "save"):
        assert inside(ev, "dodt/train_step", "dodt/" + name), name
    assert inside(ev, "dodt/forward", "dodt/rpn")


def test_stack_forward_spans_nest_as_the_work(setup):
    from dodt_tpu_torch.models.stack import StackAvodNet
    cfg, ds, _ = setup
    model = StackAvodNet(cfg, CLUSTERS)
    dt_avod.init_params(model, torch.Generator().manual_seed(0))
    batch = ds.next_batch(1, shuffle=False, augment=False)
    # a stack of four frames: the couple's two, twice
    per_frame = ("points", "points_valid", "image")
    stack = {k: torch.as_tensor(np.concatenate([batch[k]] * 2, axis=1)
                                if k in per_frame else batch[k])
             for k in per_frame + ("ground_plane", "p2", "orig_image_shape")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.eval()(stack, mode="val")
    ev = spans(prof)
    assert sum(e[0] == "dodt/forward" for e in ev) == 1
    for name in ("rasterize", "towers", "rpn", "second_stage"):
        assert inside(ev, "dodt/forward", "dodt/" + name), name
    assert inside(ev, "dodt/rasterize", "dodt/integrate")
    assert inside(ev, "dodt/rpn", "dodt/nms")
    assert inside(ev, "dodt/second_stage", "dodt/stack_corr")
    assert inside(ev, "dodt/second_stage", "dodt/nms")


def test_span_without_a_profiler_is_the_shared_null_context():
    assert metrics.span("dodt/a") is metrics.span("dodt/b")
    with metrics.span("dodt/a") as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]):
        assert metrics.span("dodt/a") is not metrics.span("dodt/a")
    assert metrics.span("dodt/a") is metrics.span("dodt/b")
