"""The second stage's CUDA graphs and what they need, on the CPU: the
CPU path captures nothing, the per-device constants that replaced
host-to-device copies give the old values exactly, and a model's graph
cache does not travel with a copy. The card's side (replays bit-equal to
eager calls, counters, launches, no sync) is in tests/test_torch_cuda.py.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

from dodt_tpu_torch.config import unittest_pipeline
from dodt_tpu_torch.data.synthetic_scan import make_batch
from dodt_tpu_torch.models import dt_avod, graphs
from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
from dodt_tpu_torch.ops import nms, projection

CLUSTERS = ((3.9, 1.6, 1.52),)


def counters(model):
    return (model.graphs.captures, model.graphs.replays, model.graphs.eager,
            len(model.graphs._entries))


def test_cpu_second_stage_captures_nothing():
    cfg = unittest_pipeline()
    model = DtAvodNet(cfg, CLUSTERS)
    init_params(model, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v)
             for k, v in make_batch(cfg, np.random.RandomState(0)).items()}
    out = model(batch, mode="val")
    states = [model.encode_frame({k: v[:, f] if k in (
        "points", "points_valid", "image") else v for k, v in batch.items()})
        for f in range(2)]
    pair = model.pair_stage(*states)
    assert counters(model) == (0, 0, 0, 0)
    with torch.no_grad():
        want = model._second_stage(
            *(torch.stack([states[0][k], states[1][k]], 1) for k in (
                "bev_feats", "img_feats", "top_anchors", "top_valid")),
            states[0]["ground_plane"], states[0]["p2"],
            states[0]["orig_image_shape"].float(), 0.0)
    assert set(pair) == set(dt_avod.FINAL_KEYS)
    for k in dt_avod.FINAL_KEYS:
        assert torch.equal(pair[k], want[k]), k
    assert out["final_boxes_3d"].shape[:2] == (batch["points"].shape[0], 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cached_bev_ranges_give_the_old_quotient(dtype):
    ext = [[-40.0, 40.0], [0.0, 70.0]]
    g = torch.Generator().manual_seed(3)
    anchors = torch.rand((2, 50, 6), generator=g, dtype=dtype) * 30.0
    corners, norm = projection.project_to_bev(anchors, ext)
    e = np.asarray(ext, np.float32)
    rx, rz = float(e[0, 1] - e[0, 0]), float(e[1, 1] - e[1, 0])
    old = corners / torch.tensor([rx, rz, rx, rz], dtype=dtype)
    assert torch.equal(norm, old)
    assert norm.dtype == dtype
    cpu = torch.device("cpu")
    assert (projection._bev_ranges(rx, rz, dtype, cpu)
            is projection._bev_ranges(rx, rz, dtype, cpu))


def test_reorder_boxes_yx_swaps_each_corner():
    boxes = torch.randn(2, 5, 4)
    assert torch.equal(projection.reorder_boxes_yx(boxes),
                       boxes[..., [1, 0, 3, 2]])


def test_cached_expand_offset_is_the_old_tensor():
    top = torch.zeros(1, 2, 3, 6)
    got = dt_avod._expand_offset(0.5, top.dtype, top.device)
    assert torch.equal(got, top.new_tensor([0.0, 0.0, 0.0, 0.5, 0.0, 0.5]))
    assert got is dt_avod._expand_offset(0.5, top.dtype, top.device)


def test_fixpoint_takes_the_plain_loop_on_the_cpu_and_refuses_others():
    g = torch.Generator().manual_seed(4)
    dom = torch.rand((2, 40, 40), generator=g) < 0.1
    dom &= torch.ones(40, 40, dtype=torch.bool).tril(-1)   # a strict order
    before = nms._KERNEL.launches
    assert torch.equal(nms.fixpoint(dom), nms.fixpoint_plain(dom))
    assert nms._KERNEL.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        nms.fixpoint(dom.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        nms.fixpoint_cuda(dom)


def test_graph_cache_fills_its_buffers_in_place():
    a, b = torch.randn(3, 4), torch.randn(3, 4)
    buf = graphs._materialize((a, b))
    assert torch.equal(buf, torch.stack([a, b], 1))
    c, d = torch.randn(3, 4), torch.randn(3, 4)
    ptr = buf.data_ptr()
    graphs._fill(buf, (c, d))
    assert buf.data_ptr() == ptr and torch.equal(buf, torch.stack([c, d], 1))
    one = graphs._materialize(a)
    assert one is not a and torch.equal(one, a)
    graphs._fill(one, c)
    assert torch.equal(one, c)
    assert graphs._materialize(None) is None
    assert graphs._signature((a, b)) == graphs._signature((c, d))
    assert graphs._signature(a) != graphs._signature(a.double())


def test_graph_cache_does_not_travel_with_a_copy():
    model = DtAvodNet(unittest_pipeline(), CLUSTERS)
    model.graphs.captures = model.graphs.replays = model.graphs.eager = 3
    model.graphs._entries["stale"] = object()
    for other in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert isinstance(other.graphs, graphs.GraphCache)
        assert counters(other) == (0, 0, 0, 0)


def _toy_stage(seed):
    """A toy stage (two linear layers) and its inputs: a pair of (5, 4)
    frames, and a weight."""
    g = torch.Generator().manual_seed(seed)
    toy = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    a, b = torch.randn(5, 4, generator=g), torch.randn(5, 4, generator=g)

    def fn(none, x, w):
        return {"y": toy(x) * w, "none": none}
    return toy, fn, (a, b), torch.rand(1, generator=g)


@pytest.mark.parametrize("case", ["no_grad", "grad", "tuple"])
def test_graph_cache_call_runs_eagerly_on_the_cpu(case):
    """On the CPU ``GraphCache.call`` runs the stage eagerly on its
    inputs (a tuple stacked on axis 1; the first tensor decides the
    device), with grad off or on, and counts nothing."""
    toy, fn, (a, b), w = _toy_stage(5)
    x = (a, b) if case == "tuple" else torch.stack([a, b], 1)
    cache = graphs.GraphCache()
    with torch.set_grad_enabled(case == "grad"):
        got = cache.call(fn, (None, x, w), "toy", [toy], None)
        want = fn(None, torch.stack([a, b], 1), w)
    assert (cache.captures, cache.replays, cache.eager,
            len(cache._entries)) == (0, 0, 0, 0)
    assert got["none"] is None and torch.equal(got["y"], want["y"])
    assert got["y"].requires_grad == (case == "grad")
