"""The port's own copies of the JAX package's host modules against the
originals: every config preset, the detection decode, the rotated BEV
IoU, the latency statistics, the metrics logger, the size clusters and
bench.py's input maker, on seeded inputs, exactly."""
import json

import numpy as np
import pytest

import bench
from dodt_tpu import config as jcfg
from dodt_tpu.data import clusters as jclusters
from dodt_tpu.eval import decode as jdecode
from dodt_tpu.utils import metrics as jmetrics
from dodt_tpu.utils import np_iou as jiou
from dodt_tpu_torch import config as tcfg
from dodt_tpu_torch.convert import config_from_json
from dodt_tpu_torch.data import clusters as tclusters
from dodt_tpu_torch.data import synthetic_scan
from dodt_tpu_torch.eval import decode as tdecode
from dodt_tpu_torch.utils import metrics as tmetrics
from dodt_tpu_torch.utils import np_iou as tiou

PRESETS = [
    ("cars_dt_tracking", ()), ("cars_dt_tracking", (2,)),
    ("cars_single_frame", ()), ("cars_dt_tracking_staged", ("/ckpt/pre",)),
    ("cars_dt_tracking_finetune", ("/ckpt/staged", 3)),
    ("pedestrians_dt_tracking", ()), ("cyclists_dt_tracking", (2,)),
    ("people_dt_tracking", ()), ("unittest_pipeline", ())]


@pytest.mark.parametrize("name,args", PRESETS,
                         ids=[f"{n}{a}" for n, a in PRESETS])
def test_presets_equal_the_jax_presets(name, args):
    """Every preset of the port's config serialises to the JAX preset's
    JSON, and a JAX config converts to the port's through it."""
    want = getattr(jcfg, name)(*args)
    got = getattr(tcfg, name)(*args)
    assert isinstance(got, tcfg.PipelineConfig)
    assert got.to_json() == want.to_json()
    assert config_from_json(want) == got
    assert tcfg.PipelineConfig.from_json(got.to_json()) == got


def test_config_save_load_and_module_constants(tmp_path):
    cfg = tcfg.unittest_pipeline()
    cfg.train.optimizer.name = "rmsprop"
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    assert tcfg.PipelineConfig.load(path) == cfg
    assert jcfg.PipelineConfig.load(path).to_json() == cfg.to_json()
    assert tcfg.DETECTOR_SUBTREES == jcfg.DETECTOR_SUBTREES


def test_clusters_equal():
    assert tclusters.DEFAULT_CAR_CLUSTERS == jclusters.DEFAULT_CAR_CLUSTERS
    assert json.dumps(tclusters.SIZE_PRIORS, sort_keys=True) == json.dumps(
        jclusters.SIZE_PRIORS, sort_keys=True)
    for cls in jclusters.SIZE_PRIORS:
        for k in (1, 2, 3):
            np.testing.assert_array_equal(tclusters.size_priors(cls, k),
                                          jclusters.size_priors(cls, k))


def _frame_outputs(rng, n):
    boxes = np.concatenate([rng.uniform(-20, 20, (n, 3)),
                            rng.uniform(0.5, 4.5, (n, 3)),
                            rng.uniform(-4, 4, (n, 1))], -1).astype(np.float32)
    orient = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    soft = rng.dirichlet(np.ones(3), n).astype(np.float32)
    valid = rng.uniform(0, 1, n) < 0.8
    offsets = rng.normal(size=(n, 3)).astype(np.float32)
    return boxes, orient, scores, soft, valid, offsets


@pytest.mark.parametrize("with_extras", [False, True])
def test_outputs_to_detections_equal(with_extras):
    rng = np.random.RandomState(3)
    boxes, orient, scores, soft, valid, offsets = _frame_outputs(rng, 40)
    np.testing.assert_array_equal(
        tdecode.resolve_box_4ca_orientation(boxes, orient),
        jdecode.resolve_box_4ca_orientation(boxes, orient))
    extras = dict(corr_offsets=offsets,
                  coexist=rng.uniform(0, 1, 40).astype(np.float32),
                  score_threshold=0.3) if with_extras else {}
    want = jdecode.outputs_to_detections(boxes, orient, scores, soft, valid,
                                         **extras)
    got = tdecode.outputs_to_detections(boxes, orient, scores, soft, valid,
                                        **extras)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if w[k] is None:
                assert g[k] is None
            else:
                np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("shape", [(12, 9), (0, 4), (1, 1)])
def test_rotated_iou_matrix_equal(shape):
    rng = np.random.RandomState(5)

    def boxes(n):
        return np.concatenate([rng.uniform(-3, 3, (n, 2)),
                               rng.uniform(0.5, 4, (n, 2)),
                               rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    a, b = boxes(shape[0]), boxes(shape[1])
    if shape == (1, 1):
        b = a.copy()                   # identical boxes: IoU 1
    np.testing.assert_array_equal(tiou.rotated_iou_matrix(a, b),
                                  jiou.rotated_iou_matrix(a, b))


def test_latency_stats_and_metrics_logger_equal(tmp_path):
    times = np.random.RandomState(7).uniform(0.01, 0.05, 25)
    assert tmetrics.latency_stats(times) == jmetrics.latency_stats(times)
    recs = []
    for mod, name in ((tmetrics, "port"), (jmetrics, "jax")):
        path = str(tmp_path / name / "metrics.jsonl")
        logger = mod.MetricsLogger(path)
        logger.log(3, loss=np.float32(1.5), lr=1e-3, tag="x")
        with open(path) as f:
            rec = json.loads(f.read())
        rec.pop("time")
        recs.append((rec, [{k: v for k, v in h.items() if k != "time"}
                           for h in logger.history]))
    assert recs[0] == recs[1]


@pytest.mark.parametrize("seed", [0, 4])
def test_make_batch_equals_bench(seed):
    cfg = jcfg.unittest_pipeline()
    want = bench.make_batch(cfg, np.random.RandomState(seed))
    got = synthetic_scan.make_batch(config_from_json(cfg),
                                    np.random.RandomState(seed))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (synthetic_scan.TAU, synthetic_scan.BASELINE_FPS) == (
        bench.TAU, bench.BASELINE_FPS)
    rng_a, rng_b = np.random.RandomState(seed), np.random.RandomState(seed)
    np.testing.assert_array_equal(
        synthetic_scan.velodyne_like_points(rng_a, 1000),
        bench.velodyne_like_points(rng_b, 1000))
