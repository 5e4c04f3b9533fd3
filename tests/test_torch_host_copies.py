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


# ---------------------------------------------------------------------------
# Data, scoring and tracking copies: exactly equal on seeded inputs, except
# the port's native AP library against the Python route (1e-9 of an AP
# point: the same arithmetic compiled without -march, so no fused
# multiply-adds).

import dataclasses
import os

from dodt_tpu import native as jnative
from dodt_tpu.data import augment as jaug
from dodt_tpu.data import kitti as jkitti
from dodt_tpu.data import synthetic as jsynth
from dodt_tpu.data import tracking as jtracking
from dodt_tpu.eval import kitti_ap as jap
from dodt_tpu.eval import kitti_writer as jwriter
from dodt_tpu.tracking import iou_tracker as jtracker
from dodt_tpu.tracking import moi as jmoi
from dodt_tpu.tracking import mot_eval as jmot
from dodt_tpu_torch import native as tnative
from dodt_tpu_torch.data import augment as taug
from dodt_tpu_torch.data import kitti as tkitti
from dodt_tpu_torch.data import synthetic as tsynth
from dodt_tpu_torch.data import tracking as ttracking
from dodt_tpu_torch.eval import kitti_ap as tap
from dodt_tpu_torch.eval import kitti_writer as twriter
from dodt_tpu_torch.tracking import iou_tracker as ttracker
from dodt_tpu_torch.tracking import moi as tmoi
from dodt_tpu_torch.tracking import mot_eval as tmot

# a static video of surface scans and an ego-motion video of beam scans
# with rendered images: every scene path of the writer
VIDEO_SPECS = [{"ego_speed": 0.0},
               {"ego_speed": 0.5, "scan": "beam", "render_images": True}]


def assert_same(got, want, path="x"):
    """Equal values, types and array dtypes, recursively."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(want):
            assert_same(getattr(got, f.name), getattr(want, f.name),
                        f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert got == want or (got != got and want != want), path


@pytest.fixture(scope="module")
def fixture_roots(tmp_path_factory):
    """The same fixture written by both packages."""
    roots = {}
    for name, mod in (("jax", jsynth), ("port", tsynth)):
        roots[name] = str(tmp_path_factory.mktemp(name) / "kitti")
        mod.write_tracking_fixture(roots[name], num_videos=2, num_frames=4,
                                   video_specs=VIDEO_SPECS)
    # one DontCare region per video, for the parsers' DontCare paths
    for root in roots.values():
        for vid in (0, 1):
            with open(os.path.join(root, "training", "label_02",
                                   f"{vid:04d}.txt"), "a") as f:
                f.write("1 -1 DontCare -1 -1 -10 600.00 150.00 700.00 "
                        "200.00 -1 -1 -1 -1000 -1000 -1000 -10\n")
    return roots


def test_write_tracking_fixture_byte_for_byte(fixture_roots):
    files = {}
    for name, root in fixture_roots.items():
        files[name] = sorted(os.path.relpath(os.path.join(d, f), root)
                             for d, _, fs in os.walk(root) for f in fs)
    assert files["port"] == files["jax"]
    assert any(f.endswith(".png") for f in files["jax"])
    for rel in files["jax"]:
        with open(os.path.join(fixture_roots["jax"], rel), "rb") as f:
            want = f.read()
        with open(os.path.join(fixture_roots["port"], rel), "rb") as f:
            assert f.read() == want, rel


def _dataset_cfg(root, max_points):
    cfg = jcfg.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.max_points = max_points
    cfg.dataset.video_train_ids = (0,)
    cfg.dataset.aug_list = (jaug.AUG_FLIPPING, jaug.AUG_PCA_JITTER)
    return cfg


@pytest.mark.parametrize("max_points", [1024, 16384],
                         ids=["subsampled", "padded"])
@pytest.mark.parametrize("augs", [(), ("flipping",),
                                  ("flipping", "pca_jitter")],
                         ids=["none", "flip", "flip_pca"])
def test_load_couple_sample_for_sample(fixture_roots, max_points, augs):
    """Every couple of both videos, every key, bitwise, under the same
    generator; the port reads its camera images through
    _camera_image."""
    cfg = _dataset_cfg(fixture_roots["jax"], max_points)
    jds = jtracking.KittiTrackingDataset(cfg.dataset, split="trainval")
    tds = ttracking.KittiTrackingDataset(config_from_json(cfg).dataset,
                                         split="trainval")
    assert_same([vars(c) for c in tds.couples],
                [vars(c) for c in jds.couples])
    assert len(jds.couples) == 8
    for idx in range(len(jds.couples)):
        want = jds.load_couple(idx, augs, np.random.RandomState(idx))
        got = tds.load_couple(idx, augs, np.random.RandomState(idx))
        assert_same(got, want, f"couple {idx}")


def test_next_batch_and_splits_equal(fixture_roots):
    """Epoch shuffling, sampled augmentations and stacking over three
    batches; the four splits' couples at stride 2."""
    cfg = _dataset_cfg(fixture_roots["jax"], 1024)
    cfg.dataset.data_stride = 2
    tcfg_ = config_from_json(cfg).dataset
    for split in ("train", "val", "trainval", "test"):
        assert_same([vars(c) for c in ttracking.KittiTrackingDataset(
            tcfg_, split=split).couples],
            [vars(c) for c in jtracking.KittiTrackingDataset(
                cfg.dataset, split=split).couples], split)
    jds = jtracking.KittiTrackingDataset(cfg.dataset, split="train")
    tds = ttracking.KittiTrackingDataset(tcfg_, split="train")
    for i in range(3):
        assert_same(tds.next_batch(2), jds.next_batch(2), f"batch {i}")


def test_kitti_readers_and_ego_transforms_equal(fixture_roots):
    """Labels (with and without DontCare, filtered), calibration, lidar,
    FOV filter, planes, oxts, ego motion and every box and point
    transform, over the ego-motion video's frame pairs."""
    base = os.path.join(fixture_roots["jax"], "training")
    lab_dir, calib_dir = (os.path.join(base, "label_02"),
                          os.path.join(base, "calib"))
    oxts_dir = os.path.join(base, "oxts")
    calib = jkitti.read_tracking_calibration(calib_dir, 1)
    assert_same(tkitti.read_tracking_calibration(calib_dir, 1), calib)
    rng = np.random.RandomState(9)
    for vid in (0, 1):
        for frame in (None, 1):
            for dc in (False, True):
                want = jkitti.read_tracking_labels(lab_dir, vid, frame, dc)
                assert_same(tkitti.read_tracking_labels(lab_dir, vid, frame,
                                                        dc), want)
                assert_same(tkitti.filter_labels(want, ("Car",), 1, 2),
                            jkitti.filter_labels(want, ("Car",), 1, 2))
        velo_dir = os.path.join(base, "velodyne", f"{vid:04d}")
        velo = jkitti.read_lidar(velo_dir, "000002")
        assert_same(tkitti.read_lidar(velo_dir, "000002"), velo)
        cam = jkitti.lidar_to_cam_frame(velo[:, :3], calib)
        assert_same(tkitti.lidar_to_cam_frame(velo[:, :3], calib), cam)
        assert_same(tkitti.filter_to_image_fov(cam, calib, (375, 1242)),
                    jkitti.filter_to_image_fov(cam, calib, (375, 1242)))
        planes = os.path.join(base, "planes", f"{vid:04d}")
        assert_same(tkitti.read_ground_plane(planes, "000001"),
                    jkitti.read_ground_plane(planes, "000001"))
    labels = jkitti.read_tracking_labels(lab_dir, 1, 3)
    boxes = labels.box_3d
    for a, b in ((0, 3), (1, 2), (2, 2), (3, 0)):
        oa, ob = (jkitti.read_oxts(oxts_dir, 1, f) for f in (a, b))
        assert_same(tkitti.read_oxts(oxts_dir, 1, b), ob)
        ego = jkitti.ego_motion(oa, ob)
        assert_same(tkitti.ego_motion(oa, ob), ego)
        assert tkitti.is_identity_ego(*ego) == jkitti.is_identity_ego(*ego)
        trans, matrix, dyaw = ego
        for inverse in (False, True):
            assert_same(tkitti.transform_boxes_3d(boxes, calib, *ego,
                                                  inverse=inverse),
                        jkitti.transform_boxes_3d(boxes, calib, *ego,
                                                  inverse=inverse))
        assert_same(tkitti.transform_labels_to_prev_frame(labels, calib,
                                                          *ego),
                    jkitti.transform_labels_to_prev_frame(labels, calib,
                                                          *ego))
        assert_same(tkitti.inverse_transform_labels(labels, calib, *ego),
                    jkitti.inverse_transform_labels(labels, calib, *ego))
        pts = rng.uniform(-20, 20, (50, 3))
        assert_same(tkitti.transform_points_to_prev_frame(pts, trans,
                                                          matrix),
                    jkitti.transform_points_to_prev_frame(pts, trans,
                                                          matrix))
        assert_same(tkitti.ego_bev_affine(calib, trans, matrix),
                    jkitti.ego_bev_affine(calib, trans, matrix))


def test_augment_equal():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (20, 30, 3)).astype(np.uint8)
    pts = rng.uniform(-10, 10, (40, 3)).astype(np.float32)
    boxes = rng.uniform(-5, 5, (6, 7)).astype(np.float32)
    plane = np.array([0.01, -1.0, 0.02, 1.65], np.float32)
    p2 = rng.uniform(0, 700, (3, 4))
    for name, arg in (("flip_image", img), ("flip_points", pts),
                      ("flip_boxes_3d", boxes), ("flip_ground_plane", plane)):
        assert_same(getattr(taug, name)(arg), getattr(jaug, name)(arg))
    assert_same(taug.flip_calib_p2(p2, (375, 1242)),
                jaug.flip_calib_p2(p2, (375, 1242)))
    assert_same(taug.pca_jitter(img, np.random.RandomState(4)),
                jaug.pca_jitter(img, np.random.RandomState(4)))


def _det_boxes(rng, n):
    return np.stack([rng.uniform(-15, 15, n), np.full(n, 1.65),
                     rng.uniform(6, 50, n), rng.uniform(3.4, 4.4, n),
                     rng.uniform(1.5, 1.8, n), rng.uniform(1.4, 1.7, n),
                     rng.uniform(-np.pi, np.pi, n)], -1)


def test_kitti_writer_equal(fixture_roots):
    calib = jkitti.read_tracking_calibration(
        os.path.join(fixture_roots["jax"], "training", "calib"), 0)
    rng = np.random.RandomState(6)
    boxes = _det_boxes(rng, 30)
    boxes[:3, 2] = [-5.0, 0.05, 200.0]            # behind, at, far away
    scores = rng.uniform(0, 1, 30)
    cls = rng.randint(0, 2, 30)
    for b in boxes:
        assert_same(twriter.project_box_to_image(b, calib, (1242, 375)),
                    jwriter.project_box_to_image(b, calib, (1242, 375)))
    want = jwriter.predictions_to_kitti_lines(
        boxes, scores, cls, calib, (1242, 375), ("Car", "Van"), 0.2)
    assert want and twriter.predictions_to_kitti_lines(
        boxes, scores, cls, calib, (1242, 375), ("Car", "Van"), 0.2) == want
    by_frame = {3: [{"box_3d": b, "score": s, "class_idx": int(c),
                     "offsets": rng.normal(size=3), "offsets_span": 3,
                     "coexist": 0.7} for b, s, c in zip(boxes, scores, cls)],
                6: [{"box_3d": boxes[0], "score": 0.5, "offsets": None}]}
    lines = jwriter.couple_detections_to_lines(by_frame, ("Car", "Van"))
    assert twriter.couple_detections_to_lines(by_frame,
                                              ("Car", "Van")) == lines
    assert_same(twriter.parse_couple_lines(lines, ("Car", "Van")),
                jwriter.parse_couple_lines(lines, ("Car", "Van")))
    for path, mod in ((fixture_roots["port"], twriter),
                      (fixture_roots["jax"], jwriter)):
        mod.write_kitti_file(os.path.join(path, "pred.txt"), lines)
        mod.write_kitti_file(os.path.join(path, "empty.txt"), [])
    for name in ("pred.txt", "empty.txt"):
        with open(os.path.join(fixture_roots["port"], name)) as f:
            got = f.read()
        with open(os.path.join(fixture_roots["jax"], name)) as f:
            assert got == f.read()


def _ap_scene(rng, mod, n_frames=12):
    """GT with Car, Van and Pedestrian, DontCare regions; detections
    near the GT plus false positives."""
    gts, dets = [], []
    for _ in range(n_frames):
        g = rng.randint(1, 6)
        boxes = _det_boxes(rng, g)
        bbs = np.stack([rng.uniform(0, 800, g), rng.uniform(0, 200, g),
                        np.zeros(g), np.zeros(g)], 1)
        bbs[:, 2] = bbs[:, 0] + rng.uniform(20, 200, g)
        bbs[:, 3] = bbs[:, 1] + rng.uniform(20, 120, g)
        types = list(rng.choice(["Car", "Car", "Van", "Pedestrian"], g))
        dc = np.array([[900.0, 100.0, 1000.0, 180.0]])[:rng.randint(0, 2)]
        gts.append(mod.FrameGt(boxes, bbs, types,
                               rng.randint(0, 3, g).astype(float),
                               rng.uniform(0, 0.6, g), dc))
        keep = rng.rand(g) > 0.2
        n_fp = rng.randint(0, 3)
        d_boxes = np.concatenate([boxes[keep] + rng.normal(
            0, 0.15, (keep.sum(), 7)), _det_boxes(rng, n_fp)])
        fp_bbs = rng.uniform(0, 900, (n_fp, 4))
        fp_bbs[:, 2:] = fp_bbs[:, :2] + rng.uniform(20, 90, (n_fp, 2))
        d_bbs = np.concatenate([bbs[keep] + rng.normal(0, 4, (keep.sum(),
                                                               4)), fp_bbs])
        d_types = list(rng.choice(["Car", "Pedestrian"], len(d_boxes)))
        dets.append(mod.FrameDet(d_boxes, d_bbs,
                                 rng.uniform(0.05, 1, len(d_boxes)),
                                 d_types))
    return gts, dets


@pytest.mark.parametrize("cls,metric,min_iou", [
    ("Car", "image", 0.7), ("Car", "ground", 0.7), ("Car", "3d", 0.7),
    ("Car", "3d", 0.5), ("Pedestrian", "ground", 0.5)])
def test_evaluate_ap_equal_on_both_routes(cls, metric, min_iou):
    """The port's Python route equals the JAX Python route exactly; the
    port's native library, built into build/native/, to 1e-9; route()
    names the route taken."""
    assert tnative.build()
    jg, jd = _ap_scene(np.random.RandomState(12), jap)
    tg, td = _ap_scene(np.random.RandomState(12), tap)
    want = jap.evaluate_ap(jg, jd, cls, metric, min_iou, use_native=False)
    assert any(v > 0 for v in want.values())
    got_py = tap.evaluate_ap(tg, td, cls, metric, min_iou, use_native=False)
    assert tnative.route() == "python"
    assert_same(got_py, want)
    got_cc = tap.evaluate_ap(tg, td, cls, metric, min_iou)
    assert tnative.route() == "native"
    assert got_cc.keys() == want.keys()
    for k in want:
        assert abs(got_cc[k] - want[k]) <= 1e-9, (k, got_cc[k], want[k])


def test_native_loader_equals_the_jax_native_loader(fixture_roots):
    base = os.path.join(fixture_roots["jax"], "training")
    calib = jkitti.read_tracking_calibration(os.path.join(base, "calib"), 1)
    velo_to_rect = (calib.r0 @ np.vstack(
        [calib.velo_to_cam, [0, 0, 0, 1]])[:3])[:3]
    path = os.path.join(base, "velodyne", "0001", "000002.bin")
    ego = jkitti.ego_motion(*(jkitti.read_oxts(os.path.join(base, "oxts"),
                                               1, f) for f in (0, 2)))
    assert tnative.build() and (jnative.available() or jnative.build())
    for args in ((), (ego[0], ego[1])):
        want = jnative.load_velodyne_cam(path, velo_to_rect, calib.p2,
                                         (375, 1242), *args)
        got = tnative.load_velodyne_cam(path, velo_to_rect, calib.p2,
                                        (375, 1242), *args)
        assert len(want) > 100
        # the JAX package's library is built with -march=native (fused
        # multiply-adds): float32 rounding apart
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_np_iou_equal():
    rng = np.random.RandomState(8)
    a, b = _det_boxes(rng, 9), _det_boxes(rng, 7)
    b[:3] = a[:3] + rng.normal(0, 0.3, (3, 7))      # overlapping pairs
    assert_same(tiou.three_d_iou_matrix(a, b), jiou.three_d_iou_matrix(a, b))
    assert_same(tiou.three_d_iou(a[0], b), jiou.three_d_iou(a[0], b))
    bev = [0, 2, 3, 4, 6]
    assert_same(tiou.rotated_iou(a[0][bev], b[:, bev]),
                jiou.rotated_iou(a[0][bev], b[:, bev]))
    assert_same(tiou.rect_intersection_area(a[1][bev], b[1][bev]),
                jiou.rect_intersection_area(a[1][bev], b[1][bev]))
    assert_same(tiou.rect_intersection_areas(a[2][bev], b[:, bev]),
                jiou.rect_intersection_areas(a[2][bev], b[:, bev]))
    assert_same(tiou.box_3d_corners(a[0]), jiou.box_3d_corners(a[0]))
    bb_a = np.sort(rng.uniform(0, 100, (9, 2, 2)), 1).transpose(0, 2, 1)
    bb_a = bb_a.reshape(9, 4)[:, [0, 2, 1, 3]]
    bb_b = bb_a[:7] + rng.normal(0, 5, (7, 4))
    assert_same(tiou.aligned_iou_2d_matrix(bb_a, bb_b),
                jiou.aligned_iou_2d_matrix(bb_a, bb_b))
    assert_same(tiou.aligned_iou_2d(bb_a[0], bb_b),
                jiou.aligned_iou_2d(bb_a[0], bb_b))


def _track_dets(rng, n_frames, ego):
    """Cars moving along their offsets, with misses, clutter, random
    scores and (with ego) box_aligned in the previous frame's
    coordinates."""
    starts = _det_boxes(rng, 5)
    vel = rng.uniform(-1, 1, (5, 3)) * [1.0, 1.5, 0.05]
    frames = []
    for f in range(n_frames):
        dets = []
        for k in range(5):
            if rng.rand() < 0.15:
                continue
            box = starts[k].copy()
            box[[0, 2, 6]] += vel[k] * f + rng.normal(0, 0.05, 3)
            d = {"frame_id": f, "box_3d": box,
                 "score": float(rng.uniform(0.3, 1)),
                 "offsets": vel[k] + rng.normal(0, 0.05, 3),
                 "coexist": float(rng.uniform(0, 1))}
            if ego:
                d["box_aligned"] = box + [0, 0, 0.4, 0, 0, 0, 0]
            dets.append(d)
        frames.append(dets)
    return frames


@pytest.mark.parametrize("ego", [False, True])
def test_track_through_ious_equal(ego):
    frames = _track_dets(np.random.RandomState(20 + ego), 8, ego)
    for kw in ({}, {"ttl": 2, "frame_gaps": [0, 1, 1, 3, 1, 1, 3, 1]}):
        want = jtracker.track_through_ious(frames, 0.6, 0.1, 2, **kw)
        assert want
        assert_same(ttracker.track_through_ious(frames, 0.6, 0.1, 2, **kw),
                    want)
    assert_same(ttracker.trajectories_to_kitti(want),
                jtracker.trajectories_to_kitti(want))


@pytest.mark.parametrize("num_frames", [2, 3, 4])
def test_interpolate_non_keyframes_equal(num_frames):
    rng = np.random.RandomState(30 + num_frames)
    frames = _track_dets(rng, num_frames, False)
    d0, d1 = frames[0], frames[-1]
    for d in d0[::2]:
        del d["coexist"]                      # no coexist head: 0.5
    want = jmoi.interpolate_non_keyframes(d0, d1, num_frames, 0.4)
    assert_same(tmoi.interpolate_non_keyframes(d0, d1, num_frames, 0.4),
                want)
    assert_same(tmoi.match_pairs(d0, d1), jmoi.match_pairs(d0, d1))


def _mot_sequence(rng, n_frames=10):
    """GT tracks (car, van, pedestrian; truncation and occlusion;
    DontCare) and predictions near them with id switches, misses and
    false positives."""
    n = 6
    start = rng.uniform(0, 900, (n, 2))
    size = rng.uniform(15, 120, (n, 2))
    vel = rng.uniform(-15, 15, (n, 2))
    types = rng.choice(["car", "car", "van", "pedestrian"], n)
    gt_frames, pred_frames = [], []
    for f in range(n_frames):
        alive = [k for k in range(n) if rng.rand() > 0.1]
        boxes = [np.concatenate([start[k] + vel[k] * f,
                                 start[k] + vel[k] * f + size[k]])
                 for k in alive]
        gt_frames.append({
            "ids": list(alive), "boxes": boxes,
            "types": [types[k] for k in alive],
            "truncation": list(rng.randint(0, 3, len(alive))),
            "occlusion": list(rng.randint(0, 4, len(alive))),
            "dontcare": [np.array([950.0, 0.0, 1100.0, 300.0])]})
        ids, pboxes = [], []
        for k, b in zip(alive, boxes):
            if rng.rand() < 0.2:
                continue
            ids.append(k if rng.rand() > 0.1 else k + 10)
            pboxes.append(b + rng.normal(0, 4, 4))
        for j in range(rng.randint(0, 3)):
            x = rng.uniform(0, 1000, 2)
            ids.append(20 + j)
            pboxes.append(np.concatenate([x, x + 40]))
        pred_frames.append({"ids": ids, "boxes": pboxes})
    return gt_frames, pred_frames


@pytest.mark.parametrize("cls", ["car", "pedestrian"])
def test_mot_scorer_equal(cls):
    seqs = [_mot_sequence(np.random.RandomState(s)) for s in (40, 41)]
    for gt, pred in seqs:
        want = jmot.evaluate_tracking(gt, pred, cls=cls)
        assert_same(tmot.evaluate_tracking(gt, pred, cls=cls), want)
    pooled = {}
    for name, mod in (("port", tmot), ("jax", jmot)):
        ev = mod.MotEvaluator(cls=cls)
        for gt, pred in seqs:
            ev.add_sequence(gt, pred)
        pooled[name] = ev.results()
    assert pooled["jax"]["TP"] > 0
    assert_same(pooled["port"], pooled["jax"])


def test_get_clusters_equal(fixture_roots, tmp_path):
    """k-means clusters per class from each package's dataset (Car from
    the labels, Pedestrian from the priors), through the txt cache and
    back."""
    cfg = _dataset_cfg(fixture_roots["jax"], 1024)
    cfg.dataset.classes = ("Car", "Pedestrian")
    cfg.dataset.num_clusters = (2, 1)
    jds = jtracking.KittiTrackingDataset(cfg.dataset, split="trainval")
    tds = ttracking.KittiTrackingDataset(config_from_json(cfg).dataset,
                                         split="trainval")
    for _ in range(2):                            # computed, then cached
        want = jclusters.get_clusters(jds, cfg, str(tmp_path / "jax"))
        assert len(want) == 3
        assert_same(tclusters.get_clusters(tds, cfg, str(tmp_path / "port")),
                    want)
    assert_same(tclusters.get_clusters(tds, cfg),
                jclusters.get_clusters(jds, cfg))
    pts = np.random.RandomState(3).uniform(1, 5, (40, 3))
    assert_same(tclusters.kmeans(pts, 3), jclusters.kmeans(pts, 3))


# ---------------------------------------------------------------------------
# The single-frame and Stack datasets: the object fixture writer byte for
# byte, KittiDataset.load_sample and KittiTrackingStackDataset.load_stack
# bitwise, merge_track_boxes and the clusters over both.

from dodt_tpu.data import detection as jdetection
from dodt_tpu.data import stack as jstack
from dodt_tpu_torch.data import detection as tdetection
from dodt_tpu_torch.data import stack as tstack


@pytest.fixture(scope="module")
def object_roots(tmp_path_factory):
    """The object fixture (two scenes of three frames) written by both
    packages."""
    roots = {}
    for name, mod in (("jax", jsynth), ("port", tsynth)):
        roots[name] = str(tmp_path_factory.mktemp("obj_" + name) / "kitti")
        mod.write_detection_fixture(roots[name], num_frames=3, num_scenes=2)
    return roots


def test_write_detection_fixture_byte_for_byte(object_roots):
    files = {}
    for name, root in object_roots.items():
        files[name] = sorted(os.path.relpath(os.path.join(d, f), root)
                             for d, _, fs in os.walk(root) for f in fs)
    assert files["port"] == files["jax"]
    assert sum(f.endswith(".png") for f in files["jax"]) == 6
    for rel in files["jax"]:
        with open(os.path.join(object_roots["jax"], rel), "rb") as f:
            want = f.read()
        with open(os.path.join(object_roots["port"], rel), "rb") as f:
            assert f.read() == want, rel


@pytest.mark.parametrize("max_points", [1024, 16384],
                         ids=["subsampled", "padded"])
@pytest.mark.parametrize("augs", [(), ("flipping",),
                                  ("flipping", "pca_jitter")],
                         ids=["none", "flip", "flip_pca"])
def test_load_sample_sample_for_sample(object_roots, max_points, augs):
    """Every sample, every key, bitwise, under the same generator; the
    port reads its camera image through _camera_image."""
    cfg = _dataset_cfg(object_roots["jax"], max_points)
    jds = jdetection.KittiDataset(cfg.dataset, split="trainval")
    tds = tdetection.KittiDataset(config_from_json(cfg).dataset,
                                  split="trainval")
    assert tds.sample_names == jds.sample_names and len(jds) == 6
    for idx in range(len(jds)):
        want = jds.load_sample(idx, augs, np.random.RandomState(idx))
        got = tds.load_sample(idx, augs, np.random.RandomState(idx))
        assert_same(got, want, f"sample {idx}")


def test_merge_track_boxes_equal():
    rng = np.random.RandomState(11)
    for n in (1, 2, 4):
        boxes = _det_boxes(rng, n).astype(np.float32)
        boxes[1:, :3] = boxes[0, :3] + rng.normal(0, 0.8, (n - 1, 3))
        boxes[1:, 6] = boxes[0, 6] + rng.normal(0, 0.1, n - 1)
        assert_same(tstack.merge_track_boxes(boxes),
                    jstack.merge_track_boxes(boxes))


@pytest.mark.parametrize("max_points", [1024, 16384],
                         ids=["subsampled", "padded"])
@pytest.mark.parametrize("augs", [(), ("flipping",),
                                  ("flipping", "pca_jitter")],
                         ids=["none", "flip", "flip_pca"])
def test_load_stack_sample_for_sample(fixture_roots, max_points, augs):
    """Every stack (data_stride 2: three frames, the last ones clamped at
    the video end) of both videos, every key, bitwise."""
    cfg = _dataset_cfg(fixture_roots["jax"], max_points)
    cfg.dataset.data_stride = 2
    jds = jstack.KittiTrackingStackDataset(cfg.dataset, split="trainval")
    tds = tstack.KittiTrackingStackDataset(config_from_json(cfg).dataset,
                                           split="trainval")
    assert tds.num_frames == jds.num_frames == 3
    for idx in range(len(jds.couples)):
        want = jds.load_stack(idx, augs, np.random.RandomState(idx))
        got = tds.load_stack(idx, augs, np.random.RandomState(idx))
        assert_same(got, want, f"stack {idx}")


def test_detection_and_stack_next_batch_equal(fixture_roots, object_roots):
    """Epoch shuffling, sampled augmentations and stacking over three
    batches of each dataset."""
    for root, jcls, tcls in (
            (object_roots["jax"], jdetection.KittiDataset,
             tdetection.KittiDataset),
            (fixture_roots["jax"], jstack.KittiTrackingStackDataset,
             tstack.KittiTrackingStackDataset)):
        cfg = _dataset_cfg(root, 1024)
        cfg.dataset.data_stride = 2
        jds = jcls(cfg.dataset, split="train")
        tds = tcls(config_from_json(cfg).dataset, split="train")
        for i in range(3):
            assert_same(tds.next_batch(2, augment=True),
                        jds.next_batch(2, augment=True), f"batch {i}")


def test_get_clusters_over_both_new_datasets(fixture_roots, object_roots):
    for root, jcls, tcls in (
            (object_roots["jax"], jdetection.KittiDataset,
             tdetection.KittiDataset),
            (fixture_roots["jax"], jstack.KittiTrackingStackDataset,
             tstack.KittiTrackingStackDataset)):
        cfg = _dataset_cfg(root, 1024)
        cfg.dataset.classes = ("Car", "Pedestrian")
        cfg.dataset.num_clusters = (2, 1)
        want = jclusters.get_clusters(jcls(cfg.dataset, split="trainval"),
                                      cfg)
        assert len(want) == 3
        assert_same(tclusters.get_clusters(
            tcls(config_from_json(cfg).dataset, split="trainval"), cfg),
            want)


# ---------------------------------------------------------------------------
# The entry points' host copies: format checker, reporting, viz, the Kalman
# tracker, the MOT scenarios and the offline video MOT, equal on seeded
# inputs (viz: the decoded PNG pixels).

from dodt_tpu import viz as jviz
from dodt_tpu.eval import reporting as jrep
from dodt_tpu.runtime import video as jvideo
from dodt_tpu.tracking import kalman as jkalman
from dodt_tpu.tracking import scenarios as jscen
from dodt_tpu.utils import format_checker as jfmt
from dodt_tpu_torch import viz as tviz
from dodt_tpu_torch.eval import reporting as trep
from dodt_tpu_torch.runtime import video as tvideo
from dodt_tpu_torch.tracking import kalman as tkalman
from dodt_tpu_torch.tracking import scenarios as tscen
from dodt_tpu_torch.utils import format_checker as tfmt


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:                # the error's type and text
        return (type(e).__name__, str(e))


def test_format_checker_equal():
    good = {"box_3d": np.zeros((4, 7)), "anchor": np.ones((2, 6)),
            "box_4c": np.zeros((3, 10)), "box_8c": np.zeros((5, 3, 8)),
            "bev_box": np.zeros((2, 4))}
    bad_3d = np.zeros((1, 7))
    bad_3d[0, 3] = -1
    cases = [(name, x) for name, x in good.items()] + [
        ("box_3d", np.zeros((4, 6))), ("box_3d", bad_3d),
        ("anchor", np.zeros((2, 6))), ("box_4c", np.zeros((3, 9))),
        ("box_8c", np.zeros((5, 8, 3))), ("bev_box", np.zeros((2, 5)))]
    for name, x in cases:
        got = _outcome(getattr(tfmt, f"check_{name}"), x)
        want = _outcome(getattr(jfmt, f"check_{name}"), x)
        assert got[0] == want[0] and str(got[1]) == str(want[1]), name
    assert issubclass(tfmt.FormatError, ValueError)


def _results(step, ap3, mota, health):
    r = {"step": step,
         "ap": {m: {"easy": ap3 + 1, "moderate": ap3, "hard": ap3 - 1}
                for m in ("AP_3D", "AP_BEV", "AP_2D")},
         "mot": {"overall": {"MOTA": mota}}}
    if health:
        r["val_health"] = {"val_losses": {"total": 0.5 + step / 100},
                           "proposal_recall": {"iou_0.5": 0.25}}
    return r


def _pixels(path):
    import matplotlib.image
    return matplotlib.image.imread(path)


def test_reporting_equal(tmp_path):
    out = tmp_path / "eval"
    out.mkdir()
    for i, (step, ap3) in enumerate([(30, 41.5), (10, 12.25), (20, 55.0)]):
        with open(out / f"results_{step}.json", "w") as f:
            json.dump(_results(step, ap3, 60.0 + i, health=i > 0), f)
    metrics = tmp_path / "train_metrics.jsonl"
    metrics.write_text('{"step": 10, "total": 2.5}\n\n{"step": 5, '
                       '"total": 3.0}\n{"step": 20, "tot')   # cut tail
    results = trep.load_results(str(out))
    assert_same(results, jrep.load_results(str(out)))
    for k in (1, 5):
        assert_same(trep.top_checkpoints(results, "AP_BEV", "hard", k),
                    jrep.top_checkpoints(results, "AP_BEV", "hard", k))
    tm = trep.load_train_metrics(str(metrics))
    assert_same(tm, jrep.load_train_metrics(str(metrics)))
    assert trep.load_train_metrics(str(tmp_path / "none.jsonl")) == []
    for train_metrics in (None, tm):
        assert trep.format_table(results, train_metrics) == \
            jrep.format_table(results, train_metrics)
    np.testing.assert_array_equal(
        _pixels(trep.plot_ap(results, str(tmp_path / "t.png"))),
        _pixels(jrep.plot_ap(results, str(tmp_path / "j.png"))))


def test_viz_equal(tmp_path):
    """Every drawing: the same PNG pixels."""
    rng = np.random.RandomState(5)
    bev = rng.rand(70, 80, 6).astype(np.float32)
    boxes = np.array([[0.0, 1.6, 3.0, 3.9, 1.6, 1.5, 0.3],
                      [1.0, 1.6, 5.0, 3.9, 1.6, 1.5, -1.1]])
    img = rng.randint(0, 255, (100, 300, 3)).astype(np.uint8)
    pts = rng.rand(2000, 4).astype(np.float32) * [8, 3, 7, 1]
    calls = [
        ("draw_bev", (bev, [[-4, 4], [-3, 3], [0, 7]]),
         {"gt_boxes": boxes, "pred_boxes": boxes, "scores": [0.9, 0.4]}),
        ("draw_image_boxes", (img, [(10, 10, 60, 60)], [0.5]), {}),
        ("draw_point_cloud_3d", (pts,),
         {"gt_boxes": boxes, "pred_boxes": boxes,
          "track_ids": np.array([0, 3])}),
        ("draw_point_cloud_3d", (pts,),
         {"pred_boxes": boxes[:1], "scores": [0.7]})]
    for i, (name, args, kw) in enumerate(calls):
        got = getattr(tviz, name)(*args, path=str(tmp_path / f"t{i}.png"),
                                  **kw)
        want = getattr(jviz, name)(*args, path=str(tmp_path / f"j{i}.png"),
                                   **kw)
        np.testing.assert_array_equal(_pixels(got), _pixels(want),
                                      err_msg=name)


def test_scenarios_equal():
    """The scenario generators bit for bit, and the MoI tracking run
    over the birth/death scenario."""
    for kw in ({}, {"n_frames": 20, "noise": 0.1, "seed": 3}):
        assert_same(tscen.hard_mot_scenario(**kw),
                    jscen.hard_mot_scenario(**kw))
    for kw in ({}, {"n_frames": 21, "tau": 3, "seed": 2}):
        got = tscen.birth_death_scenario(**kw)
        assert_same(got, jscen.birth_death_scenario(**kw))
        gt, couples = got
        n = len(gt)
        assert_same(tscen.run_moi_tracking(gt, couples, n),
                    jscen.run_moi_tracking(gt, couples, n))
    poses = tscen.ego_poses(6, speed=1.5)
    assert_same(poses, jscen.ego_poses(6, speed=1.5))
    boxes = tscen.hard_mot_scenario(n_frames=4)[1][2]
    b = np.stack([d["box_3d"] for d in boxes])
    assert_same(tscen.make_ego_fn(poses)(1, 2, b),
                jscen.make_ego_fn(poses)(1, 2, b))
    assert_same(tscen.project_box(b[0]), jscen.project_box(b[0]))


@pytest.mark.parametrize("ego", [False, True])
def test_kf_pipeline_equal(ego):
    _, dets = jscen.hard_mot_scenario(n_frames=24, seed=1)
    ego_fn = jscen.make_ego_fn(jscen.ego_poses(24, speed=1.0)) if ego \
        else None
    for kw in ({}, {"iou_threshold": 0.1, "max_misses": 1, "min_hits": 3}):
        assert_same(tkalman.kf_pipeline(dets, ego_fn=ego_fn, **kw),
                    jkalman.kf_pipeline(dets, ego_fn=ego_fn, **kw))


def _video_dets(scene, frames):
    return {0: {f: [{"box_3d": np.asarray(b, float), "score": 0.9,
                     "bbox_2d": np.array([100.0, 100, 180, 160]),
                     "type": "Car", "offsets": np.zeros(3),
                     "coexist": 1.0}
                    for _, b in scene.camera_boxes_at(f)] for f in frames}}


@pytest.mark.parametrize("tracker", ["iou", "kf"])
def test_run_video_pipeline_equal(tmp_path, tracker):
    """Both arms, with and without the ego callbacks built from each
    package's own dataset, and the MOT scores of the lines."""
    root = str(tmp_path / "kitti")
    jsynth.write_tracking_fixture(root, num_videos=1, num_frames=7,
                                  ego_speed=2.0, num_cars=3, seed=4)
    cfg = jcfg.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.video_train_ids = (0,)
    jds = jtracking.KittiTrackingDataset(cfg.dataset, split="trainval")
    tds = ttracking.KittiTrackingDataset(config_from_json(cfg).dataset,
                                         split="trainval")
    scene = jsynth.SyntheticScene(0, 7, num_cars=3, seed=4, ego_speed=2.0)
    for cb in (False, True):
        kw = dict(tracker=tracker, stride=3, sigma_iou=0.01, t_min=2)
        tkw, jkw = dict(kw), dict(kw)
        if cb:
            tkw.update(align_fn=tvideo.dataset_align_fn(tds),
                       ego_fn=tvideo.dataset_ego_fn(tds))
            jkw.update(align_fn=jvideo.dataset_align_fn(jds),
                       ego_fn=jvideo.dataset_ego_fn(jds))
        got = tvideo.run_video_pipeline(_video_dets(scene, (0, 3, 6)), **tkw)
        want = jvideo.run_video_pipeline(_video_dets(scene, (0, 3, 6)),
                                         **jkw)
        assert got == want, cb
        assert got[0] or not cb         # the ego-aligned runs keep tracks
        assert_same(tvideo.score_tracking(got, tds.labels),
                    jvideo.score_tracking(want, jds.labels))


def test_video_file_loaders_equal(tmp_path):
    """load_kitti_detections and load_couple_detections over the same
    files, and the offline IoU run scoring like the in-memory one on
    the hard scenario (tests/test_video_pipeline.py's check)."""
    n = 16
    gt, dets = tscen.hard_mot_scenario(n_frames=n)
    couples_dir, frames_dir = tmp_path / "couples", tmp_path / "frames"
    couples_dir.mkdir()
    frames_dir.mkdir()
    for f in range(n - 1):
        twriter.write_kitti_file(
            str(couples_dir / f"00{f:04d}_00{f + 1:04d}.txt"),
            twriter.couple_detections_to_lines({f: dets[f],
                                                f + 1: dets[f + 1]}))
    for f in range(n):
        with open(frames_dir / f"00{f:04d}.txt", "w") as fh:
            for d in dets[f]:
                x, y, z, l, w, h, ry = d["box_3d"]
                fh.write(f"Car -1 -1 -10 100.0 100.0 180.0 160.0 {h} {w} "
                         f"{l} {x} {y} {z} {ry} {d['score']}\n")
    assert_same(tvideo.load_kitti_detections(str(frames_dir)),
                jvideo.load_kitti_detections(str(frames_dir)))
    loaded = tvideo.load_couple_detections(str(couples_dir))
    assert_same(loaded, jvideo.load_couple_detections(str(couples_dir)))

    def score(seq):
        tracks = ttracker.track_through_ious(
            seq, high_threshold=0.85, iou_threshold=0.005, t_min=3, ttl=4)
        return tmot.evaluate_tracking(gt, tscen.tracks_to_pred_frames(
            tracks, n))

    r_mem = score(dets)
    r_file = score([loaded[0].get(f, []) for f in range(n)])
    for k in ("MOTA", "IDS", "FN", "FP", "MT", "ML"):
        assert r_mem[k] == r_file[k], k
