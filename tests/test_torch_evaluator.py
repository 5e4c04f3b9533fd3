"""The port's evaluator (dodt_tpu_torch.runtime.evaluator) against the
JAX one on synthetic tracking fixtures, from the same checkpointed
parameters: the JAX orbax checkpoint, converted with flax_to_state_dict
and saved through the port's CheckpointIO.

- predict_couples: the same detections per couple and frame;
- the JAX run_checkpoint_once scoring the port's predictions gives the
  JAX results;
- the port's own run_checkpoint_once gives the JAX results JSON and the
  same prediction and couple files, on one static video at data_stride 1
  and on a static and an ego-motion video at data_stride 3 (far-keyframe
  recovery and MoI).

Tolerances: boxes 1e-4 (metres), scores and correlation offsets 1e-5
(f32 summation-order rounding); AP and MOT numbers 1e-6. In the files,
numbers are compared at those tolerances plus one unit of their printed
precision (1e-3 in the frame files, 1e-6 in the couple files), and the
image boxes to 0.05 px (1e-4 m moves a projected corner by under 0.01 px
at the fixture's depths of 7 m and more); detection counts, classes,
file names and the score-threshold decisions are equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dodt_tpu import config as cfg_mod
from dodt_tpu.data import synthetic, tracking
from dodt_tpu.models import dt_avod as jdt
from dodt_tpu.runtime.evaluator import Evaluator as JaxEvaluator
from dodt_tpu.runtime.trainer import CheckpointIO as JaxCheckpointIO
from dodt_tpu.runtime.trainer import create_train_state
from dodt_tpu_torch.convert import config_from_json, flax_to_state_dict
from dodt_tpu_torch.data import tracking as ttracking
from dodt_tpu_torch.models import dt_avod as tdt
from dodt_tpu_torch.runtime.evaluator import Evaluator
from dodt_tpu_torch.runtime.trainer import CheckpointIO, TrainState

CLUSTERS = ((3.9, 1.6, 1.52),)


def _cfg(root, stride=1, train_ids=()):
    cfg = cfg_mod.unittest_pipeline()
    cfg.dataset.dataset_dir = root
    cfg.dataset.data_stride = stride
    cfg.dataset.video_train_ids = train_ids
    cfg.dataset.max_points = 4096
    cfg.eval.batch_size = 3           # the last chunk is padded
    # random weights score about 0.5: let every detection start and keep
    # a track, so the MOT scorer sees the boxes
    cfg.eval.track_lth = cfg.eval.track_hth = 0.0
    cfg.eval.track_tmin = 1
    return cfg


def _port_checkpoint(ckpt_dir, step, params):
    """The JAX parameters, converted, as the port's checkpoint."""
    sd = flax_to_state_dict(params)
    CheckpointIO(ckpt_dir).save(step, TrainState(step=step, params=sd,
                                                 opt_state={}))


def _port_model(cfg, params=None):
    model = tdt.DtAvodNet(config_from_json(cfg), CLUSTERS)
    if params is not None:
        model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def jax_params(tmp_path_factory):
    """A JAX train state's parameters, from the first fixture's couple."""
    root = str(tmp_path_factory.mktemp("init") / "kitti")
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=2)
    cfg = _cfg(root)
    ds = tracking.KittiTrackingDataset(cfg.dataset, split="val")
    batch = {k: jnp.asarray(v)[None]
             for k, v in ds.load_couple(0, augs=()).items()
             if isinstance(v, np.ndarray)}
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    state = create_train_state(cfg, jmodel, batch, jax.random.PRNGKey(0))
    return state._replace(step=np.int32(1))


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory, jax_params):
    tmp = tmp_path_factory.mktemp("eval_torch")
    root = str(tmp / "kitti")
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=5,
                                     ego_speed=0.5)
    cfg = _cfg(root, train_ids=(0,))
    ds = tracking.KittiTrackingDataset(cfg.dataset, split="trainval")
    jmodel = jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS)
    JaxCheckpointIO(str(tmp / "ckpt")).save(1, jax_params)
    jev = JaxEvaluator(cfg, jmodel, ds, ckpt_dir=str(tmp / "ckpt"),
                       output_dir=str(tmp / "eval_jax"))
    params = jax.tree_util.tree_map(np.asarray, jev.ckpt.restore_params(1))
    ev = Evaluator(config_from_json(cfg), _port_model(cfg, params), ds,
                   str(tmp / "ckpt_port"), str(tmp / "eval_port"),
                   device="cpu")
    return cfg, ds, jev, params, ev, tmp


@pytest.mark.parametrize("idxs", [[0, 1, 2], [3]], ids=["full", "padded"])
def test_predict_couples_match_jax(evaluators, idxs):
    _, ds, jev, params, ev, _ = evaluators
    want = jev.predict_couples(params, idxs)
    got = ev.predict_couples(idxs)
    assert len(got) == len(want) == len(idxs)
    n_dets = 0
    for g, w, idx in zip(got, want, idxs):
        assert g["couple"] == w["couple"] == ds.couples[idx]
        assert len(g["dets"]) == len(w["dets"]) == 2
        for gf, wf in zip(g["dets"], w["dets"]):
            assert len(gf) == len(wf)
            n_dets += len(gf)
            for gd, wd in zip(gf, wf):
                assert gd["class_idx"] == wd["class_idx"]
                np.testing.assert_allclose(gd["box_3d"], wd["box_3d"],
                                           atol=1e-4)
                np.testing.assert_allclose(gd["score"], wd["score"],
                                           atol=1e-5)
                if wd["offsets"] is None:
                    assert gd["offsets"] is None
                else:
                    np.testing.assert_allclose(gd["offsets"], wd["offsets"],
                                               atol=1e-5)
    assert n_dets > 0


def test_predict_couple_is_the_first_of_a_batch(evaluators):
    _, _, _, _, ev, _ = evaluators
    one, = ev.predict_couples([2])
    again = ev.predict_couple(2)
    assert one["couple"] == again["couple"]
    for a, b in zip(one["dets"], again["dets"]):
        assert [d["score"] for d in a] == [d["score"] for d in b]


def _assert_results_equal(got, want):
    """AP (both passes, every class, metric and difficulty) and every MOT
    number, per video and overall, to 1e-6."""
    for key in ("ap", "ap_per_class", "ap_05_per_class"):
        assert got[key].keys() == want[key].keys(), key
    for key in ("ap_per_class", "ap_05_per_class"):
        for cls, metrics in want[key].items():
            assert got[key][cls].keys() == metrics.keys()
            for metric, by_diff in metrics.items():
                assert got[key][cls][metric].keys() == by_diff.keys()
                for diff, v in by_diff.items():
                    np.testing.assert_allclose(
                        got[key][cls][metric][diff], v, atol=1e-6,
                        err_msg=f"{key}/{cls}/{metric}/{diff}")
    assert got["mot"].keys() == want["mot"].keys()
    for vid, res in want["mot"].items():
        assert got["mot"][vid].keys() == res.keys()
        for k, v in res.items():
            if isinstance(v, (int, float)):
                np.testing.assert_allclose(got["mot"][vid][k], v, atol=1e-6,
                                           err_msg=f"mot/{vid}/{k}")
    assert want["mot"]["overall"]["TP"] + want["mot"]["overall"]["FP"] > 0


def test_scores_match_jax_with_port_predictions(evaluators, monkeypatch):
    """run_checkpoint_once's AP (both IoU passes, every class, metric and
    difficulty) and MOT results are the same whether the JAX evaluator
    scores its own predictions or the port's."""
    cfg, ds, jev, _, ev, tmp = evaluators
    want = jev.run_checkpoint_once(1)
    port = JaxEvaluator(cfg, jev.model, ds, ckpt_dir=str(tmp / "ckpt"),
                        output_dir=str(tmp / "eval_mixed"))
    monkeypatch.setattr(port, "predict_couples",
                        lambda params, idxs: ev.predict_couples(idxs))
    got = port.run_checkpoint_once(1)
    _assert_results_equal(got, want)


# ------------------------------------------------ run_checkpoint_once

# (videos' ego speeds, frames per video, data_stride)
FIXTURES = {"static_stride1": ((0.0,), 5, 1),
            "ego_stride3": ((0.0, 0.5), 7, 3)}


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def checkpoint_runs(request, tmp_path_factory, jax_params):
    """Both evaluators' run_checkpoint_once on one fixture, from the same
    parameters: (JAX results, port results, JAX dir, port dir, dataset)."""
    speeds, n_frames, stride = FIXTURES[request.param]
    tmp = tmp_path_factory.mktemp(request.param)
    root = str(tmp / "kitti")
    synthetic.write_tracking_fixture(
        root, num_videos=len(speeds), num_frames=n_frames,
        video_specs=[{"ego_speed": s} for s in speeds])
    cfg = _cfg(root, stride)
    jds = tracking.KittiTrackingDataset(cfg.dataset, split="val")
    tds = ttracking.KittiTrackingDataset(config_from_json(cfg).dataset,
                                         split="val")
    assert len(tds.couples) <= 8
    JaxCheckpointIO(str(tmp / "ckpt_jax")).save(1, jax_params)
    jev = JaxEvaluator(cfg, jdt.DtAvodNet(cfg=cfg, cluster_sizes=CLUSTERS),
                       jds, ckpt_dir=str(tmp / "ckpt_jax"),
                       output_dir=str(tmp / "jax"))
    want = jev.run_checkpoint_once(1)
    _port_checkpoint(str(tmp / "ckpt_port"), 1, jax_params.params)
    ev = Evaluator(config_from_json(cfg), _port_model(cfg), tds,
                   str(tmp / "ckpt_port"), str(tmp / "port"), device="cpu")
    got = ev.run_checkpoint_once()
    return want, got, str(tmp / "jax"), str(tmp / "port"), tds


def test_run_checkpoint_once_results_match_jax(checkpoint_runs):
    """results_{step}.json: AP at both passes and MOT per video and
    overall, as written to disk and as returned."""
    import json
    want, got, jdir, tdir, _ = checkpoint_runs
    _assert_results_equal(got, want)
    with open(os.path.join(jdir, "results_1.json")) as f:
        want_disk = json.load(f)
    with open(os.path.join(tdir, "results_1.json")) as f:
        got_disk = json.load(f)
    assert got_disk.keys() == want_disk.keys() == {
        "step", "ap", "ap_per_class", "ap_05_per_class", "mot"}
    assert got_disk["step"] == want_disk["step"] == 1
    _assert_results_equal(got_disk, want_disk)


def _read_lines(path):
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines()]


def _assert_frame_lines(got, want, name):
    """type -1 -1 -10 x1 y1 x2 y2 h w l x y z ry score (3 decimals)."""
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert g[:4] == w[:4], name
        g, w = np.float64(g[4:]), np.float64(w[4:])
        np.testing.assert_allclose(g[:4], w[:4], atol=0.05, err_msg=name)
        np.testing.assert_allclose(g[4:11], w[4:11], atol=1e-4 + 1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(g[11], w[11], atol=1e-5 + 1e-3,
                                   err_msg=name)


def _assert_couple_lines(got, want, name):
    """frame type score x y z l w h ry dx dz dry coexist span (6
    decimals)."""
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert (g[:2], g[13:]) == (w[:2], w[13:]), name
        g, w = np.float64(g[2:13]), np.float64(w[2:13])
        np.testing.assert_allclose(g[0], w[0], atol=1e-5 + 1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g[1:8], w[1:8], atol=1e-4 + 1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g[8:], w[8:], atol=1e-5 + 1e-6,
                                   err_msg=name)


def test_prediction_files_match_jax(checkpoint_runs):
    """The same frame files (every frame of every video, MoI frames
    included) and couple files (one per couple), line for line."""
    _, _, jdir, tdir, ds = checkpoint_runs
    n_lines = 0
    for sub, check in (("data", _assert_frame_lines),
                       ("couples", _assert_couple_lines)):
        jsub = os.path.join(jdir, "predictions_1", sub)
        tsub = os.path.join(tdir, "predictions_1", sub)
        names = sorted(os.listdir(jsub))
        assert sorted(os.listdir(tsub)) == names
        if sub == "data":
            frames = {(cp.video_id, f) for cp in ds.couples
                      for f in range(cp.frame_a, cp.frame_b + 1)}
            assert names == sorted(f"{v:02d}{f:04d}.txt"
                                   for v, f in frames)
        else:
            assert names == sorted(f"{cp.name}.txt" for cp in ds.couples)
        for name in names:
            got = _read_lines(os.path.join(tsub, name))
            check(got, _read_lines(os.path.join(jsub, name)), name)
            n_lines += len(got)
        if sub == "data" and ds.cfg.data_stride > 1:
            # MoI filled the frames between keyframes
            keys = {(cp.video_id, f) for cp in ds.couples
                    for f in (cp.frame_a, cp.frame_b)}
            assert sum(len(_read_lines(os.path.join(
                tsub, f"{v:02d}{f:04d}.txt"))) for v, f in frames - keys)
    assert n_lines > 0


# --------------------------------------------------- port-only paths

def test_run_latest_checkpoints_evaluates_each_step_once(tmp_path,
                                                         jax_params):
    """Two checkpoints: the first poll evaluates both, in step order,
    with val_health in the results; the next finds nothing new; a third
    checkpoint is evaluated alone."""
    root = str(tmp_path / "kitti")
    synthetic.write_tracking_fixture(root, num_videos=1, num_frames=2)
    cfg = config_from_json(_cfg(root))
    cfg.eval.val_health = True
    ds = ttracking.KittiTrackingDataset(cfg.dataset, split="val")
    ckpt = str(tmp_path / "ckpt")
    for step in (2, 5):
        _port_checkpoint(ckpt, step, jax_params.params)
    ev = Evaluator(cfg, _port_model(_cfg(root)), ds, ckpt,
                   str(tmp_path / "out"), device="cpu")
    calls = []
    run = ev.run_checkpoint_once
    ev.run_checkpoint_once = lambda step=None: calls.append(step) or run(step)
    first = ev.run_latest_checkpoints()
    assert [r["step"] for r in first] == calls == [2, 5]
    for r in first:
        assert r["val_health"]["num_couples"] == len(ds.couples)
        assert np.isfinite(r["val_health"]["val_losses"]["total"])
        assert os.path.isfile(str(tmp_path / "out" / f"results_{r['step']}"
                                                      ".json"))
    assert ev.run_latest_checkpoints() == [] and calls == [2, 5]
    _port_checkpoint(ckpt, 7, jax_params.params)
    assert [r["step"] for r in ev.repeated_checkpoint_run(
        max_wait_rounds=1)] == [7]
    assert calls == [2, 5, 7]
    assert set(ev.stage_seconds) == {"load", "forward", "write", "ap",
                                     "tracking", "val_health"}


def test_dataset_without_couples_raises(tmp_path, jax_params):
    """A dataset without couples (two single-frame samples) takes the
    detection-only evaluation: the paired model's forward raises on its
    one frame per sample; the one-frame model's run writes a file per
    sample and AP at both passes, no MOT (tests/test_torch_single_frame.py
    holds it against the JAX evaluator)."""
    from dodt_tpu_torch.data import detection, synthetic as tsynth
    root = str(tmp_path / "kitti")
    tsynth.write_detection_fixture(root, num_frames=2)
    cfg = config_from_json(_cfg(root))
    ds = detection.KittiDataset(cfg.dataset, split="val")
    _port_checkpoint(str(tmp_path / "ckpt"), 1, jax_params.params)
    ev = Evaluator(cfg, _port_model(_cfg(root)), ds, str(tmp_path / "ckpt"),
                   str(tmp_path / "out"), device="cpu")
    with pytest.raises(ValueError, match="1 frames per sample"):
        ev.run_checkpoint_once()
    one = tdt.DtAvodNet(cfg, CLUSTERS, num_frames=1)
    sd = {k: v for k, v in flax_to_state_dict(jax_params.params).items()
          if k.split(".")[0] not in ("bev_corr_bottleneck", "corr_fc")}
    CheckpointIO(str(tmp_path / "ckpt1")).save(
        1, TrainState(step=1, params=sd, opt_state={}))
    ev = Evaluator(cfg, one, ds, str(tmp_path / "ckpt1"),
                   str(tmp_path / "out1"), device="cpu")
    res = ev.run_checkpoint_once()
    assert set(res) == {"step", "ap", "ap_per_class", "ap_05_per_class"}
    assert sorted(os.listdir(tmp_path / "out1" / "predictions_1" / "data")) \
        == ["000000.txt", "000001.txt"]
    assert set(ev.stage_seconds) == {"load", "forward", "write", "ap"}


def test_no_checkpoint_raises(tmp_path):
    cfg = config_from_json(_cfg(str(tmp_path)))
    ev = Evaluator(cfg, _port_model(_cfg(str(tmp_path))), None,
                   str(tmp_path / "ckpt"), str(tmp_path / "out"),
                   device="cpu")
    with pytest.raises(FileNotFoundError):
        ev.run_checkpoint_once()
    assert next(ev.model.parameters()).device == torch.device("cpu")
