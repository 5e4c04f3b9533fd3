"""The port's CLI (dodt_tpu_torch/cli.py) against tests/test_cli.py's
JAX CLI on the CPU (``--device cpu``): config round-trip, the dataset
and model dispatch of all three model names, the single-frame clusters,
``demo``, and ``train`` -> ``evaluate`` -> ``infer`` on the tiny
tracking fixture, plus ``dodt_tpu_torch.entry``, the twin of
``__graft_entry__.entry``."""
import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__
from dodt_tpu import cli as jcli
from dodt_tpu import config as jcfg
from dodt_tpu.data import synthetic
from dodt_tpu_torch import cli
from dodt_tpu_torch import config as cfg_mod
from dodt_tpu_torch import entry as entry_mod


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    t_root = str(tmp_path_factory.mktemp("cli_tracking_torch"))
    synthetic.write_tracking_fixture(t_root, num_videos=1, num_frames=4)
    d_root = str(tmp_path_factory.mktemp("cli_object_torch"))
    synthetic.write_detection_fixture(d_root, num_frames=3)
    return t_root, d_root


def _tiny(root, model_name, stride=1):
    cfg = jcfg.unittest_pipeline()
    cfg.model.model_name = model_name
    cfg.dataset.dataset_dir = root
    cfg.dataset.data_stride = stride
    cfg.dataset.video_train_ids = (0,)
    return cfg


def test_config_roundtrip(tmp_path):
    """The port's preset saves and loads as test_cli.py holds JAX's, and
    the JAX preset's file loads into the port with the same JSON."""
    cfg = cfg_mod.cars_dt_tracking(data_stride=3)
    path = str(tmp_path / "cfg.json")
    cfg.save(path)
    loaded = cfg_mod.PipelineConfig.load(path)
    assert loaded.dataset.data_stride == 3
    assert loaded.model.rpn.train_nms_size == 1024
    assert loaded.model.avod.nms_iou_thresh == 0.01
    assert loaded.dataset.kitti_utils.area_extents[0] == (-40.0, 40.0)
    assert loaded.model.correlation.max_displacement == 5
    assert loaded.dataset.kitti_utils.bev_shape == (700, 800)
    jpath = str(tmp_path / "jax_cfg.json")
    jcfg.cars_dt_tracking(data_stride=3).save(jpath)
    assert cfg_mod.PipelineConfig.load(jpath).to_json() == loaded.to_json()


@pytest.mark.parametrize("name", ["avod_model", "dt_avod_model",
                                  "stack_avod_model"])
def test_build_dispatch(roots, tmp_path, name):
    """Each model_name builds the port's dataset and model family, with
    the JAX CLI's couples and clusters."""
    from dodt_tpu_torch.data.detection import KittiDataset
    from dodt_tpu_torch.data.stack import KittiTrackingStackDataset
    from dodt_tpu_torch.data.tracking import KittiTrackingDataset
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    from dodt_tpu_torch.models.stack import StackAvodNet

    t_root, d_root = roots
    ds_cls, model_cls, frames = {
        "avod_model": (KittiDataset, DtAvodNet, 1),
        "dt_avod_model": (KittiTrackingDataset, DtAvodNet, 2),
        "stack_avod_model": (KittiTrackingStackDataset, StackAvodNet, None),
    }[name]
    cfg = _tiny(d_root if name == "avod_model" else t_root, name,
                stride=2 if name.startswith("stack") else 1)
    path = str(tmp_path / f"{name}.json")
    cfg.save(path)
    _, ds, model = cli._build(path, "train")
    _, jds, jmodel = jcli._build(path, "train")
    assert isinstance(ds, ds_cls) and isinstance(model, model_cls)
    if frames is not None:
        assert model.num_frames == frames
    assert len(ds) == len(jds)
    np.testing.assert_array_equal(np.asarray(model.cluster_sizes),
                                  np.asarray(jmodel.cluster_sizes))


def test_single_frame_clusters(roots, tmp_path):
    """A Pedestrian single-frame config on the Car fixture gets the
    per-class priors, as the JAX CLI's does, never Car sizes."""
    _, d_root = roots
    cfg = _tiny(d_root, "avod_model")
    cfg.dataset.classes = ("Pedestrian",)
    cfg.dataset.num_clusters = (1,)
    path = str(tmp_path / "ped_cfg.json")
    cfg.save(path)
    _, _, model = cli._build(path, "train")
    _, _, jmodel = jcli._build(path, "train")
    assert model.cluster_sizes[0][0] < 1.5
    np.testing.assert_array_equal(np.asarray(model.cluster_sizes),
                                  np.asarray(jmodel.cluster_sizes))


def test_demo_command(roots, tmp_path, capsys):
    """demo writes its three files; the statistics are the JAX demo's."""
    t_root, _ = roots
    cfg_path = str(tmp_path / "demo_cfg.json")
    _tiny(t_root, "dt_avod_model").save(cfg_path)
    out_dir, jout_dir = str(tmp_path / "demo_out"), str(tmp_path / "jax")
    cli.main(["--device", "cpu", "demo", "--config", cfg_path,
              "--output_dir", out_dir, "--sample", "0"])
    printed = json.loads(capsys.readouterr().out)
    jcli.main(["demo", "--config", cfg_path, "--output_dir", jout_dir,
               "--sample", "0"])
    for name in ("bev_sample.png", "anchor_grid.png", "dataset_stats.json"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "dataset_stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(jout_dir, "dataset_stats.json")) as f:
        assert stats == json.load(f)
    assert printed["stats"] == stats


def test_train_evaluate_infer(roots, tmp_path, capsys):
    """train (2 steps) -> evaluate -> infer through cli.main on the CPU:
    evaluate's results equal a direct Evaluator.run_checkpoint_once on
    the same checkpoint, and infer prints its timing line."""
    from dodt_tpu_torch.runtime.evaluator import Evaluator

    t_root, _ = roots
    cfg = _tiny(t_root, "dt_avod_model")
    cfg.dataset.video_train_ids = (0,)
    cfg_path = str(tmp_path / "cfg.json")
    cfg.save(cfg_path)
    ckpt = str(tmp_path / "ckpt")
    cpu = ["--device", "cpu"]
    cli.main(cpu + ["train", "--config", cfg_path, "--ckpt_dir", ckpt,
                    "--max_steps", "2"])
    assert sorted(os.listdir(ckpt)) == ["2", "train_metrics.jsonl"]
    capsys.readouterr()

    out = str(tmp_path / "eval_out")
    cli.main(cpu + ["evaluate", "--config", cfg_path, "--ckpt_dir", ckpt,
                    "--output_dir", out, "--split", "train"])
    printed = capsys.readouterr().out
    results = json.loads(printed[:printed.index("\n}\n") + 2])
    assert results["step"] == 2
    assert printed.splitlines()[-2].startswith("step")   # reporting table
    _, ds, model = cli._build(cfg_path, "train")
    direct = Evaluator(cfg_mod.PipelineConfig.load(cfg_path), model, ds, ckpt,
                       str(tmp_path / "direct"), device="cpu"
                       ).run_checkpoint_once(2)
    assert json.dumps(results, sort_keys=True) == json.dumps(
        json.loads(json.dumps(direct, default=float)), sort_keys=True)
    def files(root):
        found = {}
        for d, _, names in os.walk(root):
            for name in names:
                with open(os.path.join(d, name)) as f:
                    found[os.path.relpath(os.path.join(d, name), root)] = \
                        f.read()
        return found
    assert files(out) == files(str(tmp_path / "direct"))

    cli.main(cpu + ["infer", "--config", cfg_path, "--ckpt_dir", ckpt,
                    "--split", "train", "--max_samples", "3",
                    "--output_dir", str(tmp_path / "infer_out")])
    timing = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(timing) == {"mean_s", "median_s", "min_s", "max_s",
                           "fps_pairs"}
    assert timing["fps_pairs"] > 0


def test_entry_points_need_a_card_or_cpu(roots, tmp_path):
    """--device defaults to the card: without one, train raises; and a
    mesh width above 1 without as many ranks is refused (nothing falls
    back to one rank; tests/test_torch_mesh.py trains it under 2)."""
    t_root, _ = roots
    cfg_path = str(tmp_path / "cfg.json")
    _tiny(t_root, "dt_avod_model").save(cfg_path)
    with pytest.raises(ValueError, match="mesh"):
        cli.main(["--device", "cpu", "train", "--config", cfg_path,
                  "--ckpt_dir", str(tmp_path / "c"), "--num_model", "2"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            cli.main(["train", "--config", cfg_path, "--ckpt_dir",
                      str(tmp_path / "c"), "--max_steps", "1"])


def test_entry_twin(monkeypatch):
    """entry(device="cpu"): __graft_entry__.entry's batch, bit for bit,
    and the flagship's final boxes and scores, finite, at its shapes. The
    point count is cut from 32768 to 4096 (the batch's other shapes and
    the model are the flagship's) to keep the CPU forward short."""
    assert entry_mod.MAX_POINTS == 32768
    monkeypatch.setattr(entry_mod, "MAX_POINTS", 4096)
    fn, (params, batch) = entry_mod.entry(device="cpu")
    cfg = jcfg.cars_dt_tracking()
    cfg.dataset.max_points = 4096
    want = __graft_entry__._synthetic_batch_full(cfg,
                                                np.random.RandomState(0))
    assert set(batch) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(batch[k].numpy(), v, err_msg=k)
    with torch.no_grad():
        boxes, scores = fn(params, batch)
    nms = cfg.model.avod.nms_size
    assert boxes.shape == (1, 2, nms, 7) and scores.shape == (1, 2, nms)
    assert torch.isfinite(boxes).all() and torch.isfinite(scores).all()
