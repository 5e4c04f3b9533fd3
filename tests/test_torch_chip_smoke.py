"""The host-side helpers of chip_smoke.py, on the CPU: the spill check of
phase 1, the cast counter of phase 3, and the failure report."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from dodt_tpu_torch.ops import roi, roi_window

ROOT = Path(chip_smoke.__file__).resolve().parent

PTXAS = """\
ptxas info    : Compiling entry function '_Z6kernelAv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelAv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z6kernelBv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelBv
    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 24 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z6kernelCv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelCv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_spills_names_the_kernels_that_spill():
    """Phase 1 fails on any kernel whose -Xptxas -v report has spill
    stores or loads; a stack frame alone is no spill."""
    assert chip_smoke.spills(PTXAS) == ["_Z6kernelBv"]
    assert chip_smoke.spills("") == []


def test_count_map_casts_sees_whole_map_casts_only():
    """Phase 3's counter: B2's twin casts the whole f32 map to bf16 (the
    cast the CUDA route no longer makes); the gather crop casts nothing,
    and a cast of a tensor of another shape does not count."""
    maps = torch.randn(2, 96, 128, 32)
    boxes = torch.rand(2, 3, 4)
    hwc = (96, 128, 32)
    assert chip_smoke.count_map_casts(
        lambda: roi_window.crop_and_resize_window_plain(maps, boxes, 7),
        hwc) == [(2, 96, 128, 32)]
    assert chip_smoke.count_map_casts(
        lambda: roi.crop_and_resize_gather(maps[0], boxes[0], 7), hwc) == []
    assert chip_smoke.count_map_casts(
        lambda: maps[:, :64].to(torch.bfloat16), hwc) == []


def test_without_a_card_it_fails_with_its_reason_on_stdout():
    """Where torch finds no card the script exits 1 and prints the reason
    on stdout as well as stderr, and no result line."""
    p = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert p.returncode == 1
    assert p.stdout.startswith("chip_smoke FAILED: torch.cuda.is_available")
    assert "chip_smoke FAILED" in p.stderr and '"ok"' not in p.stdout


def test_eval_fixture_is_the_tracking_fixture_without_pngs(tmp_path):
    """Phases 9-10's fixture: write_tracking_fixture's files, byte for
    byte, but the PNGs; its dataset's samples equal those read from the
    PNGs with cv2, bitwise."""
    import numpy as np
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.data import synthetic, tracking
    a, b = str(tmp_path / "smoke"), str(tmp_path / "writer")
    scenes = chip_smoke.write_eval_fixture(a, (0.0, 0.5), 4)
    synthetic.write_tracking_fixture(b, num_videos=2, num_frames=4,
                                     video_specs=[{"ego_speed": 0.0},
                                                  {"ego_speed": 0.5}])

    def files(root):
        return {str(p.relative_to(root)): p.read_bytes()
                for p in Path(root).rglob("*") if p.is_file()}
    got, want = files(a), files(b)
    assert got == {k: v for k, v in want.items() if not k.endswith(".png")}
    assert len(want) - len(got) == 8

    cfg = chip_smoke.eval_cfg(unittest_pipeline(), b)
    cfg.dataset.data_stride = 3
    ds = chip_smoke.eval_dataset(cfg, scenes)
    ref = tracking.KittiTrackingDataset(cfg.dataset, split="val")
    assert [c.name for c in ds.couples] == [c.name for c in ref.couples]
    for idx in range(len(ds.couples)):
        s, r = ds.load_couple(idx), ref.load_couple(idx)
        assert s.keys() == r.keys()
        for k in r:
            if isinstance(r[k], np.ndarray):
                assert s[k].dtype == r[k].dtype
            np.testing.assert_array_equal(s[k], r[k], err_msg=k)


def test_eval_outputs_check_on_a_cpu_run(tmp_path):
    """Phase 10's CPU arm at a small size: run_checkpoint_once over the
    smoke fixture passes check_eval_outputs, and the check fails on a
    missing frame file and on a non-finite number (MOTP is infinite by
    the official protocol only where there is no true positive)."""
    import json
    import pytest
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.models.dt_avod import DtAvodNet, init_params
    from dodt_tpu_torch.runtime.evaluator import Evaluator
    from dodt_tpu_torch.runtime.trainer import (CheckpointIO,
                                                create_train_state)
    scenes = chip_smoke.write_eval_fixture(str(tmp_path / "kitti"), (0.5,),
                                           4)
    cfg = chip_smoke.eval_cfg(unittest_pipeline(), str(tmp_path / "kitti"))
    cfg.dataset.data_stride = 3
    model = DtAvodNet(cfg, ((3.9, 1.6, 1.52),))
    init_params(model, torch.Generator().manual_seed(5))
    CheckpointIO(str(tmp_path / "ckpt")).save(
        1, create_train_state(cfg, model))
    ds = chip_smoke.eval_dataset(cfg, scenes)
    out = tmp_path / "out"
    ev = Evaluator(cfg, model, ds, str(tmp_path / "ckpt"), str(out),
                   device="cpu")
    res = ev.run_checkpoint_once()
    keys = chip_smoke.RESULT_KEYS - {"val_health"}
    frames, couples = chip_smoke.check_eval_outputs(res, str(out), ds, keys)
    assert frames == [f"00{f:04d}.txt" for f in range(4)]
    assert couples == ["000000_000003.txt", "000003_000003.txt"]
    assert dict(chip_smoke.numbers({"a": {"b": 1.5, "c": "x"}})) == {
        "results/a/b": 1.5}
    path = out / "results_1.json"
    disk = json.loads(path.read_text())
    for key, value in (("MOTA", float("inf")), ("TP", 1)):
        bad = json.loads(json.dumps(disk))
        bad["mot"]["overall"]["MOTP"] = float("inf")
        bad["mot"]["overall"][key] = value
        path.write_text(json.dumps(bad))
        with pytest.raises(chip_smoke.PhaseError, match="not finite"):
            chip_smoke.check_eval_outputs(res, str(out), ds, keys)
    path.write_text(json.dumps(disk))
    (out / "predictions_1" / "data" / "000001.txt").unlink()
    with pytest.raises(chip_smoke.PhaseError, match="frame files"):
        chip_smoke.check_eval_outputs(res, str(out), ds, keys)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in Path(root).rglob("*") if p.is_file()}


def _assert_samples_equal(s, r):
    assert s.keys() == r.keys()
    for k in r:
        if isinstance(r[k], np.ndarray):
            assert s[k].dtype == r[k].dtype, k
        np.testing.assert_array_equal(s[k], r[k], err_msg=k)


def test_detection_fixture_without_pngs_reads_as_the_png_route(tmp_path):
    """Phases 11 and 13's object fixture: write_detection_fixture's files,
    byte for byte, but the PNGs; detection_dataset's samples equal those
    KittiDataset reads from the PNGs with cv2, bitwise."""
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.data import detection, synthetic
    a, b = str(tmp_path / "smoke"), str(tmp_path / "writer")
    scene = chip_smoke.write_detection_eval_fixture(a, 3)
    synthetic.write_detection_fixture(b, num_frames=3)
    got, want = _files(a), _files(b)
    assert got == {k: v for k, v in want.items() if not k.endswith(".png")}
    assert len(want) - len(got) == 3
    cfg = unittest_pipeline()
    cfg.dataset.dataset_dir = b
    ds = chip_smoke.detection_dataset(cfg, scene)
    ref = detection.KittiDataset(cfg.dataset, split="val")
    assert ds.sample_names == ref.sample_names
    for idx in range(len(ref)):
        _assert_samples_equal(ds.load_sample(idx), ref.load_sample(idx))


def test_stack_eval_dataset_reads_as_the_png_route(tmp_path):
    """Phase 12 reads phase 9's fixture through KittiTrackingStackDataset
    with the flat-card images: every stack equal to the PNG route's."""
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.data import stack, synthetic
    scenes = chip_smoke.write_eval_fixture(str(tmp_path / "smoke"),
                                           (0.0, 0.5), 4)
    synthetic.write_tracking_fixture(str(tmp_path / "png"), num_videos=2,
                                     num_frames=4,
                                     video_specs=[{"ego_speed": 0.0},
                                                  {"ego_speed": 0.5}])
    cfg = chip_smoke.eval_cfg(unittest_pipeline(), str(tmp_path / "png"))
    cfg.dataset.data_stride = 3
    ds = chip_smoke.eval_dataset(cfg, scenes,
                                 stack.KittiTrackingStackDataset)
    ref = stack.KittiTrackingStackDataset(cfg.dataset, split="val")
    assert ds.num_frames == 4 and len(ds.couples) == len(ref.couples) == 4
    for idx in range(len(ref.couples)):
        _assert_samples_equal(ds.load_stack(idx), ref.load_stack(idx))


def test_smoke_batches_have_the_datasets_keys(tmp_path):
    """one_frame and stack_batch turn train_batch's couple into the keys,
    dtypes (but the images') and frame counts of KittiDataset's and
    KittiTrackingStackDataset's batches."""
    from dodt_tpu_torch.config import unittest_pipeline
    from dodt_tpu_torch.data import detection, stack, synthetic
    cfg = unittest_pipeline()
    couple = chip_smoke.train_batch(cfg, np.random.RandomState(0))
    synthetic.write_detection_fixture(str(tmp_path / "obj"), num_frames=1)
    synthetic.write_tracking_fixture(str(tmp_path / "trk"), num_videos=1,
                                     num_frames=4)
    for got, root, cls, frames in (
            (chip_smoke.one_frame(couple), "obj", detection.KittiDataset, 1),
            (chip_smoke.stack_batch(couple), "trk",
             stack.KittiTrackingStackDataset, 4)):
        cfg.dataset.dataset_dir = str(tmp_path / root)
        cfg.dataset.data_stride = frames - 1
        want = cls(cfg.dataset, split="train").next_batch(1, augment=False)
        want.pop("sample_name")
        assert got.keys() == want.keys(), cls
        for k, v in want.items():
            # make_batch's images are float32, as bench.py's
            assert got[k].dtype == v.dtype or k == "image", k
            assert got[k].ndim == v.ndim, k
        assert got["points"].shape[1] == got["image"].shape[1] == frames
