"""The host-side helpers of chip_smoke.py, on the CPU: the spill check of
phase 1, the cast counter of phase 3, and the failure report."""
import subprocess
import sys
from pathlib import Path

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
