"""The control reads not correct: the float8 reference in the program's
place, judged against the float32 reference at each cell's own sizes.
Needs the card (the cells' sizes do not fit a CPU test run); on the card:

    python -m pytest -m cuda bench_port/tests -q
"""
import json

import pytest


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cars_dt.stream", "cars_single.detect",
                                  "cars_dt.train"])
def test_control_reads_not_correct(card, capsys, cell):
    import control
    control.main(["--workload", cell, "--seeds", str(2 ** 31 + 101)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["control_correct"] is False, line


def test_control_at_test_sizes_reads_not_correct(tiny_root, capsys):
    """The same control on the CPU at test sizes, through the tiny
    checkout's copy of control.py."""
    import importlib.util
    import os
    import sys
    path = os.path.join(tiny_root, "bench_port", "control.py")
    spec = importlib.util.spec_from_file_location("tiny_control", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = list(sys.path)
    try:
        module.main(["--workload", "cars_dt.stream", "--seeds", "5",
                     "--device", "cpu"])
    finally:
        sys.path[:] = saved
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["control_correct"] is False, line
