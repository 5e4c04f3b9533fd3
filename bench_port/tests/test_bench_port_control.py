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


def tiny_control(root, args):
    """control.py's ``main(args)`` through the tiny checkout's copy."""
    import importlib.util
    import os
    import sys
    path = os.path.join(root, "bench_port", "control.py")
    spec = importlib.util.spec_from_file_location("tiny_control", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = list(sys.path)
    try:
        module.main(args + ["--device", "cpu"])
    finally:
        sys.path[:] = saved


def test_control_at_test_sizes_reads_not_correct(tiny_root, capsys):
    """The same control on the CPU at test sizes, through the tiny
    checkout's copy of control.py."""
    tiny_control(tiny_root, ["--workload", "cars_dt.stream", "--seeds", "5"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["control_correct"] is False, line


@pytest.mark.parametrize("fault", ["none", "half_batch", "no_exchange"])
def test_data_parallel_faults_in_the_references_place(dp4_root, capsys,
                                                      fault):
    """The float32 reference in the program's place on the data-parallel
    cell reads correct; stepping on half of each global batch, or on
    rank 0's rows alone, reads not correct, by the loss."""
    tiny_control(dp4_root, ["--workload", "cars_dt.train_dp4", "--seeds",
                             "5", "--precision", "float32", "--fault",
                             fault])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["control_correct"] is (fault == "none"), line
    if fault != "none":
        assert line["numbers"]["loss_gap"] > line["limits"]["loss_gap"]
