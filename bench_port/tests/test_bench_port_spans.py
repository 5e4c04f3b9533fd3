"""The readers of the program's spans (harness/spans.py and the metrics
that use it) on hand-made traces with known intervals, and on traced CPU
runs of the cells."""
import json
import os
import types

import pytest

from conftest import REPO, run_cell
from harness import spans
from harness.cells import load_metric
from harness.trace import DeviceTrace

NEW = {"stream": ["idle_ms.upload", "idle_ms.rasterize", "idle_ms.towers",
                  "idle_ms.rpn", "idle_ms.second_stage",
                  "syncs_per_keyframe"],
       "detect": ["idle_ms.rasterize", "idle_ms.towers", "idle_ms.rpn",
                  "idle_ms.second_stage", "syncs_per_keyframe"],
       "train": ["idle_ms.forward", "idle_ms.backward", "idle_ms.optimizer",
                 "data_wait_ms", "syncs_per_step"]}
CELLS = {"stream": "cars_dt.stream", "detect": "cars_single.detect",
         "train": "cars_dt.train"}


def ev(cat, name, ts, end):
    return {"cat": cat, "name": name, "ts": ts, "dur": end - ts}


def span(name, ts, end):
    return ev("user_annotation", name, ts, end)


def kernel(ts, end):
    return ev("kernel", "k", ts, end)


def runtime(name, ts, end):
    return ev("cuda_runtime", name, ts, end)


# the opening and closing syncs mark the stretch [0, 1005]; two whole
# keyframes, one cut by the start and one by the stop
STREAM = [
    runtime("cudaDeviceSynchronize", 0, 5),
    runtime("cudaDeviceSynchronize", 1000, 1005),
    span("dodt/keyframe", -50, 40), span("dodt/upload", -50, -10),
    span("dodt/keyframe", 10, 110), span("dodt/upload", 10, 30),
    span("dodt/encode", 30, 80), span("dodt/rpn", 50, 80),
    span("dodt/nms", 60, 80), span("dodt/fetch", 90, 110),
    span("dodt/keyframe", 200, 300), span("dodt/upload", 200, 220),
    span("dodt/encode", 220, 290), span("dodt/rpn", 250, 280),
    span("dodt/keyframe", 900, 1100), span("dodt/upload", 900, 950),
    kernel(15, 25), kernel(55, 75), kernel(205, 210), kernel(250, 280),
    kernel(920, 940), kernel(-40, -20),
    runtime("cudaStreamSynchronize", 62, 66),
    runtime("cudaEventSynchronize", 260, 262),
    runtime("cudaMemcpyAsync", 92, 100),
    runtime("cudaStreamSynchronize", 920, 930),
]

TRAIN = [
    runtime("cudaDeviceSynchronize", 0, 5),
    runtime("cudaDeviceSynchronize", 500, 505),
    span("dodt/train_step", 10, 200), span("dodt/data_wait", 10, 14),
    span("dodt/forward", 14, 100), span("dodt/backward", 100, 180),
    span("dodt/train_step", 200, 400), span("dodt/data_wait", 200, 202),
    span("dodt/forward", 202, 300), span("dodt/backward", 300, 390),
    span("dodt/train_step", 400, 600), span("dodt/data_wait", 400, 440),
    kernel(20, 90), kernel(100, 150), kernel(210, 300), kernel(300, 380),
    runtime("cudaStreamSynchronize", 95, 99),
]


def readings(events, entry):
    trace = None if events is None else DeviceTrace(events, 1e-3)
    return types.SimpleNamespace(
        cell=types.SimpleNamespace(mix={"entry": entry}),
        run=types.SimpleNamespace(trace=trace))


def read(name, events, entry):
    return load_metric(REPO, name).read(readings(events, entry))


def test_roots_cut_by_the_stretch_are_left_out():
    c = spans.Calls(DeviceTrace(STREAM, 1e-3), "dodt/keyframe")
    assert c.roots == [(10, 110), (200, 300)]


def test_idle_inside_a_span_per_call():
    # upload: 10 of 20 idle in the first keyframe, 15 of 20 in the second
    assert read("idle_ms.upload", STREAM, "stream") == pytest.approx(
        (10 + 15) / 2 / 1e3)
    # rpn: 10 of 30 idle, then 0 of 30
    assert read("idle_ms.rpn", STREAM, "stream") == pytest.approx(
        10 / 2 / 1e3)
    c = spans.Calls(DeviceTrace(STREAM, 1e-3), "dodt/keyframe")
    # a span counts its children's idle time: encode holds rpn's kernel
    assert c.idle_ms("dodt/encode") == pytest.approx((30 + 40) / 2 / 1e3)
    assert c.idle_ms("dodt/fetch") == pytest.approx(20 / 2 / 1e3)
    # the root holds every piece: idle = root length - busy
    assert c.idle_ms("dodt/keyframe") == pytest.approx(
        (100 - 30 + 100 - 35) / 2 / 1e3)


def test_syncs_inside_roots_per_call():
    # one in each whole keyframe; the cut keyframe's and the stretch's
    # own syncs, and a memcpy, do not count
    assert read("syncs_per_keyframe", STREAM, "stream") == 1.0
    assert read("syncs_per_step", TRAIN, "train") == pytest.approx(1 / 2)


def test_train_readings():
    # the third step ends past the closing sync: two steps count
    assert read("data_wait_ms", TRAIN, "train") == pytest.approx(
        (4 + 2) / 2 / 1e3)
    assert read("idle_ms.forward", TRAIN, "train") == pytest.approx(
        (16 + 8) / 2 / 1e3)
    assert read("idle_ms.backward", TRAIN, "train") == pytest.approx(
        (30 + 10) / 2 / 1e3)
    # no optimizer span in this trace
    assert read("idle_ms.optimizer", TRAIN, "train") is None


@pytest.mark.parametrize("entry", sorted(NEW))
def test_readers_return_none_without_the_spans(entry):
    """A trace of a program with no spans (the parent's), a span of
    another cell's root, and an untraced run: None, no error."""
    plain = [e for e in STREAM + TRAIN if not e["name"].startswith("dodt/")]
    other = [e for e in STREAM + TRAIN
             if e["name"] != spans.ROOTS[entry]]
    for name in NEW[entry]:
        for events in (plain, other, None):
            assert read(name, events, entry) is None, (name, events)


@pytest.mark.parametrize("declared", [True, False])
def test_an_entry_added_as_a_file_declares_its_root(tmp_path, monkeypatch,
                                                     declared):
    """A new entry names its root span in its own module (``ROOT_SPAN``);
    the readers find it there, and without it read None."""
    entries = tmp_path / "bench_port" / "entries"
    entries.mkdir(parents=True)
    (entries / "fit.py").write_text(
        'ROOT_SPAN = "dodt/fit_step"\n' if declared else "")
    monkeypatch.setattr(spans, "ROOT", str(tmp_path))
    events = [dict(e, name="dodt/fit_step") if e["name"] == "dodt/train_step"
              else e for e in TRAIN]
    want = {"data_wait_ms": (4 + 2) / 2 / 1e3,
            "idle_ms.forward": (16 + 8) / 2 / 1e3,
            "syncs_per_step": 1 / 2}
    for name, value in want.items():
        got = read(name, events, "fit")
        assert got == (pytest.approx(value) if declared else None), name


@pytest.mark.parametrize("entry", sorted(NEW))
def test_every_new_metric_is_listed_for_its_cells(entry):
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    listed = {m["name"] for m in bench["per_layer"]
              if CELLS[entry] in m.get("workloads", [])}
    assert set(NEW[entry]) <= listed


@pytest.mark.parametrize("entry", sorted(NEW))
def test_a_traced_cpu_run_reports_the_new_metrics(tiny_root, entry):
    if entry == "train":
        # on the CPU no closing sync marks the stretch's end, so a
        # traced step ending after the last operator counts as cut: three
        # traced steps leave one whole step
        p = os.path.join(tiny_root, "bench_port", "traffic", "train.json")
        mix = json.load(open(p))
        json.dump(dict(mix, trace_steps=3), open(p, "w"))
    res, err = run_cell(tiny_root, CELLS[entry], trace=1)
    assert res["correct"], err
    for name in NEW[entry]:
        assert res["metrics"][name]["value"] >= 0, name
