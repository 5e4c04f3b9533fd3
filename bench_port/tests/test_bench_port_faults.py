"""Each cell's run with the timed path broken underneath reads not
correct: an answer altered where it is produced, a stale state handed
on, a train step that returns its state unchanged, an altered loss.
The runs skip the look for a card and run on the CPU at test sizes; the
unbroken run reads correct."""
import pytest

from conftest import run_cell


def shifted(fn, key, by=10.0):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        return {**out, key: out[key] + by}
    return wrapped


def test_unbroken_cells_read_correct(tiny_root):
    for cell in ("cars_dt.stream", "cars_single.detect", "cars_dt.train"):
        res, err = run_cell(tiny_root, cell)
        assert res["correct"], (cell, err)
        assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", ["finals", "proposals", "stale_state"])
def test_stream_fault_reads_not_correct(tiny_root, monkeypatch, fault):
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    if fault == "finals":
        monkeypatch.setattr(DtAvodNet, "pair_stage", shifted(
            DtAvodNet.pair_stage, "final_boxes_3d"))
    elif fault == "proposals":
        monkeypatch.setattr(DtAvodNet, "encode_frame", shifted(
            DtAvodNet.encode_frame, "top_anchors"))
    else:
        real, first = DtAvodNet.encode_frame, []

        def stale(self, batch):
            state = real(self, batch)
            first.append(first[0] if first else state)
            return first[-1]
        monkeypatch.setattr(DtAvodNet, "encode_frame", stale)
    res, _ = run_cell(tiny_root, "cars_dt.stream")
    assert not res["correct"]


def test_detect_fault_reads_not_correct(tiny_root, monkeypatch):
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    monkeypatch.setattr(DtAvodNet, "forward", shifted(
        DtAvodNet.forward, "final_boxes_3d"))
    res, _ = run_cell(tiny_root, "cars_single.detect")
    assert not res["correct"]


@pytest.mark.parametrize("fault", ["state_unchanged", "loss_altered"])
def test_train_fault_reads_not_correct(tiny_root, monkeypatch, fault):
    from dodt_tpu_torch.runtime import trainer
    real = trainer.make_train_step

    def broken(*a, **k):
        step = real(*a, **k)

        def step_fn(state, batch, rand):
            new, losses = step(state, batch, rand)
            if fault == "state_unchanged":
                return state._replace(step=new.step), losses
            return new, {**losses, "total": losses["total"] * 1.5}
        step_fn.reduced_bytes, step_fn.sharded = 0, step.sharded
        return step_fn
    monkeypatch.setattr(trainer, "make_train_step", broken)
    res, err = run_cell(tiny_root, "cars_dt.train")
    assert not res["correct"], err
    key = "change_gap" if fault == "state_unchanged" else "loss_gap"
    assert res["checks"][key]["value"] > res["checks"][key]["limit"]
