"""The data-parallel train cell's pieces on the CPU: each rank's share of
the pool, the samples a step counts, and a run on two gloo ranks
through the port's launcher, whose comparison takes the ranks' couples
as one global batch: sound, it reads correct; with the step broken
underneath in the ranks, it reads not correct; with a forbidden module
loaded in a rank, it gives no result."""
import json
import os

import pytest

from conftest import DP4 as CELL
from conftest import run_cell


def dp4():
    from harness.cells import ROOT, load_entry
    return load_entry(ROOT, "train_dp4")


@pytest.mark.parametrize("batch", [4, 8])
def test_each_rank_takes_its_contiguous_share_in_turn(batch):
    shard = dp4().shard_indices
    ranks, pool, local = 4, 32, batch // 4
    steps = [shard(s, ranks, batch, pool) for s in range(16 // local)]
    assert all(len(b) == batch for b in steps)
    for r in range(ranks):
        rows = [i for b in steps for i in b[r * local:(r + 1) * local]]
        assert rows == [8 * r + k % 8 for k in range(16)]


def test_the_pool_dataset_serves_the_global_batches():
    ds = dp4().RankShards([{"x": i * __import__("numpy").ones((1, 2))}
                           for i in range(8)], 2)
    b = ds.next_batch(2)
    for _ in range(4):
        ds.next_batch(2)
    assert ds.served == [0, 4, 1, 5, 2, 6, 3, 7, 0, 4]
    assert b["x"][:, 0].tolist() == [0, 4]


def two_pass(root):
    """cars_dt at test sizes with the two-pass RPN, so that the ranks'
    candidates are gathered too."""
    p = os.path.join(root, "bench_port", "configs", "cars_dt.json")
    cfg = json.load(open(p))
    cfg["pipeline"]["model"]["rpn"]["fusion_top_k"] = 32
    json.dump(cfg, open(p, "w"))


def test_two_gloo_ranks_read_correct_and_count_the_global_batch(
        dp4_root, monkeypatch):
    import run
    seen = []
    real = run.Readings.__init__

    def spy(self, cell, ctx, r, *a):
        seen.append(r)
        real(self, cell, ctx, r, *a)
    monkeypatch.setattr(run.Readings, "__init__", spy)
    two_pass(dp4_root)
    res, err = run_cell(dp4_root, CELL)
    assert res["correct"], err
    r = seen[0]
    assert r.samples_per_call == 2 and r.calls == res["attempted"] >= 1
    assert res["metrics"]["train_samples_per_s"]["value"] == pytest.approx(
        r.calls * 2 / r.window_s)
    steps = [e for e in err if "interest_miss" in e]
    assert len(steps) == 5, err
    assert all("interest_miss 0.0;" in e for e in steps), steps
    assert all(res["checks"][k]["value"] < 1e-4 for k in res["checks"])
    assert sum("rank " in e and "device memory peak" in e
               for e in err) == 2


BREAK = '''

_real_rank = rank


def rank(*args):
    """The rank with its train step broken underneath: %s."""
    import torch
    from dodt_tpu_torch.parallel import mesh
    from dodt_tpu_torch.runtime import trainer
    fault = %r
    real_step, real_reduce = trainer.make_train_step, mesh.reduce_over_data

    def make_train_step(*a, **k):
        step = real_step(*a, **k)

        def step_fn(state, batch, rand):
            new, losses = step(state, batch, rand)
            if fault == "state_unchanged":
                return state._replace(step=new.step), losses
            if fault == "loss_altered":
                losses = {**losses, "total": losses["total"] * 1.5}
            return new, losses
        step_fn.reduced_bytes, step_fn.sharded = 0, step.sharded
        return step_fn

    def reduce_over_data(grads, losses, m):
        if fault == "no_exchange":
            return grads, losses, 0
        # half of the batch left out, the mean taken over the rest
        if m.data_index >= m.num_data // 2:
            grads = {k: torch.zeros_like(v) for k, v in grads.items()}
            losses = {k: torch.zeros_like(v) for k, v in losses.items()}
        g, l, n = real_reduce(grads, losses, m)
        return ({k: 2 * v for k, v in g.items()},
                {k: 2 * v for k, v in l.items()}, n)
    trainer.make_train_step = make_train_step
    if fault in ("no_exchange", "half_batch"):
        mesh.reduce_over_data = reduce_over_data
    return _real_rank(*args)
'''


@pytest.mark.parametrize("fault,number", [
    ("state_unchanged", "change_gap"), ("loss_altered", "loss_gap"),
    ("half_batch", "loss_gap"), ("no_exchange", "loss_gap")])
def test_a_step_broken_in_the_ranks_reads_not_correct(dp4_root, fault,
                                                     number):
    p = os.path.join(dp4_root, "bench_port", "entries", "train_dp4.py")
    with open(p, "a") as f:
        f.write(BREAK % (fault, fault))
    res, err = run_cell(dp4_root, CELL)
    assert not res["correct"], err
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


LOADS = '''

_real_rank = rank


def rank(*args):
    """The rank, with a stand-in of the JAX package loaded in rank 1."""
    import sys
    import types
    import torch.distributed as dist
    if dist.get_rank() == 1:
        sys.modules["dodt_tpu"] = types.ModuleType("dodt_tpu")
    return _real_rank(*args)
'''


def test_a_forbidden_module_in_a_rank_gives_no_result(dp4_root, capsys):
    p = os.path.join(dp4_root, "bench_port", "entries", "train_dp4.py")
    with open(p, "a") as f:
        f.write(LOADS)
    with pytest.raises(SystemExit) as e:
        run_cell(dp4_root, CELL)
    assert e.value.code == 2
    assert "{1: ['dodt_tpu']}" in capsys.readouterr().err
