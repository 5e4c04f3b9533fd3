"""A configuration's model is built by the family its file names
(``families/<family>.py``; ``dt_avod`` where it names none): the same
modules and weights as a direct build, a new family added as files
alone, and a family that does not build the pipeline's model_name
refused at set-up."""
import json
import os

import pytest
import torch

from conftest import BENCH, run_cell
from harness.cells import family_of
from harness.weights import make_weights


def shapes(module):
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


@pytest.mark.parametrize("name", ["cars_dt", "cars_single"])
def test_family_builds_the_models_a_direct_build_does(name):
    from dodt_tpu_torch.config import PipelineConfig
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    from reference.config import PipelineConfig as RefConfig
    from reference.model import DtAvodNet as RefNet
    config = json.load(open(os.path.join(BENCH, "configs", name + ".json")))
    assert "family" not in config
    family = family_of(config)
    text = json.dumps(config["pipeline"])
    clusters = tuple(map(tuple, config["cluster_sizes"]))
    cfg, rcfg = PipelineConfig.from_json(text), RefConfig.from_json(text)
    program = shapes(family.program(cfg, config))
    assert program == shapes(DtAvodNet(cfg, clusters,
                                       num_frames=config["num_frames"]))
    reference = shapes(family.reference(rcfg, config, "float32"))
    assert reference == shapes(RefNet(rcfg, clusters,
                                      num_frames=config["num_frames"],
                                      precision="float32"))
    assert program == reference
    dev, scales = torch.device("cpu"), config["assumed"]["output_scales"]
    a = make_weights(program, 2 ** 31 + 7, dev, scales)
    b = make_weights(reference, 2 ** 31 + 7, dev, scales)
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


TWIN = '''"""Family twin: the dt_avod family's models, built through a module
of their own."""
import sys

MODEL_NAMES = ("dt_avod_model",)


def program(cfg, config):
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    print("twin: program", file=sys.stderr)
    return DtAvodNet(cfg, tuple(map(tuple, config["cluster_sizes"])),
                     num_frames=config["num_frames"])


def reference(ref_cfg, config, precision="float32"):
    from reference.model import DtAvodNet
    print("twin: reference", file=sys.stderr)
    return DtAvodNet(ref_cfg, tuple(map(tuple, config["cluster_sizes"])),
                     num_frames=config["num_frames"], precision=precision)
'''


def snapshot(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[p] = open(p, "rb").read()
    return out


def add_config(root, name, cell, **changes):
    """A configuration ``name`` (cars_dt's file with ``changes``) and its
    stream cell, as a later PR would add them: files and entries."""
    bench_dir = os.path.join(root, "bench_port")
    cfg = json.load(open(os.path.join(bench_dir, "configs", "cars_dt.json")))
    cfg.update(name=name, **changes)
    json.dump(cfg, open(os.path.join(bench_dir, "configs", name + ".json"),
                        "w"))
    json.dump({"feat_gap": 0.5, "proposal_miss": 0.5, "final_gap": 0.5},
              open(os.path.join(bench_dir, "limits", cell + ".json"), "w"))
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": name, "source": "x",
                             "file": f"bench_port/configs/{name}.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": name,
                               "traffic": "stream", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "cars_dt.stream" in m.get("workloads", []):
            m["workloads"].append(cell)
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return cfg


def test_a_family_added_as_files_runs(tiny_root, capsys):
    """A second family module and a configuration that names it, added as
    files: the run builds the program and the reference through it, and
    no existing file changes."""
    before = snapshot(os.path.join(tiny_root, "bench_port"))
    with open(os.path.join(tiny_root, "bench_port", "families", "twin.py"),
              "w") as f:
        f.write(TWIN)
    add_config(tiny_root, "cars_twin", "cars_twin.stream", family="twin")
    res, err = run_cell(tiny_root, "cars_twin.stream")
    assert res["correct"], err
    said = capsys.readouterr().err
    assert "twin: program" in said and "twin: reference" in said
    assert all(open(p, "rb").read() == b for p, b in before.items())


@pytest.mark.parametrize("family", [None, "twin"])
def test_a_family_that_does_not_build_the_model_name_raises(tiny_root,
                                                            family):
    with open(os.path.join(tiny_root, "bench_port", "families", "twin.py"),
              "w") as f:
        f.write(TWIN)
    changes = {} if family is None else {"family": family}
    cfg = add_config(tiny_root, "cars_stack", "cars_stack.stream", **changes)
    p = os.path.join(tiny_root, "bench_port", "configs", "cars_stack.json")
    cfg["pipeline"]["model"]["model_name"] = "stack_avod_model"
    json.dump(cfg, open(p, "w"))
    with pytest.raises(ValueError, match=r"family '(dt_avod|twin)' builds "
                       r".*model_name is 'stack_avod_model'"):
        run_cell(tiny_root, "cars_stack.stream")
