"""A cell of BENCHMARK.json and the files it is made of, found by name:
``configs/<config>.json`` (the configuration's file as BENCHMARK.json
names it; its ``family`` names the module ``families/<family>.py`` that
builds its model, ``dt_avod`` where it names none),
``traffic/<traffic>.json`` (the mix's parameters; its
``entry`` names the module ``entries/<entry>.py`` that drives the
program and compares), ``limits/<cell>.json`` and one
``metrics/<metric>.py`` per metric. Adding a configuration, a model
family, a mix, an entry, a cell or a metric adds files and entries; no
file changes."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH_DIR = "bench_port"
# The checkout this harness lies in: where a family is found when no
# other root is given.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_FAMILY = "dt_avod"


class Cell:
    def __init__(self, name: str, spec: Dict, config: Dict, mix: Dict,
                 limits: Dict, end_to_end: List[Dict], per_layer: List[Dict],
                 family):
        self.name = name
        self.chips = spec["chips"]
        self.config, self.mix, self.limits = config, mix, limits
        self.family = family
        self.end_to_end, self.per_layer = end_to_end, per_layer


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    specs = {w["name"]: w for w in bench["workloads"]}
    if name not in specs:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: "
                         f"{sorted(specs)}")
    spec = specs[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[spec["config"]]
    here = os.path.join(root, BENCH_DIR)
    config = _json(os.path.join(root, cfg_entry["file"]))
    return Cell(
        name, spec, config,
        _json(os.path.join(here, "traffic", spec["traffic"] + ".json")),
        _json(os.path.join(here, "limits", name + ".json")),
        [m for m in bench["end_to_end"] if _applies(m, name)],
        [m for m in bench["per_layer"] if _applies(m, name)],
        family_of(config, root))


def _module(root: str, sub: str, name: str):
    path = os.path.join(root, BENCH_DIR, sub, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{sub}_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_metric(root: str, name: str):
    """The reader module ``metrics/<name>.py`` of an end-to-end or
    per-layer metric: ``read(readings)`` gives the metric's value, or
    None where the run has nothing to read."""
    return _module(root, "metrics", name)


def load_entry(root: str, name: str):
    """The entry module ``entries/<name>.py`` that a mix's ``entry``
    names: ``drive``, ``check`` and ``control`` (harness/program.py)."""
    return _module(root, "entries", name)


def load_family(root: str, name: str):
    """The model family module ``families/<name>.py``: ``MODEL_NAMES``,
    ``program(cfg, config)`` and ``reference(ref_cfg, config,
    precision)`` (families/dt_avod.py)."""
    return _module(root, "families", name)


def family_of(config: Dict, root: str = ROOT):
    """The family module of a configuration file's contents: the one its
    ``family`` names, ``dt_avod`` where it names none. Raises where that
    family does not build the pipeline's ``model_name``, so that no
    configuration is built silently as another family's model."""
    name = config.get("family", DEFAULT_FAMILY)
    family = load_family(root, name)
    model = config["pipeline"]["model"]["model_name"]
    if model not in family.MODEL_NAMES:
        raise ValueError(
            f"configuration {config.get('name')!r}: family {name!r} builds "
            f"{list(family.MODEL_NAMES)}, the pipeline's model_name is "
            f"{model!r}")
    return family
