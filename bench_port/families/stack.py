"""Family ``stack``: the port's ``StackAvodNet`` (``stack_avod_model``,
F = ``data_stride + 1`` frames a sample) and the reference's copy of
its val forward (``reference/stack.py``). A configuration file names it
under ``family``; ``harness.cells.family_of`` finds it by name."""
from typing import Dict

MODEL_NAMES = ("stack_avod_model",)


def clusters(config: Dict):
    return tuple(map(tuple, config["cluster_sizes"]))


def program(cfg, config: Dict):
    from dodt_tpu_torch.models.stack import StackAvodNet
    return StackAvodNet(cfg, clusters(config))


def reference(ref_cfg, config: Dict, precision: str = "float32"):
    from reference.stack import StackAvodNet
    return StackAvodNet(ref_cfg, clusters(config), precision=precision)
