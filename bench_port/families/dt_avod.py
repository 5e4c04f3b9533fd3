"""Family ``dt_avod``: the port's ``DtAvodNet`` and the reference's copy
of it, paired (``num_frames`` 2, ``dt_avod_model``) or single-frame
(``num_frames`` 1, ``avod_model``). A configuration file that names no
``family`` is of this one.

A family module exports ``MODEL_NAMES`` (the ``pipeline.model.model_name``
values it builds), ``program(cfg, config)`` (the port's model on the CPU,
weights not set) and ``reference(ref_cfg, config, precision)`` (the plain
reference's model); ``harness.cells.family_of`` finds it by name."""
from typing import Dict

MODEL_NAMES = ("dt_avod_model", "avod_model")


def clusters(config: Dict):
    return tuple(map(tuple, config["cluster_sizes"]))


def program(cfg, config: Dict):
    from dodt_tpu_torch.models.dt_avod import DtAvodNet
    return DtAvodNet(cfg, clusters(config), num_frames=config["num_frames"])


def reference(ref_cfg, config: Dict, precision: str = "float32"):
    from reference.model import DtAvodNet
    return DtAvodNet(ref_cfg, clusters(config),
                     num_frames=config["num_frames"], precision=precision)
