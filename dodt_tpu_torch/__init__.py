"""dodt_tpu_torch — the PyTorch + CUDA port of dodt_tpu.

Mirrors the JAX package module for module (``ops/``, ``models/``,
``runtime/``) and is held against it by the ``tests/test_torch_*.py``
parity tests. Public functions keep the JAX package's NHWC layout.
All four Pallas kernels of the JAX package are hand-written CUDA kernels
for Hopper (``csrc/``), each with a plain PyTorch twin in the same
module; the twin runs for CPU tensors, the kernel for CUDA tensors.

This package imports ``torch`` and nothing of ``jax``, ``flax``,
``orbax`` or the JAX package ``dodt_tpu``. The host modules it needs
are its own copies, under the JAX package's module names: ``config``,
``data/clusters.py``, ``eval/decode.py``, ``utils/metrics.py``,
``utils/np_iou.py``, and ``data/synthetic_scan.py`` (bench.py's input
maker). A JAX config converts through JSON
(``convert.config_from_json``).
"""

__version__ = "0.1.0"
