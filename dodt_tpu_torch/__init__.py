"""dodt_tpu_torch — the PyTorch + CUDA port of dodt_tpu.

Mirrors the JAX package module for module (``ops/``, ``models/``,
``runtime/``) and is held against it by the ``tests/test_torch_*.py``
parity tests. Public functions keep the JAX package's NHWC layout.
All four Pallas kernels of the JAX package are hand-written CUDA kernels
for Hopper (``csrc/``), each with a plain PyTorch twin in the same
module; the twin runs for CPU tensors, the kernel for CUDA tensors.

This package imports ``torch`` and never ``jax``, ``flax`` or ``orbax``.
Host modules of ``dodt_tpu`` that never import JAX (``dodt_tpu.config``,
``dodt_tpu.eval.decode``, ``dodt_tpu.utils.metrics``) are shared by
import.
"""

__version__ = "0.1.0"
