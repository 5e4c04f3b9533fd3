"""Runtime format contracts for box/anchor tensors.

Parity target: reference avod/core/format_checker.py:1-226 — raises on
malformed representations. Works on numpy arrays and (shape-only) on
traced JAX values; value checks are skipped under tracing.

The port's copy of dodt_tpu/utils/format_checker.py.
"""
from __future__ import annotations

import numpy as np


class FormatError(ValueError):
    pass


def _last_dim(x):
    if hasattr(x, "shape") and len(x.shape) > 0:
        return x.shape[-1]
    return None


def _is_concrete(x):
    return isinstance(x, np.ndarray) or np.isscalar(x) or \
        isinstance(x, (list, tuple))


def check_box_3d(x):
    """box_3d: (..., 7) [x, y, z, l, w, h, ry]; dims positive, ry in
    [-pi, pi] (value checks only on concrete arrays)."""
    if _last_dim(x) != 7:
        raise FormatError(f"box_3d must have last dim 7, got {x.shape}")
    if _is_concrete(x):
        a = np.asarray(x).reshape(-1, 7)
        if len(a) and np.any(a[:, 3:6] < 0):
            raise FormatError("box_3d dims must be non-negative")
        if len(a) and np.any(np.abs(a[:, 6]) > np.pi + 1e-4):
            raise FormatError("box_3d ry must be within [-pi, pi]")
    return x


def check_anchor(x):
    """anchor: (..., 6) [x, y, z, dim_x, dim_y, dim_z]."""
    if _last_dim(x) != 6:
        raise FormatError(f"anchor must have last dim 6, got {x.shape}")
    if _is_concrete(x):
        a = np.asarray(x).reshape(-1, 6)
        if len(a) and np.any(a[:, 3:6] <= 0):
            raise FormatError("anchor dims must be positive")
    return x


def check_box_4c(x):
    if _last_dim(x) != 10:
        raise FormatError(f"box_4c must have last dim 10, got {x.shape}")
    return x


def check_box_8c(x):
    shape = getattr(x, "shape", ())
    if len(shape) < 2 or shape[-2:] != (3, 8):
        raise FormatError(f"box_8c must end in (3, 8), got {shape}")
    return x


def check_bev_box(x):
    if _last_dim(x) != 4:
        raise FormatError(f"bev box must have last dim 4, got {x.shape}")
    return x
