"""ctypes bindings for the native (C++) components: the KITTI AP
evaluator (``kitti_ap.cpp``) and the velodyne loader
(``kitti_loader.cpp``).

``build()`` compiles each source with ``g++`` into ``build/native/`` at
the repository root (listed in ``.gitignore``), never beside the
sources. A library's file name carries a hash of its source, the flags,
the compiler's version and the C library's, so an edited source is
rebuilt and a library built on another machine is never loaded. Without
a compiler every caller degrades to the pure-Python twins, as the JAX
package's does. ``route()`` says which AP route the last
``kitti_ap.evaluate_ap`` call took.

The port's copy of dodt_tpu/native/__init__.py, which builds with
``-march=native`` beside its sources; here no ``-march``: the baseline
x86-64 target has no fused multiply-add for the compiler to contract
into, so the library computes as the Python route does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = {"kitti_ap": ["-O3", "-shared", "-fPIC"],
         "kitti_loader": ["-O3", "-shared", "-fPIC", "-pthread"]}

_paths: Dict[str, Path] = {}
_route: Optional[str] = None


def _compiler_version() -> str:
    try:
        return subprocess.run(["g++", "--version"], capture_output=True,
                              text=True, check=True).stdout
    except (subprocess.CalledProcessError, FileNotFoundError):
        return ""


def library_path(name: str) -> Path:
    """Where ``lib<name>.so`` of the current source lives."""
    if name not in _paths:
        h = hashlib.sha256((_DIR / f"{name}.cpp").read_bytes())
        h.update(" ".join(FLAGS[name]).encode())
        h.update(_compiler_version().encode())
        h.update(" ".join(platform.libc_ver()).encode())
        _paths[name] = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    return _paths[name]


def _load(name: str):
    path = library_path(name)
    if not path.exists():
        return None
    return ctypes.CDLL(str(path))


def build(force: bool = False) -> bool:
    """Build the native libs into ``build/native/``. Returns True on
    success, False without a working ``g++`` (the Python twins then
    serve)."""
    if not force and available():
        return True
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, flags in FLAGS.items():
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *flags, str(_DIR / f"{name}.cpp"), "-o",
                            str(tmp)], check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, out)   # atomic: a reader never sees half a file
    return True


def available() -> bool:
    return all(library_path(name).exists() for name in FLAGS)


def note_route(name: str) -> None:
    global _route
    _route = name


def route() -> Optional[str]:
    """"native" or "python": the route the last ``kitti_ap.evaluate_ap``
    call took; None before the first call."""
    return _route


_ap_lib = None
_loader_lib = None


def _get_ap_lib():
    global _ap_lib
    if _ap_lib is None:
        lib = _load("kitti_ap")
        if lib is None:
            return None
        lib.kitti_ap.restype = ctypes.c_double
        lib.kitti_ap.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32),    # gt_counts
            np.ctypeslib.ndpointer(np.float64),  # gt_boxes7
            np.ctypeslib.ndpointer(np.float64),  # gt_bbox4
            np.ctypeslib.ndpointer(np.int32),    # ignored_gt
            np.ctypeslib.ndpointer(np.int32),    # dc_counts
            np.ctypeslib.ndpointer(np.float64),  # dc_bbox4
            np.ctypeslib.ndpointer(np.int32),    # det_counts
            np.ctypeslib.ndpointer(np.float64),  # det_boxes7
            np.ctypeslib.ndpointer(np.float64),  # det_bbox4
            np.ctypeslib.ndpointer(np.float64),  # det_scores
            np.ctypeslib.ndpointer(np.int32),    # ignored_det
        ]
        _ap_lib = lib
    return _ap_lib


def _get_loader_lib():
    global _loader_lib
    if _loader_lib is None:
        lib = _load("kitti_loader")
        if lib is None:
            return None
        lib.load_velodyne_cam.restype = ctypes.c_int
        lib.load_velodyne_cam.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.float64),
            np.ctypeslib.ndpointer(np.float64),
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.float32),
            ctypes.c_int,
        ]
        _loader_lib = lib
    return _loader_lib


# ---------------------------------------------------------------- AP

_METRIC_IDS = {"image": 0, "ground": 1, "3d": 2}


def kitti_ap_native(gt_counts, gt_boxes7, gt_bbox4, ignored_gt,
                    dc_counts, dc_bbox4,
                    det_counts, det_boxes7, det_bbox4, det_scores,
                    ignored_det, metric: str, min_iou: float) -> float:
    lib = _get_ap_lib()
    if lib is None:
        raise RuntimeError("libkitti_ap.so not built")
    return lib.kitti_ap(
        _METRIC_IDS[metric], min_iou, len(gt_counts),
        np.ascontiguousarray(gt_counts, np.int32),
        np.ascontiguousarray(gt_boxes7, np.float64).reshape(-1),
        np.ascontiguousarray(gt_bbox4, np.float64).reshape(-1),
        np.ascontiguousarray(ignored_gt, np.int32),
        np.ascontiguousarray(dc_counts, np.int32),
        np.ascontiguousarray(dc_bbox4, np.float64).reshape(-1),
        np.ascontiguousarray(det_counts, np.int32),
        np.ascontiguousarray(det_boxes7, np.float64).reshape(-1),
        np.ascontiguousarray(det_bbox4, np.float64).reshape(-1),
        np.ascontiguousarray(det_scores, np.float64),
        np.ascontiguousarray(ignored_det, np.int32))


# ------------------------------------------------------------ loader

def load_velodyne_cam(path: str, velo_to_rect: np.ndarray,
                      p2: np.ndarray, image_shape,
                      ego_trans=None, ego_rot=None,
                      capacity: int = 262144) -> np.ndarray:
    """Read + transform + FOV-filter a velodyne file natively.
    Returns (N, 3) float32 camera-frame points."""
    lib = _get_loader_lib()
    if lib is None:
        raise RuntimeError("libkitti_loader.so not built")
    out = np.empty((capacity, 3), np.float32)
    t_ptr = r_ptr = None
    if ego_trans is not None:
        t_arr = np.ascontiguousarray(ego_trans, np.float64)
        r_arr = np.ascontiguousarray(ego_rot, np.float64)
        t_ptr = t_arr.ctypes.data_as(ctypes.c_void_p)
        r_ptr = r_arr.ctypes.data_as(ctypes.c_void_p)
    n = lib.load_velodyne_cam(
        path.encode(), np.ascontiguousarray(velo_to_rect,
                                            np.float64).reshape(-1),
        np.ascontiguousarray(p2, np.float64).reshape(-1),
        int(image_shape[0]), int(image_shape[1]), t_ptr, r_ptr,
        out, capacity)
    if n < 0:
        raise IOError(f"failed to read {path}")
    return out[:n].copy()
