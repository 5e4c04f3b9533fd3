"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

The ``.cu`` sources have a plain C interface. At first use each is
compiled by its own ``nvcc`` for ``sm_90a``, all started together, and
the objects are linked into one shared library under ``build/kernels/``
at the repository root (listed in ``.gitignore``) and loaded with
``ctypes``. The library's file name
carries a hash of the sources and flags, so an edited source is rebuilt
and a stale library is never loaded.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` as an int; ``CudaKernel`` raises on a non-zero
return and otherwise counts the launch. ``KERNELS`` lists every entry
point, in the order their modules defined them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_lib: Optional[ctypes.CDLL] = None
KERNELS: List["CudaKernel"] = []


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc "
                           "on PATH to build the kernels")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdodt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile the kernel library unless a library of the current
    sources exists. Returns its path and the compiler's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel;
    empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        objs.append(BUILD_DIR / f"{src.stem}.{tag}.o")
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs[-1]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    failed = [f"{o.name}: nvcc exit {p.returncode}\n{log}"
              for o, p, log in zip(objs, procs, logs) if p.returncode]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        res = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True,
                             text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode:
            failed.append(f"link: nvcc exit {res.returncode}\n{logs[-1]}")
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    return out, "".join(logs)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        lib.dodt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dodt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class CudaKernel:
    """One C entry point of the kernel library.

    ``launches`` counts launches that returned no error; a wrapper calls
    the kernel only where it launches it, so the count shows which path
    a run took.
    """

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def __call__(self, device: torch.device, *args) -> None:
        if self._fn is None:
            fn = getattr(load(), self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        index = device.index or 0
        # the current stream's handle, without building a Stream object
        err = self._fn(*args, index, torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            msg = load().dodt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      ndim: int, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    rank ``ndim`` whose data pointer is ``align``-byte aligned (the
    kernels use 16-byte vector loads)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")
