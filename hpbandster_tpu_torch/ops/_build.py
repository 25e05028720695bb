"""Build and load the port's CUDA kernels.

Each source in ``hpbandster_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``; the wrappers pass device pointers and PyTorch's current stream.
The library lands in ``<repo>/build/torch_kernels``, named by a hash of its
source and flags, so an edited source rebuilds and an
unchanged one loads at once. Nothing is built when a module is imported:
the first launch builds.

Built without ``--use_fast_math``: the scorer's parity with the reference
rests on IEEE ``logf``/``log1pf``/``expf`` and correctly rounded division.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

__all__ = ["BUILD_LOG", "CSRC", "build_dir", "find_nvcc", "build_library", "load_library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS: List[str] = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
#: compiler output of the builds this process ran (ptxas register and
#: shared-memory report), by kernel name
BUILD_LOG: Dict[str, str] = {}


def build_dir() -> Path:
    return CSRC.parent.parent / "build" / "torch_kernels"


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or the ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags is already built; returns the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    # compile to a private name, then rename: a reader never sees half a file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        BUILD_LOG[name] = proc.stdout + proc.stderr
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name)))
        _LOADED[name] = lib
    return lib
