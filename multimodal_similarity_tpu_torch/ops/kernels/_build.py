"""Build the CUDA sources under ``csrc/`` into shared libraries and load
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` at first use, into ``_build/`` beside the package (listed in
``.gitignore``).  The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("batch_hard", "lifted")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_BOUND: Dict[str, Callable] = {}

# kernel launches by kernel name, shared by every wrapper: each adds one
# where it launches its kernel; callers reset and read it to show that a
# path went through the kernels
LAUNCHES: Dict[str, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the CUDA "
                           "kernels")
    return path


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together.  Returns each new build's compiler
    output (``-Xptxas -v``: registers, shared memory, spills); raises with
    that output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)  # atomic: never a half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def bind(source: str, name: str, argtypes) -> Callable:
    """The C function ``name`` of ``csrc/<source>.cu`` with its ctypes
    signature set (int return), built and loaded at first use."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = getattr(load_library(source), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn
