"""ctypes bindings of the native (C++) host data path.

``csrc/msim_native.cc`` runs the host loops of the input pipeline:
TFRecord framing and SequenceExample parsing on a thread pool, straight
into a batch buffer, and the TSN gather that copies each event's sampled
frames out of a session's feature array.  It has a plain C interface and is
compiled with ``g++`` at first use into ``_build/`` beside the package
(listed in ``.gitignore``), under a file name that carries a hash of the
source and the flags; the compiler writes a temporary file that is renamed
into place, so concurrent first uses from several processes never load a
half-written library.  A failed build or load raises with the compiler's
message: no caller falls back to Python because the library is missing.
What does fall back is data the native code does not take (features that
are not f32 or not C-contiguous, a prepare function that is not a TSN
sampler, a record whose key is missing or whose frame width differs): the
callers count each native call and each deferral (``PATHS``).
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from multimodal_similarity_tpu_torch.utils import profiling

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "msim_native.cc"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# calls by path, counted in the counter registry (utils/profiling.py) as
# ``native.<path>`` by the callers, from their threads: ``gather`` a
# session whose events took the native TSN gather, ``gather_deferred`` one
# that took the per-event Python loop; ``parse`` a TFRecord batch parsed
# natively, ``parse_deferred`` one parsed in Python
PATHS = ("gather", "gather_deferred", "parse", "parse_deferred")

_LOCK = threading.Lock()
_LIB = None


def reset_counts() -> None:
    """Set every path's counter to 0."""
    profiling.reset_counts("native.", PATHS)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libmsim_native_{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless its current build exists; raises with
    the compiler's output when ``g++`` fails or is missing."""
    target = library_path()
    if target.exists():
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native "
                           f"data path from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc {proc.returncode}) building "
                           f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)  # atomic: never a half-written library
    return target


def load_native() -> ctypes.CDLL:
    """The native library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.msim_crc32c.restype = ctypes.c_uint32
            lib.msim_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.msim_load_event_batch.restype = ctypes.c_int64
            lib.msim_load_event_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ]
            lib.msim_gather_segments.restype = None
            lib.msim_gather_segments.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ]
            _LIB = lib
        return _LIB


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_crc32c(data: bytes) -> int:
    return int(load_native().msim_crc32c(data, len(data)))


def native_load_event_batch(paths: Sequence[str], key: str, max_time: int,
                            feat_dim: int, n_threads: int = 0,
                            out: Optional[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]] = None):
    """Parse one-event TFRecord files on a thread pool -> (features [N,
    max_time, feat_dim] f32 zero-padded, seq_len [N] int32, labels [N]
    int32, the count of events parsed).  A file that fails its CRC, does
    not parse, lacks ``key`` or holds frames of another width is left
    zero (seq_len 1) and not counted.  ``out``: C-contiguous arrays of
    those shapes and types to parse into, in place of new ones."""
    lib = load_native()
    n = len(paths)
    if max_time < 1 or feat_dim < 1:
        raise ValueError(f"max_time {max_time} and feat_dim {feat_dim} "
                         "must be positive")
    if out is None:
        out = (np.empty((n, max_time, feat_dim), np.float32),
               np.empty((n,), np.int32), np.empty((n,), np.int32))
    feats, seq_len, labels = out
    if not (feats.shape == (n, max_time, feat_dim)
            and feats.dtype == np.float32 and seq_len.shape == (n,)
            and labels.shape == (n,) and seq_len.dtype == np.int32
            and labels.dtype == np.int32
            and all(a.flags["C_CONTIGUOUS"] for a in out)):
        raise ValueError("native_load_event_batch: out arrays of the wrong "
                         "shape, type or layout")
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ok = lib.msim_load_event_batch(
        c_paths, n, key.encode(), _ptr(feats, ctypes.c_float), max_time,
        feat_dim, _ptr(seq_len, ctypes.c_int32),
        _ptr(labels, ctypes.c_int32), n_threads)
    return feats, seq_len, labels, int(ok)


def native_gather_segments(feats: np.ndarray, starts: np.ndarray,
                           offsets: np.ndarray) -> np.ndarray:
    """feats [T, D] f32, starts [E] int64, offsets [E, S] int64 -> [E, S,
    D] f32, row e, s being ``feats[starts[e] + offsets[e, s]]``.  Raises
    IndexError for a frame index outside [0, T): the C side copies
    unchecked."""
    lib = load_native()
    feats = np.ascontiguousarray(feats, np.float32)
    starts = np.ascontiguousarray(starts, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    if feats.ndim != 2 or offsets.ndim != 2 or \
            starts.shape != offsets.shape[:1]:
        raise ValueError(
            f"gather_segments wants feats [T, D], starts [E], offsets "
            f"[E, S]; got {feats.shape}, {starts.shape}, {offsets.shape}")
    e, s = offsets.shape
    idx = starts[:, None] + offsets
    if idx.size and (idx.min() < 0 or idx.max() >= feats.shape[0]):
        raise IndexError(
            f"gather_segments frame index out of range: "
            f"[{idx.min()}, {idx.max()}] vs {feats.shape[0]} rows")
    out = np.empty((e, s, feats.shape[1]), np.float32)
    lib.msim_gather_segments(
        _ptr(feats, ctypes.c_float), feats.shape[1],
        _ptr(starts, ctypes.c_int64), _ptr(offsets, ctypes.c_int64), e, s,
        _ptr(out, ctypes.c_float))
    return out
