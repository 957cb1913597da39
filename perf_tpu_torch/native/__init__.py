"""Host-side C++ of the port, built with ``g++`` at first use.

Counterpart of ``perf_tpu/native/__init__.py``. ``tour.cpp`` is the
package's own copy of ``perf_tpu/native/tour.cpp`` (the anchor-tour
annealer). It is compiled into ``build/native`` at the repository root
(listed in ``.gitignore``), named by a hash of the source, and loaded with
``ctypes``. There is no NumPy fallback: the JAX package's fallback anneals
with another generator and gives another order, so a missing compiler
raises instead of changing the trajectory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "native"
_LIBS: dict = {}
_LOCK = threading.Lock()


def build_and_load(name: str) -> ctypes.CDLL:
    """Compile ``<name>.cpp`` (once per source hash) and load it."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = _DIR / f"{name}.cpp"
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        lib_path = BUILD_DIR / f"lib{name}.{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
        _LIBS[name] = ctypes.CDLL(str(lib_path))
        return _LIBS[name]


def solve_tour(positions: np.ndarray, n_steps: int = 10000,
               seed: int = 0) -> np.ndarray:
    """Anchor order [n] int64 of a short open tour through ``positions``
    [n, 3]: simulated annealing of random pair swaps."""
    positions = np.ascontiguousarray(positions, dtype=np.float32)
    n = positions.shape[0]
    lib = build_and_load("tour")
    lib.solve_tour.restype = ctypes.c_double
    order = np.empty(n, dtype=np.int64)
    lib.solve_tour(
        positions.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(n), ctypes.c_int64(n_steps),
        ctypes.c_uint64(seed or 1),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return order
