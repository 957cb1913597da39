"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and bound with ``ctypes``. Nothing is
built or loaded at import: the first launch of a kernel builds it, and
``build_all`` builds every source at once, one ``nvcc`` process per source,
all started together. Libraries land in ``build/kernels`` at the repository
root (listed in ``.gitignore``), named by a hash of their source, the
shared headers (``csrc/*.cuh``) and flags, so an edited source or header is
rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; ``CudaKernel.launch`` raises on a
non-zero return and counts the launch. A library's ``-Xptxas -v`` log is
kept beside it (``.log``), so a library built by an earlier process still
has its log (``CudaKernel.build_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda/bin)")


_LIBS: dict = {}            # library path -> loaded ctypes.CDLL
_LIB_LOCK = threading.Lock()


class CudaKernel:
    """One C entry point ``symbol`` of the ``csrc/<source>`` library. Entry
    points of one source with the same flags share one library.

    ``launches`` counts successful launches; nothing else increments it."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 extra_flags: tuple = ()):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.extra_flags = list(extra_flags)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lib = None

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def _cmd(self):
        src = self.source_path
        flags = ARCH_FLAGS + BASE_FLAGS + self.extra_flags
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(src.read_bytes() + headers
                                + " ".join(flags).encode()).hexdigest()[:12]
        out = BUILD_DIR / f"{src.stem}.{digest}.so"
        return [_nvcc(), *flags, "-o", str(out), str(src)], out

    def start_build(self):
        """Start nvcc unless the library exists; returns (Popen|None, path)."""
        cmd, out = self._cmd()
        if out.exists():
            return None, out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd[cmd.index("-o") + 1] = str(tmp)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path, proc.out_path = tmp, out
        return proc, out

    @staticmethod
    def finish_build(proc) -> str:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        proc.out_path.with_suffix(".log").write_text(log)
        os.replace(proc.tmp_path, proc.out_path)
        return log

    def _load(self):
        with _LIB_LOCK:
            if self._fn is None:
                out = self._cmd()[1]
                lib = _LIBS.get(out)
                if lib is None:
                    proc, out = self.start_build()
                    if proc is not None:
                        self.build_log = self.finish_build(proc)
                    lib = _LIBS[out] = ctypes.CDLL(str(out))
                if not self.build_log and out.with_suffix(".log").exists():
                    self.build_log = out.with_suffix(".log").read_text()
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes + [P]
                fn.restype = I32
                self._fn, self._lib = fn, lib
        return self._fn

    def library(self) -> ctypes.CDLL:
        """The loaded library of this kernel's source (built at first use)."""
        self._load()
        return self._lib

    def launch(self, *args):
        """Launch on the current stream; raise on a CUDA error."""
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


KERNELS: dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def build_all() -> dict:
    """Build every registered kernel's library in parallel; returns
    {name: nvcc log} (``-Xptxas -v`` register / spill report)."""
    # each wrapper module registers its kernels when it is imported
    from ..core import resample  # noqa: F401
    from ..fields import ngp  # noqa: F401
    from ..kernels import brickgrid, gather, hashgrid  # noqa: F401
    from ..render import occgrid, prop, renderer, snapshot  # noqa: F401
    from ..train import scene  # noqa: F401
    started = {}                     # one nvcc per library, all at once
    for k in KERNELS.values():
        out = k._cmd()[1]
        if out not in started:
            started[out] = [k, k.start_build()[0], ""]
    for entry in started.values():
        if entry[1] is not None:
            entry[2] = CudaKernel.finish_build(entry[1])
    logs = {}
    for k in KERNELS.values():
        k.build_log = started[k._cmd()[1]][2]
        logs[k.name] = k.build_log
        k._load()
    return logs


def reset_counts():
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in KERNELS.values()}


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where a dim of None is free) on ``device``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
