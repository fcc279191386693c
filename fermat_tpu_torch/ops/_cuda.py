"""Build and bind the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for sm_90a into a shared library
with a plain C interface and called through ctypes: pointers come from
`tensor.data_ptr()`, the stream from `torch.cuda.current_stream()`. Nothing
is compiled when a module is imported; the first launch builds the library
into `fermat_tpu_torch/_build/` (listed in .gitignore), keyed by a hash of
the source, the csrc/ headers it includes and the flags, so a fresh checkout
builds from its own sources.

Every C entry point returns the `cudaGetLastError()` seen after its launch;
a non-zero code raises. A failed build raises with the compiler output.
There is no fallback to the plain PyTorch version.

The tracer kernels are compiled with --fmad=false (and never with
-use_fast_math): torch's elementwise kernels do not contract a*b+c across
ops, so with contraction off the kernel rounds exactly like its plain
version on the card and the two can be held to equal hit ids.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source on first use")
    return found


_LOCAL_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def _lib_path(source: str) -> Path:
    """The library's path, keyed by the source, the headers of csrc/ it
    includes and the flags: editing a shared header rebuilds its users."""
    src = (CSRC / source).read_bytes()
    headers = b"".join((CSRC / h.decode()).read_bytes() for h in _LOCAL_INCLUDE.findall(src))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{key}.so"


class BuildResult:
    def __init__(self, source: str, path: Path, seconds: float, log: str):
        self.source, self.path, self.seconds, self.log = source, path, seconds, log


def build(sources: List[str]) -> Dict[str, BuildResult]:
    """Compile every source not yet built, one nvcc process each, all started
    together. Returns {source: BuildResult}; raises on any failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, BuildResult] = {}
    procs = []
    for s in sources:
        path = _lib_path(s)
        if path.exists():
            out[s] = BuildResult(s, path, 0.0, "cached")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / s)]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        procs.append((s, path, tmp, p, time.perf_counter()))
    failures = []
    for s, path, tmp, p, t0 in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {s} (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
        out[s] = BuildResult(s, path, time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


_LIBS: Dict[str, ctypes.CDLL] = {}


def _library(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        res = build([source])[source]
        lib = ctypes.CDLL(str(res.path))
        _LIBS[source] = lib
    return lib


P = ctypes.c_void_p  # device pointers and the stream
I = ctypes.c_int


class CudaKernel:
    """One C entry point of a csrc/ library, with its launch count.

    `launches` counts calls that launched the kernel; chip_smoke.py resets
    it to 0 before driving the main path and reads it afterwards, and the
    command line's -benchmark JSON reports it. `every` lists the kernels
    defined so far.
    """

    every: List["CudaKernel"] = []

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        CudaKernel.every.append(self)
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None

    def _bind(self):
        lib = _library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes + [I, P]  # device index, stream
        fn.restype = I
        err = getattr(lib, "fermat_error_string")
        err.argtypes = [I]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err
        return fn

    def launch(self, device: torch.device, *args, count: int = 1) -> None:
        """Calls the entry point; `count` is the number of this kernel's
        launches the call enqueues (one C call may enqueue a batch)."""
        fn = self._fn or self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        code = fn(*args, device.index if device.index is not None
                  else torch.cuda.current_device(), stream)
        if code != 0:
            raise RuntimeError(f"{self.name}: CUDA error {code} "
                               f"({self._err(code).decode()}) at launch")
        self.launches += count


def check_cuda_tensor(t: torch.Tensor, name: str, dtype, ndim: int,
                      device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
