"""ctypes binding of the repo's native host runtime, native/fermat_native.cpp
(fermat_tpu/utils/native.py): the OBJ geometry parser and the binned-SAH
BVH builder, C++ host code for the CPU-bound parts of scene ingestion.

The port builds its own library from that source with g++ into
`fermat_tpu_torch/_build/` (listed in .gitignore) at first use, keyed by a
hash of the source, the flags and the host CPU's feature flags; it never
loads or writes the `native/libfermat_native.so` beside the source. The flags are
JAX's (native.py:63-66), so the two libraries compute the same trees.

Unlike JAX's binding, nothing falls back: a missing source, a failed build
or a failed load raises with the compiler's message, and a parse or build
that returns no result raises too. The Python routes are taken only where a
caller asks for them (`accel/bvh.build_bvh_for_mesh(use_native=False)`) or
below the size thresholds of the callers (`scene/loaders/obj.py`,
`accel/bvh.py`).
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "fermat_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib: Optional[C.CDLL] = None


class _ObjResult(C.Structure):
    _fields_ = [
        ("vertices", C.POINTER(C.c_float)),
        ("normals", C.POINTER(C.c_float)),
        ("uvs", C.POINTER(C.c_float)),
        ("tri_v", C.POINTER(C.c_int32)),
        ("tri_n", C.POINTER(C.c_int32)),
        ("tri_uv", C.POINTER(C.c_int32)),
        ("tri_mat", C.POINTER(C.c_int32)),
        ("mat_names", C.c_char_p),
        ("nv", C.c_int64), ("nn", C.c_int64), ("nt", C.c_int64),
        ("ntri", C.c_int64), ("n_mats", C.c_int64), ("mat_names_len", C.c_int64),
    ]


class _BvhResult(C.Structure):
    _fields_ = [
        ("lo", C.POINTER(C.c_float)),
        ("hi", C.POINTER(C.c_float)),
        ("skip", C.POINTER(C.c_int32)),
        ("prim_start", C.POINTER(C.c_int32)),
        ("is_leaf", C.POINTER(C.c_uint8)),
        ("prims", C.POINTER(C.c_int32)),
        ("n_nodes", C.c_int64),
        ("n_prim_slots", C.c_int64),
    ]


def _cpu_id() -> bytes:
    """The host CPU's feature flags: -march=native builds for them, so a
    library built on another CPU is not reused."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    """Where the library of this source, these flags and this CPU is built."""
    if not SOURCE.exists():
        raise RuntimeError(f"the native runtime's source is missing: {SOURCE}")
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + _cpu_id()).hexdigest()[:16]
    return BUILD_DIR / f"fermat_native-{key}.so"


def build() -> Path:
    """Compile the library unless it is built; raises with g++'s output."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    p = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp],
                       capture_output=True, text=True, timeout=300)
    if p.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SOURCE} (exit {p.returncode}):\n"
                           f"{p.stdout}{p.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build sees all or nothing
    return path


def _load() -> C.CDLL:
    global _lib
    if _lib is None:
        lib = C.CDLL(str(build()))
        lib.obj_load.restype = C.POINTER(_ObjResult)
        lib.obj_load.argtypes = [C.c_char_p]
        lib.obj_free.argtypes = [C.POINTER(_ObjResult)]
        lib.bvh_build.restype = C.POINTER(_BvhResult)
        lib.bvh_build.argtypes = [C.POINTER(C.c_float), C.POINTER(C.c_float),
                                  C.POINTER(C.c_float), C.c_int64, C.c_int32]
        lib.bvh_free.argtypes = [C.POINTER(_BvhResult)]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (it raises otherwise)."""
    _load()
    return True


def _as_np(ptr, shape, dtype):
    n = int(np.prod(shape))
    if n == 0:
        return np.zeros(shape, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True).reshape(shape)


def load_obj_geometry(path: str) -> dict:
    """Native OBJ parse (native.py:100-129): vertices, normals, uvs, tri_v,
    tri_n, tri_uv, tri_mat and material_names (usemtl first-use order)."""
    lib = _load()
    rp = lib.obj_load(os.fsencode(path))
    if not rp:
        raise RuntimeError(f"native obj_load could not read {path}")
    r = rp.contents
    try:
        return {
            "vertices": _as_np(r.vertices, (int(r.nv), 3), np.float32),
            "normals": _as_np(r.normals, (int(r.nn), 3), np.float32),
            "uvs": _as_np(r.uvs, (int(r.nt), 2), np.float32),
            "tri_v": _as_np(r.tri_v, (int(r.ntri), 3), np.int32),
            "tri_n": _as_np(r.tri_n, (int(r.ntri), 3), np.int32),
            "tri_uv": _as_np(r.tri_uv, (int(r.ntri), 3), np.int32),
            "tri_mat": _as_np(r.tri_mat, (int(r.ntri),), np.int32),
            "material_names": (
                C.string_at(r.mat_names, int(r.mat_names_len)).decode().split("\n")[:-1]
                if r.mat_names_len else []),
        }
    finally:
        lib.obj_free(rp)


def build_bvh_native(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                     leaf_size: int = 4) -> dict:
    """Native binned-SAH build (native.py:132-157): the flattened skip-link
    arrays lo, hi, skip, prim_start, is_leaf and prims."""
    lib = _load()
    c = np.ascontiguousarray(centroids, np.float32)
    lo_ = np.ascontiguousarray(lo, np.float32)
    hi_ = np.ascontiguousarray(hi, np.float32)
    fp = C.POINTER(C.c_float)
    rp = lib.bvh_build(c.ctypes.data_as(fp), lo_.ctypes.data_as(fp), hi_.ctypes.data_as(fp),
                       C.c_int64(c.shape[0]), C.c_int32(leaf_size))
    if not rp:
        raise RuntimeError(f"native bvh_build returned no tree for {c.shape[0]} primitives")
    r = rp.contents
    nn = int(r.n_nodes)
    try:
        return {
            "lo": _as_np(r.lo, (nn, 3), np.float32),
            "hi": _as_np(r.hi, (nn, 3), np.float32),
            "skip": _as_np(r.skip, (nn,), np.int32),
            "prim_start": _as_np(r.prim_start, (nn,), np.int32),
            "is_leaf": _as_np(r.is_leaf, (nn,), np.uint8).astype(bool),
            "prims": _as_np(r.prims, (int(r.n_prim_slots),), np.int32),
        }
    finally:
        lib.bvh_free(rp)
