"""PLY mesh loader, ASCII and binary little/big endian
(fermat_tpu/scene/loaders/ply.py; the reference's rply-based loadModelPLY).

Vertex x/y/z (with nx/ny/nz, and s/t or u/v) and face vertex_indices
lists, polygons triangulated as a fan; one default material, one group.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> MeshStorage:
    """A .ply file as a MeshStorage."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements: List[Tuple[str, int, list]] = []  # (name, count, props)
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("comment") or not line:
                continue
            tok = line.split()
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append((tok[4], "list", tok[2], tok[3]))
                else:
                    elements[-1][2].append((tok[2], "scalar", tok[1]))
            elif tok[0] == "end_header":
                break

        verts = np.zeros((0, 3), np.float32)
        norms = np.zeros((0, 3), np.float32)
        uvs = np.zeros((0, 2), np.float32)
        faces: List[List[int]] = []

        endian = "<" if fmt == "binary_little_endian" else ">"

        for name, count, props in elements:
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(f.readline().decode("ascii").split())
                if name == "vertex":
                    names = [p[0] for p in props]
                    arr = np.asarray(rows, np.float32)
                    verts, norms, uvs = _extract_vertex(arr, names)
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        faces.append([int(x) for x in r[1 : 1 + n]])
            else:
                if name == "vertex" and all(p[1] == "scalar" for p in props):
                    # fast path: fixed-stride vertex block via numpy
                    dt = np.dtype(
                        [(p[0], endian + _TYPES[p[2]][0]) for p in props]
                    )
                    arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
                    names = [p[0] for p in props]
                    cols = np.stack(
                        [arr[nm].astype(np.float32) for nm in names], axis=1
                    )
                    verts, norms, uvs = _extract_vertex(cols, names)
                elif name == "face":
                    for _ in range(count):
                        for p in props:
                            if p[1] == "list":
                                cfmt, csz = _TYPES[p[2]]
                                ifmt, isz = _TYPES[p[3]]
                                (n,) = struct.unpack(
                                    endian + cfmt, f.read(csz)
                                )
                                idx = struct.unpack(
                                    endian + ifmt * n, f.read(isz * n)
                                )
                                if p[0] in ("vertex_indices", "vertex_index"):
                                    faces.append(list(idx))
                            else:
                                f.read(_TYPES[p[2]][1])
                else:
                    # skip unknown fixed-stride element
                    stride = sum(_TYPES[p[2]][1] for p in props if p[1] == "scalar")
                    f.read(stride * count)

    tris = []
    for face in faces:
        for k in range(1, len(face) - 1):
            tris.append([face[0], face[k], face[k + 1]])
    tris_np = np.asarray(tris, np.int32).reshape(-1, 3)
    has_n = norms.shape[0] == verts.shape[0] and norms.shape[0] > 0
    has_uv = uvs.shape[0] == verts.shape[0] and uvs.shape[0] > 0
    mat = HostMaterial("default")
    mat.diffuse = (0.75, 0.75, 0.75)
    return MeshStorage(
        vertices=verts,
        triangles=tris_np,
        normals=norms if has_n else np.zeros((0, 3), np.float32),
        normal_indices=tris_np.copy() if has_n else np.full_like(tris_np, -1),
        uvs=uvs if has_uv else np.zeros((0, 2), np.float32),
        uv_indices=tris_np.copy() if has_uv else np.full_like(tris_np, -1),
        material_ids=np.zeros(tris_np.shape[0], np.int32),
        materials=[mat],
        group_names=["ply"],
        group_offsets=np.asarray([0, tris_np.shape[0]], np.int32),
    )


def _extract_vertex(arr: np.ndarray, names: List[str]):
    def cols(keys):
        if all(k in names for k in keys):
            return arr[:, [names.index(k) for k in keys]].astype(np.float32)
        return np.zeros((0, len(keys)), np.float32)

    verts = cols(["x", "y", "z"])
    norms = cols(["nx", "ny", "nz"])
    uvs = cols(["s", "t"])
    if uvs.shape[0] == 0:
        uvs = cols(["u", "v"])
    return verts, norms, uvs
