"""STL (binary and ASCII) and OFF importers (fermat_tpu/scene/loaders/misc.py),
the two interchange formats JAX parses itself where the reference falls
back to assimp. An STL's triangle soup is welded into shared vertices (the
corners rounded to 7 decimals); OFF polygons are triangulated as a fan.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage


def _default_material() -> HostMaterial:
    m = HostMaterial("default")
    m.diffuse = (0.7, 0.7, 0.7)
    return m


def _soup_storage(tris: np.ndarray, name: str) -> MeshStorage:
    """(T, 3, 3) corner positions -> MeshStorage (deduplicated vertices)."""
    flat = tris.reshape(-1, 3).astype(np.float32)
    verts, inv = np.unique(flat.round(7), axis=0, return_inverse=True)
    t = inv.reshape(-1, 3).astype(np.int32)
    return MeshStorage(
        vertices=verts.astype(np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.zeros(t.shape[0], np.int32),
        materials=[_default_material()],
        group_names=[name],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )


def load_stl(path: str) -> MeshStorage:
    """STL importer — binary (84-byte header + 50-byte records) or ASCII."""
    with open(path, "rb") as f:
        head = f.read(84)
    is_ascii = head[:5].lower() == b"solid"
    if is_ascii:
        # a binary file can also start with 'solid'; verify the count math
        try:
            n = struct.unpack("<I", head[80:84])[0]
            if os.path.getsize(path) == 84 + 50 * n:
                is_ascii = False
        except struct.error:
            pass
    if is_ascii:
        tris = []
        cur = []
        with open(path, "r", errors="replace") as f:
            for line in f:
                tok = line.split()
                if len(tok) >= 4 and tok[0] == "vertex":
                    cur.append([float(tok[1]), float(tok[2]), float(tok[3])])
                    if len(cur) == 3:
                        tris.append(cur)
                        cur = []
        if not tris:
            raise ValueError(f"no triangles in ASCII STL {path}")
        return _soup_storage(np.asarray(tris, np.float64), "stl")
    n = struct.unpack("<I", head[80:84])[0]
    with open(path, "rb") as f:
        f.seek(84)
        raw = np.frombuffer(f.read(50 * n), np.uint8)
    if raw.size != 50 * n:
        raise ValueError(f"truncated binary STL {path}")
    rec = raw.reshape(n, 50)
    # 12B normal + 3x12B vertices + 2B attr
    v = rec[:, 12:48].copy().view(np.float32).reshape(n, 3, 3)
    return _soup_storage(v.astype(np.float64), "stl")


def load_off(path: str) -> MeshStorage:
    """OFF importer (triangulates polygonal faces as a fan)."""
    with open(path, "r", errors="replace") as f:
        tokens = []
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                tokens.extend(line.split())
    i = 0
    if tokens[i].upper().endswith("OFF"):
        i += 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    verts = np.asarray(tokens[i:i + 3 * nv], np.float64).reshape(nv, 3)
    i += 3 * nv
    tris = []
    for _ in range(nf):
        k = int(tokens[i])
        idx = [int(x) for x in tokens[i + 1:i + 1 + k]]
        i += 1 + k
        for j in range(1, k - 1):  # fan triangulation
            tris.append([idx[0], idx[j], idx[j + 1]])
    t = np.asarray(tris, np.int32)
    return MeshStorage(
        vertices=verts.astype(np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.zeros(t.shape[0], np.int32),
        materials=[_default_material()],
        group_names=["off"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )
