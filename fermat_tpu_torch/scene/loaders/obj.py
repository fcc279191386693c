"""The Wavefront OBJ + MTL loader (fermat_tpu/scene/loaders/obj.py).

The MTL half: material records with their texture names, parsed as
MeshBase.cpp:530-700 does. The OBJ half (obj.py:72-88, :124-214): v / vn /
vt streams with independent v/vt/vn index triplets, 1-based and negative
(relative) indices, polygons triangulated as a fan, `g` / `o` groups kept
with their names, `mtllib` and `usemtl` materials in first-use order.
`save_obj` writes a MeshStorage as an OBJ and its MTL, which load_obj reads
back to the same arrays and materials (the scene files a test or a card
run writes at run time). Its corners take the standard forms v, v/vt,
v//vn and v/vt/vn: the native parser misreads "v/vt/" (an empty normal
index last), taking the next corner's vertex as its normal (ROADMAP
Queue 3).

Files of 1 MB or more (`_NATIVE_MIN_BYTES`) parse their geometry through
the native C++ runtime (utils/native.py), the MTL still here, as JAX routes
them (obj.py:77-121): the file is then one group, "default", and its
materials are the usemtl names in first-use order. A failed native build or
parse raises; nothing falls back to the Python parser.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage


def _texpath(name: str) -> str:
    """Windows-style texture paths (bathroom.mtl's backslashes) made portable."""
    return name.replace("\\", "/")


_VEC3 = {"Kd": "diffuse", "Ks": "specular", "Ke": "emissive", "emissive": "emissive",
         "Kr": "reflectivity", "Td": "diffuse_trans"}
_MAPS = {"map_Kd": "diffuse_map_name", "map_Ks": "specular_map_name",
         "map_Ke": "emissive_map_name", "map_Bump": "bump_map_name",
         "map_bump": "bump_map_name", "bump": "bump_map_name"}


def load_mtl(path: str) -> List[HostMaterial]:
    """The materials of an .mtl file in file order: Kd Ks Ke Kr Td Ns Ni d Tr
    and the map_Kd / map_Ks / map_Ke / bump texture names (the last token)."""
    mats: List[HostMaterial] = []
    cur: Optional[HostMaterial] = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            key = tok[0]
            if key == "newmtl":
                cur = HostMaterial(tok[1] if len(tok) > 1 else "")
                mats.append(cur)
            elif cur is None:
                continue
            elif key in _VEC3:
                setattr(cur, _VEC3[key], tuple(float(x) for x in tok[1:4]))
            elif key == "Ns":
                cur.phong_exponent = float(tok[1])
            elif key == "Ni":
                cur.ior = float(tok[1])
            elif key == "d":
                cur.opacity = float(tok[1])
            elif key == "Tr":
                cur.opacity = 1.0 - float(tok[1])
            elif key in _MAPS:
                setattr(cur, _MAPS[key], _texpath(tok[-1]))
    return mats


def _resolve(idx: int, count: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based."""
    return idx - 1 if idx > 0 else count + idx


_NATIVE_MIN_BYTES = 1 << 20  # the C++ parser takes files of 1 MB and more


def load_obj(path: str) -> MeshStorage:
    """An OBJ file and the MTL files it names, as a MeshStorage; large files
    parse their geometry natively."""
    if os.path.getsize(path) >= _NATIVE_MIN_BYTES:
        return _load_obj_native(path)
    return _load_obj_python(path)


def _load_obj_native(path: str) -> MeshStorage:
    """The native parse with the MTL read here (obj.py:90-121)."""
    from fermat_tpu_torch.utils.native import load_obj_geometry

    geo = load_obj_geometry(path)
    base = os.path.dirname(path)
    mtl_mats: Dict[str, HostMaterial] = {}
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("mtllib"):
                mtl_path = os.path.join(base, line.split(None, 1)[1].strip())
                if os.path.exists(mtl_path):
                    for m in load_mtl(mtl_path):
                        mtl_mats[m.name] = m
    materials = [mtl_mats.get(n, HostMaterial(n)) for n in geo["material_names"]
                 ] or [HostMaterial("default")]
    ntri = geo["tri_v"].shape[0]
    return MeshStorage(
        vertices=geo["vertices"], triangles=geo["tri_v"],
        normals=geo["normals"], normal_indices=geo["tri_n"],
        uvs=geo["uvs"], uv_indices=geo["tri_uv"],
        material_ids=geo["tri_mat"], materials=materials,
        group_names=["default"], group_offsets=np.asarray([0, ntri], np.int32),
    )


def _load_obj_python(path: str) -> MeshStorage:
    """The Python parse of an OBJ file and the MTL files it names."""
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    uvs: List[List[float]] = []
    tris: List[List[int]] = []
    tri_n: List[List[int]] = []
    tri_uv: List[List[int]] = []
    tri_mat: List[int] = []
    materials: List[HostMaterial] = []
    mat_index: Dict[str, int] = {}
    cur_mat = -1
    group_names: List[str] = []
    group_offsets: List[int] = [0]
    base = os.path.dirname(path)

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            key = tok[0]
            if key == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif key == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif key == "vt":
                uvs.append([float(x) for x in tok[1:3]])
            elif key == "mtllib":
                mtl_path = os.path.join(base, " ".join(tok[1:]))
                if os.path.exists(mtl_path):
                    for m in load_mtl(mtl_path):
                        mat_index[m.name] = len(materials)
                        materials.append(m)
            elif key == "usemtl":
                name = tok[1] if len(tok) > 1 else ""
                if name not in mat_index:
                    mat_index[name] = len(materials)
                    materials.append(HostMaterial(name))
                cur_mat = mat_index[name]
            elif key in ("g", "o"):
                name = " ".join(tok[1:])
                if len(tris) > group_offsets[-1]:
                    group_offsets.append(len(tris))
                    group_names.append(name or f"group{len(group_names)}")
                elif group_names:
                    group_names[-1] = name or group_names[-1]
                else:
                    group_names.append(name or "group0")
            elif key == "f":
                corners = []
                for c in tok[1:]:
                    parts = c.split("/")
                    vi = _resolve(int(parts[0]), len(verts))
                    ti = _resolve(int(parts[1]), len(uvs)) if len(parts) > 1 and parts[1] else -1
                    ni = (_resolve(int(parts[2]), len(norms)) if len(parts) > 2 and parts[2]
                          else -1)
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):  # a fan
                    a, b, c = corners[0], corners[k], corners[k + 1]
                    tris.append([a[0], b[0], c[0]])
                    tri_uv.append([a[1], b[1], c[1]])
                    tri_n.append([a[2], b[2], c[2]])
                    tri_mat.append(max(cur_mat, 0))

    if not materials:
        materials = [HostMaterial("default")]
        materials[0].diffuse = (0.75, 0.75, 0.75)
    if not group_names:
        group_names = ["default"]
    group_offsets.append(len(tris))
    return MeshStorage(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        triangles=np.asarray(tris, np.int32).reshape(-1, 3),
        normals=np.asarray(norms, np.float32).reshape(-1, 3),
        normal_indices=np.asarray(tri_n, np.int32).reshape(-1, 3),
        uvs=np.asarray(uvs, np.float32).reshape(-1, 2),
        uv_indices=np.asarray(tri_uv, np.int32).reshape(-1, 3),
        material_ids=np.asarray(tri_mat, np.int32),
        materials=materials,
        group_names=group_names,
        group_offsets=np.asarray(group_offsets, np.int32),
    )


def _num(x) -> str:
    """A number as the shortest text that reads back to the same value."""
    return repr(float(x))


def save_obj(storage: MeshStorage, path: str) -> None:
    """`path` (.obj) and its .mtl beside it: vertices, normals and uvs, one
    face a triangle with its v/vt/vn indices, a `g` line where a group
    starts and a `usemtl` line where the material changes. Every material
    is written, each field load_mtl reads."""
    base = os.path.splitext(path)[0]
    mtl = os.path.basename(base) + ".mtl"
    with open(base + ".mtl", "w") as f:
        for m in storage.materials:
            f.write(f"newmtl {m.name}\n")
            for key, field_ in (("Kd", "diffuse"), ("Ks", "specular"), ("Ke", "emissive"),
                                ("Kr", "reflectivity"), ("Td", "diffuse_trans")):
                f.write(f"{key} " + " ".join(_num(c) for c in getattr(m, field_)) + "\n")
            f.write(f"Ns {_num(m.phong_exponent)}\nNi {_num(m.ior)}\nd {_num(m.opacity)}\n")
            for key, field_ in (("map_Kd", "diffuse_map_name"), ("map_Ks", "specular_map_name"),
                                ("map_Ke", "emissive_map_name"), ("bump", "bump_map_name")):
                if getattr(m, field_):
                    f.write(f"{key} {getattr(m, field_)}\n")
    tri, ni, ui = storage.triangles, storage.normal_indices, storage.uv_indices
    has = lambda idx: idx.shape[0] == tri.shape[0]
    starts = {int(o): k for k, o in enumerate(storage.group_offsets[:-1])}
    with open(path, "w") as f:
        f.write(f"mtllib {mtl}\n")
        for rows, key in ((storage.vertices, "v"), (storage._resolved_normals(), "vn"),
                          (storage._resolved_uvs(), "vt")):
            for r in rows:
                f.write(key + " " + " ".join(_num(c) for c in r) + "\n")
        cur = None
        for t in range(tri.shape[0]):
            if t in starts and starts[t] < len(storage.group_names):
                f.write(f"g {storage.group_names[starts[t]]}\n")
            m = int(storage.material_ids[t])
            if m != cur:
                f.write(f"usemtl {storage.materials[m].name}\n")
                cur = m
            corners = []
            for c in range(3):  # v, v/vt, v//vn or v/vt/vn
                vt = str(ui[t, c] + 1) if has(ui) and ui[t, c] >= 0 else ""
                vn = str(ni[t, c] + 1) if has(ni) and ni[t, c] >= 0 else ""
                corners.append(f"{tri[t, c] + 1}" + (f"/{vt}" if vt or vn else "")
                               + (f"/{vn}" if vn else ""))
            f.write("f " + " ".join(corners) + "\n")
