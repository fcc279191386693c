"""glTF 2.0 importer (.gltf JSON + external/data-URI buffers, .glb binary):
the port's own copy of fermat_tpu/scene/loaders/gltf.py, host numpy code.

Widens the assimp-fallback loader breadth (the reference dispatches
everything that isn't obj/ply to assimp, src/assimp_loader.cpp; assimp is
unavailable in this environment, so the dominant modern interchange format
is parsed natively). Covers the mesh subset the renderer consumes:

- scenes/nodes: full hierarchy walk, node.matrix or TRS composition,
  multiple nodes instancing one mesh each get their own transformed copy
- meshes/primitives: POSITION/NORMAL/TEXCOORD_0 + indices (modes 4
  TRIANGLES, 5 TRIANGLE_STRIP, 6 TRIANGLE_FAN), interleaved or tightly
  packed bufferViews, all five index/attribute component types,
  normalized integer attributes
- materials: pbrMetallicRoughness baseColorFactor/baseColorTexture,
  metallic/roughness -> specular + phong exponent (the same Blinn
  mapping MeshStorage.cpp:163 uses in reverse), emissiveFactor/-Texture,
  doubleSided ignored (the renderer shades both faces), KHR punctual
  lights out of scope (scene lights come from .fa / SceneView)

Positions/normals transform by the node matrix (normals by its inverse
transpose); winding flips under negative-determinant transforms so
geometric normals stay outward.

Two faults of JAX's copy are not carried (ROADMAP Queue 3): with no
`scenes` key JAX walks every node as a root, so the mesh of a child node
lands twice (gltf.py:204), and `"scenes": []` raises IndexError. Here an
asset without a scene walks the root nodes, those no node names as a child.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional

import numpy as np

from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage

_CTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
          "MAT2": 4, "MAT3": 9, "MAT4": 16}
_NORM_MAX = {np.int8: 127.0, np.uint8: 255.0,
             np.int16: 32767.0, np.uint16: 65535.0}


def _read_buffers(g: dict, base_dir: str, glb_bin: Optional[bytes]) -> List[bytes]:
    bufs = []
    for b in g.get("buffers", []):
        uri = b.get("uri")
        if uri is None:
            if glb_bin is None:
                raise ValueError("buffer without uri outside a .glb")
            bufs.append(glb_bin)
        elif uri.startswith("data:"):
            bufs.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                bufs.append(f.read())
    return bufs


def _accessor(g: dict, bufs: List[bytes], idx: int) -> np.ndarray:
    a = g["accessors"][idx]
    if "sparse" in a:
        raise ValueError("sparse accessors are not supported")
    n = a["count"]
    ncomp = _NCOMP[a["type"]]
    dtype = _CTYPE[a["componentType"]]
    itemsize = np.dtype(dtype).itemsize
    if "bufferView" not in a:  # all-zeros per spec
        out = np.zeros((n, ncomp), np.float32)
        return out[:, 0] if ncomp == 1 else out
    bv = g["bufferViews"][a["bufferView"]]
    buf = bufs[bv["buffer"]]
    start = bv.get("byteOffset", 0) + a.get("byteOffset", 0)
    stride = bv.get("byteStride", 0) or ncomp * itemsize
    raw = np.frombuffer(buf, np.uint8,
                        count=stride * (n - 1) + ncomp * itemsize,
                        offset=start)
    arr = np.lib.stride_tricks.as_strided(
        raw, shape=(n, ncomp * itemsize), strides=(stride, 1)
    ).copy().view(dtype).reshape(n, ncomp)
    out = arr.astype(np.float32 if dtype != np.uint32 else np.float64)
    if a.get("normalized") and dtype in _NORM_MAX:
        out = out / _NORM_MAX[dtype]
        if dtype in (np.int8, np.int16):
            out = np.maximum(out, -1.0)
    return out[:, 0] if ncomp == 1 else out


def _node_matrix(nd: dict) -> np.ndarray:
    if "matrix" in nd:
        return np.asarray(nd["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "scale" in nd:
        m = np.diag(list(nd["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in nd:  # xyzw quaternion
        x, y, z, w = nd["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        rm = np.eye(4, dtype=np.float32)
        rm[:3, :3] = r
        m = rm @ m
    if "translation" in nd:
        tm = np.eye(4, dtype=np.float32)
        tm[:3, 3] = nd["translation"]
        m = tm @ m
    return m


def _material(g: dict, idx: Optional[int]) -> HostMaterial:
    mat = HostMaterial(f"gltf_{idx if idx is not None else 'default'}")
    if idx is None:
        mat.diffuse = (0.75, 0.75, 0.75)
        return mat
    m = g["materials"][idx]
    pbr = m.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    metallic = pbr.get("metallicFactor", 1.0)
    rough = pbr.get("roughnessFactor", 1.0)
    # metallic moves base color from the diffuse to the specular lobe;
    # roughness maps to the Blinn exponent the composite BSDF consumes
    # through HostMaterial.roughness == 1/phong_exponent
    mat.diffuse = tuple(float(c) * (1.0 - metallic) for c in base[:3])
    mat.specular = tuple(float(c) * metallic for c in base[:3])
    mat.phong_exponent = 1.0 / max(float(rough), 1e-3)
    mat.opacity = float(base[3])
    em = m.get("emissiveFactor", [0.0, 0.0, 0.0])
    mat.emissive = tuple(float(c) for c in em)

    def tex_name(info):
        if info is None:
            return ""
        tex = g["textures"][info["index"]]
        src = tex.get("source")
        if src is None:
            return ""
        return g["images"][src].get("uri", "") or ""

    mat.diffuse_map_name = tex_name(pbr.get("baseColorTexture"))
    mat.emissive_map_name = tex_name(m.get("emissiveTexture"))
    return mat


def _tri_indices(idx: np.ndarray, mode: int) -> np.ndarray:
    idx = idx.astype(np.int64).reshape(-1)
    if mode == 4:  # TRIANGLES
        return idx.reshape(-1, 3)
    if mode == 5:  # TRIANGLE_STRIP (alternating winding)
        a, b, c = idx[:-2], idx[1:-1], idx[2:]
        flip = np.arange(a.size) % 2 == 1
        tri = np.stack([a, np.where(flip, c, b), np.where(flip, b, c)], 1)
        return tri[(tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2])
                   & (tri[:, 0] != tri[:, 2])]
    if mode == 6:  # TRIANGLE_FAN
        return np.stack([np.full(idx.size - 2, idx[0]),
                         idx[1:-1], idx[2:]], 1)
    raise ValueError(f"unsupported primitive mode {mode}")


def load_gltf(path: str) -> MeshStorage:
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin = None
    with open(path, "rb") as f:
        head = f.read(4)
        if head == b"glTF":  # .glb container
            _ver, _len = struct.unpack("<II", f.read(8))
            g = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<I4s", hdr)
                data = f.read(clen)
                if ctype == b"JSON":
                    g = json.loads(data.decode("utf-8"))
                elif ctype == b"BIN\x00":
                    glb_bin = data
            if g is None:
                raise ValueError(f"{path}: no JSON chunk in glb")
        else:
            f.seek(0)
            g = json.loads(f.read().decode("utf-8"))

    bufs = _read_buffers(g, base_dir, glb_bin)

    # collect (mesh index, world matrix) through the node hierarchy
    instances: List[tuple] = []
    nodes = g.get("nodes", [])

    def walk(ni: int, parent: np.ndarray):
        nd = nodes[ni]
        m = parent @ _node_matrix(nd)
        if "mesh" in nd:
            instances.append((nd["mesh"], m))
        for ch in nd.get("children", []):
            walk(ch, m)

    scenes = g.get("scenes") or []
    if scenes:
        roots = scenes[g.get("scene", 0)].get("nodes", [])
    else:
        children = {ch for nd in nodes for ch in nd.get("children", [])}
        roots = [ni for ni in range(len(nodes)) if ni not in children]
    for ni in roots:
        walk(ni, np.eye(4, dtype=np.float32))
    if not instances:  # no scene graph: take the meshes as-is
        instances = [(i, np.eye(4, dtype=np.float32))
                     for i in range(len(g.get("meshes", [])))]

    verts, norms, uvs = [], [], []
    tris, nidx, uidx, mids = [], [], [], []
    materials: List[HostMaterial] = []
    mat_slot: Dict[Optional[int], int] = {}
    group_names: List[str] = []
    group_offsets = [0]
    v_off = n_off = u_off = 0

    for mesh_i, world in instances:
        mesh = g["meshes"][mesh_i]
        nrm_mat = np.linalg.inv(world[:3, :3]).T
        flip = bool(np.linalg.det(world[:3, :3]) < 0.0)
        for pi, prim in enumerate(mesh.get("primitives", [])):
            attrs = prim["attributes"]
            pos = _accessor(g, bufs, attrs["POSITION"])
            pos_w = pos @ world[:3, :3].T + world[:3, 3]
            nv = pos.shape[0]
            if "indices" in prim:
                tri = _tri_indices(_accessor(g, bufs, prim["indices"]),
                                   prim.get("mode", 4))
            else:
                tri = _tri_indices(np.arange(nv), prim.get("mode", 4))
            if flip:
                tri = tri[:, [0, 2, 1]]
            verts.append(pos_w.astype(np.float32))
            tris.append(tri.astype(np.int64) + v_off)
            if "NORMAL" in attrs:
                nr = _accessor(g, bufs, attrs["NORMAL"]) @ nrm_mat.T
                ln = np.linalg.norm(nr, axis=1, keepdims=True)
                norms.append((nr / np.maximum(ln, 1e-20)).astype(np.float32))
                nidx.append(tri.astype(np.int64) + n_off)
                n_off += nv
            else:
                nidx.append(np.full_like(tri, -1, np.int64))
            if "TEXCOORD_0" in attrs:
                uv = _accessor(g, bufs, attrs["TEXCOORD_0"])[:, :2].copy()
                uv[:, 1] = 1.0 - uv[:, 1]  # glTF v is top-down
                uvs.append(uv.astype(np.float32))
                uidx.append(tri.astype(np.int64) + u_off)
                u_off += nv
            else:
                uidx.append(np.full_like(tri, -1, np.int64))
            mi = prim.get("material")
            if mi not in mat_slot:
                mat_slot[mi] = len(materials)
                materials.append(_material(g, mi))
            mids.append(np.full(tri.shape[0], mat_slot[mi], np.int32))
            v_off += nv
            group_names.append(mesh.get("name", f"mesh{mesh_i}") + f".{pi}")
            group_offsets.append(group_offsets[-1] + tri.shape[0])

    if not tris:
        raise ValueError(f"{path}: no triangles")
    t = np.concatenate(tris).astype(np.int32)
    return MeshStorage(
        vertices=np.concatenate(verts) if verts else np.zeros((0, 3), np.float32),
        triangles=t,
        normals=(np.concatenate(norms) if norms
                 else np.zeros((0, 3), np.float32)),
        normal_indices=np.concatenate(nidx).astype(np.int32),
        uvs=np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32),
        uv_indices=np.concatenate(uidx).astype(np.int32),
        material_ids=np.concatenate(mids),
        materials=materials,
        group_names=group_names,
        group_offsets=np.asarray(group_offsets, np.int32),
    )


def _runs(material_ids: np.ndarray):
    """(start, end, material) of each run of equal consecutive material ids."""
    cut = np.flatnonzero(np.diff(material_ids)) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [material_ids.shape[0]]])
    return [(int(a), int(b), int(material_ids[a])) for a, b in zip(starts, ends)]


def _corners(storage: MeshStorage, a: int, b: int):
    """Triangles a..b unwelded: (positions, normals or None, uvs or None),
    three rows a triangle; an attribute is written where every corner has one."""
    tri = storage.triangles[a:b].reshape(-1)
    out = [storage.vertices[tri].astype(np.float32)]
    for idx, vals in ((storage.normal_indices, storage._resolved_normals()),
                      (storage.uv_indices, storage._resolved_uvs())):
        rows = idx[a:b].reshape(-1) if idx.shape[0] == storage.n_triangles else None
        ok = rows is not None and vals.shape[0] and (rows >= 0).all()
        out.append(vals[rows].astype(np.float32) if ok else None)
    return out


def save_gltf(storage: MeshStorage, path: str) -> None:
    """Write a MeshStorage as glTF 2.0 that load_gltf reads back: a .glb
    container, else a .gltf with its buffer as a data URI. One primitive a
    run of triangles of one material, unwelded (three vertices a triangle);
    each material as pbrMetallicRoughness: baseColor = diffuse + specular
    with metallic = |specular| / |diffuse + specular|, roughness =
    HostMaterial.roughness, alpha = opacity, emissiveFactor = emissive.
    The port's scene writer (chip_smoke.py and the tests write their
    scenes with it); JAX has none."""
    blob = bytearray()
    views, accessors, prims = [], [], []

    def add(arr: np.ndarray, kind: str, ctype: int, target: int = None) -> int:
        data = np.ascontiguousarray(arr).tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data + b"\x00" * (-len(data) % 4))
        acc = {"bufferView": len(views) - 1, "componentType": ctype, "count": int(arr.shape[0]),
               "type": kind}
        if kind == "VEC3" and ctype == 5126:
            acc["min"] = arr.min(0).tolist()
            acc["max"] = arr.max(0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    for a, b, mat in _runs(storage.material_ids):
        pos, nrm, uv = _corners(storage, a, b)
        attrs = {"POSITION": add(pos, "VEC3", 5126)}
        if nrm is not None:
            attrs["NORMAL"] = add(nrm, "VEC3", 5126)
        if uv is not None:
            flipped = uv.copy()
            flipped[:, 1] = 1.0 - flipped[:, 1]  # glTF v is top-down
            attrs["TEXCOORD_0"] = add(flipped, "VEC2", 5126)
        idx = np.arange(pos.shape[0], dtype="<u4")
        prims.append({"attributes": attrs, "indices": add(idx, "SCALAR", 5125), "material": mat})
    materials = []
    for m in storage.materials:
        d, s = np.asarray(m.diffuse, np.float64), np.asarray(m.specular, np.float64)
        base = d + s
        tot = float(base.sum())
        metallic = float(s.sum()) / tot if tot > 0 else 0.0
        materials.append({"name": m.name, "pbrMetallicRoughness": {
            "baseColorFactor": [*base.tolist(), float(m.opacity)], "metallicFactor": metallic,
            "roughnessFactor": float(m.roughness)}, "emissiveFactor": list(m.emissive)})
    g = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
         "nodes": [{"mesh": 0}], "meshes": [{"name": "mesh", "primitives": prims}],
         "materials": materials, "accessors": accessors, "bufferViews": views,
         "buffers": [{"byteLength": len(blob)}]}
    if path.lower().endswith(".glb"):
        js = json.dumps(g).encode()
        js += b" " * (-len(js) % 4)
        body = (struct.pack("<I4s", len(js), b"JSON") + js
                + struct.pack("<I4s", len(blob), b"BIN\x00") + bytes(blob))
        with open(path, "wb") as f:
            f.write(b"glTF" + struct.pack("<II", 2, 12 + len(body)) + body)
    else:
        g["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                  + base64.b64encode(bytes(blob)).decode())
        with open(path, "w") as f:
            json.dump(g, f)
