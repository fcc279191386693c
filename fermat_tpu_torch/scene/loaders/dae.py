"""COLLADA (.dae) importer — the 1.4/1.5 mesh subset: the port's own copy of
fermat_tpu/scene/loaders/dae.py, host numpy code.

Further widens the assimp-fallback breadth (src/assimp_loader.cpp; assimp
links COLLADA natively). Parsed with xml.etree — no new dependencies:

- library_geometries: <mesh> with <source>/<vertices> and
  <triangles>/<polylist> primitives, per-input offsets (VERTEX/NORMAL/
  TEXCOORD may share or split index streams), polylist fans
- library_visual_scenes: node hierarchy with <matrix>/<translate>/
  <rotate>/<scale> composition in document order, instance_geometry
  (multiple instances of one geometry each land transformed),
  instance_material symbol->target binding
- library_materials/library_effects: phong/lambert/blinn diffuse,
  specular, emission, shininess, transparency; <texture> diffuse refs
  resolve through library_images init_from to a file name
- asset/up_axis: Z_UP/X_UP rotated into the renderer's Y-up convention

Normals transform by the node matrix inverse transpose; winding flips
under negative-determinant transforms (mirrored instances).

Two faults of JAX's copy are not carried (ROADMAP Queue 3): an empty `<p>`
of a polylist crashes there (dae.py:226) and is an empty primitive here,
and `<transparency>`, which JAX never parses, sets HostMaterial.opacity:
transparency x the alpha of `<transparent>` in the default A_ONE mode,
1 - transparency x the luminance of `<transparent>` in RGB_ZERO mode.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage


def _strip(tag: str) -> str:
    return tag.split("}")[-1]


def _local(el: ET.Element, name: str) -> List[ET.Element]:
    return [c for c in el if _strip(c.tag) == name]


def _find(el: ET.Element, *path: str) -> Optional[ET.Element]:
    cur = el
    for name in path:
        nxt = _local(cur, name)
        if not nxt:
            return None
        cur = nxt[0]
    return cur


def _farr(text: Optional[str]) -> np.ndarray:
    return np.asarray((text or "").split(), np.float64)


def _iarr(text: Optional[str]) -> np.ndarray:
    return np.asarray((text or "").split(), np.int64)


def _up_matrix(up: str) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    if up == "Z_UP":  # z-up -> y-up: (x, y, z) -> (x, z, -y)
        m[:3, :3] = [[1, 0, 0], [0, 0, 1], [0, -1, 0]]
    elif up == "X_UP":  # x-up -> y-up: (x, y, z) -> (y, x, -z)
        m[:3, :3] = [[0, 1, 0], [1, 0, 0], [0, 0, -1]]
    return m


def _node_matrix(nd: ET.Element) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    for ch in nd:
        t = _strip(ch.tag)
        if t == "matrix":
            m = m @ _farr(ch.text).reshape(4, 4)
        elif t == "translate":
            tm = np.eye(4)
            tm[:3, 3] = _farr(ch.text)[:3]
            m = m @ tm
        elif t == "rotate":
            x, y, z, deg = _farr(ch.text)[:4]
            a = np.deg2rad(deg)
            ax = np.asarray([x, y, z], np.float64)
            n = np.linalg.norm(ax)
            if n > 0:
                ax /= n
                c, s = np.cos(a), np.sin(a)
                K = np.array([[0, -ax[2], ax[1]],
                              [ax[2], 0, -ax[0]],
                              [-ax[1], ax[0], 0]])
                rm = np.eye(4)
                rm[:3, :3] = np.eye(3) * c + s * K + (1 - c) * np.outer(ax, ax)
                m = m @ rm
        elif t == "scale":
            m = m @ np.diag(list(_farr(ch.text)[:3]) + [1.0])
    return m


def _effect_material(root: ET.Element, eff_url: str,
                     images: Dict[str, str], name: str) -> HostMaterial:
    mat = HostMaterial(name)
    mat.diffuse = (0.75, 0.75, 0.75)
    lib = _find(root, "library_effects")
    if lib is None:
        return mat
    eff = next((e for e in _local(lib, "effect")
                if e.get("id") == eff_url.lstrip("#")), None)
    if eff is None:
        return mat
    # sampler/surface param indirection for textures
    params: Dict[str, str] = {}
    for np_el in eff.iter():
        if _strip(np_el.tag) == "newparam":
            sid = np_el.get("sid", "")
            for k in np_el.iter():
                t = _strip(k.tag)
                if t == "init_from" and k.text:
                    params[sid] = k.text.strip()
                elif t == "source" and k.text:
                    params[sid] = params.get(k.text.strip(),
                                             k.text.strip())

    def color_of(tag: str):
        for el in eff.iter():
            if _strip(el.tag) == tag:
                col = _find(el, "color")
                if col is not None:
                    return tuple(_farr(col.text)[:3].astype(float))
                tex = _find(el, "texture")
                if tex is not None and tag == "diffuse":
                    ref = tex.get("texture", "")
                    fname = params.get(ref, images.get(ref, ref))
                    fname = images.get(fname, fname)
                    mat.diffuse_map_name = os.path.basename(fname)
                    return (1.0, 1.0, 1.0)
        return None

    d = color_of("diffuse")
    if d is not None:
        mat.diffuse = d
    s = color_of("specular")
    if s is not None:
        mat.specular = s
    e = color_of("emission")
    if e is not None:
        mat.emissive = e
    transparency = None
    for el in eff.iter():
        if _strip(el.tag) == "shininess":
            f = _find(el, "float")
            if f is not None:
                mat.phong_exponent = float(_farr(f.text)[0])
        elif _strip(el.tag) == "transparency":
            f = _find(el, "float")
            if f is not None:
                transparency = float(_farr(f.text)[0])
    if transparency is not None:
        mat.opacity = _opacity(eff, transparency)
    return mat


def _opacity(eff: ET.Element, transparency: float) -> float:
    """COLLADA 1.4 opacity: A_ONE (the default) takes the alpha of
    <transparent>, RGB_ZERO one minus its luminance (1.0 when absent)."""
    el = next((e for e in eff.iter() if _strip(e.tag) == "transparent"), None)
    col = _find(el, "color") if el is not None else None
    rgba = _farr(col.text) if col is not None else np.ones(4)
    rgba = np.concatenate([rgba, np.ones(4)])[:4]
    if el is not None and el.get("opaque", "A_ONE") == "RGB_ZERO":
        lum = 0.212671 * rgba[0] + 0.71516 * rgba[1] + 0.072169 * rgba[2]
        return float(1.0 - transparency * lum)
    return float(rgba[3] * transparency)


def load_dae(path: str) -> MeshStorage:
    root = ET.parse(path).getroot()
    asset = _find(root, "asset", "up_axis")
    up = _up_matrix(asset.text.strip() if asset is not None and asset.text
                    else "Y_UP")

    # images: id -> file name
    images: Dict[str, str] = {}
    ilib = _find(root, "library_images")
    if ilib is not None:
        for im in _local(ilib, "image"):
            init = _find(im, "init_from")
            if init is not None and init.text:
                images[im.get("id", "")] = init.text.strip()

    # materials: id -> HostMaterial (via effect)
    materials_by_id: Dict[str, HostMaterial] = {}
    mlib = _find(root, "library_materials")
    if mlib is not None:
        for mt in _local(mlib, "material"):
            ie = _find(mt, "instance_effect")
            url = ie.get("url", "") if ie is not None else ""
            materials_by_id[mt.get("id", "")] = _effect_material(
                root, url, images, mt.get("name") or mt.get("id", "dae"))

    # geometries: id -> list of primitive dicts
    geoms: Dict[str, list] = {}
    glib = _find(root, "library_geometries")
    if glib is None:
        raise ValueError(f"{path}: no library_geometries")
    for geo in _local(glib, "geometry"):
        mesh = _find(geo, "mesh")
        if mesh is None:
            continue
        sources: Dict[str, np.ndarray] = {}
        for src in _local(mesh, "source"):
            fa = _find(src, "float_array")
            acc = _find(src, "technique_common", "accessor")
            if fa is None or acc is None:
                continue
            stride = int(acc.get("stride", 1))
            arr = _farr(fa.text).reshape(-1, stride)
            sources[src.get("id", "")] = arr
        verts_el = _find(mesh, "vertices")
        vert_src = {}
        if verts_el is not None:
            for inp in _local(verts_el, "input"):
                if inp.get("semantic") == "POSITION":
                    vert_src[verts_el.get("id", "")] = \
                        inp.get("source", "").lstrip("#")
        prims = []
        for prim in mesh:
            t = _strip(prim.tag)
            if t not in ("triangles", "polylist"):
                continue
            inputs = []
            for inp in _local(prim, "input"):
                sem = inp.get("semantic")
                sid = inp.get("source", "").lstrip("#")
                sid = vert_src.get(sid, sid)
                inputs.append((sem, sid, int(inp.get("offset", 0))))
            stride = max(off for _, _, off in inputs) + 1 if inputs else 1
            p = _find(prim, "p")
            idx = _iarr(p.text) if p is not None else np.zeros(0, np.int64)
            idx = idx.reshape(-1, stride)
            if t == "polylist":
                vcount = _find(prim, "vcount")
                vc = _iarr(vcount.text if vcount is not None else None)
                tris = []
                pos = 0
                for n in vc:
                    for k in range(1, n - 1):  # fan
                        tris.append([pos, pos + k, pos + k + 1])
                    pos += n
                tri_rows = np.asarray(tris, np.int64).reshape(-1, 3)
            else:
                tri_rows = np.arange(idx.shape[0]).reshape(-1, 3)
            prims.append({
                "inputs": inputs, "idx": idx, "tris": tri_rows,
                "material": prim.get("material", ""),
                "sources": sources,
            })
        geoms[geo.get("id", "")] = prims

    # instances from the visual scene (fallback: every geometry once)
    instances = []
    vlib = _find(root, "library_visual_scenes")

    def walk(nd: ET.Element, parent: np.ndarray):
        m = parent @ _node_matrix(nd)
        for ig in _local(nd, "instance_geometry"):
            binds = {}
            for im in ig.iter():
                if _strip(im.tag) == "instance_material":
                    binds[im.get("symbol", "")] = \
                        im.get("target", "").lstrip("#")
            instances.append((ig.get("url", "").lstrip("#"), m, binds))
        for ch in _local(nd, "node"):
            walk(ch, m)

    if vlib is not None:
        for vs in _local(vlib, "visual_scene"):
            for nd in _local(vs, "node"):
                walk(nd, up)
    if not instances:
        instances = [(gid, up, {}) for gid in geoms]

    verts, norms, uvs = [], [], []
    tris, nidx, uidx, mids = [], [], [], []
    materials: List[HostMaterial] = []
    mat_slot: Dict[str, int] = {}
    group_names: List[str] = []
    group_offsets = [0]
    v_off = n_off = u_off = 0

    for gid, world, binds in instances:
        nrm_mat = np.linalg.inv(world[:3, :3]).T
        flip = bool(np.linalg.det(world[:3, :3]) < 0.0)
        for pi, prim in enumerate(geoms.get(gid, [])):
            srcs = prim["sources"]
            sem_of = {sem: (sid, off) for sem, sid, off in prim["inputs"]}
            if "VERTEX" not in sem_of:
                continue
            psid, poff = sem_of["VERTEX"]
            pos = srcs[psid][:, :3]
            pos_w = pos @ world[:3, :3].T + world[:3, 3]
            corner_pos = prim["idx"][:, poff]
            tri = corner_pos[prim["tris"]]
            if flip:
                tri = tri[:, [0, 2, 1]]
            verts.append(pos_w.astype(np.float32))
            tris.append(tri + v_off)
            if "NORMAL" in sem_of:
                nsid, noff = sem_of["NORMAL"]
                nr = srcs[nsid][:, :3] @ nrm_mat.T
                ln = np.linalg.norm(nr, axis=1, keepdims=True)
                norms.append((nr / np.maximum(ln, 1e-20)).astype(np.float32))
                nt = prim["idx"][:, noff][prim["tris"]]
                if flip:
                    nt = nt[:, [0, 2, 1]]
                nidx.append(nt + n_off)
                n_off += srcs[nsid].shape[0]
            else:
                nidx.append(np.full_like(tri, -1))
            if "TEXCOORD" in sem_of:
                usid, uoff = sem_of["TEXCOORD"]
                uvs.append(srcs[usid][:, :2].astype(np.float32))
                ut = prim["idx"][:, uoff][prim["tris"]]
                if flip:
                    ut = ut[:, [0, 2, 1]]
                uidx.append(ut + u_off)
                u_off += srcs[usid].shape[0]
            else:
                uidx.append(np.full_like(tri, -1))
            mat_id = binds.get(prim["material"], prim["material"])
            if mat_id not in mat_slot:
                mat_slot[mat_id] = len(materials)
                materials.append(materials_by_id.get(
                    mat_id, _default_mat(mat_id)))
            mids.append(np.full(tri.shape[0], mat_slot[mat_id], np.int32))
            v_off += pos.shape[0]
            group_names.append(f"{gid}.{pi}")
            group_offsets.append(group_offsets[-1] + tri.shape[0])

    if not tris:
        raise ValueError(f"{path}: no triangles")
    t = np.concatenate(tris).astype(np.int32)
    return MeshStorage(
        vertices=np.concatenate(verts).astype(np.float32),
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


def _default_mat(name: str) -> HostMaterial:
    m = HostMaterial(name or "dae_default")
    m.diffuse = (0.75, 0.75, 0.75)
    return m


def _floats(a) -> str:
    return " ".join(repr(float(x)) for x in np.asarray(a, np.float64).reshape(-1))


def save_dae(storage: MeshStorage, path: str) -> None:
    """Write a MeshStorage as a COLLADA 1.4 document that load_dae reads
    back: one geometry with position, normal and uv sources, one
    <triangles> a run of triangles of one material (split index streams),
    each material a phong effect (diffuse, specular, emission, shininess,
    transparency as opacity in A_ONE mode). The port's scene writer; JAX
    has none."""
    from fermat_tpu_torch.scene.loaders.gltf import _runs

    tri = storage.triangles
    normals, uvs = storage._resolved_normals(), storage._resolved_uvs()
    has = lambda idx, vals: idx.shape[0] == tri.shape[0] and vals.shape[0] and (idx >= 0).all()
    has_n, has_uv = has(storage.normal_indices, normals), has(storage.uv_indices, uvs)

    def source(sid, arr, stride):
        return (f'<source id="{sid}"><float_array id="{sid}-a" count="{arr.size}">'
                f'{_floats(arr)}</float_array><technique_common><accessor source="#{sid}-a" '
                f'count="{arr.shape[0]}" stride="{stride}"/></technique_common></source>')

    geo = [source("pos", storage.vertices, 3)]
    if has_n:
        geo.append(source("nrm", normals, 3))
    if has_uv:
        geo.append(source("uv", uvs, 2))
    geo.append('<vertices id="verts"><input semantic="POSITION" source="#pos"/></vertices>')
    streams = [tri] + ([storage.normal_indices] if has_n else []) + (
        [storage.uv_indices] if has_uv else [])
    inputs = '<input semantic="VERTEX" source="#verts" offset="0"/>'
    if has_n:
        inputs += '<input semantic="NORMAL" source="#nrm" offset="1"/>'
    if has_uv:
        inputs += f'<input semantic="TEXCOORD" source="#uv" offset="{len(streams) - 1}"/>'
    binds = []
    for a, b, mat in _runs(storage.material_ids):
        p = np.stack([s[a:b] for s in streams], axis=-1).reshape(-1)
        geo.append(f'<triangles count="{b - a}" material="m{mat}">{inputs}'
                   f'<p>{" ".join(str(int(x)) for x in p)}</p></triangles>')
    effects, mats = [], []
    for k, m in enumerate(storage.materials):
        binds.append(f'<instance_material symbol="m{k}" target="#mat{k}"/>')
        effects.append(
            f'<effect id="fx{k}"><profile_COMMON><technique sid="common"><phong>'
            f'<emission><color>{_floats(m.emissive)} 1</color></emission>'
            f'<diffuse><color>{_floats(m.diffuse)} 1</color></diffuse>'
            f'<specular><color>{_floats(m.specular)} 1</color></specular>'
            f'<shininess><float>{float(m.phong_exponent)!r}</float></shininess>'
            f'<transparency><float>{float(m.opacity)!r}</float></transparency>'
            f'</phong></technique></profile_COMMON></effect>')
        mats.append(f'<material id="mat{k}" name="{m.name}"><instance_effect url="#fx{k}"/>'
                    f'</material>')
    doc = ('<?xml version="1.0" encoding="utf-8"?>\n<COLLADA xmlns="http://www.collada.org/'
           '2005/11/COLLADASchema" version="1.4.1"><asset><up_axis>Y_UP</up_axis></asset>'
           f'<library_effects>{"".join(effects)}</library_effects>'
           f'<library_materials>{"".join(mats)}</library_materials>'
           f'<library_geometries><geometry id="geom"><mesh>{"".join(geo)}</mesh></geometry>'
           '</library_geometries><library_visual_scenes><visual_scene id="scene"><node>'
           '<instance_geometry url="#geom"><bind_material><technique_common>'
           f'{"".join(binds)}</technique_common></bind_material></instance_geometry></node>'
           '</visual_scene></library_visual_scenes></COLLADA>\n')
    with open(path, "w") as f:
        f.write(doc)
