"""The `.fa` Fermat scene format (fermat_tpu/scene/loaders/fa.py;
fermat_loader.cpp:60-345), and `load_mesh_any`, the loader dispatch by file
extension. Directives:
  Begin/End                 push/pop of the transform stack
  Transform m00..m33        a full 4x4, top = M * top
  Translate x y z, Scale x y z, RotateX/Y/Z deg
  LoadScene/LoadMesh file   an obj/ply/stl/off/fa file, the current
                            transform baked in
  SetMaterial name, LoadMaterials file   accepted and skipped
  Camera persp eye.. aim.. up.. fov(rad)
  DirectionalLight direction x y z color r g b

Each directive pre-multiplies the stack top, so a later directive is applied
last to the vertices. `load_mesh_any` also reads glTF (.gltf, .glb) and
COLLADA (.dae) through loaders/gltf.py and dae.py (fa.py:86-93).
"""
from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from fermat_tpu_torch.core.camera import Camera
from fermat_tpu_torch.scene.lights import DirectionalLightDef
from fermat_tpu_torch.scene.loaders.obj import load_obj
from fermat_tpu_torch.scene.mesh import MeshStorage

__all__ = ["DirectionalLightDef", "LoadedScene", "load_fa", "load_mesh_any"]


@dataclass
class LoadedScene:
    mesh: MeshStorage
    cameras: List[Camera] = field(default_factory=list)
    dir_lights: List[DirectionalLightDef] = field(default_factory=list)

    @property
    def camera(self) -> Optional[Camera]:
        return self.cameras[0] if self.cameras else None


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _rot_z(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def load_mesh_any(path: str) -> MeshStorage:
    """The mesh of a scene file, by its extension: obj, ply, fa, stl, off,
    gltf, glb, dae."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".ply":
        from fermat_tpu_torch.scene.loaders.ply import load_ply

        return load_ply(path)
    if ext == ".fa":
        return load_fa(path).mesh
    if ext in (".stl", ".off"):
        from fermat_tpu_torch.scene.loaders.misc import load_off, load_stl

        return load_stl(path) if ext == ".stl" else load_off(path)
    if ext in (".gltf", ".glb"):
        from fermat_tpu_torch.scene.loaders.gltf import load_gltf

        return load_gltf(path)
    if ext == ".dae":
        from fermat_tpu_torch.scene.loaders.dae import load_dae

        return load_dae(path)
    raise ValueError(
        f"unsupported mesh format: {path} (supported: obj, ply, fa, pbrt, stl, off, gltf, "
        "glb, dae)")


def load_fa(path: str, strict: bool = True) -> LoadedScene:
    """Parse a .fa scene. strict=True raises on missing referenced meshes
    (the reference throws MeshException, fermat_loader.cpp:150-155);
    strict=False warns and skips, useful for the bundled scenes whose large
    .obj payloads are not shipped in the reference checkout."""
    base = os.path.dirname(os.path.abspath(path))
    mesh = MeshStorage()
    cameras: List[Camera] = []
    dir_lights: List[DirectionalLightDef] = []
    stack = [np.eye(4, dtype=np.float32)]

    with open(path, "r", errors="replace") as f:
        toks: List[str] = []
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                toks.extend(line.split())
    i = 0

    def take(n: int) -> List[str]:
        nonlocal i
        out = toks[i : i + n]
        i += n
        return out

    while i < len(toks):
        cmd = toks[i]
        i += 1
        if cmd == "Begin":
            stack.append(stack[-1].copy())
        elif cmd == "End":
            stack.pop()
        elif cmd == "Transform":
            vals = [float(x) for x in take(16)]
            m = np.array(vals, np.float32).reshape(4, 4)
            stack[-1] = m @ stack[-1]
        elif cmd == "Translate":
            x, y, z = (float(v) for v in take(3))
            m = np.eye(4, dtype=np.float32)
            m[:3, 3] = (x, y, z)
            stack[-1] = m @ stack[-1]
        elif cmd == "Scale":
            x, y, z = (float(v) for v in take(3))
            m = np.diag(np.array([x, y, z, 1.0], np.float32))
            stack[-1] = m @ stack[-1]
        elif cmd in ("RotateX", "RotateY", "RotateZ"):
            a = math.radians(float(take(1)[0]))
            m = {"RotateX": _rot_x, "RotateY": _rot_y, "RotateZ": _rot_z}[cmd](a)
            stack[-1] = m @ stack[-1]
        elif cmd in ("LoadScene", "LoadMesh"):
            fname = take(1)[0]
            fpath = fname if os.path.isabs(fname) else os.path.join(base, fname)
            if not os.path.exists(fpath):
                if strict:
                    raise FileNotFoundError(f".fa references missing file: {fpath}")
                print(f"[fa] warning: skipping missing mesh {fpath}", file=sys.stderr)
                continue
            sub = load_mesh_any(fpath)
            sub.transform(stack[-1])
            mesh.merge(sub)
        elif cmd == "Camera":
            # Camera persp eye x y z aim x y z up x y z fov f
            params = {"eye": (0, 0, 0), "aim": (0, 0, -1), "up": (0, 1, 0), "fov": 1.0}
            if take(1)[0] != "persp":
                raise ValueError(".fa: only 'persp' cameras are supported")
            while i < len(toks) and toks[i] in ("eye", "aim", "up", "fov"):
                key = take(1)[0]
                n = 1 if key == "fov" else 3
                vals = [float(v) for v in take(n)]
                params[key] = vals[0] if n == 1 else tuple(vals)
            cameras.append(
                Camera.create(params["eye"], params["aim"], params["up"], params["fov"])
            )
        elif cmd == "DirectionalLight":
            params = {"direction": (0, -1, 0), "color": (1, 1, 1)}
            while i < len(toks) and toks[i] in ("dir", "direction", "color"):
                key = take(1)[0]
                vals = tuple(float(v) for v in take(3))
                params["direction" if key in ("dir", "direction") else "color"] = vals
            dir_lights.append(DirectionalLightDef(params["direction"], params["color"]))
        elif cmd == "LoadMaterials":
            take(1)  # mtl file merge — materials come in with their meshes
        elif cmd == "SetMaterial":
            # SetMaterial name — override hook; accept and skip value tokens
            take(1)
        else:
            raise ValueError(f".fa: unknown directive '{cmd}' in {path}")

    return LoadedScene(mesh=mesh, cameras=cameras, dir_lights=dir_lights)
