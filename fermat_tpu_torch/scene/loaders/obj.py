"""The MTL half of the Wavefront OBJ loader (fermat_tpu/scene/loaders/obj.py:23-69):
material records with their texture names, parsed as MeshBase.cpp:530-700
does. The OBJ geometry parser is not ported."""
from __future__ import annotations

from typing import List, Optional

from fermat_tpu_torch.scene.materials import HostMaterial


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
