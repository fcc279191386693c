"""Material table — SoA analog of MeshMaterial (fermat_tpu/scene/materials.py).

`HostMaterial` is the loader-side staging record; `MaterialTable` holds one
tensor per field, indexed by material id.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3

Tensor = torch.Tensor

# material flags (materials.py:31-33): the low bits make a material invisible
# to direct / indirect NEE shadow rays; FLAG_EMISSIVE is derived
FLAG_SHADOW_DIRECT_IGNORE = 1 << 0
FLAG_SHADOW_INDIRECT_IGNORE = 1 << 1
FLAG_EMISSIVE = 1 << 8


class MaterialTable(NamedTuple):
    """Per-material tensors; a gathered row-set has (N,) tensors instead."""

    diffuse: Vec3
    specular: Vec3
    emissive: Vec3
    diffuse_trans: Vec3
    reflectivity: Vec3
    roughness: Tensor
    ior: Tensor
    opacity: Tensor
    flags: Tensor  # int32
    diffuse_map: Tensor  # int32 texture slots; -1 = none
    specular_map: Tensor
    emissive_map: Tensor
    bump_map: Tensor

    def packed_rows(self) -> Tensor:
        """Float fields as one (M, 19) row matrix: diffuse(0:3) specular(3:6)
        emissive(6:9) diffuse_trans(9:12) reflectivity(12:15) roughness(15)
        ior(16) opacity(17) flags(18)."""
        return torch.stack(
            [
                self.diffuse.x, self.diffuse.y, self.diffuse.z,
                self.specular.x, self.specular.y, self.specular.z,
                self.emissive.x, self.emissive.y, self.emissive.z,
                self.diffuse_trans.x, self.diffuse_trans.y, self.diffuse_trans.z,
                self.reflectivity.x, self.reflectivity.y, self.reflectivity.z,
                self.roughness, self.ior, self.opacity,
                self.flags.to(torch.float32),
            ],
            dim=1,
        )

    @staticmethod
    def from_host(mats: "list[HostMaterial]", device) -> "MaterialTable":
        if not mats:
            mats = [HostMaterial(name="default")]
        t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(device)
        v3 = lambda key: Vec3(*(t([getattr(m, key)[i] for m in mats], np.float32)
                                for i in range(3)))
        s = lambda key, dt=np.float32: t([getattr(m, key) for m in mats], dt)
        return MaterialTable(
            diffuse=v3("diffuse"),
            specular=v3("specular"),
            emissive=v3("emissive"),
            diffuse_trans=v3("diffuse_trans"),
            reflectivity=v3("reflectivity"),
            roughness=s("roughness"),
            ior=s("ior"),
            opacity=s("opacity"),
            flags=s("flags", np.int32),
            diffuse_map=s("diffuse_map", np.int32),
            specular_map=s("specular_map", np.int32),
            emissive_map=s("emissive_map", np.int32),
            bump_map=s("bump_map", np.int32),
        )


class HostMaterial:
    """Mutable host-side material (MeshBase.cpp:370-410 analog)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.diffuse = (0.0, 0.0, 0.0)
        self.specular = (0.0, 0.0, 0.0)
        self.emissive = (0.0, 0.0, 0.0)
        self.diffuse_trans = (0.0, 0.0, 0.0)
        self.reflectivity = (0.0, 0.0, 0.0)
        self.phong_exponent = 0.0
        self.ior = 1.0
        self.opacity = 1.0
        self.flags = 0
        self.diffuse_map = -1
        self.specular_map = -1
        self.emissive_map = -1
        self.bump_map = -1
        # texture file names resolved by a scene loader
        self.diffuse_map_name = ""
        self.specular_map_name = ""
        self.emissive_map_name = ""
        self.bump_map_name = ""

    @property
    def roughness(self) -> float:
        # MeshStorage.cpp:163
        return 1.0 / self.phong_exponent if self.phong_exponent else 1.0

    def finalize_flags(self):
        """Set derived flags (renderer.cu:734-744 material flag pass)."""
        if max(self.emissive) > 0.0:
            self.flags |= FLAG_EMISSIVE
        return self
