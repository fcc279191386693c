"""Analytic light types: point lights and disk/rect area lights
(fermat_tpu/scene/analytic_lights.py).

Two routes for a disk or a rectangle, as in the JAX package:
  * add_rect_light / add_disk_light tessellate it into emissive triangles
    merged into the host mesh, so that the mesh-light NEE and the emissive
    hits serve it;
  * AreaLightsView keeps it analytic, with exact sample / map / pdf forms
    (lights.h:175-249). Such a light is invisible to BSDF rays, so its NEE
    carries weight 1 (no MIS).
Point lights are delta lights, sampled in the PT pass's delta-light NEE beside
the directional lights (scene/lights.DirectionalLightsView).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.core.sampling import square_to_uniform_disk
from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage

Tensor = torch.Tensor


def _emissive_material(radiance) -> HostMaterial:
    m = HostMaterial("light")
    m.emissive = tuple(float(c) for c in radiance)
    return m


def _basis(n: np.ndarray):
    """(t, b) tangents of a normal, in float64 as analytic_lights.py:33-38."""
    n = n / max(np.linalg.norm(n), 1e-12)
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    t = np.cross(n, a)
    t /= max(np.linalg.norm(t), 1e-12)
    return t, np.cross(n, t)


def _emitter_mesh(vertices, triangles, radiance) -> MeshStorage:
    t = np.asarray(triangles, np.int32)
    return MeshStorage(
        vertices=np.asarray(vertices, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.zeros(t.shape[0], np.int32),
        materials=[_emissive_material(radiance)],
    )


def add_rect_light(mesh: MeshStorage, center, normal, u_extent: float, v_extent: float,
                   radiance) -> MeshStorage:
    """Rectangle area light -> 2 emissive triangles merged into `mesh`."""
    c = np.asarray(center, np.float32)
    t, b = _basis(np.asarray(normal, np.float32))
    corners = [
        c - t * u_extent - b * v_extent,
        c + t * u_extent - b * v_extent,
        c + t * u_extent + b * v_extent,
        c - t * u_extent + b * v_extent,
    ]
    return mesh.merge(_emitter_mesh(corners, [[0, 1, 2], [0, 2, 3]], radiance))


def add_disk_light(mesh: MeshStorage, center, normal, radius: float, radiance,
                   segments: int = 16) -> MeshStorage:
    """Disk area light -> a fan of `segments` emissive triangles merged into
    `mesh` (lights.h DiskLight:175)."""
    c = np.asarray(center, np.float32)
    t, b = _basis(np.asarray(normal, np.float32))
    verts = [c]
    for k in range(segments):
        a = 2 * np.pi * k / segments
        verts.append(c + (t * np.cos(a) + b * np.sin(a)) * radius)
    tris = [[0, 1 + k, 1 + (k + 1) % segments] for k in range(segments)]
    return mesh.merge(_emitter_mesh(verts, tris, radiance))


class PointLightsView(NamedTuple):
    """SoA point lights (delta; lights.h Point), intensity in W/sr."""

    px: Tensor
    py: Tensor
    pz: Tensor
    ix: Tensor
    iy: Tensor
    iz: Tensor

    @staticmethod
    def build(defs, device) -> "PointLightsView":
        """defs: (position, intensity) pairs."""
        p = np.array([light[0] for light in defs], np.float32).reshape(-1, 3)
        i = np.array([light[1] for light in defs], np.float32).reshape(-1, 3)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return PointLightsView(t(p[:, 0]), t(p[:, 1]), t(p[:, 2]),
                               t(i[:, 0]), t(i[:, 1]), t(i[:, 2]))

    @property
    def count(self) -> int:
        return self.px.shape[0]


class AreaLightsView(NamedTuple):
    """Analytic disk/rect area lights (analytic_lights.py:124-223). `kind`
    (0 = disk of radius ru, 1 = rect of half-extents ru, rv along u, v), `ru`
    and `rv` are host numpy arrays: they steer Python branches, as in JAX;
    the rest are (L,) tensors on the device."""

    kind: np.ndarray  # (L,) int32
    px: Tensor  # center
    py: Tensor
    pz: Tensor
    ux: Tensor  # tangent u (unit)
    uy: Tensor
    uz: Tensor
    vx: Tensor  # tangent v (unit)
    vy: Tensor
    vz: Tensor
    nx: Tensor  # emission normal (unit)
    ny: Tensor
    nz: Tensor
    cx: Tensor  # radiance
    cy: Tensor
    cz: Tensor
    ru: np.ndarray  # (L,) float32 disk radius / rect u half-extent
    rv: np.ndarray  # (L,) float32 rect v half-extent (a disk's is its radius)

    @staticmethod
    def build(defs, device) -> "AreaLightsView":
        """defs: dicts {kind: 'disk' | 'rect', pos, normal, color, radius |
        (u_extent, v_extent)}."""
        rows = []
        for d in defs:
            n = np.asarray(d["normal"], np.float32)
            n = n / max(np.linalg.norm(n), 1e-12)
            t, b = _basis(n)
            kind = 0 if d.get("kind", "disk") == "disk" else 1
            ru = float(d.get("radius", d.get("u_extent", 1.0)))
            rv = float(d.get("v_extent", ru))
            rows.append((kind, *np.asarray(d["pos"], np.float32), *t, *b, *n,
                         *np.asarray(d["color"], np.float32), ru, rv))
        a = np.asarray(rows, np.float32).reshape(-1, 18)
        return AreaLightsView.from_arrays(
            a[:, 0].astype(np.int32), [a[:, k] for k in range(1, 16)], a[:, 16].copy(),
            a[:, 17].copy(), device)

    @staticmethod
    def from_arrays(kind: np.ndarray, columns, ru: np.ndarray, rv: np.ndarray,
                    device) -> "AreaLightsView":
        """The view from host arrays: kind, the 15 device columns px ... cz
        in field order, ru and rv."""
        t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
        return AreaLightsView(np.asarray(kind, np.int32), *(t(c) for c in columns),
                              np.asarray(ru, np.float32), np.asarray(rv, np.float32))

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def map(self, li: int, u0: Tensor, u1: Tensor):
        """(u0, u1) -> a point of light li: (pos, normal, Le, pdf_area). Disk:
        the concentric warp, pdf 1/(pi r^2); rect: bilinear over
        [-ru, ru] x [-rv, rv], pdf 1/(4 ru rv)."""
        dx, dy = square_to_uniform_disk(u0, u1)
        ru, rv = float(self.ru[li]), float(self.rv[li])
        if int(self.kind[li]) == 0:
            ox, oy = dx * ru, dy * ru
            pdf = 1.0 / (np.pi * ru * ru)
        else:
            ox, oy = (u0 * 2.0 - 1.0) * ru, (u1 * 2.0 - 1.0) * rv
            pdf = 1.0 / (4.0 * ru * rv)
        pos = Vec3(self.px[li] + self.ux[li] * ox + self.vx[li] * oy,
                   self.py[li] + self.uy[li] * ox + self.vy[li] * oy,
                   self.pz[li] + self.uz[li] * ox + self.vz[li] * oy)
        sh = u0.shape
        nrm = Vec3(*(a[li].expand(sh) for a in (self.nx, self.ny, self.nz)))
        le = Vec3(*(a[li].expand(sh) for a in (self.cx, self.cy, self.cz)))
        return pos, nrm, le, torch.full(sh, pdf, dtype=torch.float32, device=u0.device)

    def sample(self, li: int, u0: Tensor, u1: Tensor):
        """A surface point of light li: the same as map at (u0, u1)."""
        return self.map(li, u0, u1)

    def pdf_area(self, li: int) -> float:
        """Area pdf of the uniform surface sampler (a constant per light)."""
        if int(self.kind[li]) == 0:
            return 1.0 / (np.pi * float(self.ru[li]) ** 2)
        return 1.0 / (4.0 * float(self.ru[li]) * float(self.rv[li]))
