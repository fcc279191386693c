"""Mesh storage: numpy host mirror + torch device view
(fermat_tpu/scene/mesh.py:31-370).

`MeshStorage` is the port's own copy of the host-side triangle mesh (the JAX
package's lives in a module that imports JAX), with the packed attribute
storage of mesh.py:45-86: `compress_normals()` / `compress_tex()` swap the
float normals / uvs for scene/compression.py's words, and every consumer
(the view build, `transform`, `merge`, `filtered`, the uv BVH, save_obj)
reads them through `_resolved_normals()` / `_resolved_uvs()`. JAX's
`transform`, `merge` and `filtered` read the float arrays alone, which are
empty on a compressed mesh; the port's keep its attributes (ROADMAP Queue 3).
`MeshView` is the device-side triangle soup, pre-gathered per corner.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3, cross, normalize, ray_barycentrics
from fermat_tpu_torch.ops.gather import gather_rows
from fermat_tpu_torch.scene import compression
from fermat_tpu_torch.scene.materials import HostMaterial, MaterialTable

Tensor = torch.Tensor


@dataclass
class MeshStorage:
    """Host-side mesh (numpy), built by procedural scenes; MeshStorage.h analog."""

    vertices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normal_indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))  # -1 => face normal
    uvs: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    uv_indices: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))  # -1 => zero uv
    material_ids: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int32))
    materials: List[HostMaterial] = field(default_factory=list)
    # the loaders' groups (mesh.py:43-44): names and triangle offsets, host
    # metadata the device view does not read
    group_names: List[str] = field(default_factory=list)
    group_offsets: np.ndarray = field(default_factory=lambda: np.zeros((1,), np.int32))
    # compressed attributes (MeshStorage.h:146-147): when set, the float
    # arrays above are empty and the resolvers decode these
    normals_packed: Optional[np.ndarray] = None  # (N,) uint32 octahedral 16+16
    uvs_packed: Optional[np.ndarray] = None  # (N,) uint32 fixed 15-bit pair
    uv_bias: Optional[np.ndarray] = None  # (2,) float32
    uv_scale: Optional[np.ndarray] = None  # (2,) float32

    def compress_normals(self) -> "MeshStorage":
        """Swap float normals for the packed octahedral codec (mesh.py:51-59)."""
        if self.normals.shape[0] and self.normals_packed is None:
            self.normals_packed = compression.compress_normals(self.normals)
            self.normals = np.zeros((0, 3), np.float32)
        return self

    def compress_tex(self) -> "MeshStorage":
        """Swap float uvs for the fixed-point codec (mesh.py:61-70)."""
        if self.uvs.shape[0] and self.uvs_packed is None:
            self.uv_bias, self.uv_scale = compression.uv_bias_scale(self.uvs)
            self.uvs_packed = compression.compress_uv(self.uvs, self.uv_bias, self.uv_scale)
            self.uvs = np.zeros((0, 2), np.float32)
        return self

    def _resolved_normals(self) -> np.ndarray:
        if self.normals_packed is not None and self.normals.shape[0] == 0:
            return compression.decompress_normals(self.normals_packed)
        return self.normals

    def _resolved_uvs(self) -> np.ndarray:
        if self.uvs_packed is not None and self.uvs.shape[0] == 0:
            return compression.decompress_uv(self.uvs_packed, self.uv_bias, self.uv_scale)
        return self.uvs

    def _expand(self) -> "MeshStorage":
        """Decode packed attributes into the float arrays in place."""
        self.normals, self.uvs = self._resolved_normals(), self._resolved_uvs()
        self.normals_packed = self.uvs_packed = self.uv_bias = self.uv_scale = None
        return self

    @property
    def n_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]

    def transform(self, m: np.ndarray) -> "MeshStorage":
        """Apply a 4x4 affine transform in place (mesh.py:96-105)."""
        v = self.vertices @ m[:3, :3].T + m[:3, 3]
        self.vertices = v.astype(np.float32)
        packed = self.normals_packed is not None
        normals = self._resolved_normals()
        if normals.shape[0]:
            ninv = np.linalg.inv(m[:3, :3]).T
            n = normals @ ninv.T
            n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
            self.normals, self.normals_packed = n.astype(np.float32), None
            if packed:
                self.compress_normals()
        return self

    def merge(self, other: "MeshStorage") -> "MeshStorage":
        """Append another mesh in place, its groups too (mesh.py:107-140).
        An empty per-corner index array means "no attribute"; once meshes
        are merged it becomes explicit -1 rows so the row count stays
        n_triangles."""
        self._expand()
        other = copy.copy(other)._expand()
        mat_off = len(self.materials)
        vtx_off = self.n_vertices
        nrm_off = self.normals.shape[0]
        uv_off = self.uvs.shape[0]
        tri_off = self.n_triangles

        def idx_rows(idx, n):
            return idx if idx.shape[0] == n else np.full((n, 3), -1, np.int32)

        self.vertices = np.concatenate([self.vertices, other.vertices])
        self.normals = np.concatenate([self.normals, other.normals])
        oni = idx_rows(other.normal_indices, other.n_triangles).copy()
        oni[oni >= 0] += nrm_off
        self.normal_indices = np.concatenate([idx_rows(self.normal_indices, tri_off), oni])
        self.uvs = np.concatenate([self.uvs, other.uvs])
        oui = idx_rows(other.uv_indices, other.n_triangles).copy()
        oui[oui >= 0] += uv_off
        self.uv_indices = np.concatenate([idx_rows(self.uv_indices, tri_off), oui])
        self.triangles = np.concatenate([self.triangles, other.triangles + vtx_off])
        self.material_ids = np.concatenate([self.material_ids, other.material_ids + mat_off])
        self.materials = self.materials + list(other.materials)
        self.group_names = self.group_names + list(other.group_names)
        self.group_offsets = np.concatenate([self.group_offsets[:-1],
                                             other.group_offsets + tri_off])
        return self

    def bbox(self) -> Tuple[np.ndarray, np.ndarray]:
        """(min, max) corners of the vertices, zeros for an empty mesh
        (mesh.py:142-145)."""
        if self.n_vertices == 0:
            return np.zeros(3, np.float32), np.zeros(3, np.float32)
        return self.vertices.min(0), self.vertices.max(0)

    def filtered(self, keep: np.ndarray) -> "MeshStorage":
        """A copy with only the triangles where keep[t], vertices, normals,
        uvs and materials shared, its groups one (mesh.py:147-172): the
        occlusion geometry of a shadow set."""
        keep = np.asarray(keep, bool)
        t = self.triangles[keep]

        def rows(idx):
            return idx[keep] if idx.shape[0] == self.n_triangles else np.full_like(t, -1)

        return MeshStorage(
            vertices=self.vertices,
            triangles=t,
            normals=self.normals,
            normal_indices=rows(self.normal_indices),
            uvs=self.uvs,
            uv_indices=rows(self.uv_indices),
            material_ids=self.material_ids[keep],
            materials=self.materials,
            group_names=["shadow"],
            group_offsets=np.asarray([0, t.shape[0]], np.int32),
            normals_packed=self.normals_packed, uvs_packed=self.uvs_packed,
            uv_bias=self.uv_bias, uv_scale=self.uv_scale,
        )

    def device_view(self, device) -> "MeshView":
        """The kernel-facing SoA view (MeshView.h:96 analog), computed in
        numpy exactly as mesh.py:174-227 and then moved to `device`."""
        t = self.triangles.astype(np.int32)
        v = self.vertices.astype(np.float32)
        p0 = v[t[:, 0]]
        p1 = v[t[:, 1]]
        p2 = v[t[:, 2]]
        gn = np.cross(p1 - p0, p2 - p0)
        gn /= np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
        corner_n = np.repeat(gn[:, None, :], 3, axis=1)  # (T, 3 corners, 3)
        normals = self._resolved_normals()
        if normals.shape[0]:
            ni = self.normal_indices
            ok = ni >= 0
            corner_n[ok] = normals[np.where(ok, ni, 0)][ok]
        corner_uv = np.zeros((self.n_triangles, 3, 2), np.float32)
        uvs = self._resolved_uvs()
        if uvs.shape[0]:
            ui = self.uv_indices
            ok = ui >= 0
            corner_uv[ok] = uvs[np.where(ok, ui, 0)][ok]

        mat = [m.finalize_flags() for m in self.materials] or [HostMaterial("default")]
        # texture-LOD base: uv-space area vs world-space area per triangle
        wld_area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=1)
        uv_e1 = corner_uv[:, 1] - corner_uv[:, 0]
        uv_e2 = corner_uv[:, 2] - corner_uv[:, 0]
        uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1] - uv_e1[:, 1] * uv_e2[:, 0])
        lod_base = 0.5 * np.log2(
            (uv_area + 1e-20) / (wld_area + 1e-20)
        ).astype(np.float32)
        j = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        v3 = lambda a: Vec3(j(a[:, 0]), j(a[:, 1]), j(a[:, 2]))
        return MeshView(
            p0=v3(p0), e1=v3(p1 - p0), e2=v3(p2 - p0), gn=v3(gn),
            n0=v3(corner_n[:, 0]), n1=v3(corner_n[:, 1]), n2=v3(corner_n[:, 2]),
            uv0=j(corner_uv[:, 0]), uv1=j(corner_uv[:, 1]), uv2=j(corner_uv[:, 2]),
            material_id=j(
                self.material_ids.astype(np.int32)
                if self.material_ids.shape[0]
                else np.zeros(self.n_triangles, np.int32)
            ),
            lod_base=j(lod_base),
            materials=MaterialTable.from_host(mat, device),
        )


class ShadeHit(NamedTuple):
    """Differential geometry + material lanes at a hit (shade_fetch output)."""

    pos: Vec3
    gn: Vec3
    sn: Vec3
    uv: Tensor  # (N, 2)
    mat_id: Tensor  # int32
    lod_base: Tensor
    mats: MaterialTable  # fields are (N,) lanes


class MeshView(NamedTuple):
    """Device-side triangle soup, pre-gathered per corner (MeshView.h:96-170).

    Triangles are stored as (p0, e1, e2) so Moller-Trumbore needs no vertex
    indirection; shading normals and uvs are resolved per corner.
    """

    p0: Vec3  # (T,)
    e1: Vec3  # p1 - p0
    e2: Vec3  # p2 - p0
    gn: Vec3  # geometric unit normal
    n0: Vec3  # shading normals at the corners
    n1: Vec3
    n2: Vec3
    uv0: Tensor  # (T, 2)
    uv1: Tensor
    uv2: Tensor
    material_id: Tensor  # (T,) int32
    lod_base: Tensor  # (T,) 0.5*log2(uv_area/world_area)
    materials: MaterialTable

    @property
    def n_triangles(self) -> int:
        return self.material_id.shape[0]

    def tri_soup(self) -> Tensor:
        """(9, T) float32 rows p0 xyz, e1 xyz, e2 xyz: the tracer's input
        (the unpadded counterpart of pallas_trace._pad_tris)."""
        return torch.stack([self.p0.x, self.p0.y, self.p0.z,
                            self.e1.x, self.e1.y, self.e1.z,
                            self.e2.x, self.e2.y, self.e2.z]).contiguous()

    def packed_rows(self) -> Tensor:
        """Per-triangle attributes as one (T, 29) row matrix: p0(0:3)
        e1(3:6) e2(6:9) gn(9:12) n0(12:15) n1(15:18) n2(18:21) uv0(21:23)
        uv1(23:25) uv2(25:27) mat_id(27) lod_base(28)."""
        return torch.stack(
            [
                self.p0.x, self.p0.y, self.p0.z,
                self.e1.x, self.e1.y, self.e1.z,
                self.e2.x, self.e2.y, self.e2.z,
                self.gn.x, self.gn.y, self.gn.z,
                self.n0.x, self.n0.y, self.n0.z,
                self.n1.x, self.n1.y, self.n1.z,
                self.n2.x, self.n2.y, self.n2.z,
                self.uv0[:, 0], self.uv0[:, 1],
                self.uv1[:, 0], self.uv1[:, 1],
                self.uv2[:, 0], self.uv2[:, 1],
                self.material_id.to(torch.float32),
                self.lod_base,
            ],
            dim=1,
        )

    def shade_rows(self) -> Tensor:
        """(T, 52) joined shading table: packed_rows (29 cols) ++ the
        material row gathered per triangle (19 float cols + 4 texture-slot
        ids), so a hit shade is ONE row fetch (mesh.py:303-322)."""
        m = self.materials
        maps = torch.stack(
            [m.diffuse_map, m.specular_map, m.emissive_map, m.bump_map], dim=1
        ).to(torch.float32)
        mfull = torch.cat([m.packed_rows(), maps], dim=1)
        return torch.cat(
            [self.packed_rows(), mfull[self.material_id.long()]], dim=1
        ).contiguous()

    def shade_fetch(self, tri: Tensor, u: Tensor, v: Tensor, table: Tensor) -> ShadeHit:
        """One-fetch differential geometry + material lanes at a hit
        (mesh.py:324-370); `table` is shade_rows(), built once per pass."""
        return _shade(_detach_geometry(gather_rows(table, tri)), u, v)

    def shade_fetch_ray(self, tri: Tensor, o: Vec3, d: Vec3, table: Tensor) -> ShadeHit:
        """shade_fetch with (u, v) derived from the ray and the fetched row's
        own p0/e1/e2 (Moller-Trumbore barycentrics, mesh.py:372-430), for
        closest tracers that return no barycentrics. inv_det is taken
        wherever det != 0, as there (no 1e-12 gate)."""
        return self.shade_fetch_ray_uv(tri, o, d, table)[0]

    def shade_fetch_ray_uv(self, tri: Tensor, o: Vec3, d: Vec3, table: Tensor):
        """(shade_fetch_ray's ShadeHit, the derived u, v)."""
        r = _detach_geometry(gather_rows(table, tri))
        vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
        u, v = ray_barycentrics(o, d, vec(0), vec(3), vec(6))
        u, v = u.detach(), v.detach()  # mesh.py:404-405
        return _shade(r, u, v), u, v

    def triangle_areas(self) -> Tensor:
        c = cross(self.e1, self.e2)
        return 0.5 * torch.sqrt(torch.clamp_min(c.x * c.x + c.y * c.y + c.z * c.z, 0.0))


def _detach_geometry(r: Tensor) -> Tensor:
    """Fetched shade rows with the 29 geometry columns detached
    (mesh.py:343 and :384): the table joins them with the material
    columns, and hit geometry must carry no gradient into the next
    bounce's rays. Rows that need no gradient pass through as they are."""
    if not r.requires_grad:
        return r
    return torch.cat([r[:, :29].detach(), r[:, 29:]], dim=1)


def _shade(r: Tensor, u: Tensor, v: Tensor) -> ShadeHit:
    """ShadeHit from fetched (N, 52) shade rows at barycentrics (u, v)."""
    vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
    p0, e1, e2, gn = vec(0), vec(3), vec(6), vec(9)
    n0, n1, n2 = vec(12), vec(15), vec(18)
    pos = p0 + e1 * u + e2 * v
    w = 1.0 - u - v
    sn = normalize(n0 * w + n1 * u + n2 * v)
    uv = (r[:, 21:23] * w[:, None] + r[:, 23:25] * u[:, None]
          + r[:, 25:27] * v[:, None])
    # round half to even, as jnp.round (mesh.py:353)
    ival = lambda c: torch.round(r[:, c]).to(torch.int32)
    mats = MaterialTable(
        diffuse=vec(29),
        specular=vec(32),
        emissive=vec(35),
        diffuse_trans=vec(38),
        reflectivity=vec(41),
        roughness=r[:, 44],
        ior=r[:, 45],
        opacity=r[:, 46],
        flags=ival(47),
        diffuse_map=ival(48),
        specular_map=ival(49),
        emissive_map=ival(50),
        bump_map=ival(51),
    )
    return ShadeHit(pos, gn, sn, uv, ival(27), r[:, 28], mats)
