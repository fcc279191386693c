"""Mesh-emitter sampling (fermat_tpu/scene/lights.py:31-149), the emitted
radiance toward a direction (`emitter_radiance`, lights.py:161-181) and the
directional lights (lights.py:184-207).

The tables are built on the host in numpy float32 with a sequential
`np.cumsum` and then moved to the device: a parallel cumsum on the card
rounds differently, which can move a CDF step and flip a light pick.
`MeshLightsView.build_on_device` builds the same tables from a MeshView
whose emissive tensors may require grad: the values are the host tables',
the gradient that of the device formulas (JAX's build, lights.py:40-85), so
the Le columns and pdf_area carry it; the CDF (the light pick) carries none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3, dot
from fermat_tpu_torch.core.sampling import square_to_uniform_triangle
from fermat_tpu_torch.ops.cdf_gather import pick_index
from fermat_tpu_torch.ops.gather import gather_rows
from fermat_tpu_torch.scene.mesh import MeshView
from fermat_tpu_torch.scene.mesh_lights import textured_tri_energies

Tensor = torch.Tensor

COMPACT_MIN_TRIANGLES = 2049  # the emissive subset serves scenes above 2048


def light_compact_tables(cdf: np.ndarray, pdf_area: np.ndarray, rows: np.ndarray):
    """(rows (L, 23), cdf (L,)) over the EMISSIVE subset of a scene with more
    than 2048 triangles, else None (fermat_tpu/integrators/pt.py:139-166).
    The cdf steps only at emissive rows, so a pick over the subset lands on
    the same triangle as a pick over all T rows. Host numpy, at view build."""
    if pdf_area.shape[0] < COMPACT_MIN_TRIANGLES:
        return None
    ids = np.nonzero(pdf_area > 0.0)[0]
    if ids.size == 0:
        return None
    return (np.ascontiguousarray(rows[ids].astype(np.float32)),
            np.ascontiguousarray(cdf[ids].astype(np.float32)))


def host_arrays(mesh: MeshView) -> dict:
    """The numpy arrays MeshLightsView.build reads, from a device view:
    p0, e1, e2, gn (T, 3), uv0, uv1, uv2 (T, 2), material_id (T,),
    emissive (M, 3), emissive_map (M,)."""
    h = lambda t: t.detach().cpu().numpy()
    v3 = lambda v: np.stack([h(v.x), h(v.y), h(v.z)], axis=1)
    m = mesh.materials
    return dict(p0=v3(mesh.p0), e1=v3(mesh.e1), e2=v3(mesh.e2), gn=v3(mesh.gn),
                uv0=h(mesh.uv0), uv1=h(mesh.uv1), uv2=h(mesh.uv2),
                material_id=h(mesh.material_id), emissive=v3(m.emissive),
                emissive_map=h(m.emissive_map))


class _Follow(torch.autograd.Function):
    """The first tensor's values with the second's gradient: a device-built
    table keeps the host table's bits in the forward pass."""

    @staticmethod
    def forward(ctx, host: Tensor, dev: Tensor) -> Tensor:
        return host.clone()

    @staticmethod
    def backward(ctx, g: Tensor):
        return None, g


class MeshLightsView(NamedTuple):
    """Device view over the emissive set (MeshLightsStorage analog)."""

    cdf: Tensor  # (T,) inclusive, normalized to 1 over all triangles
    pdf_area: Tensor  # (T,) area pdf of sampling a point on tri t (0 if not emissive)
    has_lights: Tensor  # () bool
    rows: Tensor  # (T, 23): p0 e1 e2 gn Le pdf_area uv0 duv1 duv2 emap
    compact: Optional[Tuple[Tensor, Tensor]] = None  # light_compact_tables
    # the emissive tensors a device build follows (build_on_device); None
    # for a table built on the host, which no gradient reaches
    emissive: Optional[Vec3] = None

    @staticmethod
    def build(mesh_np: dict, device, weights: Optional[np.ndarray] = None) -> "MeshLightsView":
        """From the host arrays of a MeshView (host_arrays). The weights are
        `weights` (T,), clamped at 0, as in JAX (lights.py:40-60), else
        luminance(emissive) * area: mesh_lights.textured_tri_energies
        without images, which SceneView.build passes with its images."""
        f32 = np.float32
        mid = mesh_np["material_id"]
        le = mesh_np["emissive"][mid]  # (T, 3) f32
        e1, e2 = mesh_np["e1"], mesh_np["e2"]
        if weights is None:
            weights = textured_tri_energies(mesh_np, [])
        w = np.maximum(np.asarray(weights).astype(f32), f32(0.0))
        c = np.cross(e1, e2)
        area = f32(0.5) * np.sqrt(np.maximum(
            c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2], f32(0.0)))
        total = w.sum(dtype=f32)
        has = bool(total > 0.0)
        safe_total = total if has else f32(1.0)
        cdf = np.cumsum(w, dtype=f32) / safe_total
        pdf_area = np.where((w > 0.0) & (area > 0.0),
                            (w / safe_total) / np.maximum(area, f32(1e-20)),
                            f32(0.0)).astype(f32)
        uv0, uv1, uv2 = mesh_np["uv0"], mesh_np["uv1"], mesh_np["uv2"]
        rows = np.concatenate([
            mesh_np["p0"], e1, e2, mesh_np["gn"], le, pdf_area[:, None],
            uv0, uv1 - uv0, uv2 - uv0,
            mesh_np["emissive_map"][mid].astype(f32)[:, None],
        ], axis=1).astype(f32)
        return MeshLightsView.from_arrays(cdf, pdf_area, np.asarray(has), rows, device)

    @staticmethod
    def build_on_device(mesh: MeshView, weights: Optional[np.ndarray] = None) -> "MeshLightsView":
        """The table of `build` from a device MeshView whose emissive tensors
        may require grad (JAX's MeshLightsView.build(mesh, weights), which
        tests/test_gradients.py::test_fd_emitter_radiance calls inside its
        loss). Forward values: the host build's, bit for bit. Gradient: the
        device formulas' (Le columns from the materials; pdf_area from
        luminance * area, or from the constant `weights`), into
        mesh.materials.emissive. A table that carries a gradient has no
        emissive subset: K4's pick is detached, and JAX's traced views take
        the full table too (pt.py:151-156)."""
        host = MeshLightsView.build(host_arrays(mesh), mesh.p0.x.device, weights)
        mid = mesh.material_id.long()
        em = mesh.materials.emissive
        le = Vec3(em.x[mid], em.y[mid], em.z[mid])
        area = mesh.triangle_areas()
        if weights is None:
            w = torch.clamp_min(0.2126 * le.x + 0.7152 * le.y + 0.0722 * le.z, 0.0) * area
        else:
            w = torch.clamp_min(torch.as_tensor(np.asarray(weights, np.float32),
                                                device=area.device), 0.0)
        total = w.sum()
        safe_total = torch.where(total > 0.0, total, 1.0)
        pdf = torch.where((w > 0.0) & (area > 0.0),
                          (w / safe_total) / torch.clamp_min(area, 1e-20), 0.0)
        emap = mesh.materials.emissive_map[mid].to(torch.float32)
        uv0 = mesh.uv0
        rows = torch.stack([*mesh.p0, *mesh.e1, *mesh.e2, *mesh.gn, *le, pdf,
                            uv0[:, 0], uv0[:, 1], *(mesh.uv1 - uv0).unbind(1),
                            *(mesh.uv2 - uv0).unbind(1), emap], dim=1)
        rows, pdf = _Follow.apply(host.rows, rows), _Follow.apply(host.pdf_area, pdf)
        return host._replace(rows=rows, pdf_area=pdf, emissive=em,
                             compact=None if rows.requires_grad else host.compact)

    def follows(self, emissive: Vec3) -> bool:
        """Whether this table was built on the device from these emissive
        tensors (build_on_device), so that NEE's Le carries their gradient."""
        return self.emissive is not None and all(a is b for a, b in zip(self.emissive, emissive))

    @staticmethod
    def from_arrays(cdf: np.ndarray, pdf_area: np.ndarray, has_lights: np.ndarray,
                    rows: np.ndarray, device) -> "MeshLightsView":
        """The device view of host tables, with their emissive subset."""
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        compact = light_compact_tables(cdf, pdf_area, rows)
        return MeshLightsView(cdf=t(cdf), pdf_area=t(pdf_area), has_lights=t(has_lights),
                              rows=t(rows),
                              compact=None if compact is None else tuple(map(t, compact)))

    def sample(self, u0: Tensor, u1: Tensor, u2: Tensor) -> Tuple[Vec3, Vec3, Vec3, Tensor, Tensor]:
        """One point on the emissive set per lane: (position, normal, Le,
        pdf_area, tri). The pick is count(cdf <= u2), clipped
        (lights.py:98-103): searchsorted(right=True), NaN u2 -> 0."""
        tri = pick_index(self.cdf, u2).to(torch.int32)
        b0, b1 = square_to_uniform_triangle(u0, u1)
        return (*row_sample(gather_rows(self.rows, tri), b0, b1), tri)

    def sample_ex(self, u0: Tensor, u1: Tensor, u2: Tensor):
        """sample() plus the sampled point's texture coordinates and the
        emitter's emissive-map index (lights.py:115-131): (position, normal,
        Le, pdf_area, tri, uv_u, uv_v, emap)."""
        tri = pick_index(self.cdf, u2).to(torch.int32)
        b0, b1 = square_to_uniform_triangle(u0, u1)
        r = gather_rows(self.rows, tri)
        return (*row_sample(r, b0, b1), tri, *row_uv(r, b0, b1))

    def pdf_area_of(self, tri: Tensor) -> Tensor:
        """Area pdf for MIS when a BSDF ray hits an emitter (lights.py:139-149)."""
        return gather_rows(self.pdf_area[:, None], torch.clamp_min(tri, 0))[:, 0]


def row_sample(r: Tensor, b0: Tensor, b1: Tensor):
    """(position, normal, Le, pdf_area) of fetched light rows at the uniform
    barycentrics (b0, b1)."""
    vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
    return vec(0) + vec(3) * b0 + vec(6) * b1, vec(9), vec(12), r[:, 15]


def row_uv(r: Tensor, b0: Tensor, b1: Tensor):
    """(uv_u, uv_v, emissive map) of fetched light rows at (b0, b1)
    (lights.py:128-130)."""
    return (r[:, 16] + r[:, 18] * b0 + r[:, 20] * b1, r[:, 17] + r[:, 19] * b0 + r[:, 21] * b1,
            r[:, 22].to(torch.int32))


def emitter_radiance(mesh: MeshView, tri: Tensor, wo_world: Vec3, gn: Vec3 = None,
                     mid: Tensor = None) -> Vec3:
    """Le leaving a surface toward wo_world, front side only (lights.py:161-181,
    edf.h Lambert). Pass (gn, mid) when the hit's row is already fetched."""
    if gn is None or mid is None:
        rows = gather_rows(mesh.packed_rows(), torch.clamp_min(tri, 0))
        gn = Vec3(rows[:, 9], rows[:, 10], rows[:, 11]) if gn is None else gn
        mid = torch.round(rows[:, 27]).to(torch.int32) if mid is None else mid
    em = mesh.materials.emissive
    le = gather_rows(torch.stack([em.x, em.y, em.z], dim=1), mid)
    front = dot(gn, wo_world) > 0.0
    return Vec3(*(torch.where(front, le[:, c], 0.0) for c in range(3)))


@dataclass
class DirectionalLightDef:
    """A directional light as the scene loaders give it
    (scene/loaders/fa.py:34): the direction the light travels and its color."""

    direction: Tuple[float, float, float]
    color: Tuple[float, float, float]


class DirectionalLightsView(NamedTuple):
    """SoA directional lights (lights.py:184-207, lights.h:249)."""

    dir_x: Tensor  # (L,) unit direction the light TRAVELS (towards the scene)
    dir_y: Tensor
    dir_z: Tensor
    col_x: Tensor
    col_y: Tensor
    col_z: Tensor

    @staticmethod
    def build(defs, device) -> "DirectionalLightsView":
        """defs: records with `direction` and `color` (DirectionalLightDef)."""
        d = np.array([light.direction for light in defs], np.float32).reshape(-1, 3)
        if d.shape[0]:
            d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
        c = np.array([light.color for light in defs], np.float32).reshape(-1, 3)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return DirectionalLightsView(t(d[:, 0]), t(d[:, 1]), t(d[:, 2]),
                                     t(c[:, 0]), t(c[:, 1]), t(c[:, 2]))

    @property
    def count(self) -> int:
        return self.dir_x.shape[0]
