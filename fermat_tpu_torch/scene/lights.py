"""Mesh-emitter sampling (fermat_tpu/scene/lights.py:31-149) and the
directional lights (lights.py:184-207).

The tables are built on the host in numpy float32 with a sequential
`np.cumsum` and then moved to the device: a parallel cumsum on the card
rounds differently, which can move a CDF step and flip a light pick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.core.sampling import square_to_uniform_triangle
from fermat_tpu_torch.ops.cdf_gather import pick_index
from fermat_tpu_torch.ops.gather import gather_rows

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


class MeshLightsView(NamedTuple):
    """Device view over the emissive set (MeshLightsStorage analog)."""

    cdf: Tensor  # (T,) inclusive, normalized to 1 over all triangles
    pdf_area: Tensor  # (T,) area pdf of sampling a point on tri t (0 if not emissive)
    has_lights: Tensor  # () bool
    rows: Tensor  # (T, 23): p0 e1 e2 gn Le pdf_area uv0 duv1 duv2 emap
    compact: Optional[Tuple[Tensor, Tensor]] = None  # light_compact_tables

    @staticmethod
    def build(mesh_np: dict, device) -> "MeshLightsView":
        """From the host arrays of a MeshView (`MeshView` fields as numpy:
        p0, e1, e2, gn (T, 3), uv0, uv1, uv2 (T, 2), material_id (T,),
        emissive (M, 3), emissive_map (M,)).

        Weight = luminance(emissive) * area, computed as the JAX package's
        SceneView.build does (mesh_lights.textured_tri_energies, then
        MeshLightsView.build with those weights).
        """
        f32 = np.float32
        mid = mesh_np["material_id"]
        le = mesh_np["emissive"][mid]  # (T, 3) f32
        e1, e2 = mesh_np["e1"], mesh_np["e2"]
        energy = (le @ np.array([0.2126, 0.7152, 0.0722])) * (
            0.5 * np.linalg.norm(np.cross(e1, e2), axis=1))
        w = np.maximum(energy.astype(f32), f32(0.0))
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
        r = gather_rows(self.rows, tri)
        vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
        p0, e1, e2, n, le = vec(0), vec(3), vec(6), vec(9), vec(12)
        pos = p0 + e1 * b0 + e2 * b1
        return pos, n, le, r[:, 15], tri

    def pdf_area_of(self, tri: Tensor) -> Tensor:
        """Area pdf for MIS when a BSDF ray hits an emitter (lights.py:139-149)."""
        return gather_rows(self.pdf_area[:, None], torch.clamp_min(tri, 0))[:, 0]


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
