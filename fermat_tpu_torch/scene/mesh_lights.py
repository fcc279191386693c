"""Textured-emitter energies and the VPL set (fermat_tpu/scene/
mesh_lights.py:430-581, src/mesh_lights.cu:158-380).

`textured_tri_energies` gives the light table's CDF weights with the
emissive map's integral folded in, a Monte Carlo estimate over each
textured emitter. `build_vpls` presamples the M virtual point lights of
nee="vpl": stratified points from the triangle CDF, resampled in proportion
to their measured emission, so that a uniform pick of a row is an
emission-proportional light sample (VPLView.sample).

Host numpy, at view build, with the JAX package's `default_rng(1351)`
streams, so the weights, the VPL rows and their `norm` are the JAX
build's bit for bit. The VPL table is a host constant: no gradient flows
into it, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops.gather import gather_rows

Tensor = torch.Tensor

_LUMA = np.array([0.2126, 0.7152, 0.0722])
_SAMPLES, _SEED = 10, 1351  # uniform points a textured emitter, and their stream


def _host_tex_lookup(images, tex_idx: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(N, 3) nearest-texel lookup in the source images; tex_idx < 0 is white."""
    out = np.ones((tex_idx.shape[0], 3), np.float64)
    for ti in np.unique(tex_idx):
        if ti < 0 or ti >= len(images):
            continue
        img = np.asarray(images[ti], np.float64)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        h, w = img.shape[:2]
        m = tex_idx == ti
        x = np.minimum((np.mod(u[m], 1.0) * w).astype(np.int64), w - 1)
        y = np.minimum((np.mod(v[m], 1.0) * h).astype(np.int64), h - 1)
        out[m] = img[y, x, :3]
    return out


def textured_tri_energies(mesh_np: dict, images) -> np.ndarray:
    """(T,) float64 emitted energy a triangle: luminance(Le) x area, with
    luminance(Le x the map's mean over _SAMPLES uniform points) on
    emitters that carry an emissive map. mesh_np: the host arrays of
    scene.lights.host_arrays."""
    mid = mesh_np["material_id"]
    e1, e2 = mesh_np["e1"], mesh_np["e2"]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    le = mesh_np["emissive"][mid]
    energy = (le @ _LUMA) * area
    tmap = mesh_np["emissive_map"][mid]
    tex_tris = np.nonzero((energy > 0) & (tmap >= 0))[0]
    if tex_tris.size == 0 or not images:
        return energy
    rng = np.random.default_rng(_SEED)
    k, t = _SAMPLES, tex_tris.size
    s = rng.random((t, k))
    r = rng.random((t, k))
    flip = s + r > 1
    s = np.where(flip, 1 - s, s)
    r = np.where(flip, 1 - r, r)
    w = 1.0 - s - r
    uv0, uv1, uv2 = (mesh_np[k_][tex_tris][:, None] for k_ in ("uv0", "uv1", "uv2"))
    uvs = uv0 * w[..., None] + uv1 * s[..., None] + uv2 * r[..., None]
    rgb = _host_tex_lookup(images, np.repeat(tmap[tex_tris], k), uvs[..., 0].ravel(),
                           uvs[..., 1].ravel())
    avg = rgb.reshape(t, k, 3).mean(1)
    energy[tex_tris] = ((le[tex_tris] * avg) @ _LUMA) * area[tex_tris]
    return energy


VPL_GATHER_MAX = 2048  # VPLView.sample fetches with K2 up to this many rows (mesh_lights.py:515)


class VPLView(NamedTuple):
    """The presampled VPL set (mesh_lights.py:492-519): rows (M, 11) float32
    with columns pos 0:3, n 3:6, Le 6:9, pdf_area 9, tri 10; norm, the
    estimate of the area integral of the emission's luminance (the density
    of a row is lum(Le) / norm)."""

    rows: Tensor  # (M, 11) float32
    norm: Tensor  # () float32

    @property
    def count(self) -> int:
        return self.rows.shape[0]

    def sample(self, u: Tensor) -> Tuple[Vec3, Vec3, Vec3, Tensor, Tensor]:
        """A uniform pick of a row by u -> (pos, n, Le, pdf_area, tri). The
        fetch is the row gather (K2) up to VPL_GATHER_MAX rows and plain
        indexing above, as in JAX."""
        m = self.rows.shape[0]
        k = torch.clamp_max((u * m).to(torch.int32), m - 1)
        r = gather_rows(self.rows, k) if m <= VPL_GATHER_MAX else self.rows[k.long()]
        vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
        return vec(0), vec(3), vec(6), r[:, 9], r[:, 10].to(torch.int32)


def build_vpls(mesh_np: dict, n_vpls: int, tri_energy: np.ndarray, images,
               device) -> Optional[VPLView]:
    """Presample and resample n_vpls VPLs (mesh_lights.py:522-581) from the
    host arrays of scene.lights.host_arrays and the triangles' energies
    (textured_tri_energies); None when the scene emits nothing. Textured
    emitters scale Le by the nearest texel of their emissive map."""
    total = tri_energy.sum()
    if total <= 0:
        return None
    p0, e1, e2, gn = mesh_np["p0"], mesh_np["e1"], mesh_np["e2"], mesh_np["gn"]
    uv0, uv1, uv2 = mesh_np["uv0"], mesh_np["uv1"], mesh_np["uv2"]
    mid, em_np, emap = mesh_np["material_id"], mesh_np["emissive"], mesh_np["emissive_map"]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)

    rng = np.random.default_rng(_SEED)
    cdf = np.cumsum(tri_energy) / total
    # stratified presample from the triangle CDF (pdf in area measure)
    r = (np.arange(n_vpls) + rng.random(n_vpls)) / n_vpls
    tri = np.minimum(np.searchsorted(cdf, r), tri_energy.size - 1)
    u = rng.random(n_vpls)
    v = rng.random(n_vpls)
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pdf_area = (tri_energy[tri] / total) / np.maximum(area[tri], 1e-20)
    pos = p0[tri] + e1[tri] * u[:, None] + e2[tri] * v[:, None]
    uvs = uv0[tri] * (1 - u - v)[:, None] + uv1[tri] * u[:, None] + uv2[tri] * v[:, None]
    le = em_np[mid[tri]]
    if images:
        le = le * _host_tex_lookup(images, emap[mid[tri]], uvs[:, 0], uvs[:, 1])
    lum = le @ _LUMA
    e_over_pdf = lum / np.maximum(pdf_area, 1e-30)
    norm = e_over_pdf.mean()  # MC estimate of the emission's area integral
    if norm <= 0:
        return None
    # resample in proportion to the measured energy: a uniform pick is then
    # emission-proportional, and a VPL's density is lum / norm
    w = e_over_pdf / np.maximum(e_over_pdf.sum(), 1e-30)
    wcdf = np.cumsum(w)
    r2 = (np.arange(n_vpls) + rng.random(n_vpls)) / n_vpls
    pick = np.minimum(np.searchsorted(wcdf, r2), n_vpls - 1)
    rows = np.concatenate(
        [pos[pick], gn[tri[pick]], le[pick], (lum[pick] / norm)[:, None],
         tri[pick][:, None].astype(np.float64)], axis=1).astype(np.float32)
    return VPLView(rows=torch.from_numpy(rows).to(device),
                   norm=torch.tensor(np.float32(norm), device=device))
