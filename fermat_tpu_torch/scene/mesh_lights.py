"""Textured-emitter energies (fermat_tpu/scene/mesh_lights.py:430-489): the
light table's CDF weights with the emissive map's integral folded in, a
Monte Carlo estimate over each textured emitter (src/mesh_lights.cu:158-285).

Host numpy, at view build, with the JAX package's `default_rng(1351)`
stream, so the weights are the JAX build's. The VPL set of nee="vpl"
(`build_vpls`) is not ported.
"""
from __future__ import annotations

import numpy as np

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
