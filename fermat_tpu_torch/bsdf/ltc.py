"""LTC (linearly transformed cosine) glossy lobe (fermat_tpu/bsdf/ltc.py:34-122).

The reference's USE_LTC alternative to GGX-Smith reflection (cugar/bsdf/
ltc.h): an exactly normalised, analytically sampleable proxy of the
cosine-weighted GGX slice,
    D(w) = cos(M^-1 w)/pi * |det M^-1| / ||M^-1 w||^3,
so pdf == D and eval = D * magnitude(roughness, cos_i) / cos_o. M is read
from the fitted (32, 32, 4) table and its (32, 32) magnitude plane by
(roughness, |cos_i|): the port's byte-for-byte copy of the JAX package's
ltc_ggx.npz in fermat_tpu_torch/data/.

JAX fetches the table bilinearly with a one-hot matmul for the TPU's MXU;
here the fetch is a direct four-tap gather and blend with the same weights
(two taps that clamp to one texel share its weight, as the one-hot rows
do). Elementwise plain PyTorch, differentiable in roughness through the
blend weights as JAX's is.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3

Tensor = torch.Tensor

_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
                    "ltc_ggx.npz")
_PLANES = {}  # device -> ((R * R, 5) float32 table, R)


def _tables(device) -> tuple:
    """((R * R, 5) planes m00, m11, m02, m20, magnitude; R) on `device`."""
    dev = torch.device(device)
    if dev not in _PLANES:
        data = np.load(_NPZ)
        tab = np.asarray(data["table"], np.float32)
        mag = np.asarray(data["magnitude"], np.float32)
        res = int(data["res"])
        planes = np.concatenate([tab, mag[..., None]], -1).reshape(res * res, 5)
        _PLANES[dev] = (torch.from_numpy(planes).to(dev), res)
    return _PLANES[dev]


def _fetch_params(roughness: Tensor, cos_t: Tensor):
    """Bilinear (m00, m11, m02, m20, magnitude) at (roughness, |cos|)."""
    planes, res = _tables(roughness.device)
    r = torch.clamp(roughness, 0.0, 1.0) * res - 0.5
    c = torch.clamp(torch.abs(cos_t), 0.0, 1.0) * res - 0.5
    r0 = torch.clamp(torch.floor(r), 0, res - 1).to(torch.int64)
    c0 = torch.clamp(torch.floor(c), 0, res - 1).to(torch.int64)
    r1 = torch.clamp_max(r0 + 1, res - 1)
    c1 = torch.clamp_max(c0 + 1, res - 1)
    fr = torch.clamp(r - r0, 0.0, 1.0)
    fc = torch.clamp(c - c0, 0.0, 1.0)
    # a tap clamped onto its neighbour adds its weight there (one-hot rows)
    one_r, one_c = r1 == r0, c1 == c0
    wr0 = (1.0 - fr) + torch.where(one_r, fr, 0.0)
    wr1 = torch.where(one_r, 0.0, fr)
    wc0 = (1.0 - fc) + torch.where(one_c, fc, 0.0)
    wc1 = torch.where(one_c, 0.0, fc)
    tap = lambda ri, ci: planes.index_select(0, ri * res + ci)  # (N, 5)
    row0 = tap(r0, c0) * wr0[:, None] + tap(r1, c0) * wr1[:, None]
    row1 = tap(r0, c1) * wr0[:, None] + tap(r1, c1) * wr1[:, None]
    out = row0 * wc0[:, None] + row1 * wc1[:, None]
    return out.unbind(1)  # m00, m11, m02, m20, magnitude


def _minv_apply(m00, m11, m02, m20, w: Vec3):
    """M^-1 w for M = [[m00,0,m02],[0,m11,0],[m20,0,1]] (closed form), and
    |det M^-1|."""
    det = m00 - m02 * m20  # det of the (x, z) 2x2 block
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, 1e-12)
    m11_c = torch.clamp_min(m11, 1e-12)
    x = (w.x - m02 * w.z) * inv_det
    y = w.y / m11_c
    z = (-m20 * w.x + m00 * w.z) * inv_det
    return Vec3(x, y, z), torch.abs(inv_det) / m11_c


def ltc_density(roughness: Tensor, wi: Vec3, wo: Vec3) -> Tensor:
    """The normalised LTC density (== the solid-angle pdf) of wo about wi."""
    m00, m11, m02, m20, _ = _fetch_params(roughness, wi.z)
    lo, det_inv = _minv_apply(m00, m11, m02, m20, wo)
    ln2 = lo.x * lo.x + lo.y * lo.y + lo.z * lo.z
    ln = torch.sqrt(torch.clamp_min(ln2, 1e-24))
    cosl = torch.clamp_min(lo.z / ln, 0.0)
    return (cosl / math.pi) * det_inv / torch.clamp_min(ln2 * ln, 1e-24)


def ltc_eval(roughness: Tensor, wi: Vec3, wo: Vec3):
    """(f, pdf): the LTC proxy of GGX-Smith reflection and its pdf;
    f = D * magnitude / cos_o (LTCBsdf::f)."""
    mag = _fetch_params(roughness, wi.z)[4]
    d = ltc_density(roughness, wi, wo)
    same = (wi.z * wo.z) > 0.0
    cos_o = torch.clamp_min(torch.abs(wo.z), 1e-8)
    f = torch.where(same, d * mag / cos_o, 0.0)
    return f, torch.where(same, d, 0.0)


def ltc_sample(roughness: Tensor, wi: Vec3, u0: Tensor, u1: Tensor):
    """wo ~ D: a cosine sample of the canonical lobe transformed by M, on
    wi's side. Returns (wo, pdf)."""
    m00, m11, m02, m20, _ = _fetch_params(roughness, wi.z)
    r = torch.sqrt(torch.clamp_min(u0, 0.0))
    phi = 2.0 * math.pi * u1
    lx = r * torch.cos(phi)
    ly = r * torch.sin(phi)
    lz = torch.sqrt(torch.clamp_min(1.0 - u0, 0.0))
    wx = m00 * lx + m02 * lz
    wy = m11 * ly
    wz = m20 * lx + lz
    n = torch.sqrt(torch.clamp_min(wx * wx + wy * wy + wz * wz, 1e-24))
    side = torch.where(wi.z >= 0.0, 1.0, -1.0)
    wo = Vec3(wx / n, wy / n, side * wz / n)
    return wo, ltc_density(roughness, wi, wo)
