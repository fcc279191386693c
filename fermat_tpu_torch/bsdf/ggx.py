"""GGX-Smith microfacet model: NDF, Smith masking, VNDF sampling, reflection
and transmission eval/pdf, and the F=1 directional-albedo table
(fermat_tpu/bsdf/ggx.py).

All directions are in the local shading frame (+z = shading normal).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3, dot, normalize

Tensor = torch.Tensor

PI = 3.141592653589793
_MIN_ALPHA = 1e-4


def _alpha(roughness):
    return torch.clamp_min(roughness * roughness, _MIN_ALPHA)


def ndf_d(alpha, nh) -> Tensor:
    """GGX NDF D(h)."""
    nh = torch.clamp_min(nh, 0.0)
    a2 = alpha * alpha
    d = nh * nh * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(PI * d * d, 1e-20)


def _lambda(alpha, cos_t) -> Tensor:
    """Smith Lambda for GGX."""
    c = torch.clamp(torch.abs(cos_t), 1e-6, 1.0)
    s2 = torch.clamp_min(1.0 - c * c, 0.0)
    a2 = alpha * alpha
    return 0.5 * (torch.sqrt(1.0 + a2 * s2 / (c * c)) - 1.0)


def smith_g1(alpha, cos_t) -> Tensor:
    return 1.0 / (1.0 + _lambda(alpha, cos_t))


def smith_g2(alpha, cos_i, cos_o) -> Tensor:
    """Height-correlated Smith masking-shadowing."""
    return 1.0 / (1.0 + _lambda(alpha, cos_i) + _lambda(alpha, cos_o))


def _flip(v: Vec3, s) -> Vec3:
    return Vec3(v.x * s, v.y * s, v.z * s)


def sample_vndf(alpha, wi: Vec3, u0, u1) -> Vec3:
    """Sample the GGX visible NDF (Heitz 2018); wi in the upper hemisphere."""
    v = normalize(Vec3(alpha * wi.x, alpha * wi.y, wi.z))
    lensq = v.x * v.x + v.y * v.y
    inv = torch.rsqrt(torch.clamp_min(lensq, 1e-20))
    big = lensq > 1e-12
    t1 = Vec3(torch.where(big, -v.y * inv, 1.0), torch.where(big, v.x * inv, 0.0),
              torch.zeros_like(v.z))
    t2 = Vec3(
        v.y * t1.z - v.z * t1.y,
        v.z * t1.x - v.x * t1.z,
        v.x * t1.y - v.y * t1.x,
    )
    r = torch.sqrt(u0)
    phi = 2.0 * PI * u1
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = t1 * p1 + t2 * p2 + v * p3
    return normalize(Vec3(alpha * nh.x, alpha * nh.y, torch.clamp_min(nh.z, 1e-6)))


def vndf_pdf(alpha, wi: Vec3, h: Vec3) -> Tensor:
    """pdf of sample_vndf in the half-vector measure."""
    ci = torch.abs(wi.z)
    g1 = smith_g1(alpha, wi.z)
    d = ndf_d(alpha, torch.abs(h.z))
    return g1 * torch.clamp_min(dot(wi, h), 0.0) * d / torch.clamp_min(ci, 1e-8)


def reflect_eval(alpha, wi: Vec3, wo: Vec3) -> Tensor:
    """Scalar GGX-Smith reflection BRDF (Fresnel applied by the caller)."""
    ci = wi.z
    co = wo.z
    same = (ci * co) > 0.0
    h = normalize(wi + wo)
    h = _flip(h, torch.where(h.z < 0, -1.0, 1.0))
    d = ndf_d(alpha, h.z)
    g = smith_g2(alpha, ci, co)
    f = d * g / torch.clamp_min(4.0 * torch.abs(ci) * torch.abs(co), 1e-12)
    return torch.where(same, f, 0.0)


def reflect_pdf(alpha, wi: Vec3, wo: Vec3) -> Tensor:
    """Solid-angle pdf of VNDF reflection sampling."""
    same = (wi.z * wo.z) > 0.0
    flip = torch.where(wi.z < 0, -1.0, 1.0)
    wiu = _flip(wi, flip)
    wou = _flip(wo, flip)
    h = normalize(wiu + wou)
    ph = vndf_pdf(alpha, wiu, h)
    p = ph / torch.clamp_min(4.0 * torch.abs(dot(wiu, h)), 1e-12)
    return torch.where(same, p, 0.0)


def reflect_sample(alpha, wi: Vec3, u0, u1) -> Tuple[Vec3, Tensor]:
    """Sample wo by VNDF; returns (wo, pdf). Handles wi in either hemisphere."""
    flip = torch.where(wi.z < 0, -1.0, 1.0)
    wiu = _flip(wi, flip)
    h = sample_vndf(alpha, wiu, u0, u1)
    wou = h * (2.0 * dot(wiu, h)) - wiu
    pdf = vndf_pdf(alpha, wiu, h) / torch.clamp_min(4.0 * torch.abs(dot(wiu, h)), 1e-12)
    wo = _flip(wou, flip)
    return wo, torch.where(wou.z > 1e-6, pdf, 0.0)


def refract_eval(alpha, ior, wi: Vec3, wo: Vec3) -> Tensor:
    """Scalar GGX-Smith BTDF (Fresnel transmittance applied by the caller);
    ior = eta_t/eta_i on the wi.z > 0 side."""
    ci = wi.z
    co = wo.z
    opposite = (ci * co) < 0.0
    eta = torch.where(ci > 0, ior, 1.0 / ior)
    h = normalize(Vec3(wi.x + wo.x * eta, wi.y + wo.y * eta, wi.z + wo.z * eta))
    h = _flip(h, torch.where(h.z < 0, -1.0, 1.0))
    ih = dot(wi, h)
    oh = dot(wo, h)
    d = ndf_d(alpha, h.z)
    g = smith_g2(alpha, ci, co)
    denom = ih + eta * oh
    jac = eta * eta * torch.abs(oh) / torch.clamp_min(denom * denom, 1e-12)
    f = (torch.abs(ih) * jac * d * g
         / torch.clamp_min(torch.abs(ci) * torch.abs(co), 1e-12))
    return torch.where(opposite, f, 0.0)


def refract_pdf(alpha, ior, wi: Vec3, wo: Vec3) -> Tensor:
    ci = wi.z
    co = wo.z
    opposite = (ci * co) < 0.0
    eta = torch.where(ci > 0, ior, 1.0 / ior)
    h = normalize(Vec3(wi.x + wo.x * eta, wi.y + wo.y * eta, wi.z + wo.z * eta))
    h = _flip(h, torch.where(h.z < 0, -1.0, 1.0))
    flip = torch.where(ci < 0, -1.0, 1.0)
    wiu = _flip(wi, flip)
    hu = _flip(h, flip)
    hu = _flip(hu, torch.where(hu.z < 0, -1.0, 1.0))
    ph = vndf_pdf(alpha, wiu, hu)
    oh = dot(wo, h)
    ih = dot(wi, h)
    denom = ih + eta * oh
    jac = eta * eta * torch.abs(oh) / torch.clamp_min(denom * denom, 1e-12)
    return torch.where(opposite, ph * jac, 0.0)


def refract_sample(alpha, ior, wi: Vec3, u0, u1) -> Tuple[Vec3, Tensor]:
    """Refraction through a sampled VNDF half vector; pdf 0 on total
    internal reflection."""
    flip = torch.where(wi.z < 0, -1.0, 1.0)
    wiu = _flip(wi, flip)
    h = sample_vndf(alpha, wiu, u0, u1)
    eta_rel = torch.where(wi.z > 0, 1.0 / ior, ior)  # eta_i / eta_t
    ih = dot(wiu, h)
    sin2_t = eta_rel * eta_rel * torch.clamp_min(1.0 - ih * ih, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wou = normalize((h * ih - wiu) * eta_rel - h * cos_t)
    wo = _flip(wou, flip)
    p = refract_pdf(alpha, ior, wi, wo)
    return wo, torch.where(tir, 0.0, p)


# ---------------------------------------------------------------------------
# Directional albedo table (glossy_reflectance analog), integrated once in
# numpy exactly as ggx.py:229-273, so the table is bit-equal to JAX's.
# ---------------------------------------------------------------------------

_ALBEDO_RES = 32


def _build_albedo_table(res: int = _ALBEDO_RES) -> np.ndarray:
    """E[roughness, cos_theta] = directional-hemispherical reflectance of
    GGX-Smith with F=1, by Gauss-Legendre quadrature."""
    from numpy.polynomial.legendre import leggauss

    nq = 32
    xs, ws = leggauss(nq)  # over [-1, 1]
    mu = 0.5 * (xs + 1.0)  # cos_theta_o in (0,1)
    wmu = 0.5 * ws
    phi = (np.arange(nq) + 0.5) / nq * 2.0 * np.pi
    wphi = 2.0 * np.pi / nq

    table = np.zeros((res, res), np.float64)
    r_grid = (np.arange(res) + 0.5) / res
    c_grid = (np.arange(res) + 0.5) / res
    for ri, rough in enumerate(r_grid):
        a = max(rough * rough, _MIN_ALPHA)
        for ci_, cv in enumerate(c_grid):
            si = np.sqrt(max(1.0 - cv * cv, 0.0))
            wi = np.array([si, 0.0, cv])
            co = mu[:, None]
            so = np.sqrt(np.maximum(1.0 - co**2, 0.0))
            lx = so * np.cos(phi)[None, :]
            ly = so * np.sin(phi)[None, :]
            lz = np.broadcast_to(co, lx.shape)
            hx = lx + wi[0]
            hy = ly + wi[1]
            hz = lz + wi[2]
            hl = np.sqrt(hx**2 + hy**2 + hz**2)
            hz_n = hz / np.maximum(hl, 1e-12)
            a2 = a * a
            dd = hz_n**2 * (a2 - 1.0) + 1.0
            D = a2 / np.maximum(np.pi * dd**2, 1e-20)

            def lam(c):
                c = np.clip(np.abs(c), 1e-6, 1.0)
                s2 = np.maximum(1.0 - c * c, 0.0)
                return 0.5 * (np.sqrt(1.0 + a2 * s2 / (c * c)) - 1.0)

            G = 1.0 / (1.0 + lam(cv) + lam(lz))
            f = D * G / np.maximum(4.0 * cv * lz, 1e-12)
            integrand = f * lz
            table[ri, ci_] = np.sum(integrand * wmu[:, None] * wphi)
    return np.clip(table, 0.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def albedo_table(device: torch.device) -> Tensor:
    """The (32, 32) F=1 albedo table on `device`, built once per process."""
    return torch.from_numpy(_build_albedo_table()).to(device)


def glossy_reflectance(roughness: Tensor, cos_theta: Tensor) -> Tensor:
    """Bilinear lookup of the F=1 GGX directional albedo (Kelemen coupling).

    The JAX version turns the lookup into a one-hot (N, 32) @ (32, 32)
    matmul because 2-D gathers are slow on the TPU (ggx.py:279-317). Here it
    is a direct 4-tap gather with the same weights (no matmul, so no TF32);
    when the row index is clipped (r0 == r1) the one-hot weight (1-fr)+fr is
    kept as one factor, as the matmul form sums it.
    """
    res = _ALBEDO_RES
    t = albedo_table(roughness.device).reshape(-1)
    r = torch.clamp(roughness, 0.0, 1.0) * res - 0.5
    c = torch.clamp(torch.abs(cos_theta), 0.0, 1.0) * res - 0.5
    # the second clamp keeps a NaN input (int conversion is undefined) in
    # range; its weights stay NaN, as the one-hot form gives
    r0 = torch.clamp(torch.floor(r), 0, res - 1).to(torch.int64).clamp(0, res - 1)
    c0 = torch.clamp(torch.floor(c), 0, res - 1).to(torch.int64).clamp(0, res - 1)
    r1 = torch.clamp_max(r0 + 1, res - 1)
    c1 = torch.clamp_max(c0 + 1, res - 1)
    fr = torch.clamp(r - r0, 0.0, 1.0)
    fc = torch.clamp(c - c0, 0.0, 1.0)
    same_r = r0 == r1
    wr0 = torch.where(same_r, (1.0 - fr) + fr, 1.0 - fr)
    wr1 = torch.where(same_r, 0.0, fr)
    same_c = c0 == c1
    wc0 = torch.where(same_c, (1.0 - fc) + fc, 1.0 - fc)
    wc1 = torch.where(same_c, 0.0, fc)
    row = lambda cc: wr0 * t[r0 * res + cc] + wr1 * t[r1 * res + cc]
    return row(c0) * wc0 + row(c1) * wc1
