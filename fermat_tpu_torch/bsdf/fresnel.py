"""Fresnel terms (fermat_tpu/bsdf/fresnel.py)."""
from __future__ import annotations

import torch

from fermat_tpu_torch.core.math import Vec3


def schlick(cos_theta, f0: Vec3) -> Vec3:
    """Schlick approximation with Vec3 F0 (cugar::fresnel_schlick)."""
    c = torch.clamp(torch.abs(cos_theta), 0.0, 1.0)
    m = 1.0 - c
    m2 = m * m
    w = m2 * m2 * m  # (1-c)^5
    return Vec3(
        f0.x + (1.0 - f0.x) * w,
        f0.y + (1.0 - f0.y) * w,
        f0.z + (1.0 - f0.z) * w,
    )


def dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel reflectance (fresnel.py:22-35):
    cos_i the |cos| of the incident angle, eta = n_i/n_t; (F, total internal
    reflection mask)."""
    c = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = eta * eta * torch.clamp_min(1.0 - c * c, 0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    r_par = (cos_t - eta * c) / torch.clamp_min(cos_t + eta * c, 1e-12)
    r_perp = (c - eta * cos_t) / torch.clamp_min(c + eta * cos_t, 1e-12)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f), tir
