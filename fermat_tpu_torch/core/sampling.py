"""Sampling warps, MIS heuristics and measure conversions
(fermat_tpu/core/sampling.py)."""
from __future__ import annotations

import torch

from fermat_tpu_torch.core.math import Vec3

TWO_PI = 6.283185307179586
INV_PI = 0.3183098861837907
PI = 3.141592653589793


def square_to_cosine_hemisphere(u0, u1) -> Vec3:
    """Cosine-weighted hemisphere about +z (pdf = cos/pi)."""
    r = torch.sqrt(u0)
    phi = TWO_PI * u1
    return Vec3(r * torch.cos(phi), r * torch.sin(phi),
                torch.sqrt(torch.clamp_min(1.0 - u0, 0.0)))


def square_to_uniform_triangle(u0, u1):
    """Uniform barycentrics on a triangle (sqrt warp)."""
    su0 = torch.sqrt(u0)
    return 1.0 - su0, u1 * su0


def power_heuristic(pdf_a, pdf_b):
    """a^2/(a^2+b^2) in the overflow-safe ratio form 1/(1+r^2)."""
    r = pdf_b / torch.clamp_min(pdf_a, 1e-32)
    return torch.where(pdf_a > 0.0, 1.0 / (1.0 + r * r), 0.0)


def square_to_uniform_disk(u0, u1):
    """Concentric (Shirley) disk mapping (sampling.py:39-53)."""
    ox = 2.0 * u0 - 1.0
    oy = 2.0 * u1 - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = torch.abs(ox) > torch.abs(oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x,
        (PI / 4.0) * (oy / torch.where(ox == 0.0, 1.0, ox)),
        (PI / 2.0) - (PI / 4.0) * (ox / torch.where(oy == 0.0, 1.0, oy)),
    )
    r = torch.where(zero, 0.0, r)
    theta = torch.where(zero, 0.0, theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_hemisphere_pdf(cos_theta):
    return torch.clamp_min(cos_theta, 0.0) * INV_PI


def square_to_uniform_sphere(u0, u1) -> Vec3:
    z = 1.0 - 2.0 * u0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = TWO_PI * u1
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def balance_heuristic(pdf_a, pdf_b):
    """a/(a+b) in the overflow-safe ratio form 1/(1+r)."""
    r = pdf_b / torch.clamp_min(pdf_a, 1e-32)
    return torch.where(pdf_a > 0.0, 1.0 / (1.0 + r), 0.0)


def pdf_solid_angle_to_area(pdf_sa, dist2, cos_theta):
    """p_A = p_sa * |cos| / r^2."""
    return pdf_sa * torch.abs(cos_theta) / torch.clamp_min(dist2, 1e-20)


def pdf_area_to_solid_angle(pdf_a, dist2, cos_theta):
    return pdf_a * dist2 / torch.clamp_min(torch.abs(cos_theta), 1e-8)
