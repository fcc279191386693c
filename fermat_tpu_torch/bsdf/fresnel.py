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
