"""Real spherical harmonics (fermat_tpu/core/sh.py; cugar/spherical/sh.h analog).

Provides the hard-coded real SH basis up to l = 3 (the reference's
templated `sh<l,m>` specializations), zonal-harmonics rotation
(`rotate_ZH`, sh.h:72-96) and MC projection/reconstruction helpers.

Basis evaluation is a flat (N, (L+1)^2) polynomial table on the input's
device — no per-(l,m) dispatch.
"""
from __future__ import annotations

import math

import torch

from fermat_tpu_torch.core.math import Vec3

Tensor = torch.Tensor


def n_coeffs(L: int) -> int:
    """Number of coefficients for max band L (inclusive)."""
    return (L + 1) * (L + 1)


def sh_basis(L: int, v: Vec3) -> Tensor:
    """(N, (L+1)^2) real SH basis at unit vectors v, bands 0..L (L <= 3).

    Index layout: i = l*(l+1) + m (the reference's flattening).
    """
    if L > 3:
        raise ValueError("sh_basis supports L <= 3 (matching cugar/sh.h)")
    x, y, z = v.x, v.y, v.z
    one = torch.ones_like(x)
    cols = [0.2820947917738781 * one]  # l=0
    if L >= 1:
        c1 = 0.4886025119029199
        cols += [c1 * y, c1 * z, c1 * x]  # m = -1, 0, 1
    if L >= 2:
        cols += [
            1.0925484305920792 * x * y,                      # (2,-2)
            1.0925484305920792 * y * z,                      # (2,-1)
            0.31539156525252005 * (3.0 * z * z - 1.0),       # (2, 0)
            1.0925484305920792 * x * z,                      # (2, 1)
            0.5462742152960396 * (x * x - y * y),            # (2, 2)
        ]
    if L >= 3:
        cols += [
            0.5900435899266435 * y * (3.0 * x * x - y * y),  # (3,-3)
            2.890611442640554 * x * y * z,                   # (3,-2)
            0.4570457994644658 * y * (5.0 * z * z - 1.0),    # (3,-1)
            0.3731763325901154 * z * (5.0 * z * z - 3.0),    # (3, 0)
            0.4570457994644658 * x * (5.0 * z * z - 1.0),    # (3, 1)
            1.445305721320277 * z * (x * x - y * y),         # (3, 2)
            0.5900435899266435 * x * (x * x - 3.0 * y * y),  # (3, 3)
        ]
    return torch.stack(cols, dim=-1)


def sh(l: int, m: int, v: Vec3) -> Tensor:
    """Single basis function (sh.h:49-70 dispatch)."""
    return sh_basis(l, v)[..., l * (l + 1) + m]


def rotate_zh(L: int, zh_coeff, d: Vec3) -> Tensor:
    """Rotate zonal-harmonics coefficients to axis d (sh.h:72-88):
    sh[l,m] = zh[l] * sqrt(4 pi / (2l+1)) * Y_lm(d).

    zh_coeff: (L+1,) array-like. Returns (N, (L+1)^2).
    """
    basis = sh_basis(L, d)
    zh = torch.as_tensor(zh_coeff, dtype=torch.float32, device=basis.device)
    scale = []
    for l in range(L + 1):
        k = math.sqrt(4.0 * math.pi / (2 * l + 1)) * zh[l]
        scale += [k] * (2 * l + 1)
    return basis * torch.stack(scale)


def project(L: int, dirs: Vec3, values: Tensor) -> Tensor:
    """MC-project function samples onto the basis: values (N,) sampled
    UNIFORMLY on the sphere -> ((L+1)^2,) coefficients."""
    basis = sh_basis(L, dirs)  # (N, C)
    return 4.0 * math.pi * torch.mean(basis * values[:, None], dim=0)


def reconstruct(coeffs: Tensor, v: Vec3) -> Tensor:
    """Evaluate the SH expansion at unit vectors v."""
    c = coeffs.shape[-1]
    L = int(math.isqrt(c)) - 1
    return torch.sum(sh_basis(L, v) * coeffs, dim=-1)
