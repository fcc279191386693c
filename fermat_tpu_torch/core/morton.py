"""Morton (Z-order) codes, 3-D and 2-D (fermat_tpu/core/morton.py:10-38).

A uint32 value lives in an int64 tensor in [0, 2^32), as in core/rng.py:
CPU torch has no uint32 multiply or shift, so every product is masked with
`& 0xFFFFFFFF` before the bit mask. With the 10- and 16-bit inputs here no
product leaves int64's range. Bit-equal to the JAX version on finite inputs; a NaN
coordinate gives an unspecified cell in both packages.
"""
from __future__ import annotations

import torch

from fermat_tpu_torch.core.rng import M32

Tensor = torch.Tensor


def expand_bits_3d(v: Tensor) -> Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v.to(torch.int64)
    v = ((v * 0x00010001) & M32) & 0xFF0000FF
    v = ((v * 0x00000101) & M32) & 0x0F00F00F
    v = ((v * 0x00000011) & M32) & 0xC30C30C3
    v = ((v * 0x00000005) & M32) & 0x49249249
    return v


def _cell(x: Tensor) -> Tensor:
    # float -> uint32 truncates toward zero, as .to(int64) does on [0, 1023]
    return torch.clamp(x * 1023.0, 0.0, 1023.0).to(torch.int64)


def morton3d(x: Tensor, y: Tensor, z: Tensor) -> Tensor:
    """30-bit 3D morton code (int64) from float coords in [0,1]^3."""
    return ((expand_bits_3d(_cell(x)) << 2) | (expand_bits_3d(_cell(y)) << 1)
            | expand_bits_3d(_cell(z)))


def expand_bits_2d(v: Tensor) -> Tensor:
    """Spread the low 16 bits of v so there is one zero bit between each."""
    v = v.to(torch.int64)
    v = (v | ((v << 8) & M32)) & 0x00FF00FF
    v = (v | ((v << 4) & M32)) & 0x0F0F0F0F
    v = (v | ((v << 2) & M32)) & 0x33333333
    v = (v | ((v << 1) & M32)) & 0x55555555
    return v


def morton2d(x: Tensor, y: Tensor) -> Tensor:
    """32-bit 2D morton code (int64) from float coords in [0,1]^2."""
    cell = lambda a: torch.clamp(a * 65535.0, 0.0, 65535.0).to(torch.int64)
    return (expand_bits_2d(cell(y)) << 1) | expand_bits_2d(cell(x))
