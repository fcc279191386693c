"""Vector math on structure-of-arrays Vec3 (fermat_tpu/core/math.py).

A Vec3 is three same-shaped tensors, one per component, so every per-ray
operation is a flat elementwise op over the wavefront. Also the octahedral
normal mapping (encode, decode and its 8+8-bit packing), reflect/refract
and the scalar helpers of math.py:108-240.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Vec3(NamedTuple):
    """SoA 3-vector: three same-shaped tensors."""

    x: Tensor
    y: Tensor
    z: Tensor

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, s) -> "Vec3":
        if isinstance(s, Vec3):
            return Vec3(self.x * s.x, self.y * s.y, self.z * s.z)
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def stack(self) -> Tensor:
        """To AoS (..., 3) — output boundary only."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    @staticmethod
    def full(n: int, v0: float, v1: float, v2: float, device) -> "Vec3":
        f = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)
        return Vec3(f(v0), f(v1), f(v2))

    @staticmethod
    def zeros(n: int, device) -> "Vec3":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return Vec3(z, z, z)


def dot(a: Vec3, b: Vec3) -> Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = torch.rsqrt(torch.clamp_min(dot(a, a), eps))
    return a * inv


def select(m: Tensor, a: Vec3, fill: float = 0.0) -> Vec3:
    """Componentwise where(m, a, fill)."""
    return Vec3(torch.where(m, a.x, fill), torch.where(m, a.y, fill),
                torch.where(m, a.z, fill))


def ray_barycentrics(o: Vec3, d: Vec3, p0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore (u, v) of the ray (o, d) on the triangle (p0, e1, e2):
    1/det wherever det != 0 (no 1e-12 gate), (0, 0) where det == 0."""
    pv = cross(d, e2)
    det = dot(e1, pv)
    inv_det = torch.where(det != 0.0, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tv = o - p0
    return dot(tv, pv) * inv_det, dot(d, cross(tv, e1)) * inv_det


def orthonormal_basis(n: Vec3):
    """(t, b) orthonormal to n — branchless Frisvad/Duff construction."""
    s = torch.where(n.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n.z)
    b = n.x * n.y * a
    t = Vec3(1.0 + s * n.x * n.x * a, s * b, -s * n.x)
    bt = Vec3(b, s + n.y * n.y * a, -n.y)
    return t, bt


def to_local(v: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return Vec3(dot(v, t), dot(v, b), dot(v, n))


def to_world(v: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    return Vec3(
        v.x * t.x + v.y * b.x + v.z * n.x,
        v.x * t.y + v.y * b.y + v.z * n.y,
        v.x * t.z + v.y * b.z + v.z * n.z,
    )


def oct_encode(n: Vec3):
    """Unit vector -> octahedral (u, v) in [-1, 1]^2 (math.py:176-184)."""
    inv_l1 = 1.0 / (torch.abs(n.x) + torch.abs(n.y) + torch.abs(n.z) + 1e-20)
    u = n.x * inv_l1
    v = n.y * inv_l1
    # fold the lower hemisphere
    uf = (1.0 - torch.abs(v)) * torch.sign(torch.where(u == 0.0, 1.0, u))
    vf = (1.0 - torch.abs(u)) * torch.sign(torch.where(v == 0.0, 1.0, v))
    return torch.where(n.z < 0.0, uf, u), torch.where(n.z < 0.0, vf, v)


def oct_decode(u: Tensor, v: Tensor) -> Vec3:
    """Octahedral (u, v) -> unit vector (math.py:187-193)."""
    z = 1.0 - torch.abs(u) - torch.abs(v)
    uf = (1.0 - torch.abs(v)) * torch.sign(torch.where(u == 0.0, 1.0, u))
    vf = (1.0 - torch.abs(u)) * torch.sign(torch.where(v == 0.0, 1.0, v))
    return normalize(Vec3(torch.where(z < 0.0, uf, u), torch.where(z < 0.0, vf, v), z))


def oct_pack16(n: Vec3) -> Tensor:
    """A unit normal packed into 16 bits, 8 + 8 (math.py:196-201); int64."""
    u, v = oct_encode(n)
    q = lambda a: torch.clamp(torch.round((a * 0.5 + 0.5) * 255.0), 0, 255).to(torch.int64)
    return q(u) | (q(v) << 8)


def oct_unpack16(p: Tensor) -> Vec3:
    p = p.to(torch.int64)
    u = ((p & 0xFF).to(torch.float32) / 255.0) * 2.0 - 1.0
    v = (((p >> 8) & 0xFF).to(torch.float32) / 255.0) * 2.0 - 1.0
    return oct_decode(u, v)


def vec3(x, y=None, z=None, device="cpu") -> Vec3:
    """A Vec3 of float32 tensors; one value fills all three."""
    if y is None:
        y = z = x
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return Vec3(t(x), t(y), t(z))


def norm(a: Vec3) -> Tensor:
    return torch.sqrt(dot(a, a))


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def where(m: Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y), torch.where(m, a.z, b.z))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Mirror direction; i points away from the surface (math.py:133-138)."""
    return n * (2.0 * dot(i, n)) - i


def refract(i: Vec3, n: Vec3, eta):
    """Refract w_i about n with relative IoR eta = n_i/n_t (math.py:141-153):
    (direction, total internal reflection mask)."""
    cos_i = dot(i, n)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    return normalize((n * cos_i - i) * eta - n * cos_t), sin2_t >= 1.0


def sqr(x):
    return x * x


def luminance(r, g, b):
    """Rec.709 luminance (math.py:232-234)."""
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def safe_rcp(x: Tensor, eps: float = 1e-12) -> Tensor:
    big = torch.abs(x) > eps
    return torch.where(big, 1.0 / torch.where(big, x, 1.0), 0.0)
