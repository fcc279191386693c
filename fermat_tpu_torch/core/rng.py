"""Counter-based RNG and the samplers (fermat_tpu/core/rng.py:33-301),
bit-identical to the JAX version: the Owen-scrambled Sobol sequence
(TiledSequence, sampler="owen"), the blue-noise-dithered one
(BlueNoiseSequence, sampler="bluenoise") and the counter-hash WhiteSequence.

PyTorch has no usable uint32 add, multiply or shift on every device, so a
uint32 value lives in an int64 tensor (or a Python int) in [0, 2^32) and
every `+`, `*` and `<<` is masked with `& 0xFFFFFFFF`. Right shifts of
masked, non-negative values are then logical shifts. Multiplication by a
32-bit constant is split into two 16-bit halves (`_mul32`) so that no
intermediate leaves int64's range.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from fermat_tpu_torch.ops.gather import gather_rows

Tensor = torch.Tensor
U32 = Union[Tensor, int]

M32 = 0xFFFFFFFF
_INV_2_32 = 2.3283064365386963e-10  # 2^-32


def _mul32(a: U32, c: int) -> U32:
    """(a * c) mod 2^32 for a uint32 value `a` and a uint32 constant `c`."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def hash_u32(x: U32) -> U32:
    """lowbias32 hash (Wellons)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(a: U32, b: U32) -> U32:
    """Boost-style golden-ratio mix of two hashes."""
    a = a & M32
    b = b & M32
    return hash_u32(a ^ ((b + 0x9E3779B9 + ((a << 6) & M32) + (a >> 2)) & M32))


def pcg_2d(a: U32, b: U32) -> Tuple[U32, U32]:
    """pcg2d (Jarzynski & Olano 2020): two decorrelated words from two
    correlated ones (rng.py:51-66)."""
    v0 = (_mul32(a & M32, 1664525) + 1013904223) & M32
    v1 = (_mul32(b & M32, 1664525) + 1013904223) & M32
    v0 = (v0 + _mul32(v1, 1664525)) & M32
    v1 = (v1 + _mul32(v0, 1664525)) & M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v0 = (v0 + _mul32(v1, 1664525)) & M32
    v1 = (v1 + _mul32(v0, 1664525)) & M32
    return v0 ^ (v0 >> 16), v1 ^ (v1 >> 16)


def uniform_from_bits(bits: Tensor) -> Tensor:
    """uint32 -> float32 in strict [0, 1).

    The two 16-bit halves and the clamp follow rng.py:80-83: hi*2^16 + lo
    rounds once, exactly like a direct conversion, and bits >= 0xFFFFFF80
    (which round to 1.0) are clamped to the largest float32 below 1.
    """
    hi = (bits >> 16).to(torch.float32)
    lo = (bits & 0xFFFF).to(torch.float32)
    u = (hi * 65536.0 + lo) * _INV_2_32
    return torch.clamp_max(u, 0.99999994)


def uniform(key: U32, counter: U32) -> Tensor:
    """One uniform float from (key, counter) (rng.py:86-88)."""
    return uniform_from_bits(hash_combine(key, counter))


def reverse_bits32(x: U32) -> U32:
    x = x & M32
    x = ((x & 0x55555555) << 1) | ((x & 0xAAAAAAAA) >> 1)
    x = ((x & 0x33333333) << 2) | ((x & 0xCCCCCCCC) >> 2)
    x = ((x & 0x0F0F0F0F) << 4) | ((x & 0xF0F0F0F0) >> 4)
    x = ((x & 0x00FF00FF) << 8) | ((x & 0xFF00FF00) >> 8)
    return ((x << 16) & M32) | (x >> 16)


def _laine_karras(x: U32, seed: U32) -> U32:
    """Laine-Karras hash permutation (an Owen scramble in reversed-bit space)."""
    x = (x + seed) & M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(x: U32, seed: U32) -> U32:
    """Nested uniform (Owen) scramble of a [0,1)-as-u32 sample (Burley 2020)."""
    return reverse_bits32(_laine_karras(reverse_bits32(x), seed))


def sobol02_u32(index: U32) -> Tuple[U32, U32]:
    """Integer Sobol (0,2) pair at `index` (unscrambled), as u32 fractions,
    of an int64 tensor or a Python int.

    Dim 1 is the 32-step XOR ladder of rng.py:132-137; every value stays in
    [0, 2^32), so the ladder wraps exactly like uint32.
    """
    i = index & M32
    d0 = reverse_bits32(i)
    d1 = 0
    v = 1 << 31
    for _ in range(32):
        d1 = d1 ^ ((i & 1) * v)
        i = i >> 1
        v = v ^ (v >> 1)
    return d0, d1


class TiledSequence(NamedTuple):
    """Per-pixel decorrelated QMC sampler (rng.py:141-187).

    `seed` changes per render restart; `instance` is the progressive pass.
    Pixels are int64 tensors holding uint32 ids; dims are Python ints or
    int64 tensors.
    """

    seed: int
    instance: int

    @staticmethod
    def create(seed: int = 0, instance: int = 0) -> "TiledSequence":
        return TiledSequence(int(seed) & M32, int(instance) & M32)

    def set_instance(self, instance: int) -> "TiledSequence":
        return self._replace(instance=int(instance) & M32)

    def sample_2d(self, pixel: Tensor, dim: U32) -> Tuple[Tensor, Tensor]:
        """Two decorrelated QMC uniforms for each pixel at dimension `dim`."""
        pix = pixel & M32
        d = dim & M32
        idx_seed = hash_combine(self.seed, hash_combine(pix, d >> 1))
        index = owen_scramble(self.instance, idx_seed)
        s0, s1 = sobol02_u32(index)
        k0 = hash_combine(idx_seed, 0x68BC21EB)
        k1 = hash_combine(idx_seed, 0x02E5BE93)
        u0 = uniform_from_bits(owen_scramble(s0, k0))
        u1 = uniform_from_bits(owen_scramble(s1, k1))
        return u0, u1

    def sample_1d(self, pixel: Tensor, dim: U32) -> Tensor:
        return self.sample_2d(pixel, dim)[0]

    def sample_3d(self, pixel: Tensor, dim: U32):
        u0, u1 = self.sample_2d(pixel, dim)
        k = hash_combine(self.seed, hash_combine(pixel & M32, ((dim & M32) + 2) & M32))
        u2 = uniform_from_bits(hash_combine(k, self.instance))
        return u0, u1, u2


# the 64x64x2 blue-noise shift table of rng.py:189-205: the port's own
# byte-for-byte copy of the JAX package's data/bluenoise64.npz, in the
# port's data directory; one float32 copy per device
_BLUENOISE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "data", "bluenoise64.npz")
_BLUENOISE_TABLES = {}


def bluenoise_table(device) -> Tensor:
    """(4096, 2) float32 shift table, flat 64 x 64 x 2."""
    dev = torch.device(device)
    if dev not in _BLUENOISE_TABLES:
        shift = np.load(_BLUENOISE)["shift"].astype(np.float32).reshape(64 * 64, 2)
        _BLUENOISE_TABLES[dev] = torch.from_numpy(shift).to(dev)
    return _BLUENOISE_TABLES[dev]


def _wrap(u: Tensor) -> Tensor:
    return torch.clamp_max(torch.where(u >= 1.0, u - 1.0, u), 0.99999994)


class BlueNoiseSequence(NamedTuple):
    """Blue-noise-dithered QMC sampler (rng.py:208-275): every pixel takes
    the same Owen-scrambled Sobol point per (instance, dimension pair),
    Cranley-Patterson shifted by its texel of a tiled 64x64 blue-noise
    table, offset per dimension pair by a hash. The table fetch is the row
    gather (K2 on the card), as JAX's is. Dimensions are Python ints."""

    seed: int
    instance: int
    res_x: int  # pixel id -> (x, y)

    @staticmethod
    def create(seed: int = 0, instance: int = 0, res_x: int = 1) -> "BlueNoiseSequence":
        return BlueNoiseSequence(int(seed) & M32, int(instance) & M32, int(res_x))

    def set_instance(self, instance: int) -> "BlueNoiseSequence":
        return self._replace(instance=int(instance) & M32)

    def _shift(self, pixel: Tensor, dim: U32):
        pix = pixel & M32
        rx = max(self.res_x, 1)
        h = hash_combine(self.seed ^ 0xB1E0, (dim & M32) >> 1)
        tx = (pix % rx + (h & 63)) & 63
        ty = (pix // rx + ((h >> 6) & 63)) & 63
        s = gather_rows(bluenoise_table(pix.device), (ty * 64 + tx).to(torch.int32))
        return s[:, 0], s[:, 1]

    def sample_2d(self, pixel: Tensor, dim: U32) -> Tuple[Tensor, Tensor]:
        # the shared point depends on the dimension pair alone, so it is
        # computed once, on the host, by the functions above: the integer
        # steps on Python ints, the float conversion on 0-d CPU tensors
        idx_seed = hash_combine(self.seed, (dim & M32) >> 1)
        s0, s1 = sobol02_u32(owen_scramble(self.instance, idx_seed))
        b0 = uniform_from_bits(torch.tensor(owen_scramble(s0, hash_combine(idx_seed, 0x68BC21EB))))
        b1 = uniform_from_bits(torch.tensor(owen_scramble(s1, hash_combine(idx_seed, 0x02E5BE93))))
        sx, sy = self._shift(pixel, dim)
        return _wrap(b0 + sx), _wrap(b1 + sy)

    def sample_1d(self, pixel: Tensor, dim: U32) -> Tensor:
        return self.sample_2d(pixel, dim)[0]

    def sample_3d(self, pixel: Tensor, dim: U32):
        u0, u1 = self.sample_2d(pixel, dim)
        k = hash_combine(self.seed, hash_combine(pixel & M32, ((dim & M32) + 2) & M32))
        return u0, u1, uniform_from_bits(hash_combine(k, self.instance))


class WhiteSequence(NamedTuple):
    """Pure counter-hash sampler (rng.py:277-301, the LFSRRandomStream analog)."""

    seed: int
    instance: int

    @staticmethod
    def create(seed: int = 0, instance: int = 0) -> "WhiteSequence":
        return WhiteSequence(int(seed) & M32, int(instance) & M32)

    def set_instance(self, instance: int) -> "WhiteSequence":
        return self._replace(instance=int(instance) & M32)

    def sample_2d(self, pixel: Tensor, dim: U32) -> Tuple[Tensor, Tensor]:
        k = hash_combine(self.seed, hash_combine(pixel & M32, dim & M32))
        a, b = pcg_2d(k, self.instance)
        return uniform_from_bits(a), uniform_from_bits(b)

    def sample_1d(self, pixel: Tensor, dim: U32) -> Tensor:
        return self.sample_2d(pixel, dim)[0]

    def sample_3d(self, pixel: Tensor, dim: U32):
        u0, u1 = self.sample_2d(pixel, dim)
        return u0, u1, self.sample_1d(pixel, ((dim & M32) + 2) & M32)
