"""Vertex-attribute compression (fermat_tpu/scene/compression.py;
MeshCompression.h analog). Host numpy code, the port's own copy: the packed
words are JAX's bit for bit.

Reference encodings (src/mesh/MeshCompression.h):
  * tex coords: bias/scale-normalized then packed into one uint32 as two
    16-bit fixed-point values (compress_tex_coord, the
    TEX_COORD_COMPRESSION_FIXED mode; dn = 1/2^15).
  * normals: unit vectors packed into one uint32; here via the octahedral
    map (core of `cugar/spherical/mappings.h`) at 16 bits per component —
    the standard survey-best encoding (mean error ~0.004 deg at 16+16).

All codecs are numpy (host, build-time); MeshStorage.compress_normals()
and compress_tex() swap the float arrays for packed ones
(MeshStorage.h:146-147, applied by renderer.cu:735-736 at load), and its
`_resolved_*` accessors decode them for every consumer.
"""
from __future__ import annotations

import numpy as np

_DN = 1.0 / (1 << 15)  # MeshCompression.h fixed-point step


# ---------------------------------------------------------------------------
# octahedral normal codec
# ---------------------------------------------------------------------------

def _oct_encode(n: np.ndarray) -> np.ndarray:
    """(N, 3) unit vectors -> (N, 2) in [-1, 1]^2 (octahedral)."""
    n = n / np.maximum(np.abs(n).sum(1, keepdims=True), 1e-20)
    xy = n[:, :2].copy()
    neg = n[:, 2] < 0.0
    flip = (1.0 - np.abs(xy[:, ::-1])) * np.where(xy >= 0.0, 1.0, -1.0)
    xy[neg] = flip[neg]
    return xy


def _oct_decode(xy: np.ndarray) -> np.ndarray:
    """(N, 2) -> (N, 3) unit vectors."""
    z = 1.0 - np.abs(xy).sum(1)
    n = np.concatenate([xy, z[:, None]], 1)
    neg = z < 0.0
    flip = (1.0 - np.abs(n[:, 1::-1])) * np.where(n[:, :2] >= 0.0, 1.0, -1.0)
    n[neg, :2] = flip[neg]
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)


def compress_normals(n: np.ndarray) -> np.ndarray:
    """(N, 3) f32 unit normals -> (N,) uint32 (16+16 octahedral)."""
    xy = _oct_encode(np.asarray(n, np.float64))
    q = np.clip(np.round((xy * 0.5 + 0.5) * 65535.0), 0, 65535).astype(np.uint32)
    return q[:, 0] | (q[:, 1] << 16)


def decompress_normals(packed: np.ndarray) -> np.ndarray:
    """(N,) uint32 -> (N, 3) f32 unit normals."""
    p = np.asarray(packed, np.uint32)
    x = (p & 0xFFFF).astype(np.float64) / 65535.0 * 2.0 - 1.0
    y = (p >> 16).astype(np.float64) / 65535.0 * 2.0 - 1.0
    return _oct_decode(np.stack([x, y], 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# fixed-point uv codec (compress_tex_coord / decompress_tex_coord)
# ---------------------------------------------------------------------------

def uv_bias_scale(uv: np.ndarray):
    """Per-mesh (bias, scale) covering the uv range (MeshView tex_bias/
    tex_scale)."""
    if uv.shape[0] == 0:
        return np.zeros(2, np.float32), np.ones(2, np.float32)
    lo = uv.min(0)
    hi = uv.max(0)
    scale = np.maximum(hi - lo, 1e-8)
    return lo.astype(np.float32), scale.astype(np.float32)


def compress_uv(uv: np.ndarray, bias: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(N, 2) f32 -> (N,) uint32, 15-bit fixed point per component."""
    tn = (np.asarray(uv, np.float64) - bias) / scale
    q = np.clip(np.round(tn * (1 << 15)), 0, (1 << 16) - 1).astype(np.uint32)
    return q[:, 0] | (q[:, 1] << 16)


def decompress_uv(packed: np.ndarray, bias: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """(N,) uint32 -> (N, 2) f32."""
    p = np.asarray(packed, np.uint32)
    tn = np.stack([(p & 0xFFFF).astype(np.float64) * _DN,
                   (p >> 16).astype(np.float64) * _DN], 1)
    return (tn * scale + bias).astype(np.float32)
