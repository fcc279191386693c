"""Texture atlas and mipmapped sampling (fermat_tpu/scene/textures.py:29-310).

Every mip level of every texture is packed into one flat (S, 4) float32
texel array with a small (n_tex, MAX_LEVELS) offset/size table, built in
numpy on the host exactly as the JAX package builds it. When every source
image is 8-bit exact (TGA), the atlas also carries an RGBA8 mirror of the
texels: `packed` (one word a texel) and `packed_q` (the four corners of the
wrap-aware bilinear quad anchored at each texel, so a level-0 bilinear
sample is one row fetch). PyTorch lacks uint32 shifts and masks on many
backends, so the mirror holds each uint32 word's bits in an int32 and
unpacks it with masked shifts.

The texel fetches are plain PyTorch row fetches (index_select), as JAX's are
XLA gathers outside any Pallas kernel; their backward is autograd's
scatter-add (index_add_, atomic on the card). Advanced indexing would give
the same values, but its backward on the card (index_put_ with accumulate,
sort-based) serialises the long runs of lanes that share a texel: the dead
lanes all read map 0's first texel.
The level-0 metadata of `sample_bilinear0` (`meta0`, built once with the
atlas) goes through the row gather (ops/gather.gather_rows, K2 on the
card), as there.

Replacing `texels` through `_replace` drops the mirror unless both of its
halves are passed too: a stale quantised mirror would win every fetch and
zero the texel gradient (textures.py:279-306).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops.gather import gather_rows

Tensor = torch.Tensor

MAX_LEVELS = 12  # up to 2048x2048
_INV255 = float(np.float32(1.0 / 255.0))


def _mip_chain(img: np.ndarray) -> List[np.ndarray]:
    """Full mip pyramid by 2x2 box filter (MipMapStorage::generate_mips),
    RGBA float32, the source padded to powers of two by nearest texels."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    if img.shape[2] == 3:
        img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
    h, w = img.shape[:2]
    hp = 1 << max(int(np.ceil(np.log2(max(h, 1)))), 0)
    wp = 1 << max(int(np.ceil(np.log2(max(w, 1)))), 0)
    if (hp, wp) != (h, w):
        yi = np.minimum(np.arange(hp) * h // hp, h - 1)
        xi = np.minimum(np.arange(wp) * w // wp, w - 1)
        img = img[yi][:, xi]
    chain = [img]
    while img.shape[0] > 1 or img.shape[1] > 1:
        # each axis on its own: a joint reshape breaks once one axis is 1
        if img.shape[0] > 1:
            h2 = img.shape[0] // 2
            img = img[: h2 * 2].reshape(h2, 2, img.shape[1], 4).mean(1)
        if img.shape[1] > 1:
            w2 = img.shape[1] // 2
            img = img[:, : w2 * 2].reshape(img.shape[0], w2, 2, 4).mean(2)
        chain.append(img.astype(np.float32))
    return chain[:MAX_LEVELS]


def _build_host(images: List[np.ndarray]) -> dict:
    """The atlas as numpy arrays, keyed by the JAX atlas's field names
    (textures.py:80-160); packed and packed_q are uint32, absent unless the
    whole chain quantises to RGBA8 losslessly."""
    if not images:
        images = [np.ones((1, 1, 4), np.float32)]
    texels = []
    offs = np.zeros((len(images), MAX_LEVELS), np.int64)
    ws = np.ones((len(images), MAX_LEVELS), np.int64)
    hs = np.ones((len(images), MAX_LEVELS), np.int64)
    nl = np.zeros(len(images), np.int64)
    cursor = 0
    for ti, img in enumerate(images):
        chain = _mip_chain(img)
        nl[ti] = len(chain)
        for li, level in enumerate(chain):
            offs[ti, li] = cursor
            hs[ti, li], ws[ti, li] = level.shape[:2]
            texels.append(level.reshape(-1, 4))
            cursor += level.shape[0] * level.shape[1]
        # clamp the tail so that out-of-range lods read the last level
        offs[ti, len(chain):] = offs[ti, len(chain) - 1]
        hs[ti, len(chain):] = hs[ti, len(chain) - 1]
        ws[ti, len(chain):] = ws[ti, len(chain) - 1]
    flat = np.concatenate(texels, 0)
    # 8-bit detection on the source levels only (mips are box-filter means);
    # when every source is 8-bit the whole chain is quantised to RGBA8
    lvl0 = np.concatenate([_mip_chain(im)[0].reshape(-1, 4) for im in images], 0)
    q0 = np.round(np.clip(lvl0, 0.0, 1.0) * 255.0)
    if np.abs(lvl0 - q0 / 255.0).max() <= (0.5 / 255.0) * 1e-3 + 1e-6:
        flat = (np.round(np.clip(flat, 0.0, 1.0) * 255.0) / 255.0).astype(np.float32)
    q = np.round(np.clip(flat, 0.0, 1.0) * 255.0)
    out = dict(texels=flat, offset=offs.astype(np.int32), width=ws.astype(np.int32),
               height=hs.astype(np.int32), n_levels=nl.astype(np.int32))
    if np.abs(flat - q / 255.0).max() <= (0.5 / 255.0) * 1e-3 + 1e-6:
        qi = q.astype(np.uint32)
        pk = (qi[:, 0] | (qi[:, 1] << 8) | (qi[:, 2] << 16) | (qi[:, 3] << 24)).astype(np.uint32)
        # the wrap-aware quad mirror, level by level
        pq = np.stack([pk, pk, pk, pk], axis=1)
        for ti in range(len(images)):
            for li in range(int(nl[ti])):
                o, wl, hl = int(offs[ti, li]), int(ws[ti, li]), int(hs[ti, li])
                lvl = pk[o:o + wl * hl].reshape(hl, wl)
                pq[o:o + wl * hl, 1] = np.roll(lvl, -1, axis=1).reshape(-1)
                pq[o:o + wl * hl, 2] = np.roll(lvl, -1, axis=0).reshape(-1)
                pq[o:o + wl * hl, 3] = np.roll(np.roll(lvl, -1, axis=0), -1, axis=1).reshape(-1)
        out.update(packed=pk, packed_q=pq)
    return out


def level0_meta(offset: Tensor, width: Tensor, height: Tensor) -> Tensor:
    """(n_tex, 4) float32 rows of sample_bilinear0, built once with the
    atlas: the level-0 offset as two halves (its low 12 bits, the rest),
    width, height. JAX's one float32 offset column is exact only up to 2^24
    texels, and a bathroom-class atlas holds more (16 textures of 1024^2
    with mips: 22.4 M)."""
    off0 = offset[:, 0]
    return torch.stack([off0 & 4095, off0 >> 12, width[:, 0], height[:, 0]],
                       dim=1).to(torch.float32)


def _unpack(p: Tensor) -> Tensor:
    """(N,) RGBA8 words (uint32 bits in int32) -> (N, 4) float32 in [0, 1]."""
    return torch.stack([((p >> s) & 0xFF).to(torch.float32) * _INV255 for s in (0, 8, 16, 24)],
                       dim=-1)


class TextureAtlas(NamedTuple):
    """Packed mip atlas on the device."""

    texels: Tensor  # (S, 4) float32
    offset: Tensor  # (n_tex, MAX_LEVELS) int32: start texel of each level
    width: Tensor  # (n_tex, MAX_LEVELS) int32
    height: Tensor  # (n_tex, MAX_LEVELS) int32
    n_levels: Tensor  # (n_tex,) int32
    packed: Optional[Tensor] = None  # (S,) int32 holding uint32 RGBA8 words
    packed_q: Optional[Tensor] = None  # (S, 4) int32: the bilinear quad of each texel
    meta0: Optional[Tensor] = None  # (n_tex, 4) float32: sample_bilinear0's level-0 rows

    @property
    def count(self) -> int:
        return self.n_levels.shape[0]

    @staticmethod
    def build(images: List[np.ndarray], device) -> "TextureAtlas":
        """Pack HxWx{1,3,4} float images (an empty list: one white 1x1)."""
        return TextureAtlas.from_arrays(_build_host(images), device)

    @staticmethod
    def from_arrays(arrays: dict, device) -> "TextureAtlas":
        """The device atlas of host arrays keyed by field name (the JAX
        atlas's leaves; packed and packed_q uint32 or absent), bit for bit."""
        t = lambda a: torch.from_numpy(np.array(a)).to(device)
        mirror = lambda k: None if arrays.get(k) is None else t(
            np.asarray(arrays[k], np.uint32).view(np.int32))
        offset, width, height, n_levels = (t(arrays[k]) for k in TextureAtlas._fields[1:5])
        return TextureAtlas(t(arrays["texels"]), offset, width, height, n_levels,
                            packed=mirror("packed"), packed_q=mirror("packed_q"),
                            meta0=level0_meta(offset, width, height))

    def _level_fetch(self, tex: Tensor, level: Tensor, u: Tensor, v: Tensor) -> Tensor:
        """Bilinear fetch at an integer mip level, wrap addressing
        (textures.py:162-197): four taps, each weighted."""
        tex, level = tex.long(), level.long()
        off = self.offset[tex, level]
        w = self.width[tex, level]
        h = self.height[tex, level]
        fu = u * w.to(torch.float32) - 0.5
        fv = v * h.to(torch.float32) - 0.5
        x0 = torch.floor(fu)
        y0 = torch.floor(fv)
        tx = (fu - x0)[:, None]
        ty = (fv - y0)[:, None]
        # torch.remainder is the floor mod of jnp.mod (fmod is not)
        x0i = torch.remainder(x0.to(torch.int32), w)
        y0i = torch.remainder(y0.to(torch.int32), h)
        x1i = torch.remainder(x0i + 1, w)
        y1i = torch.remainder(y0i + 1, h)
        if self.packed is not None:
            tap = lambda xi, yi: _unpack(self.packed.index_select(0, (off + yi * w + xi).long()))
        else:
            tap = lambda xi, yi: self.texels.index_select(0, (off + yi * w + xi).long())
        return (tap(x0i, y0i) * (1 - tx) * (1 - ty) + tap(x1i, y0i) * tx * (1 - ty)
                + tap(x0i, y1i) * (1 - tx) * ty + tap(x1i, y1i) * tx * ty)

    def sample(self, tex: Tensor, u: Tensor, v: Tensor, lod: Optional[Tensor] = None) -> Tensor:
        """(N, 4) RGBA: trilinear at `lod` (mip-level units), bilinear at
        level 0 for lod=None; u, v wrap; tex < 0 gives white. lod=None takes
        sample_bilinear0's one-fetch quad when the mirror exists
        (textures.py:199-228)."""
        if lod is None and self.packed_q is not None:
            return self.sample_bilinear0(tex, u, v)
        tex_c = torch.clamp_min(tex, 0)
        max_l = (self.n_levels[tex_c.long()] - 1).to(torch.float32)
        if lod is None:
            rgba = self._level_fetch(tex_c, torch.zeros_like(tex_c), u, v)
        else:
            lv = torch.minimum(torch.clamp_min(lod, 0.0), max_l)
            l0 = torch.floor(lv).to(torch.int32)
            l1 = torch.minimum(l0 + 1, max_l.to(torch.int32))
            f = (lv - l0)[:, None]
            rgba = (self._level_fetch(tex_c, l0, u, v) * (1 - f)
                    + self._level_fetch(tex_c, l1, u, v) * f)
        return torch.where((tex < 0)[:, None], 1.0, rgba)

    def sample_bilinear0(self, tex: Tensor, u: Tensor, v: Tensor) -> Tensor:
        """Bilinear at mip level 0 (textures.py:230-277), the reference's
        shading lookup. With the mirror: the level-0 metadata rides a row
        fetch (K2) and the quad is one (S, 4) row, blended in x, then in y;
        without it, _level_fetch's four weighted taps. The two round apart
        in the last bits, so each atlas keeps JAX's branch."""
        tex_c = torch.clamp_min(tex, 0)
        if self.packed_q is None:
            rgba = self._level_fetch(tex_c, torch.zeros_like(tex_c), u, v)
            return torch.where((tex < 0)[:, None], 1.0, rgba)
        m = gather_rows(self.meta0, tex_c.to(torch.int32))
        off = m[:, 0].to(torch.int32) + m[:, 1].to(torch.int32) * 4096
        w = m[:, 2].to(torch.int32)
        h = m[:, 3].to(torch.int32)
        fu = u * m[:, 2] - 0.5
        fv = v * m[:, 3] - 0.5
        x0 = torch.floor(fu)
        y0 = torch.floor(fv)
        tx = (fu - x0)[:, None]
        ty = (fv - y0)[:, None]
        x0i = torch.remainder(x0.to(torch.int32), w)
        y0i = torch.remainder(y0.to(torch.int32), h)
        quad = self.packed_q.index_select(0, (off + y0i * w + x0i).long())
        c00, c10, c01, c11 = (_unpack(quad[:, k]) for k in range(4))
        rgba = (c00 * (1 - tx) + c10 * tx) * (1 - ty) + (c01 * (1 - tx) + c11 * tx) * ty
        return torch.where((tex < 0)[:, None], 1.0, rgba)


_ORIG_ATLAS_REPLACE = TextureAtlas._replace


def _atlas_replace(self, **kw):
    """TextureAtlas._replace (textures.py:279-306; a NamedTuple method cannot
    be overridden in the class body). New `texels` drop the RGBA8 mirror
    unless both halves are passed too; passing only one raises ValueError,
    since a fresh tap beside stale quad neighbours would be silently wrong."""
    if "texels" in kw:
        if ("packed" in kw) != ("packed_q" in kw):
            raise ValueError("TextureAtlas._replace: packed and packed_q must be replaced "
                             "together (the RGBA8 mirror is a pair)")
        kw.setdefault("packed", None)
        kw.setdefault("packed_q", None)
    return _ORIG_ATLAS_REPLACE(self, **kw)


TextureAtlas._replace = _atlas_replace


def modulate(color: Vec3, rgba: Tensor) -> Vec3:
    """color * rgba's RGB (textures.py:309)."""
    return Vec3(color.x * rgba[:, 0], color.y * rgba[:, 1], color.z * rgba[:, 2])
