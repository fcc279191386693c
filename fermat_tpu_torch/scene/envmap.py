"""Lat-long environment map with luminance importance sampling
(fermat_tpu/scene/envmap.py).

Sampling inverts ONE flattened (H*W,) CDF of luminance(texel) * sin(theta_row)
with a lower-bound search (torch.searchsorted, side "left"), then jitters
inside the chosen texel; the solid-angle pdf of that procedure is
    p(omega) = (w / total) * (H * W) / (2 pi^2 sin theta)
with sin(theta) at the actual direction, so eval-side MIS pdfs are exact.
The lookups are plain tensor indexing: none of them is a Pallas kernel in
the JAX package.

The CDF is summed on the host in float64 and rounded once to float32, so it
is the same on every device (a float32 cumsum over 2M texels rounds
differently in XLA and on the card). `total` is numpy's float32 sum of the
weights, as the JAX build takes it.

Mapping (standard lat-long):
  u = 0.5 + atan2(x, -z) / (2 pi)      v = acos(y) / pi     (v = 0 at +Y)
  dir(u, v) = (sin th sin ph, cos th, -sin th cos ph),
              th = pi v, ph = 2 pi (u - 0.5)
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3

Tensor = torch.Tensor

_TWO_PI = 2.0 * math.pi
_INV_2PI = 1.0 / _TWO_PI
_INV_PI = 1.0 / math.pi


class EnvMapView(NamedTuple):
    """Device view of a lat-long radiance map and its sampling tables."""

    img: Tensor  # (H, W, 3) float32 radiance, row 0 = +Y pole (v = 0)
    weight: Tensor  # (H*W,) luminance * sin(theta_row): sampling weights
    cdf: Tensor  # (H*W,) inclusive cumulative sum of weight
    total: Tensor  # () sum of weight (> 0: a black map samples uniformly)

    @staticmethod
    def build(img: np.ndarray, device) -> "EnvMapView":
        """img: (H, W, 3) float32 HDR radiance, top row = +Y pole."""
        img = np.ascontiguousarray(np.asarray(img, np.float32))
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"env map must be (H, W, 3), got {img.shape}")
        h = img.shape[0]
        lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
        sin_t = np.sin((np.arange(h, dtype=np.float32) + 0.5) * math.pi / h)
        wt = (lum * sin_t[:, None]).reshape(-1)
        if wt.sum() <= 0.0:  # black map: keep a valid uniform distribution
            wt = np.ones_like(wt)
        cdf = np.cumsum(wt, dtype=np.float64).astype(np.float32)
        return EnvMapView.from_arrays(img, wt, cdf, np.float32(wt.sum()), device)

    @staticmethod
    def from_arrays(img, weight, cdf, total, device) -> "EnvMapView":
        t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
        return EnvMapView(t(img), t(weight), t(cdf), t(np.asarray(total, np.float32)))

    def dir_to_uv(self, d: Vec3):
        u = 0.5 + torch.atan2(d.x, -d.z) * _INV_2PI
        v = torch.acos(torch.clamp(d.y, -1.0, 1.0)) * _INV_PI
        return u, v

    def uv_to_dir(self, u: Tensor, v: Tensor) -> Vec3:
        th = v * math.pi
        ph = (u - 0.5) * _TWO_PI
        st = torch.sin(th)
        return Vec3(st * torch.sin(ph), torch.cos(th), -st * torch.cos(ph))

    def eval(self, d: Vec3) -> Vec3:
        """Bilinear radiance lookup in the (unit) direction d."""
        h, w, _ = self.img.shape
        tex = self.img.reshape(-1, 3)
        u, v = self.dir_to_uv(d)
        fu = u * w - 0.5
        fv = v * h - 0.5
        x0 = torch.floor(fu)
        y0 = torch.floor(fv)
        tx = (fu - x0)[:, None]
        ty = (fv - y0)[:, None]
        x0i = torch.remainder(x0.to(torch.int32), w)
        x1i = torch.remainder(x0i + 1, w)
        y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)  # clamp at the poles
        y1i = torch.clamp(y0i + 1, 0, h - 1)

        def tap(xi, yi):
            return tex[(yi * w + xi).long()]  # (N, 3)

        c = (tap(x0i, y0i) * (1 - tx) * (1 - ty)
             + tap(x1i, y0i) * tx * (1 - ty)
             + tap(x0i, y1i) * (1 - tx) * ty
             + tap(x1i, y1i) * tx * ty)
        return Vec3(c[:, 0], c[:, 1], c[:, 2])

    def _pdf_at(self, wt: Tensor, d: Vec3) -> Tensor:
        h, w, _ = self.img.shape
        sin_t = torch.sqrt(torch.clamp_min(1.0 - d.y * d.y, 1e-12))
        return wt / self.total * (h * w) / (2.0 * math.pi * math.pi * sin_t)

    def pdf(self, d: Vec3) -> Tensor:
        """Solid-angle pdf of sample() producing direction d (for MIS)."""
        h, w, _ = self.img.shape
        u, v = self.dir_to_uv(d)
        xi = torch.clamp((u * w).to(torch.int32), 0, w - 1)
        yi = torch.clamp((v * h).to(torch.int32), 0, h - 1)
        return self._pdf_at(self.weight[(yi * w + xi).long()], d)

    def sample(self, u1: Tensor, u2: Tensor):
        """A direction ~ luminance * sin(theta): (dir, pdf_solid_angle,
        radiance), the radiance the chosen texel's own value (not bilinear),
        so that radiance / pdf stays bounded across sharp texel edges."""
        h, w, _ = self.img.shape
        target = u1 * self.total
        idx = torch.clamp(torch.searchsorted(self.cdf, target, right=False), 0, h * w - 1)
        prev = torch.where(idx > 0, self.cdf[torch.clamp_min(idx - 1, 0)], 0.0)
        wt = self.weight[idx]
        # the remainder of the inversion is uniform in [0, 1): the in-texel x
        # jitter (one sequence dimension inverts the CDF and x together)
        rx = torch.clamp((target - prev) / torch.clamp_min(self.cdf[idx] - prev, 1e-20),
                         0.0, 1.0 - 1e-6)
        yi = torch.div(idx, w, rounding_mode="floor")
        xi = idx - yi * w
        u = (xi.to(torch.float32) + rx) / w
        v = (yi.to(torch.float32) + torch.clamp(u2, 0.0, 1.0 - 1e-6)) / h
        d = self.uv_to_dir(u, v)
        rad = self.img.reshape(-1, 3)[idx]
        return d, self._pdf_at(wt, d), Vec3(rad[:, 0], rad[:, 1], rad[:, 2])


def scene_env_radiance(view, d: Vec3) -> Vec3:
    """Environment radiance along d for a SceneView (envmap.py:157-172): the
    map scaled by view.env when the view has one, else the constant view.env."""
    if view.env_map is not None:
        e = view.env_map.eval(d)
        return Vec3(e.x * view.env[0], e.y * view.env[1], e.z * view.env[2])
    return Vec3(*(view.env[k].expand(d.x.shape) for k in range(3)))
