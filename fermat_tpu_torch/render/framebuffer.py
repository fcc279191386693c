"""Framebuffer: AOV channels, progressive blending, online variance, tonemap,
and the first-hit G-buffer record (fermat_tpu/render/framebuffer.py).

Progressive accumulation is fb' = fb * n/(n+1) + sample/(n+1), with the
blend weights computed in float32 as the JAX version computes them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# channel ids (FBufferDesc, renderer_view.h:133-145; framebuffer.py:24-29)
DIFFUSE_C = 0
SPECULAR_C = 1
DIRECT_C = 2
COMPOSITED_C = 3
DIFFUSE_A = 4
SPECULAR_A = 5


class Framebuffer(NamedTuple):
    diffuse: Tensor  # (H, W, 3)
    specular: Tensor
    direct: Tensor
    composited: Tensor
    diffuse_albedo: Tensor
    specular_albedo: Tensor
    var_luminance: Tensor  # (H, W, 4) online variance of (direct, diffuse, specular, composited)

    @staticmethod
    def create(res_y: int, res_x: int, device) -> "Framebuffer":
        z3 = torch.zeros((res_y, res_x, 3), dtype=torch.float32, device=device)
        z4 = torch.zeros((res_y, res_x, 4), dtype=torch.float32, device=device)
        return Framebuffer(z3, z3, z3, z3, z3, z3, z4)

    @property
    def res(self):
        return self.composited.shape[0], self.composited.shape[1]

    def accumulate_pass(self, instance: int, diffuse: Tensor, specular: Tensor,
                        direct: Tensor, composited: Tensor, diffuse_albedo: Tensor,
                        specular_albedo: Tensor) -> "Framebuffer":
        """One progressive pass: old * n/(n+1) + new/(n+1), plus the Welford
        variance delta of update_variances_kernel (renderer.cu:333-362)."""
        n = np.float32(instance) + np.float32(1.0)  # frame count after this pass
        w_old = float((n - np.float32(1.0)) / n)
        w_new = float(np.float32(1.0) / n)
        nf, nm1 = float(n), float(n - np.float32(1.0))
        nn = float(n * n)

        blend = lambda old, new: old * w_old + new * w_new
        new_diffuse = blend(self.diffuse, diffuse)
        new_specular = blend(self.specular, specular)
        new_direct = blend(self.direct, direct)
        new_comp = blend(self.composited, composited)
        new_da = blend(self.diffuse_albedo, diffuse_albedo)
        new_sa = blend(self.specular_albedo, specular_albedo)

        lum = lambda *imgs: torch.stack([i.amax(dim=-1) for i in imgs], dim=-1)
        delta = (lum(new_direct, new_diffuse, new_specular, new_comp)
                 - lum(self.direct, self.diffuse, self.specular, self.composited))
        delta_var = (nf * delta) * (nm1 * delta) / nn
        new_var = self.var_luminance * w_old + delta_var
        return Framebuffer(new_diffuse, new_specular, new_direct, new_comp, new_da,
                           new_sa, new_var)


def tonemap(img: Tensor, exposure: float = 1.0, gamma: float = 2.2) -> Tensor:
    """HDR -> display: exposure, Reinhard c/(1+c), gamma (renderer.cu:83-108)."""
    c = torch.clamp_min(img * exposure, 0.0)
    c = c / (c + 1.0)
    return torch.pow(c, 1.0 / gamma)


def to_rgba8(img: Tensor, exposure: float = 1.0, gamma: float = 2.2) -> Tensor:
    c = tonemap(img, exposure, gamma)
    return torch.clamp(c * 256.0, 0.0, 255.0).to(torch.uint8)


def rmse(a: Tensor, b: Tensor) -> Tensor:
    """Image RMSE (main.cu:63-126 diff/ref compare)."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.sqrt(torch.mean(d * d))


class GBuffer(NamedTuple):
    """First-hit geometry buffer (framebuffer.py:116-135, GBufferView of
    framebuffer.h:49-124). RenderingContext keeps these fields, with the
    hit position and the miss mask, in its `gbuffer` dict."""

    depth: Tensor  # (H, W)
    tri: Tensor  # (H, W) int32, -1 = miss
    normal: Tensor  # (H, W, 3) shading normal
    uv: Tensor  # (H, W, 2)
    material: Tensor  # (H, W) int32

    @staticmethod
    def create(res_y: int, res_x: int, device) -> "GBuffer":
        f = lambda shape, v, dt: torch.full(shape, v, dtype=dt, device=device)
        return GBuffer(depth=f((res_y, res_x), float("inf"), torch.float32),
                       tri=f((res_y, res_x), -1, torch.int32),
                       normal=f((res_y, res_x, 3), 0.0, torch.float32),
                       uv=f((res_y, res_x, 2), 0.0, torch.float32),
                       material=f((res_y, res_x), -1, torch.int32))
