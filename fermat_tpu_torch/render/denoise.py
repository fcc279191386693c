"""Edge-avoiding A-trous wavelet (EAW) denoiser, the cross-bilateral XBL
filter and the variance prefilter (fermat_tpu/render/denoise.py).

Reference: src/eaw.{h,cu} (B3-spline 5x5 taps with kernelWeights
{1, 2/3, 1/6} — eaw.cu:55; color/normal/position edge-stopping weights —
eaw.cu:74-121; norm_diff = 1 - dot — eaw.cu:35-41), src/xbl.{h,cu} and the
filtering driver renderer.cu:1099-1217 (7 iterations with doubling steps,
per-channel demodulation by albedo, variance-adaptive phi_color,
box-prefiltered variance renderer.cu:366-399).

Each EAW tap is a `torch.roll` and a mask over the whole (H, W, 3) plane,
as in JAX; XBL's taps are flat-index gathers at per-pixel shifts that
`hash_combine` / `uniform_from_bits` make bit-equal to JAX's. Plain tensor
code on the image's device: the JAX filters are XLA code, no Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fermat_tpu_torch.core.camera import Camera, camera_frame
from fermat_tpu_torch.core.math import dot
from fermat_tpu_torch.core.rng import hash_combine, hash_u32, uniform_from_bits
from fermat_tpu_torch.core.sampling import square_to_uniform_disk

Tensor = torch.Tensor

_KW = (1.0, 2.0 / 3.0, 1.0 / 6.0)  # B3 spline (eaw.cu:55)


class EAWParams(NamedTuple):
    """eaw.h EAWParams; defaults follow renderer.cu:1114-1118."""

    phi_normal: float = 2.0
    phi_position: float = 1.0
    phi_color: float = 1.0e-4  # (instance^2+1)/10000 at instance 0
    n_iterations: int = 7


def _inside(h: int, w: int, dy: int, dx: int, device) -> Tensor:
    """(H, W) mask of the pixels whose (dy, dx) neighbour is in the image."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)


def filter_variance(var: Tensor, fw: int = 2) -> Tensor:
    """(2fw+1)^2 box prefilter of the variance plane (renderer.cu:366-399)."""
    h, w = var.shape
    acc = torch.zeros_like(var)
    cnt = torch.zeros_like(var)
    for dy in range(-fw, fw + 1):
        for dx in range(-fw, fw + 1):
            valid = _inside(h, w, dy, dx, var.device)
            acc = acc + torch.where(valid, torch.roll(var, (-dy, -dx), (0, 1)), 0.0)
            cnt = cnt + valid.to(var.dtype)
    return acc / torch.clamp_min(cnt, 1.0)


def _pos_radius(position: Tensor, cam: Camera, res_x: int, res_y: int) -> Tensor:
    """Per-pixel world-space pixel footprint (eaw.cu:62-64)."""
    u, v, w = camera_frame(cam, res_x / res_y)
    ulen = torch.sqrt(dot(u, u))
    vlen = torch.sqrt(dot(v, v))
    wlen2 = dot(w, w)
    rel = position - torch.stack([cam.eye.x, cam.eye.y, cam.eye.z]).to(position.device)
    depth_w = (rel[..., 0] * w.x + rel[..., 1] * w.y + rel[..., 2] * w.z) / wlen2
    return 20.0 * torch.minimum(ulen / res_x, vlen / res_y) * depth_w


def _exponent(base, c_p, n_p, p_p, img, normal, position, phi_c, phi_n, phi_p) -> Tensor:
    """base - position stop - normal stop - color stop, summed in JAX's order
    (base 0 for EAW, minus the squared tap distance for XBL)."""
    dc = c_p - img
    w_color = torch.sum(dc * dc, -1) * phi_c
    w_normal = (1.0 - torch.clamp_min(torch.sum(n_p * normal, -1), 1e-8)) * phi_n
    dp = p_p - position
    w_pos = torch.sum(dp * dp, -1) * phi_p
    return (base - torch.clamp_min(w_pos, 0.0) - torch.clamp_min(w_normal, 0.0)
            - torch.clamp_min(w_color, 0.0))


def _normalize(img: Tensor, sum_c: Tensor, sum_w: Tensor, miss: Tensor) -> Tensor:
    filtered = torch.where((sum_w > 0.0)[..., None],
                           sum_c / torch.clamp_min(sum_w, 1e-20)[..., None], img)
    # miss pixels pass through untouched (eaw.cu:67-71)
    return torch.where(miss[..., None], img, filtered)


def eaw_step(img: Tensor, normal: Tensor, position: Tensor, miss: Tensor, var: Tensor,
             pos_radius: Tensor, params: EAWParams, step: int) -> Tensor:
    """One A-trous iteration at tap spacing `step` (eaw.cu:74-121)."""
    h, w = img.shape[:2]
    phi_n = params.phi_normal * step * step
    phi_p = params.phi_position / torch.clamp_min(pos_radius * pos_radius, 1e-12)
    phi_c = params.phi_color / torch.clamp_min(var * var, 1e-3)
    sum_w = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    sum_c = torch.zeros_like(img)
    for ty in (-2, -1, 0, 1, 2):
        for tx in (-2, -1, 0, 1, 2):
            dy, dx = ty * step, tx * step
            kern = _KW[abs(ty)] * _KW[abs(tx)]
            roll = lambda a: torch.roll(a, (-dy, -dx), (0, 1))
            c_p = roll(img)
            inside = _inside(h, w, dy, dx, img.device) & ~roll(miss)
            e = _exponent(0.0, c_p, roll(normal), roll(position), img, normal, position,
                          phi_c, phi_n, phi_p)
            wgt = torch.where(inside, kern * torch.exp(e), 0.0)
            sum_w = sum_w + wgt
            sum_c = sum_c + wgt[..., None] * c_p
    return _normalize(img, sum_c, sum_w, miss)


def eaw(img: Tensor, normal: Tensor, position: Tensor, miss: Tensor, var: Tensor,
        pos_radius: Tensor, params: EAWParams = EAWParams()) -> Tensor:
    """n_iterations of doubling-step EAW (renderer.cu EAW driver)."""
    for i in range(params.n_iterations):
        img = eaw_step(img, normal, position, miss, var, pos_radius, params, 1 << i)
    return img


def xbl(img: Tensor, normal: Tensor, position: Tensor, miss: Tensor, var: Tensor,
        pos_radius: Tensor, seq_shift: Tensor, params: EAWParams = EAWParams(),
        taps: int = 16, filter_radius: float = 10.0, sigma: float = 10.0) -> Tensor:
    """Cross-bilateral filter with stochastic QMC disk taps (xbl.cu:120-146):
    `taps` Cranley-Patterson-shifted disk samples (seq_shift (H, W, 2) in
    [0, 1)) scaled by filter_radius, a Gaussian spatial falloff and EAW's
    edge stops."""
    h, w = img.shape[:2]
    dev = img.device
    phi_n = params.phi_normal
    phi_p = params.phi_position / torch.clamp_min(pos_radius * pos_radius, 1e-12)
    phi_c = params.phi_color / torch.clamp_min(var * var, 1e-3)
    flat_img, flat_n = img.reshape(h * w, 3), normal.reshape(h * w, 3)
    flat_p, flat_m = position.reshape(h * w, 3), miss.reshape(h * w)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    sum_w = torch.zeros((h, w), dtype=img.dtype, device=dev)
    sum_c = torch.zeros_like(img)
    for s in range(taps):
        if s == 0:
            dx = torch.zeros((h, w), device=dev)
            dy = torch.zeros((h, w), device=dev)
        else:
            shift = lambda k: uniform_from_bits(torch.tensor(hash_u32(s * 2 + k), device=dev))
            u = torch.remainder(shift(1) + seq_shift[..., 0], 1.0)
            v = torch.remainder(shift(2) + seq_shift[..., 1], 1.0)
            ox, oy = square_to_uniform_disk(u, v)
            dx = torch.round(ox * filter_radius)
            dy = torch.round(oy * filter_radius)
        px = torch.clamp(xx + dx.to(torch.int64), 0, w - 1)
        py = torch.clamp(yy + dy.to(torch.int64), 0, h - 1)
        idx = (py * w + px).reshape(-1)
        c_p = flat_img[idx].reshape(h, w, 3)
        d2 = (dx * dx + dy * dy) / (sigma * sigma)
        e = _exponent(-d2, c_p, flat_n[idx].reshape(h, w, 3), flat_p[idx].reshape(h, w, 3),
                      img, normal, position, phi_c, phi_n, phi_p)
        wgt = torch.where(flat_m[idx].reshape(h, w), 0.0, torch.exp(e))
        sum_w = sum_w + wgt
        sum_c = sum_c + wgt[..., None] * c_p
    return _normalize(img, sum_c, sum_w, miss)


def xbl_shifts(h: int, w: int, device) -> Tensor:
    """(H, W, 2) per-pixel Cranley-Patterson shifts of XBL (denoise.py:236-241)."""
    pix = torch.arange(h * w, dtype=torch.int64, device=device)
    s0 = uniform_from_bits(hash_combine(pix, 17)).reshape(h, w)
    s1 = uniform_from_bits(hash_combine(pix, 37)).reshape(h, w)
    return torch.stack([s0, s1], -1)


def denoise(fb, gbuffer_normal: Tensor, gbuffer_position: Tensor, gbuffer_miss: Tensor,
            cam: Camera, instance: int = 0, w_min: float = 1e-2,
            method: str = "eaw") -> Tensor:
    """The filtering pipeline (renderer.cu:1099-1217 kFiltered path):
    demodulate diffuse and specular by their albedo AOVs, prefilter the
    variance, filter each (EAW a-trous or XBL), remodulate, and add the
    unfiltered direct channel."""
    if method not in ("eaw", "xbl"):
        raise ValueError(f"denoise method {method!r}: eaw or xbl")
    h, w = fb.res
    params = EAWParams(phi_color=float(instance * instance + 1) / 1.0e4)
    pos_radius = _pos_radius(gbuffer_position, cam, w, h)
    seq_shift = xbl_shifts(h, w, gbuffer_position.device) if method == "xbl" else None
    out = fb.direct
    for img, albedo, var_idx in ((fb.diffuse, fb.diffuse_albedo, 1),
                                 (fb.specular, fb.specular_albedo, 2)):
        wgt = torch.clamp_min(albedo, w_min)
        demod = img / wgt
        var = filter_variance(fb.var_luminance[..., var_idx], 2)
        if method == "xbl":
            filtered = xbl(demod, gbuffer_normal, gbuffer_position, gbuffer_miss, var,
                           pos_radius, seq_shift, params)
        else:
            filtered = eaw(demod, gbuffer_normal, gbuffer_position, gbuffer_miss, var,
                           pos_radius, params)
        out = out + filtered * wgt
    return out
