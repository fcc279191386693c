"""BSDF sampling inversion: (wi, wo) back to primary sample coordinates
(fermat_tpu/bsdf/inversion.py).

Each map is the inverse of the forward warp in bsdf/composite.py,
bsdf/ggx.py and core/sampling.py: the cosine hemisphere (u0 = 1 - z^2,
u1 = atan2(y, x) / 2 pi), the GGX VNDF (unstretch, project onto the cap
basis, undo the lower-cap blend, polar coordinates), reflection through
h = normalize(wi + wo), transmission through Walter's half vector, and the
lobe pick, whose u2 is placed uniformly inside the chosen lobe's interval
of the selection CDF. CMLT's chart swaps re-express a path in a
neighbouring chart with these maps. Flat lane math, as the forward warps.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fermat_tpu_torch.bsdf import ggx
from fermat_tpu_torch.bsdf.composite import (ALL_LOBES, DIFFUSE_REFL, DIFFUSE_TRANS,
                                             GLOSSY_REFL, GLOSSY_TRANS, BsdfParams,
                                             _selection_probs)
from fermat_tpu_torch.core.math import Vec3, dot, normalize
from fermat_tpu_torch.core.sampling import INV_PI, TWO_PI

Tensor = torch.Tensor


def _wrap01(x: Tensor) -> Tensor:
    return x - torch.floor(x)


def invert_cosine_hemisphere(wo: Vec3) -> Tuple[Tensor, Tensor, Tensor]:
    """Inverse of square_to_cosine_hemisphere for a +z-hemisphere wo:
    (u0, u1, ok)."""
    z = wo.z
    u0 = torch.clamp(1.0 - z * z, 0.0, 1.0)
    u1 = _wrap01(torch.atan2(wo.y, wo.x) / TWO_PI)
    return u0, u1, z > 0.0


def invert_vndf(alpha, wi: Vec3, h: Vec3) -> Tuple[Tensor, Tensor, Tensor]:
    """Inverse of ggx.sample_vndf: the (u0, u1) that give h from wi (wi in
    the +z hemisphere; callers flip). Returns (u0, u1, ok)."""
    nh = normalize(Vec3(h.x / alpha, h.y / alpha, h.z))
    v = normalize(Vec3(alpha * wi.x, alpha * wi.y, wi.z))
    lensq = v.x * v.x + v.y * v.y
    inv = torch.rsqrt(torch.clamp_min(lensq, 1e-20))
    wide = lensq > 1e-12
    t1 = Vec3(torch.where(wide, -v.y * inv, 1.0), torch.where(wide, v.x * inv, 0.0),
              torch.zeros_like(v.z))
    t2 = Vec3(v.y * t1.z - v.z * t1.y, v.z * t1.x - v.x * t1.z, v.x * t1.y - v.y * t1.x)
    p1 = dot(nh, t1)
    p2b = dot(nh, t2)  # the blended second coordinate
    p3 = dot(nh, v)
    s = 0.5 * (1.0 + v.z)
    disc = torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0))
    p2 = (p2b - (1.0 - s) * disc) / torch.clamp_min(s, 1e-8)
    r2 = p1 * p1 + p2 * p2
    ok = (p3 >= 0.0) & (r2 <= 1.0 + 1e-6)
    return torch.clamp(r2, 0.0, 1.0), _wrap01(torch.atan2(p2, p1) / TWO_PI), ok


def _flip_up(wi: Vec3, wo: Vec3):
    flip = torch.where(wi.z < 0, -1.0, 1.0)
    return wi * flip, wo * flip


def invert_ggx_reflect(alpha, wi: Vec3, wo: Vec3) -> Tuple[Tensor, Tensor, Tensor]:
    """Inverse of ggx.reflect_sample."""
    wiu, wou = _flip_up(wi, wo)
    u0, u1, ok = invert_vndf(alpha, wiu, normalize(wiu + wou))
    return u0, u1, ok & (wou.z > 0.0)


def invert_ggx_refract(alpha, ior, wi: Vec3, wo: Vec3) -> Tuple[Tensor, Tensor, Tensor]:
    """Inverse of ggx.refract_sample (Walter 2007's half vector; eta is
    eta_t / eta_i of the flipped, incoming-above configuration)."""
    wiu, wou = _flip_up(wi, wo)
    eta = ior
    h = normalize(Vec3(wiu.x + wou.x * eta, wiu.y + wou.y * eta, wiu.z + wou.z * eta))
    h = h * torch.where(h.z < 0, -1.0, 1.0)
    u0, u1, ok = invert_vndf(alpha, wiu, h)
    return u0, u1, ok & (wou.z < 0.0)


class BsdfInversion(NamedTuple):
    """One scatter event inverted."""

    u0: Tensor
    u1: Tensor
    u2: Tensor  # the selection coordinate, inside the chosen lobe's interval
    component: Tensor  # int32 lobe the inversion attributed wo to
    pdf: Tensor  # solid-angle pdf of sampling wo through that lobe x its selection
    ok: Tensor


def _pick(is_dr, is_dt, is_gr, a, b, c, d):
    return torch.where(is_dr, a, torch.where(is_dt, b, torch.where(is_gr, c, d)))


def classify_component(p: BsdfParams, wi: Vec3, wo: Vec3, u_comp: Tensor,
                       lobes=ALL_LOBES) -> Tensor:
    """The lobe wo is attributed to, chosen by u_comp with probability
    proportional to each lobe's pdf (path_inversion.h:66's strategy)."""
    alpha = ggx._alpha(p.roughness)
    same = (wi.z * wo.z) > 0.0
    zero = torch.zeros_like(wo.z)
    abs_co = torch.abs(wo.z)
    p_dr, p_dt, p_gr, p_gt, _ = _selection_probs(p, wi, lobes)
    w_dr = p_dr * (torch.where(same, abs_co * INV_PI, 0.0) if lobes[0] else zero)
    w_dt = p_dt * (torch.where(~same, abs_co * INV_PI, 0.0) if lobes[1] else zero)
    w_gr = p_gr * (ggx.reflect_pdf(alpha, wi, wo) if lobes[2] else zero)
    w_gt = p_gt * (ggx.refract_pdf(alpha, p.ior, wi, wo) if lobes[3] else zero)
    total = torch.clamp_min(w_dr + w_dt + w_gr + w_gt, 1e-20)
    c0 = w_dr / total
    c1 = c0 + w_dt / total
    c2 = c1 + w_gr / total
    return torch.where(u_comp < c0, DIFFUSE_REFL,
           torch.where(u_comp < c1, DIFFUSE_TRANS,
           torch.where(u_comp < c2, GLOSSY_REFL, GLOSSY_TRANS))).to(torch.int32)


def invert(p: BsdfParams, wi: Vec3, wo: Vec3, u_comp: Tensor, u_slot: Tensor,
           lobes=ALL_LOBES) -> BsdfInversion:
    """The (u0, u1, u2) with which composite.sample gives wo through the
    attributed lobe: u_comp picks the lobe among those consistent with wo,
    u_slot places u2 inside its selection interval. sample(invert(wo)) == wo
    wherever `ok` (inversion.py:171-236)."""
    alpha = ggx._alpha(p.roughness)
    comp = classify_component(p, wi, wo, u_comp, lobes)
    side = torch.where(wi.z >= 0, 1.0, -1.0)
    u0_dr, u1_dr, ok_dr = invert_cosine_hemisphere(Vec3(wo.x, wo.y, wo.z * side))
    u0_dt, u1_dt, ok_dt = invert_cosine_hemisphere(Vec3(wo.x, wo.y, -wo.z * side))
    u0_gr, u1_gr, ok_gr = invert_ggx_reflect(alpha, wi, wo)
    u0_gt, u1_gt, ok_gt = invert_ggx_refract(alpha, p.ior, wi, wo)

    is_dr = comp == DIFFUSE_REFL
    is_dt = comp == DIFFUSE_TRANS
    is_gr = comp == GLOSSY_REFL
    pick = lambda a, b, c, d: _pick(is_dr, is_dt, is_gr, a, b, c, d)
    u0 = pick(u0_dr, u0_dt, u0_gr, u0_gt)
    u1 = pick(u1_dr, u1_dt, u1_gr, u1_gt)
    ok = pick(ok_dr, ok_dt, ok_gr, ok_gt)

    # u2 inside the lobe's selection interval (CDF order dr | dt | gr | gt)
    p_dr, p_dt, p_gr, p_gt, _ = _selection_probs(p, wi, lobes)
    lo = torch.where(is_dr, 0.0, torch.where(is_dt, p_dr, torch.where(
        is_gr, p_dr + p_dt, p_dr + p_dt + p_gr)))
    width = pick(p_dr, p_dt, p_gr, p_gt)
    u2 = lo + u_slot * width
    ok = ok & (width > 0.0)

    # the inversion's pdf: the lobe's selection x its solid-angle pdf
    same = (wi.z * wo.z) > 0.0
    abs_co = torch.abs(wo.z)
    zero = torch.zeros_like(abs_co)
    pdf_lobe = pick(torch.where(same, abs_co * INV_PI, 0.0),
                    torch.where(~same, abs_co * INV_PI, 0.0),
                    ggx.reflect_pdf(alpha, wi, wo) if lobes[2] else zero,
                    ggx.refract_pdf(alpha, p.ior, wi, wo) if lobes[3] else zero)
    return BsdfInversion(u0=u0, u1=u1, u2=u2, component=comp, pdf=pdf_lobe * width, ok=ok)
