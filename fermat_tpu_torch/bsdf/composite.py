"""Composite layered BSDF: Lambert refl/trans + GGX-Smith refl/trans with
Fresnel-weighted layering, Kelemen-coupled energy conservation and the
optional perfectly-specular clearcoat (fermat_tpu/bsdf/composite.py).

Components (bsdf.h:127-155): 0 diffuse reflection, 1 diffuse transmission,
2 glossy reflection, 3 glossy transmission, 4 clearcoat reflection.
`lobes` = (dr, dt, gr, gt) is a static mask: a disabled lobe is not computed.
The glossy reflection lobe is GGX-Smith (glossy="ggx") or its LTC proxy
(glossy="ltc", bsdf/ltc.py; the reference's USE_LTC switch).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from fermat_tpu_torch.bsdf import ggx
from fermat_tpu_torch.bsdf.ltc import ltc_eval, ltc_sample
from fermat_tpu_torch.bsdf.fresnel import schlick
from fermat_tpu_torch.core.math import Vec3, normalize, dot
from fermat_tpu_torch.core.sampling import INV_PI, square_to_cosine_hemisphere

Tensor = torch.Tensor

DIFFUSE_REFL = 0
DIFFUSE_TRANS = 1
GLOSSY_REFL = 2
GLOSSY_TRANS = 3
CLEARCOAT_REFL = 4

# finite stand-in for the delta clearcoat's infinite pdf (bsdf.h:1118)
_DELTA_PDF = 1.0e30

ALL_LOBES = (True, True, True, True)  # (dr, dt, gr, gt)


GLOSSY_MODELS = ("ggx", "ltc")


def _check_glossy(glossy: str) -> None:
    if glossy not in GLOSSY_MODELS:
        raise NotImplementedError(
            f"glossy_model={glossy!r}: the glossy models are {GLOSSY_MODELS}")


class BsdfParams(NamedTuple):
    """Per-lane material parameters."""

    diffuse: Vec3
    diffuse_trans: Vec3
    specular: Vec3  # raw material specular; F0 = specular / pi
    roughness: Tensor
    ior: Tensor
    opacity: Tensor
    reflectivity: Vec3  # clearcoat normal-incidence reflectivity

    @staticmethod
    def from_materials(m) -> "BsdfParams":
        """From a gathered MaterialTable row-set."""
        return BsdfParams(
            diffuse=m.diffuse,
            diffuse_trans=m.diffuse_trans,
            specular=m.specular,
            roughness=m.roughness,
            ior=m.ior,
            opacity=m.opacity,
            reflectivity=m.reflectivity,
        )

    @property
    def f0(self) -> Vec3:
        return Vec3(self.specular.x * INV_PI, self.specular.y * INV_PI,
                    self.specular.z * INV_PI)


def _max_comp(v: Vec3) -> Tensor:
    return torch.maximum(torch.maximum(v.x, v.y), v.z)


def _e_glossy(p: BsdfParams, cos_t: Tensor, e_fn=None) -> Tensor:
    """Fresnel-scaled glossy directional albedo (hemispherical-average
    Schlick F_avg = F0 + (1 - F0)/21, exactly 0 for F0 = 0).

    `e_fn(roughness, cos_t)` replaces the bilinear F=1 albedo lookup; the
    megakernel path passes its exact 32-knot piecewise-linear rebuild
    (ops/pt_mega.py). Every function below threads it through."""
    e1 = (e_fn or ggx.glossy_reflectance)(p.roughness, cos_t)
    f0m = _max_comp(p.f0)
    # XLA lowers a division by a constant to a multiply by its float32
    # reciprocal; the port writes it so, to round like the reference
    favg = f0m + (1.0 - f0m) * (1.0 / 21.0)
    favg = torch.where(f0m <= 0.0, 0.0, favg)
    e = torch.clamp(e1 * favg, 0.0, 1.0)
    return torch.where(p.ior == 0.0, 0.0, e)


def clearcoat_fresnel(p: BsdfParams, wi: Vec3) -> Vec3:
    """Fresnel reflection of the perfectly-specular clearcoat (bsdf.h:1202-1232);
    reflectivity == 0 gives exactly 0."""
    r0 = torch.clamp_max(_max_comp(p.reflectivity), 0.95)
    sq = torch.sqrt(torch.clamp_min(r0, 0.0))
    ior_c = (1.0 + sq) / torch.clamp_min(1.0 - sq, 1e-6)
    ci = torch.abs(wi.z)
    eta = 1.0 / ior_c
    s2t = eta * eta * torch.clamp_min(1.0 - ci * ci, 0.0)
    ct = torch.sqrt(torch.clamp_min(1.0 - s2t, 0.0))
    rs = (ci - ior_c * ct) / torch.clamp_min(ci + ior_c * ct, 1e-8)
    rp = (ior_c * ci - ct) / torch.clamp_min(ior_c * ci + ct, 1e-8)
    f_s = 0.5 * (rs * rs + rp * rp)
    w = torch.clamp((f_s - r0) / torch.clamp_min(1.0 - r0, 1e-6), 0.0, 1.0)
    lerp = lambda a: a + (1.0 - a) * w
    off = _max_comp(p.reflectivity) <= 0.0
    return Vec3(
        torch.where(off, 0.0, lerp(p.reflectivity.x)),
        torch.where(off, 0.0, lerp(p.reflectivity.y)),
        torch.where(off, 0.0, lerp(p.reflectivity.z)),
    )


def scene_clearcoat(materials_host) -> bool:
    """Static: whether any material carries a clearcoat (reflectivity > 0)."""
    return any(max(m.reflectivity) > 0 for m in materials_host)


def scene_lobes(materials_host) -> tuple:
    """Static lobe mask from host materials: scenes without transmissive
    materials skip the transmission lobes."""
    has_dt = any(max(m.diffuse_trans) > 0 for m in materials_host)
    has_gt = any(m.opacity < 1.0 for m in materials_host)
    return (True, has_dt, True, has_gt)


def component_weights(p: BsdfParams, wi: Vec3, wo: Vec3, e_fn=None):
    """(glossy_refl r_coeff Vec3, diffuse_w, diffuse_trans_w, glossy_trans_w)
    (bsdf.h:722-744)."""
    h = normalize(wi + wo)
    voh = torch.abs(dot(wi, h))
    voh = torch.where(torch.isfinite(voh), voh, torch.abs(wi.z))
    r_coeff = schlick(voh, p.f0)
    suppressed = p.ior == 0.0  # ior == 0 signals glossy suppression (bsdf.h:638)
    r_coeff = Vec3(
        torch.where(suppressed, 0.0, r_coeff.x),
        torch.where(suppressed, 0.0, r_coeff.y),
        torch.where(suppressed, 0.0, r_coeff.z),
    )
    t = 1.0 - _max_comp(r_coeff)
    k = (1.0 - _e_glossy(p, torch.abs(wi.z), e_fn)) * (
        1.0 - _e_glossy(p, torch.abs(wo.z), e_fn))
    diffuse_w = t * p.opacity * k
    diffuse_trans_w = t * p.opacity * k
    glossy_trans_w = t * (1.0 - p.opacity)
    return r_coeff, diffuse_w, diffuse_trans_w, glossy_trans_w


def _selection_probs(p: BsdfParams, wi: Vec3, lobes=ALL_LOBES, clearcoat: bool = False,
                     e_fn=None):
    """Lobe selection probabilities from view-dependent weight luminances;
    with the clearcoat the coat takes mean(Fc) (bsdf.h:999-1001)."""
    nov = torch.abs(wi.z)
    r_lum = _max_comp(schlick(nov, p.f0))
    r_lum = torch.where(p.ior == 0.0, 0.0, r_lum)
    t = 1.0 - r_lum
    k = 1.0 - _e_glossy(p, nov, e_fn)
    zero = torch.zeros_like(nov)
    w_dr = t * p.opacity * k * _max_comp(p.diffuse) if lobes[0] else zero
    w_dt = t * p.opacity * k * _max_comp(p.diffuse_trans) if lobes[1] else zero
    w_gr = r_lum if lobes[2] else zero
    w_gt = t * (1.0 - p.opacity) if lobes[3] else zero
    total = w_dr + w_dt + w_gr + w_gt
    inv = 1.0 / torch.clamp_min(total, 1e-12)
    dead = total <= 1e-12
    # dead lanes fall back to diffuse so probs stay normalized
    p_dr = torch.where(dead, 1.0, w_dr * inv)
    p_dt = torch.where(dead, 0.0, w_dt * inv)
    p_gr = torch.where(dead, 0.0, w_gr * inv)
    p_gt = torch.where(dead, 0.0, w_gt * inv)
    if clearcoat:
        fc = clearcoat_fresnel(p, wi)
        p_cc = (fc.x + fc.y + fc.z) * (1.0 / 3.0)  # as XLA lowers "/ 3.0"
        s = 1.0 - p_cc
        return p_dr * s, p_dt * s, p_gr * s, p_gt * s, p_cc
    return p_dr, p_dt, p_gr, p_gt, zero


def _glossy_refl_eval(p: BsdfParams, alpha, wi: Vec3, wo: Vec3, glossy: str):
    """Glossy reflection (f, pdf): GGX-Smith or the LTC proxy
    (composite.py:233-240)."""
    if glossy == "ltc":
        return ltc_eval(p.roughness, wi, wo)
    return ggx.reflect_eval(alpha, wi, wo), ggx.reflect_pdf(alpha, wi, wo)


def _lobe_values(p: BsdfParams, wi: Vec3, wo: Vec3, lobes, glossy: str, e_fn=None):
    """Shared head of f_and_pdf / f_split: lobe weights and per-lobe values."""
    alpha = ggx._alpha(p.roughness)
    r_coeff, w_d, w_dt, w_gt = component_weights(p, wi, wo, e_fn)
    same = (wi.z * wo.z) > 0.0
    abs_co = torch.abs(wo.z)
    zero = torch.zeros_like(abs_co)
    f_dr = torch.where(same, INV_PI, 0.0) * w_d if lobes[0] else zero
    f_dt = torch.where(~same, INV_PI, 0.0) * w_dt if lobes[1] else zero
    if lobes[2]:
        g_r, pdf_gr = _glossy_refl_eval(p, alpha, wi, wo, glossy)
    else:
        g_r, pdf_gr = zero, zero
    g_t = ggx.refract_eval(alpha, p.ior, wi, wo) * w_gt if lobes[3] else zero
    return alpha, r_coeff, same, abs_co, zero, f_dr, f_dt, g_r, pdf_gr, g_t


def _mix_pdf(p, wi, wo, lobes, clearcoat, alpha, same, abs_co, zero, pdf_gr, e_fn=None):
    p_dr, p_dt, p_gr, p_gt, _ = _selection_probs(p, wi, lobes, clearcoat, e_fn)
    return (
        p_dr * (torch.where(same, abs_co * INV_PI, 0.0) if lobes[0] else zero)
        + p_dt * (torch.where(~same, abs_co * INV_PI, 0.0) if lobes[1] else zero)
        + p_gr * pdf_gr
        + p_gt * (ggx.refract_pdf(alpha, p.ior, wi, wo) if lobes[3] else zero)
    )


def f_and_pdf(p: BsdfParams, wi: Vec3, wo: Vec3, lobes=ALL_LOBES,
              clearcoat: bool = False, glossy: str = "ggx",
              e_fn=None) -> Tuple[Vec3, Tensor]:
    """Composite f and the mixture pdf of `sample` (bsdf.h:336-413)."""
    _check_glossy(glossy)
    alpha, r_coeff, same, abs_co, zero, f_dr, f_dt, g_r, pdf_gr, g_t = (
        _lobe_values(p, wi, wo, lobes, glossy, e_fn))
    fx = p.diffuse.x * f_dr + p.diffuse_trans.x * f_dt + r_coeff.x * g_r + g_t
    fy = p.diffuse.y * f_dr + p.diffuse_trans.y * f_dt + r_coeff.y * g_r + g_t
    fz = p.diffuse.z * f_dr + p.diffuse_trans.z * f_dt + r_coeff.z * g_r + g_t
    if clearcoat:
        tc = clearcoat_fresnel(p, wi)
        fx, fy, fz = fx * (1.0 - tc.x), fy * (1.0 - tc.y), fz * (1.0 - tc.z)
    mix = _mix_pdf(p, wi, wo, lobes, clearcoat, alpha, same, abs_co, zero, pdf_gr, e_fn)
    return Vec3(fx, fy, fz), mix


def f(p: BsdfParams, wi: Vec3, wo: Vec3, lobes=ALL_LOBES) -> Vec3:
    """The composite BSDF value alone (composite.py:188-191)."""
    return f_and_pdf(p, wi, wo, lobes)[0]


def f_split(p: BsdfParams, wi: Vec3, wo: Vec3, lobes=ALL_LOBES,
            clearcoat: bool = False, glossy: str = "ggx",
            e_fn=None) -> Tuple[Vec3, Vec3, Tensor]:
    """(f_diffuse, f_glossy, mixture_pdf) — the per-component split used to
    route diffuse vs specular framebuffer channels."""
    _check_glossy(glossy)
    alpha, r_coeff, same, abs_co, zero, f_dr, f_dt, g_r, pdf_gr, g_t = (
        _lobe_values(p, wi, wo, lobes, glossy, e_fn))
    fd = Vec3(
        p.diffuse.x * f_dr + p.diffuse_trans.x * f_dt,
        p.diffuse.y * f_dr + p.diffuse_trans.y * f_dt,
        p.diffuse.z * f_dr + p.diffuse_trans.z * f_dt,
    )
    fg = Vec3(r_coeff.x * g_r + g_t, r_coeff.y * g_r + g_t, r_coeff.z * g_r + g_t)
    if clearcoat:
        tc = clearcoat_fresnel(p, wi)
        fd = Vec3(fd.x * (1.0 - tc.x), fd.y * (1.0 - tc.y), fd.z * (1.0 - tc.z))
        fg = Vec3(fg.x * (1.0 - tc.x), fg.y * (1.0 - tc.y), fg.z * (1.0 - tc.z))
    mix = _mix_pdf(p, wi, wo, lobes, clearcoat, alpha, same, abs_co, zero, pdf_gr, e_fn)
    return fd, fg, mix


def diffuse_refl_unit(p: BsdfParams, wi: Vec3, wo: Vec3, clearcoat: bool = False,
                      e_fn=None, lobes=ALL_LOBES) -> Vec3:
    """d f / d p.diffuse: the diffuse-reflection lobe with the albedo factored
    out (composite.py:326-345). f_split's fd is exactly linear in p.diffuse
    and component_weights does not read it, so this is the per-channel
    partial derivative the replay-gradient kernel accumulates; the channels
    differ only under clearcoat (the 1 - Fc coat transmission is chromatic)."""
    _r, w_d, _w_dt, _w_gt = component_weights(p, wi, wo, e_fn)
    same = (wi.z * wo.z) > 0.0
    f_dr = torch.where(same, INV_PI, 0.0) * w_d if lobes[0] else torch.zeros_like(w_d)
    if clearcoat:
        tc = clearcoat_fresnel(p, wi)
        return Vec3(f_dr * (1.0 - tc.x), f_dr * (1.0 - tc.y), f_dr * (1.0 - tc.z))
    return Vec3(f_dr, f_dr, f_dr)


class BsdfSample(NamedTuple):
    wo: Vec3  # sampled direction (local frame)
    f: Vec3  # composite BSDF value
    pdf: Tensor  # mixture solid-angle pdf
    g: Vec3  # f * |cos| / pdf — the throughput weight
    component: Tensor  # sampled lobe (int32)
    valid: Tensor  # pdf > 0


def sample(p: BsdfParams, wi: Vec3, u0, u1, u2, lobes=ALL_LOBES,
           clearcoat: bool = False, glossy: str = "ggx", e_fn=None) -> BsdfSample:
    """One-sample-MIS lobe sampling (Bsdf::sample, bsdf.h:830-1140)."""
    _check_glossy(glossy)
    p_dr, p_dt, p_gr, p_gt, p_cc = _selection_probs(p, wi, lobes, clearcoat, e_fn)
    alpha = ggx._alpha(p.roughness)
    side = torch.where(wi.z >= 0, 1.0, -1.0)

    c0 = p_dr
    c1 = c0 + p_dt
    c2 = c1 + p_gr
    c3 = c2 + p_gt
    comp = torch.where(u2 < c0, DIFFUSE_REFL,
           torch.where(u2 < c1, DIFFUSE_TRANS,
           torch.where(u2 < c2, GLOSSY_REFL,
           torch.where(u2 < c3, GLOSSY_TRANS, CLEARCOAT_REFL)))).to(torch.int32)
    if not clearcoat:
        comp = torch.clamp_max(comp, GLOSSY_TRANS)

    # sample every lobe (branchless) and select
    d_loc = square_to_cosine_hemisphere(u0, u1)
    wo_dr = Vec3(d_loc.x, d_loc.y, d_loc.z * side)
    wo_dt = Vec3(d_loc.x, d_loc.y, -d_loc.z * side)
    if not lobes[2]:
        wo_gr = wo_dr
    elif glossy == "ltc":
        wo_gr, _ = ltc_sample(p.roughness, wi, u0, u1)
    else:
        wo_gr, _ = ggx.reflect_sample(alpha, wi, u0, u1)
    if lobes[3]:
        wo_gt, pdf_gt_s = ggx.refract_sample(alpha, p.ior, wi, u0, u1)
    else:
        wo_gt, pdf_gt_s = wo_dr, torch.ones_like(u0)

    is_dr = comp == DIFFUSE_REFL
    is_dt = comp == DIFFUSE_TRANS
    is_gr = comp == GLOSSY_REFL
    is_gt = comp == GLOSSY_TRANS
    pick = lambda a, b, c, d: torch.where(is_dr, a, torch.where(is_dt, b, torch.where(is_gr, c, d)))
    wo = Vec3(pick(wo_dr.x, wo_dt.x, wo_gr.x, wo_gt.x),
              pick(wo_dr.y, wo_dt.y, wo_gr.y, wo_gt.y),
              pick(wo_dr.z, wo_dt.z, wo_gr.z, wo_gt.z))
    if clearcoat:
        # mirror about the shading normal: out = 2 cos_i * N - in
        is_cc = comp == CLEARCOAT_REFL
        wo = Vec3(torch.where(is_cc, -wi.x, wo.x), torch.where(is_cc, -wi.y, wo.y),
                  torch.where(is_cc, wi.z, wo.z))

    # detached sampling (composite.py:425-427): the sampled direction and the
    # mixture pdf are constants of the estimator, gradients flow through f
    wo = Vec3(wo.x.detach(), wo.y.detach(), wo.z.detach())
    fv, mix_pdf = f_and_pdf(p, wi, wo, lobes, clearcoat, glossy, e_fn)
    # glossy-trans TIR lanes have pdf 0
    mix_pdf = torch.where(is_gt & (pdf_gt_s <= 0.0), 0.0, mix_pdf)
    mix_pdf = mix_pdf.detach()  # composite.py:432
    valid = mix_pdf > 1e-12
    inv_pdf = torch.where(valid, 1.0 / torch.where(valid, mix_pdf, 1.0), 0.0)
    cos_o = torch.abs(wo.z)
    g = Vec3(fv.x * cos_o * inv_pdf, fv.y * cos_o * inv_pdf, fv.z * cos_o * inv_pdf)
    if clearcoat:
        # delta coat reflection: g = Fc / p_comp, f delta, pdf = delta stand-in
        is_cc = comp == CLEARCOAT_REFL
        fc = clearcoat_fresnel(p, wi)
        p_cc_safe = torch.clamp_min(p_cc, 1e-12)
        cc_ok = is_cc & (p_cc > 1e-7)
        coat = lambda f, gg: torch.where(is_cc, torch.where(cc_ok, f / p_cc_safe, 0.0), gg)
        g = Vec3(coat(fc.x, g.x), coat(fc.y, g.y), coat(fc.z, g.z))
        fv = Vec3(torch.where(is_cc, 0.0, fv.x), torch.where(is_cc, 0.0, fv.y),
                  torch.where(is_cc, 0.0, fv.z))
        mix_pdf = torch.where(is_cc, _DELTA_PDF, mix_pdf)
        valid = torch.where(is_cc, cc_ok, valid)
    return BsdfSample(wo=wo, f=fv, pdf=mix_pdf, g=g, component=comp, valid=valid)
