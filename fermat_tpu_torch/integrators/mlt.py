"""Veach-style path-space Metropolis light transport (fermat_tpu/integrators/mlt.py).

Chains are lanes. One pass:

  1. PRESAMPLE: each chain traces one light subpath and one eye subpath,
     BPT-style with the SmallVCM dVCM/dVC recursion and light tracing left
     out (the eye dVCM starts at zero), and enumerates every (s, t >= 2)
     strategy of at most max_path_length segments, plus the eye paths that
     escape to the environment after a bounce (s = -1).
  2. SEED: a per-chain RIS pick of one strategy in proportion to its
     MIS-weighted luminance; the chain's weight W is the sum of the
     candidates' luminances.
  3. CHAIN STEPS: step 0 re-traces the seed unperturbed; the later steps
     perturb the screen point and every interior direction (the
     exponential spherical kernel or the half-vector kernel, by vertex),
     re-trace the whole path, and accept with
     [lum(V') J'] / [lum(V) J]; both paths splat their expected values with
     `index_add_`. Every st_swap_frequency-th step (from step freq-1 on) is
     an ST swap instead: the same geometric path relabelled (s, t) ->
     (s -+ 1, t +- 1), no ray traced.

A chain stores its vertices as (triangle, u, v) and re-interpolates them at
every step with one fetch of the shade table (MeshView.shade_fetch, K2)
per slot: the geometry, the material and the emission of JAX's
`_interp`, `_params_of` and `_emissive_of` in one row. Where the closest
tracer returns no barycentrics (the frontier route) a hit's (u, v) are
derived from the ray and the fetched triangle, as in the PT pass, and the
derived (u, v) are what the chain stores; JAX meets that route only on a
TPU, where it stores u = v = 0.

JAX's fori_loop and lax.cond become a Python loop over a host step index:
`enable = step > 0` and the swap cadence are decided on the host, with no
readback. The passes trace with the view's own closest and any-hit tracers
(integrators/pt.view_tracers); shadow sets, analytic, point and directional
lights and textures are ignored, as in JAX: NEE samples the full mesh-light
table, and an escape takes scene_env_radiance. tracer="mega" raises
NotImplementedError (JAX's pass walks a BVH under that name).

The uint32 hashes follow core/rng.py: int64 tensors or Python ints masked
to 32 bits; `step * 4096 + dim` wraps in 32 bits as JAX's does.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from fermat_tpu_torch.bsdf.composite import BsdfParams, f_and_pdf
from fermat_tpu_torch.bsdf.composite import f as bsdf_f
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.camera import CameraSampler
from fermat_tpu_torch.core.math import (Vec3, dot, normalize, orthonormal_basis, select,
                                        to_local, to_world)
from fermat_tpu_torch.core.rng import M32, hash_combine, uniform_from_bits
from fermat_tpu_torch.core.sampling import (INV_PI, TWO_PI, square_to_cosine_hemisphere,
                                            square_to_uniform_triangle)
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.integrators.bpt import _eval_both
from fermat_tpu_torch.scene.envmap import scene_env_radiance
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor
_BIG = 3.0e38


class MLTOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's MLTOptions (mlt.py:85-104)."""

    max_path_length: int = 6  # max segments per path
    n_chains: int = 0  # 0 -> one chain per pixel
    steps_per_pass: int = 12  # chain steps per pass, the identity step included
    screen_perturbations: float = 1.0  # probability of perturbing the screen point
    exp_perturbations: float = 0.45  # per-vertex spherical perturbation probability
    h_perturbations: float = 0.45  # per-vertex half-vector perturbation probability
    perturbation_radius: float = 0.1
    st_swap_frequency: int = 4  # every Nth step is an ST swap; 0 disables
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"


# ---------------------------------------------------------------------------
# Perturbation kernels (mlt_perturbations.h)
# ---------------------------------------------------------------------------

def _log_ratio(b1: float, b2: float) -> float:
    """-log(b2 / b1) taken in float32, as JAX takes it of the float32 ratio."""
    return float(-np.log(np.float32(b2 / b1)))


def bounded_exp_map(u: Tensor, b1: float, b2: float) -> Tensor:
    """Signed log-uniform magnitude in [b1, b2] (Bounded_exponential.map)."""
    ln = _log_ratio(b1, b2)
    return torch.where(u < 0.5, b2 * torch.exp(ln * (0.5 - u) * 2.0),
                       -b2 * torch.exp(ln * (u - 0.5) * 2.0))


def exp_spherical_perturbation(d: Vec3, z0: Tensor, z1: Tensor, radius: float) -> Vec3:
    """d rotated by a log-uniform angle about a uniform azimuth
    (mlt_perturbations.h:42-64)."""
    nrm = normalize(d)
    t, b = orthonormal_basis(nrm)
    phi = z0 * TWO_PI
    theta = bounded_exp_map(z1, 1.0e-4, radius)
    st = torch.sin(theta)
    ct = torch.cos(theta)
    return normalize(t * (torch.cos(phi) * st) + b * (torch.sin(phi) * st) + nrm * ct)


def _where3(m: Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y), torch.where(m, a.z, b.z))


def _microfacet_h(win: Vec3, wout: Vec3, nrm: Vec3, eta: Tensor) -> Vec3:
    """The microfacet normal mapping win to wout, oriented along nrm:
    win + wout on reflection, Walter's win + eta wout on transmission."""
    refl = (dot(nrm, win) * dot(nrm, wout)) >= 0.0
    h_r = normalize(win + wout)
    h_t = normalize(Vec3(win.x + wout.x * eta, win.y + wout.y * eta, win.z + wout.z * eta))
    h = _where3(refl, h_r, h_t)
    return h * torch.where(dot(h, nrm) < 0.0, -1.0, 1.0)


def h_perturbation(old_in: Vec3, old_out: Vec3, old_n: Vec3, old_eta: Tensor, new_in: Vec3,
                   new_n: Vec3, new_eta: Tensor, z0: Tensor, z1: Tensor,
                   radius: float) -> Vec3:
    """The half-vector perturbation (mlt_perturbations.h:168-222): perturb
    the microfacet in the old local frame, carry it to the new frame, and
    scatter new_in through it in the old path's mode."""
    o_n = old_n * torch.where(dot(old_n, old_in) < 0.0, -1.0, 1.0)
    n_n = new_n * torch.where(dot(new_n, new_in) < 0.0, -1.0, 1.0)
    h = _microfacet_h(old_in, old_out, o_n, old_eta)
    ot, ob = orthonormal_basis(o_n)
    h_loc = exp_spherical_perturbation(to_local(h, ot, ob, o_n), z0, z1, radius)
    nt, nb = orthonormal_basis(n_n)
    h_new = to_world(h_loc, nt, nb, n_n)
    refl = dot(o_n, old_out) >= 0.0
    vh = dot(new_in, h_new)
    refl_dir = h_new * (2.0 * vh) - new_in
    eta = new_eta
    cos_t2 = 1.0 - eta * eta * (1.0 - vh * vh)
    cos_t = -torch.where(vh >= 0.0, 1.0, -1.0) * torch.sqrt(torch.clamp_min(cos_t2, 0.0))
    k = eta * vh + cos_t
    refr_dir = Vec3(k * h_new.x - eta * new_in.x, k * h_new.y - eta * new_in.y,
                    k * h_new.z - eta * new_in.z)
    return normalize(_where3(refl | (cos_t2 < 0.0), refl_dir, refr_dir))


def h_perturbation_density(win: Vec3, wout: Vec3, nrm: Vec3, eta: Tensor) -> Tensor:
    """|d w_o / d H| of the H -> out map (mlt_perturbations.h:226-252)."""
    nn = nrm * torch.where(dot(nrm, win) < 0.0, -1.0, 1.0)
    refl = (dot(nn, win) * dot(nn, wout)) >= 0.0
    h = _microfacet_h(win, wout, nn, eta)
    voh = dot(win, h)
    loh = dot(wout, h)
    d_refl = 4.0 * torch.abs(loh)
    inv_eta = 1.0 / torch.clamp_min(eta, 1e-8)
    denom = voh + inv_eta * loh
    d_refr = (denom * denom) / torch.clamp_min(inv_eta * inv_eta * torch.abs(loh), 1e-12)
    d = torch.where(refl, d_refl, d_refr)
    return torch.where(torch.isfinite(d) & (d > 0.0), d, 1.0e8)


def _eta_of(p: BsdfParams, nrm: Vec3, win: Vec3) -> Tensor:
    """Relative IoR eta_o / eta_i of the H map on win's side."""
    ior = torch.clamp_min(p.ior, 1e-3)
    return torch.where(dot(nrm, win) >= 0.0, 1.0 / ior, ior)


# ---------------------------------------------------------------------------
# Chain state and helpers
# ---------------------------------------------------------------------------

class ChainState(NamedTuple):
    """Explicit vertex-chain storage, chains = lanes (mlt.py:213-242): slot
    j of e_* holds eye surface vertex x_{j+1}, slot j of l_* light surface
    vertex y_{j+1}, y_0 lives in l0_*; (uv_x, uv_y) is the screen point."""

    uv_x: Tensor
    uv_y: Tensor
    e_tri: Tensor  # (n, K) int32
    e_u: Tensor
    e_v: Tensor
    l0_tri: Tensor  # (n,)
    l0_u: Tensor
    l0_v: Tensor
    l_tri: Tensor  # (n, LS)
    l_u: Tensor
    l_v: Tensor
    s: Tensor  # (n,) int32 light-side vertex count incl. y_0 (0 = pure eye path)
    m: Tensor  # (n,) int32 total segments
    val_x: Tensor  # (n,) current path value V
    val_y: Tensor
    val_z: Tensor
    weight: Tensor  # (n,) RIS seed weight W
    env: Tensor  # (n,) bool: an eye path whose segment m escapes to the environment
    env_dx: Tensor  # its escape direction
    env_dy: Tensor
    env_dz: Tensor

    @staticmethod
    def from_numpy(arrays: dict, device) -> "ChainState":
        """From JAX's ChainState arrays by field name (int32 ids, float32
        values, bool env)."""
        def conv(name):
            a = np.asarray(arrays[name])
            dt = (np.bool_ if name == "env" else
                  np.int32 if name.endswith("tri") or name in ("s", "m") else np.float32)
            return torch.from_numpy(np.array(a, dtype=dt)).to(device)

        return ChainState(*(conv(f) for f in ChainState._fields))


def _lum(x: Tensor, y: Tensor, z: Tensor) -> Tensor:
    return 0.2126 * x + 0.7152 * y + 0.0722 * z


def _sel(idx: Tensor, items: list):
    """The per-lane item idx of a Python list of slot values (tensors,
    Vec3s or tuples of them), zeros where idx is out of range: JAX's
    _sel_a / _sel_v (mlt.py:253-265), one where per slot."""
    first = items[0]
    if isinstance(first, tuple):
        return _rebuild(first, [_sel(idx, [it[k] for it in items]) for k in range(len(first))])
    out = torch.zeros_like(first)
    for j, v in enumerate(items):
        out = torch.where(idx == j, v, out)
    return out


def _where_t(m: Tensor, a, b):
    """where(m, a, b) over matching tuples of tensors."""
    if isinstance(a, tuple):
        return _rebuild(a, [_where_t(m, x, y) for x, y in zip(a, b)])
    return torch.where(m, a, b)


def _rebuild(like: tuple, parts: list) -> tuple:
    """A tuple of `like`'s type (a NamedTuple or a plain tuple) of parts."""
    return type(like)(*parts) if hasattr(like, "_fields") else tuple(parts)


class _Rand(NamedTuple):
    """Per-(chain, step, dim) decorrelated uniforms (mlt.py:268-283)."""

    base: Tensor  # (n,) uint32 in int64

    @staticmethod
    def create(seed: int, instance: int, n: int, device) -> "_Rand":
        cid = torch.arange(n, dtype=torch.int64, device=device)
        return _Rand(hash_combine(hash_combine(seed & M32, instance & M32), cid))

    def u(self, step: int, dim: int) -> Tensor:
        return uniform_from_bits(hash_combine(self.base, ((step & M32) * 4096 + dim) & M32))


class _Vtx(NamedTuple):
    """A vertex as the chain steps read it: geometry, BSDF and emission."""

    pos: Vec3
    gn: Vec3
    sn: Vec3
    params: BsdfParams
    le: Vec3


def _vtx_of(sh) -> _Vtx:
    return _Vtx(sh.pos, sh.gn, sh.sn, BsdfParams.from_materials(sh.mats), sh.mats.emissive)


class _Ctx(NamedTuple):
    """What a pass's phases share (JAX's _EvalCtx)."""

    view: SceneView
    opts: "MLTOptions"  # or cmlt.CMLTOptions
    cam: CameraSampler
    tr: "pt_mod.ViewTracers"
    table: Tensor  # the shade rows, built once a pass
    res_x: int
    res_y: int
    n: int


def _make_ctx(view: SceneView, opts, res_x: int, res_y: int, n: int,
              renderer: str = "MLT") -> _Ctx:
    """The pass's context; `opts` is any options tuple with ray_eps and
    tracer (CMLT shares it)."""
    return _Ctx(view, opts, CameraSampler.create(view.camera, res_x / res_y),
                pt_mod.view_tracers(view, opts.tracer, renderer), view.mesh.shade_rows(),
                res_x, res_y, n)


def _interp(ctx: _Ctx, tri: Tensor, u: Tensor, v: Tensor) -> _Vtx:
    """A stored vertex re-interpolated (mlt.py:303-304), by one shade fetch."""
    return _vtx_of(ctx.view.mesh.shade_fetch(torch.clamp_min(tri, 0).contiguous(),
                                             u.contiguous(), v.contiguous(), ctx.table))


def _trace(ctx: _Ctx, o: Vec3, d: Vec3, active: Tensor):
    """A closest trace and its hit's vertex: (hit, tri, u, v, _Vtx), (u, v)
    derived from the ray where the tracer returns none."""
    hit = ctx.tr.closest(o, d, ctx.opts.ray_eps, _BIG, active)
    _, sh, u, v = pt_mod.surface(ctx.view, ctx.tr, ctx.table, hit, o, d)
    return hit, u, v, _vtx_of(sh)


def _cam_eye(ctx: _Ctx) -> Vec3:
    eye = ctx.view.camera.eye
    return Vec3(*(c.expand(ctx.n) for c in eye))


def _fsum(m: Tensor) -> Tensor:
    return m.to(torch.float32).sum()


def _frame_f(p: BsdfParams, sn: Vec3, win: Vec3, wout: Vec3, lobes) -> Vec3:
    t_b, b_b = orthonormal_basis(sn)
    return bsdf_f(p, to_local(win, t_b, b_b, sn), to_local(wout, t_b, b_b, sn), lobes)


# ---------------------------------------------------------------------------
# Phase 1 and 2: the BPT presample and the per-chain RIS seed
# ---------------------------------------------------------------------------

def _presample(ctx: _Ctx, rng: _Rand):
    """The seeding pass (mlt.py:683-968): returns (ChainState, rays)."""
    view, opts, n = ctx.view, ctx.opts, ctx.n
    dev = view.device
    K = opts.max_path_length
    LS = max(K - 2, 1)
    eps, lobes = opts.ray_eps, opts.lobes
    f32 = dict(dtype=torch.float32, device=dev)
    n_rays = torch.zeros((), **f32)
    u0 = lambda dim: rng.u(0, dim)

    uv0_x, uv0_y = u0(0), u0(1)
    ul0, ul1, ul2 = u0(2), u0(3), u0(4)
    lpos, ln, lle, lpdf_a, ltri = view.lights.sample(ul0, ul1, ul2)
    lb0, lb1 = square_to_uniform_triangle(ul0, ul1)
    has_light = view.lights.has_lights & (lpdf_a > 0.0)
    d_loc = square_to_cosine_hemisphere(u0(5), u0(6))
    lt, lb = orthonormal_basis(ln)
    d = to_world(d_loc, lt, lb, ln)
    cos_emit = torch.clamp_min(d_loc.z, 1e-8)
    pdf_emit = lpdf_a * cos_emit * INV_PI
    inv_pe = torch.where(has_light, 1.0 / torch.clamp_min(pdf_emit, 1e-20), 0.0)
    l_thr = Vec3(lle.x * cos_emit * inv_pe, lle.y * cos_emit * inv_pe, lle.z * cos_emit * inv_pe)
    l_dvcm = lpdf_a / torch.clamp_min(pdf_emit, 1e-20)
    l_dvc = cos_emit / torch.clamp_min(pdf_emit, 1e-20)
    o = pt_mod._offset_origin(lpos, ln, d, eps)
    alive = has_light

    # the light slots: (tri, u, v, valid, thr, dvcm, dvc, wi) a slot
    L = {k: [] for k in ("tri", "u", "v", "valid", "thr", "dvcm", "dvc", "wi")}
    for j in range(LS):
        hit, hu, hv, vx = _trace(ctx, o, d, alive)
        n_rays = n_rays + _fsum(alive)
        valid = alive & hit.hit_mask
        wi = -d
        flip = torch.where(dot(vx.gn, wi) < 0.0, -1.0, 1.0)
        sn_f = vx.sn * flip
        cos_in = torch.clamp_min(torch.abs(dot(sn_f, wi)), 1e-8)
        t_safe = torch.where(valid, hit.t, 1.0)
        dvcm = l_dvcm * (t_safe * t_safe) / cos_in
        dvc = l_dvc / cos_in
        L["tri"].append(torch.where(valid, hit.tri, 0))
        L["u"].append(torch.where(valid, hu, 0.0))
        L["v"].append(torch.where(valid, hv, 0.0))
        L["valid"].append(valid)
        L["thr"].append(select(valid, l_thr))
        L["dvcm"].append(torch.where(valid, dvcm, 0.0))
        L["dvc"].append(torch.where(valid, dvc, 0.0))
        L["wi"].append(wi)
        if j + 1 < LS:
            t_b, b_b = orthonormal_basis(sn_f)
            wi_loc = to_local(wi, t_b, b_b, sn_f)
            sm = bsdf_sample(vx.params, wi_loc, u0(10 + 3 * j), u0(11 + 3 * j),
                             u0(12 + 3 * j), lobes)
            pdf_rev = f_and_pdf(vx.params, sm.wo, wi_loc, lobes)[1]
            cos_out = torch.clamp_min(torch.abs(sm.wo.z), 1e-8)
            pdf_fwd = torch.clamp_min(sm.pdf, 1e-20)
            l_dvc = (cos_out / pdf_fwd) * (dvc * pdf_rev + dvcm)
            l_dvcm = 1.0 / pdf_fwd
            wo_w = to_world(sm.wo, t_b, b_b, sn_f)
            alive = valid & sm.valid
            l_thr = select(alive, Vec3(l_thr.x * sm.g.x, l_thr.y * sm.g.y, l_thr.z * sm.g.z))
            o = pt_mod._offset_origin(vx.pos, vx.gn, wo_w, eps)
            d = wo_w
    # the stored light vertices as the strategies read them back: from
    # (tri, u, v), triangle 0 at (0, 0) where a slot is empty
    lvx = [_interp(ctx, L["tri"][j], L["u"][j], L["v"][j]) for j in range(LS)]

    # ---- the eye walk and the strategies ----
    d = ctx.cam.sample_direction(uv0_x, uv0_y)
    o = _cam_eye(ctx)
    e_dvcm = torch.zeros(n, **f32)  # light tracing excluded
    e_dvc = torch.zeros(n, **f32)
    e_thr = Vec3.full(n, 1.0, 1.0, 1.0, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    E = {k: [] for k in ("tri", "u", "v")}
    strategies = []  # (s, m, rgb); s == -1 marks an env-terminated eye path
    d_rec = []
    for i in range(K):
        d_rec.append(d)
        hit, hu, hv, vx = _trace(ctx, o, d, alive)
        n_rays = n_rays + _fsum(alive)
        valid = alive & hit.hit_mask
        if i >= 1:
            # segment i+1 escapes (i == 0, the directly visible environment,
            # is render_pass_fb's own term)
            env_rad = scene_env_radiance(view, d)
            strategies.append((-1, i + 1, select(alive & ~hit.hit_mask, Vec3(
                e_thr.x * env_rad.x, e_thr.y * env_rad.y, e_thr.z * env_rad.z))))
        tri_c = torch.clamp_min(hit.tri, 0)
        pos, gn = vx.pos, vx.gn
        wi = -d
        flip = torch.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f, sn_f = gn * flip, vx.sn * flip
        cos_in = torch.clamp_min(torch.abs(dot(sn_f, wi)), 1e-8)
        t_safe = torch.where(valid, hit.t, 1.0)
        e_dvcm = e_dvcm * (t_safe * t_safe) / cos_in
        e_dvc = e_dvc / cos_in
        E["tri"].append(torch.where(valid, hit.tri, 0))
        E["u"].append(torch.where(valid, hu, 0.0))
        E["v"].append(torch.where(valid, hv, 0.0))
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        p = vx.params

        # s = 0: an emissive hit (m = i+1)
        le = vx.le
        pdf_direct_a = view.lights.pdf_area_of(tri_c)
        cos_l = torch.clamp_min(dot(gn, wi), 1e-8)
        pdf_emit_hit = pdf_direct_a * cos_l * INV_PI
        if i == 0:
            w = torch.ones(n, **f32)
        else:
            w = 1.0 / (1.0 + (pdf_direct_a * e_dvcm + pdf_emit_hit * e_dvc))
        msk = valid & ((le.x + le.y + le.z) > 0.0) & (dot(gn, wi) > 0.0)
        strategies.append((0, i + 1, select(msk, Vec3(e_thr.x * le.x * w, e_thr.y * le.y * w,
                                                      e_thr.z * le.z * w))))

        # s = 1: connect to y_0 (m = i+2)
        if i + 2 <= K:
            to_l = lpos - pos
            ld2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
            ld = torch.sqrt(ld2)
            wo = to_l * (1.0 / ld)
            cos_at_l = dot(ln, -wo)
            wo_loc = to_local(wo, t_b, b_b, sn_f)
            fe, pdf_fwd, pdf_rev = _eval_both(p, wi_loc, wo_loc, lobes)
            cos_here = torch.abs(wo_loc.z)
            abs_cos_l = torch.clamp_min(torch.abs(cos_at_l), 1e-8)
            pdf_l_sa = lpdf_a * ld2 / abs_cos_l
            w_light = pdf_fwd / torch.clamp_min(pdf_l_sa, 1e-20)
            emis_full = lpdf_a * torch.clamp_min(cos_at_l, 0.0) * INV_PI
            w_cam = (emis_full * cos_here / (torch.clamp_min(pdf_l_sa, 1e-20) * abs_cos_l)
                     * (e_dvcm + e_dvc * pdf_rev))
            w = 1.0 / (w_light + 1.0 + w_cam)
            able = valid & has_light & (cos_at_l > 1e-6) & ((fe.x + fe.y + fe.z) > 0.0)
            so = pt_mod._offset_origin(pos, gn, wo, eps)
            occ = ctx.tr.anyhit(so, wo, 0.0, ld * (1.0 - 1e-3), able)
            n_rays = n_rays + _fsum(able)
            scale = cos_here * w / torch.clamp_min(pdf_l_sa, 1e-20)
            strategies.append((1, i + 2, select(able & ~occ, Vec3(
                e_thr.x * fe.x * lle.x * scale, e_thr.y * fe.y * lle.y * scale,
                e_thr.z * fe.z * lle.z * scale))))

        # s >= 2: connect to the stored light vertex y_{j+1} (m = i+j+3)
        for j in range(LS):
            m_total = i + j + 3
            if m_total > K:
                break
            lv = lvx[j]
            vwi = L["wi"][j]
            vflip = torch.where(dot(lv.gn, vwi) < 0.0, -1.0, 1.0)
            vsn_f = lv.sn * vflip
            vthr = L["thr"][j]
            conn = lv.pos - pos
            cd2 = torch.clamp_min(dot(conn, conn), 1e-12)
            cd = torch.sqrt(cd2)
            cdir = conn * (1.0 / cd)
            co_loc = to_local(cdir, t_b, b_b, sn_f)
            fe, pdf_e_fwd, pdf_e_rev = _eval_both(p, wi_loc, co_loc, lobes)
            cos_e = torch.abs(co_loc.z)
            lt_b, lb_b = orthonormal_basis(vsn_f)
            lwi_loc = to_local(vwi, lt_b, lb_b, vsn_f)
            lwo_loc = to_local(-cdir, lt_b, lb_b, vsn_f)
            fl, pdf_l_fwd, pdf_l_rev = _eval_both(lv.params, lwi_loc, lwo_loc, lobes)
            cos_lv = torch.abs(lwo_loc.z)
            g = cos_e * cos_lv / cd2
            pdf_e_fwd_a = pdf_e_fwd * cos_lv / cd2
            pdf_l_fwd_a = pdf_l_fwd * cos_e / cd2
            w_light = pdf_e_fwd_a * (L["dvcm"][j] + L["dvc"][j] * pdf_l_rev)
            w_cam = pdf_l_fwd_a * (e_dvcm + e_dvc * pdf_e_rev)
            w = 1.0 / (w_light + 1.0 + w_cam)
            able = (valid & L["valid"][j] & (g > 0.0) & ((fe.x + fe.y + fe.z) > 0.0)
                    & ((fl.x + fl.y + fl.z) > 0.0))
            so = pt_mod._offset_origin(pos, gn_f, cdir, eps)
            occ = ctx.tr.anyhit(so, cdir, 0.0, cd * (1.0 - 1e-3), able)
            n_rays = n_rays + _fsum(able)
            amp = torch.where(able & ~occ, g * w, 0.0)
            # no where: a NaN comes out as in JAX
            strategies.append((j + 2, m_total, Vec3(
                e_thr.x * fe.x * vthr.x * fl.x * amp, e_thr.y * fe.y * vthr.y * fl.y * amp,
                e_thr.z * fe.z * vthr.z * fl.z * amp)))

        if i + 1 < K:
            sm = bsdf_sample(p, wi_loc, u0(40 + 3 * i), u0(41 + 3 * i), u0(42 + 3 * i), lobes)
            pdf_rev_w = f_and_pdf(p, sm.wo, wi_loc, lobes)[1]
            cos_out = torch.clamp_min(torch.abs(sm.wo.z), 1e-8)
            pdf_fwd_w = torch.clamp_min(sm.pdf, 1e-20)
            e_dvc = (cos_out / pdf_fwd_w) * (e_dvc * pdf_rev_w + e_dvcm)
            e_dvcm = 1.0 / pdf_fwd_w
            wo_w = to_world(sm.wo, t_b, b_b, sn_f)
            alive = valid & sm.valid
            e_thr = select(alive, Vec3(e_thr.x * sm.g.x, e_thr.y * sm.g.y, e_thr.z * sm.g.z))
            o = pt_mod._offset_origin(pos, gn, wo_w, eps)
            d = wo_w

    # ---- phase 2: the per-chain RIS pick (mlt.py:941-968) ----
    lums = torch.stack([_lum(*c) for (_, _, c) in strategies], dim=1)
    lums = torch.where(torch.isfinite(lums), torch.clamp_min(lums, 0.0), 0.0)
    weight = lums.sum(dim=1)
    cdf = torch.cumsum(lums, dim=1)
    u_pick = u0(90) * torch.clamp_min(weight, 1e-30)
    pick = torch.clamp_max((cdf <= u_pick[:, None]).sum(dim=1), len(strategies) - 1)
    s_arr = torch.tensor([st[0] for st in strategies], dtype=torch.int32, device=dev)
    m_arr = torch.tensor([st[1] for st in strategies], dtype=torch.int32, device=dev)
    s_pick, m_pick = s_arr[pick], m_arr[pick]
    is_env = s_pick < 0
    esc = _sel(torch.clamp(m_pick - 1, 0, K - 1), d_rec)
    zero = torch.zeros(n, **f32)
    state = ChainState(
        uv_x=uv0_x, uv_y=uv0_y,
        e_tri=torch.stack(E["tri"], 1), e_u=torch.stack(E["u"], 1),
        e_v=torch.stack(E["v"], 1),
        l0_tri=ltri, l0_u=lb0, l0_v=lb1,
        l_tri=torch.stack(L["tri"], 1), l_u=torch.stack(L["u"], 1),
        l_v=torch.stack(L["v"], 1),
        s=torch.where(is_env, 0, s_pick).to(torch.int32), m=m_pick,
        val_x=zero, val_y=zero, val_z=zero, weight=weight,
        env=is_env, env_dx=esc.x, env_dy=esc.y, env_dz=esc.z)
    return state, n_rays


# ---------------------------------------------------------------------------
# Phase 3: the chain steps
# ---------------------------------------------------------------------------

def _retrace_side(ctx: _Ctx, rng: _Rand, step: int, enable: bool, n_seg: Tensor,
                  d_old: Vec3, d_new: Vec3, start_pos: Vec3, old: List[_Vtx],
                  tri_old: Tensor, u_old: Tensor, v_old: Tensor, dim0: int, V: Vec3,
                  j_old: Tensor, j_new: Tensor, ok_new: Tensor, n_rays: Tensor,
                  offset_first: bool, start_gn: Vec3 = None):
    """One side re-traced with per-vertex perturbations (mlt.py:307-446):
    traces the new chain, multiplies f * cos_out of each new scatter into V
    and the H densities into j_old / j_new. `old` are the side's stored
    vertices, re-interpolated. Returns (new tri, u, v columns, the new
    vertices with their incoming directions, V, j_old, j_new, ok_new,
    n_rays)."""
    opts = ctx.opts
    S = tri_old.shape[1]
    eps, lobes, radius = opts.ray_eps, opts.lobes, opts.perturbation_radius
    pe, ph = opts.exp_perturbations, opts.h_perturbations
    prev_pos, prev_gn = start_pos, start_gn
    new_tri, new_u, new_v, new_vx, new_in = [], [], [], [], []
    for j in range(S):
        seg_active = (j + 1) <= n_seg
        o = old[j]
        origin = (prev_pos if j == 0 and not offset_first
                  else pt_mod._offset_origin(prev_pos, prev_gn, d_new, eps))
        act = seg_active & ok_new
        hit, hu, hv, nv = _trace(ctx, origin, d_new, act)
        n_rays = n_rays + _fsum(act)
        got = hit.hit_mask
        ok_new = ok_new & (~seg_active | got)
        keep = seg_active & got
        new_tri.append(torch.where(keep, hit.tri, tri_old[:, j]))
        new_u.append(torch.where(keep, hu, u_old[:, j]))
        new_v.append(torch.where(keep, hv, v_old[:, j]))
        new_vx.append(nv)
        new_in.append(-d_new)
        if j + 1 < S:
            # the direction of the next segment, leaving slot j
            nseg_active = (j + 2) <= n_seg
            out_old = normalize(old[j + 1].pos - o.pos)
            if enable:
                u_pv = rng.u(step, dim0 + 7 * j)
                zz0 = rng.u(step, dim0 + 7 * j + 1)
                zz1 = rng.u(step, dim0 + 7 * j + 2)
                choose_exp = u_pv < pe
                choose_h = (u_pv >= pe) & (u_pv < pe + ph)
                out_exp = exp_spherical_perturbation(out_old, zz0, zz1, radius)
                o_eta = _eta_of(o.params, o.sn, -d_old)
                n_eta = _eta_of(nv.params, nv.sn, -d_new)
                out_h = h_perturbation(-d_old, out_old, o.sn, o_eta, -d_new, nv.sn, n_eta,
                                       zz0, zz1, radius)
                out_new = _where3(choose_exp, out_exp, _where3(choose_h, out_h, out_old))
            else:  # step 0 re-traces the seed: no kernel is chosen
                out_new = out_old
            # f * cos_out of the new scatter at slot j (mlt_core.h:582-603)
            f_n = _frame_f(nv.params, nv.sn, -d_new, out_new, lobes)
            cos_n = torch.abs(dot(nv.sn, out_new))
            V = Vec3(torch.where(nseg_active, V.x * f_n.x * cos_n, V.x),
                     torch.where(nseg_active, V.y * f_n.y * cos_n, V.y),
                     torch.where(nseg_active, V.z * f_n.z * cos_n, V.z))
            if enable:
                use_h = choose_h & nseg_active
                hd_o = h_perturbation_density(-d_old, out_old, o.sn, o_eta)
                hd_n = h_perturbation_density(-d_new, out_new, nv.sn, n_eta)
                j_old = j_old * torch.where(use_h, hd_o, 1.0)
                j_new = j_new * torch.where(use_h, hd_n, 1.0)
            d_old, d_new = out_old, out_new
            prev_pos, prev_gn = nv.pos, nv.gn
    return new_tri, new_u, new_v, new_vx, new_in, V, j_old, j_new, ok_new, n_rays


def _pix_of(ctx: _Ctx, ux: Tensor, uy: Tensor) -> Tensor:
    px = torch.clamp((ux * ctx.res_x).to(torch.int32), 0, ctx.res_x - 1)
    py = torch.clamp((uy * ctx.res_y).to(torch.int32), 0, ctx.res_y - 1)
    return (py * ctx.res_x + px).long()


def _splat_pair(splat: Tensor, pix_old: Tensor, val_old: Vec3, amp_old: Tensor,
                pix_new: Tensor, val_new: Vec3, amp_new: Tensor) -> None:
    """Both expected-value splats, the old path's first (mlt.py:1192-1203)."""
    splat.index_add_(0, pix_old, torch.stack([val_old.x * amp_old, val_old.y * amp_old,
                                              val_old.z * amp_old], -1))
    splat.index_add_(0, pix_new, torch.stack([val_new.x * amp_new, val_new.y * amp_new,
                                              val_new.z * amp_new], -1))


def _perturb_step(ctx: _Ctx, rng: _Rand, step: int, state: ChainState, splat: Tensor):
    """One perturbation step of every chain (mlt.py:973-1225); adds its
    splats into `splat`. Returns (state, rays)."""
    view, opts, n = ctx.view, ctx.opts, ctx.n
    dev = view.device
    eps, lobes, radius = opts.ray_eps, opts.lobes, opts.perturbation_radius
    enable = step > 0
    n_rays = torch.zeros((), dtype=torch.float32, device=dev)
    is_env = state.env
    s = state.s
    t_count = state.m + 1 - s  # eye vertices incl. the camera
    # env chains store x_1..x_{m-1}: m-1 traced segments, the m-th escapes
    n_eye_seg = torch.where(is_env, state.m - 1, t_count - 1)
    n_light_seg = torch.clamp_min(s - 1, 0)

    # ---- the screen perturbation ----
    if enable:
        do_scr = rng.u(step, 100) < opts.screen_perturbations
        r_mag = bounded_exp_map(rng.u(step, 102), 1.0e-4, radius)
        phi = rng.u(step, 101) * TWO_PI
        nuv_x = state.uv_x + torch.where(do_scr, torch.cos(phi) * r_mag, 0.0)
        nuv_y = state.uv_y + torch.where(do_scr, torch.sin(phi) * r_mag, 0.0)
        nuv_x = nuv_x - torch.floor(nuv_x)
        nuv_y = nuv_y - torch.floor(nuv_y)
    else:
        nuv_x, nuv_y = state.uv_x, state.uv_y

    ones = torch.ones(n, dtype=torch.float32, device=dev)
    V = Vec3(ones, ones, ones)
    j_old = j_new = ones
    ok_new = torch.ones(n, dtype=torch.bool, device=dev)

    # ---- the eye side ----
    K, LS = state.e_tri.shape[1], state.l_tri.shape[1]
    e_old = [_interp(ctx, state.e_tri[:, j], state.e_u[:, j], state.e_v[:, j]) for j in range(K)]
    (e_ntri, e_nu, e_nv, e_new, e_in, V, j_old, j_new, ok_new, n_rays) = _retrace_side(
        ctx, rng, step, enable, n_eye_seg, ctx.cam.sample_direction(state.uv_x, state.uv_y),
        ctx.cam.sample_direction(nuv_x, nuv_y), _cam_eye(ctx), e_old, state.e_tri, state.e_u,
        state.e_v, 110, V, j_old, j_new, ok_new, n_rays, offset_first=False)

    # ---- the light side: y_0 fixed, its emission direction perturbed ----
    l0 = _interp(ctx, state.l0_tri, state.l0_u, state.l0_v)
    l_old = [_interp(ctx, state.l_tri[:, j], state.l_u[:, j], state.l_v[:, j])
             for j in range(LS)]
    demit_old = normalize(l_old[0].pos - l0.pos)
    pe_tot = opts.exp_perturbations + opts.h_perturbations
    has_l_side = s >= 2
    if enable:
        do_emit = (rng.u(step, 302) < pe_tot) & has_l_side
        demit_new = _where3(do_emit, exp_spherical_perturbation(
            demit_old, rng.u(step, 300), rng.u(step, 301), radius), demit_old)
    else:
        demit_new = demit_old
    # the emission's Le * cos_out on the new path (Lambert EDF)
    cos_e_new = torch.abs(dot(l0.gn, demit_new))
    V = Vec3(torch.where(has_l_side, V.x * l0.le.x * cos_e_new, V.x),
             torch.where(has_l_side, V.y * l0.le.y * cos_e_new, V.y),
             torch.where(has_l_side, V.z * l0.le.z * cos_e_new, V.z))
    ok_new = ok_new & (~has_l_side | (dot(l0.gn, demit_new) > 0.0))
    (l_ntri, l_nu, l_nv, l_new, l_in, V, j_old, j_new, ok_new, n_rays) = _retrace_side(
        ctx, rng, step, enable, n_light_seg, demit_old, demit_new, l0.pos, l_old, state.l_tri,
        state.l_u, state.l_v, 400, V, j_old, j_new, ok_new, n_rays, offset_first=True,
        start_gn=l0.gn)

    # ---- the end terms ----
    # env chains: the end surface vertex is x_{m-1} (slot m-2)
    ex = _sel(torch.where(is_env, state.m - 2, t_count - 2), [
        (*v, d_in) for v, d_in in zip(e_new, e_in)])
    ex_pos, ex_gn, ex_sn, ex_p, ex_le, ex_in = ex
    is_s0 = (s == 0) & ~is_env
    is_s1 = s == 1
    is_s2 = s >= 2

    # s = 0: the eye end vertex must be emissive, facing the path
    v_s0 = select(dot(ex_gn, ex_in) > 0.0, ex_le)

    # the connection target: y_0 (s = 1) or the light end vertex y_{s-1}
    ly = _sel(s - 2, [(v.pos, v.sn, v.params, d_in) for v, d_in in zip(l_new, l_in)])
    ly_pos = _where3(is_s2, ly[0], l0.pos)
    ly_sn = _where3(is_s2, ly[1], l0.gn)
    ly_p = _where_t(is_s2, ly[2], l0.params)
    ly_in = ly[3]
    conn = ly_pos - ex_pos
    cd2 = torch.clamp_min(dot(conn, conn), 1e-12)
    cd = torch.sqrt(cd2)
    cdir = conn * (1.0 / cd)
    et, eb = orthonormal_basis(ex_sn)
    ex_in_loc = to_local(ex_in, et, eb, ex_sn)
    f_eye = bsdf_f(ex_p, ex_in_loc, to_local(cdir, et, eb, ex_sn), lobes)

    # env chains: perturb the stored escape, require it still escapes, and
    # multiply the end scatter's f * cos and the environment's radiance
    esc_old = Vec3(state.env_dx, state.env_dy, state.env_dz)
    if enable:
        do_esc = is_env & (rng.u(step, 602) < pe_tot)
        esc_new = _where3(do_esc, exp_spherical_perturbation(
            esc_old, rng.u(step, 600), rng.u(step, 601), radius), esc_old)
    else:
        esc_new = esc_old
    f_esc = bsdf_f(ex_p, ex_in_loc, to_local(esc_new, et, eb, ex_sn), lobes)
    cos_esc = torch.abs(dot(ex_sn, esc_new))
    so_esc = pt_mod._offset_origin(ex_pos, ex_gn, esc_new, eps)
    esc_active = is_env & ok_new & (state.weight > 0.0)
    hit_esc = ctx.tr.closest(so_esc, esc_new, eps, _BIG, esc_active)
    n_rays = n_rays + _fsum(esc_active)
    ok_new = ok_new & (~is_env | ~hit_esc.hit_mask)
    e_l = scene_env_radiance(view, esc_new)
    v_env = Vec3(f_esc.x * cos_esc * e_l.x, f_esc.y * cos_esc * e_l.y, f_esc.z * cos_esc * e_l.z)

    cos_ex = torch.abs(dot(ex_sn, cdir))
    cos_ly = torch.abs(dot(ly_sn, cdir))
    g_conn = cos_ex * cos_ly / cd2
    # the light end's factor: Le (s = 1, front side only) or its BSDF (s >= 2)
    f_ly = _frame_f(ly_p, ly_sn, ly_in, -cdir, lobes)
    lfac = _where3(is_s1, select(dot(l0.gn, -cdir) > 0.0, l0.le), f_ly)
    v_conn = Vec3(f_eye.x * g_conn * lfac.x, f_eye.y * g_conn * lfac.y,
                  f_eye.z * g_conn * lfac.z)
    so = pt_mod._offset_origin(ex_pos, ex_gn, cdir, eps)
    need_vis = ~is_s0 & ~is_env & ok_new
    occ = ctx.tr.anyhit(so, cdir, 0.0, cd * (1.0 - 1e-3), need_vis)
    n_rays = n_rays + _fsum(need_vis)
    v_conn = select(~occ, v_conn)

    v_end = _where3(is_env, v_env, _where3(is_s0, v_s0, v_conn))
    V = select(ok_new, Vec3(V.x * v_end.x, V.y * v_end.y, V.z * v_end.z))
    V = select(torch.isfinite(V.x + V.y + V.z), V)

    # ---- MH accept / reject with the expected-value splats ----
    lum_new = _lum(*V)
    lum_old = _lum(state.val_x, state.val_y, state.val_z)
    q_new = lum_new * j_new
    q_old = lum_old * j_old
    ar = torch.where(q_old > 0.0, torch.clamp_max(q_new / torch.clamp_min(q_old, 1e-30), 1.0),
                     torch.where(q_new > 0.0, 1.0, 0.0))
    live = state.weight > 0.0
    w_chain = state.weight
    amp_old = torch.where(live & (lum_old > 0.0),
                          w_chain * (1.0 - ar) / torch.clamp_min(lum_old, 1e-30), 0.0)
    amp_new = torch.where(live & (lum_new > 0.0), w_chain * ar / torch.clamp_min(lum_new, 1e-30),
                          0.0)
    _splat_pair(splat, _pix_of(ctx, state.uv_x, state.uv_y),
                Vec3(state.val_x, state.val_y, state.val_z), amp_old,
                _pix_of(ctx, nuv_x, nuv_y), V, amp_new)

    accept = live & (rng.u(step, 999) < ar)
    acc2 = accept[:, None]
    upd2 = lambda old, cols: torch.where(acc2, torch.stack(cols, 1), old)
    acc_env = accept & is_env
    state = state._replace(
        uv_x=torch.where(accept, nuv_x, state.uv_x), uv_y=torch.where(accept, nuv_y, state.uv_y),
        e_tri=upd2(state.e_tri, e_ntri), e_u=upd2(state.e_u, e_nu), e_v=upd2(state.e_v, e_nv),
        l_tri=upd2(state.l_tri, l_ntri), l_u=upd2(state.l_u, l_nu), l_v=upd2(state.l_v, l_nv),
        val_x=torch.where(accept, V.x, state.val_x), val_y=torch.where(accept, V.y, state.val_y),
        val_z=torch.where(accept, V.z, state.val_z),
        env_dx=torch.where(acc_env, esc_new.x, state.env_dx),
        env_dy=torch.where(acc_env, esc_new.y, state.env_dy),
        env_dz=torch.where(acc_env, esc_new.z, state.env_dz))
    return state, n_rays


def _st_swap_step(ctx: _Ctx, rng: _Rand, step: int, state: ChainState, splat: Tensor):
    """The ST swap (mlt.py:449-648): relabel (s, t) -> (s -+ 1, t +- 1) on
    the same geometric path, accepted with lum(val f_B / f_A) / lum(val),
    the stored value rescaled by the geometric ratio; no ray is traced.
    Adds its splats into `splat`; returns the state."""
    n, lobes = ctx.n, ctx.opts.lobes
    dev = ctx.view.device
    S_e, LS = state.e_tri.shape[1], state.l_tri.shape[1]
    s = state.s
    t_count = state.m + 1 - s
    live = state.weight > 0.0  # every live chain deposits
    movable = live & ~state.env  # env chains sit the swap out

    cols = lambda a: [a[:, j] for j in range(a.shape[1])]
    # ---- the three pivot vertices ----
    ie = torch.clamp(t_count - 2, 0, S_e - 1)  # the eye end slot
    ie2 = torch.clamp(t_count - 3, 0, S_e - 1)  # the eye slot before it (t >= 3)
    e1_tri, e1_u, e1_v = (_sel(ie, cols(a)) for a in (state.e_tri, state.e_u, state.e_v))
    e1 = _interp(ctx, e1_tri, e1_u, e1_v)
    e2 = _interp(ctx, *(_sel(ie2, cols(a)) for a in (state.e_tri, state.e_u, state.e_v)))
    il = torch.clamp(s - 2, 0, LS - 1)  # the light end slot (s >= 2)
    il2 = torch.clamp(s - 3, 0, LS - 1)  # the light slot before it (s >= 3)
    light = lambda idx, a, a0, cond: torch.where(cond, _sel(idx, cols(a)), a0)
    y1_tri, y1_u, y1_v = (light(il, a, a0, s >= 2) for a, a0 in (
        (state.l_tri, state.l0_tri), (state.l_u, state.l0_u), (state.l_v, state.l0_v)))
    y1 = _interp(ctx, y1_tri, y1_u, y1_v)
    y2 = _interp(ctx, *(light(il2, a, a0, s >= 3) for a, a0 in (
        (state.l_tri, state.l0_tri), (state.l_u, state.l0_u), (state.l_v, state.l0_v))))

    eps2 = 1e-12
    dC_v = y1.pos - e1.pos  # the connection edge e1 <-> y1 (s >= 1)
    dC2 = torch.clamp_min(dot(dC_v, dC_v), eps2)
    dirC = dC_v * (1.0 / torch.sqrt(dC2))
    dA_v = e1.pos - e2.pos  # the eye edge e2 -> e1 (t >= 3)
    dA2 = torch.clamp_min(dot(dA_v, dA_v), eps2)
    dirA = dA_v * (1.0 / torch.sqrt(dA2))
    dB_v = y1.pos - y2.pos  # the light edge y2 -> y1 (s >= 2)
    dB2 = torch.clamp_min(dot(dB_v, dB_v), eps2)
    dirB = dB_v * (1.0 / torch.sqrt(dB2))

    # ---- the direction coin and what is feasible ----
    coin = rng.u(step, 770) < 0.5
    do_down = coin & movable & (s >= 1) & (t_count <= S_e)
    do_up = ~coin & movable & (t_count >= 3) & (s <= LS)

    ones = torch.ones(n, dtype=torch.float32, device=dev)
    one3 = Vec3(ones, ones, ones)
    # DOWN (y1 moves): f_A = f(y1; -dirB, -dirC), f_B the roles swapped;
    # s == 1 moves y_0 itself (the emission end): no BSDF factor
    fA_d = _where3(s >= 2, _frame_f(y1.params, y1.sn, -dirB, -dirC, lobes), one3)
    fB_d = _where3(s >= 2, _frame_f(y1.params, y1.sn, -dirC, -dirB, lobes), one3)
    cos_y1_C = torch.abs(dot(y1.sn, dirC))
    cos_y1_B = torch.abs(dot(y1.sn, dirB))
    geom_d = torch.where(s >= 2, cos_y1_B * dC2 / torch.clamp_min(cos_y1_C * dB2, eps2),
                         dC2 / torch.clamp_min(cos_y1_C, 1e-8))
    # UP (e1 moves): f_A = f(e1; -dirA, dirC), f_B the roles swapped; s == 0
    # moves an emissive eye end: no BSDF factor
    fA_u = _where3(s >= 1, _frame_f(e1.params, e1.sn, -dirA, dirC, lobes), one3)
    fB_u = _where3(s >= 1, _frame_f(e1.params, e1.sn, dirC, -dirA, lobes), one3)
    cos_e1_A = torch.abs(dot(e1.sn, dirA))
    cos_e1_C = torch.abs(dot(e1.sn, dirC))
    geom_u = torch.where(s >= 1, cos_e1_A * dC2 / torch.clamp_min(cos_e1_C * dA2, eps2),
                         cos_e1_A / torch.clamp_min(dA2, eps2))
    fA = _where3(do_down, fA_d, fA_u)
    fB = _where3(do_down, fB_d, fB_u)
    geom = torch.where(do_down, geom_d, geom_u)

    # a channel that one factorization zeroes and the other does not cannot
    # be rescaled: reject (the reverse move rejects alike)
    tiny = 1e-20
    cons = (((fA.x > tiny) == (fB.x > tiny)) & ((fA.y > tiny) == (fB.y > tiny))
            & ((fA.z > tiny) == (fB.z > tiny)) & torch.isfinite(geom) & (geom > 0.0))
    do = (do_down | do_up) & cons
    fr = lambda b, a: torch.where(a > tiny, b / torch.clamp_min(a, tiny), 0.0)
    val = Vec3(state.val_x, state.val_y, state.val_z)
    v_f = Vec3(val.x * fr(fB.x, fA.x), val.y * fr(fB.y, fA.y), val.z * fr(fB.z, fA.z))
    lum_old = _lum(*val)
    a_ratio = torch.where(lum_old > 0.0, _lum(*v_f) / torch.clamp_min(lum_old, 1e-30), 0.0)
    ar = torch.where(do, torch.clamp_max(a_ratio, 1.0), 0.0)

    # the expected-value splats, both at the chain's pixel
    pix = _pix_of(ctx, state.uv_x, state.uv_y)
    w_chain = state.weight
    amp_old = torch.where(live & (lum_old > 0.0),
                          w_chain * (1.0 - ar) / torch.clamp_min(lum_old, 1e-30), 0.0)
    v_n = Vec3(v_f.x * geom, v_f.y * geom, v_f.z * geom)
    lum_new = _lum(*v_n)
    amp_new = torch.where(live & (lum_new > 0.0), w_chain * ar / torch.clamp_min(lum_new, 1e-30),
                          0.0)
    _splat_pair(splat, pix, val, amp_old, pix, v_n, amp_new)

    accept = do & (rng.u(step, 771) < ar)
    acc_d = accept & do_down
    acc_u = accept & do_up

    def put(arr, tgt, value, acc):
        return torch.stack([torch.where(acc & (tgt == j), value, arr[:, j])
                            for j in range(arr.shape[1])], 1)

    tgt_e = t_count - 1  # the new eye end slot after DOWN
    tgt_l = s - 1  # the new light end slot after UP (s >= 1)
    up_hi = acc_u & (s >= 1)
    up_l0 = acc_u & (s == 0)
    return state._replace(
        e_tri=put(state.e_tri, tgt_e, y1_tri, acc_d), e_u=put(state.e_u, tgt_e, y1_u, acc_d),
        e_v=put(state.e_v, tgt_e, y1_v, acc_d),
        l_tri=put(state.l_tri, tgt_l, e1_tri, up_hi), l_u=put(state.l_u, tgt_l, e1_u, up_hi),
        l_v=put(state.l_v, tgt_l, e1_v, up_hi),
        l0_tri=torch.where(up_l0, e1_tri, state.l0_tri),
        l0_u=torch.where(up_l0, e1_u, state.l0_u), l0_v=torch.where(up_l0, e1_v, state.l0_v),
        s=torch.where(acc_d, s - 1, torch.where(acc_u, s + 1, s)),
        val_x=torch.where(accept, v_n.x, state.val_x),
        val_y=torch.where(accept, v_n.y, state.val_y),
        val_z=torch.where(accept, v_n.z, state.val_z))


def is_swap_step(opts: MLTOptions, step: int) -> bool:
    """Whether step `step` of a pass is an ST swap (mlt.py:1232)."""
    freq = opts.st_swap_frequency
    return freq > 0 and step > 0 and step % freq == freq - 1


def _n_chains(opts: MLTOptions, res_x: int, res_y: int) -> int:
    return opts.n_chains if opts.n_chains > 0 else res_x * res_y


def presample(view: SceneView, opts: MLTOptions, res_x: int, res_y: int, instance: int,
              seed: int = 0):
    """Phases 1 and 2 of a pass: the seeded ChainState and its rays."""
    n = _n_chains(opts, res_x, res_y)
    return _presample(_make_ctx(view, opts, res_x, res_y, n),
                      _Rand.create(seed, instance, n, view.device))


def step(view: SceneView, opts: MLTOptions, res_x: int, res_y: int, instance: int,
         seed: int, state: ChainState, step_idx: int):
    """Chain step `step_idx` of the pass (instance, seed) from `state`: a
    perturbation or, on the swap cadence, an ST swap. Returns (state, the
    step's un-normalized (H*W, 3) splat, its rays)."""
    n = state.uv_x.shape[0]
    ctx = _make_ctx(view, opts, res_x, res_y, n)
    rng = _Rand.create(seed, instance, n, view.device)
    splat = torch.zeros((res_x * res_y, 3), dtype=torch.float32, device=view.device)
    if is_swap_step(opts, step_idx):
        return (_st_swap_step(ctx, rng, step_idx, state, splat), splat,
                torch.zeros((), device=view.device))
    state, rays = _perturb_step(ctx, rng, step_idx, state, splat)
    return state, splat, rays


def render_pass(view: SceneView, opts: MLTOptions, res_x: int, res_y: int, instance: int,
                seed: int = 0):
    """One MLT pass (mlt.py:651-1252): ((H*W, 3) image in the PT pass's
    per-pixel-mean units, rays)."""
    n = _n_chains(opts, res_x, res_y)
    ctx = _make_ctx(view, opts, res_x, res_y, n)
    rng = _Rand.create(seed, instance, n, view.device)
    state, n_rays = _presample(ctx, rng)
    splat = torch.zeros((res_x * res_y, 3), dtype=torch.float32, device=view.device)
    for i in range(opts.steps_per_pass):
        if is_swap_step(opts, i):
            state = _st_swap_step(ctx, rng, i, state, splat)
        else:
            state, rays = _perturb_step(ctx, rng, i, state, splat)
            n_rays = n_rays + rays
    norm = float(res_x * res_y) / (float(n) * float(opts.steps_per_pass))
    return splat * norm, n_rays


def render_pass_fb(view: SceneView, opts: MLTOptions, res_x: int, res_y: int, instance: int,
                   seed: int = 0) -> "pt_mod._PassOutput":
    """The context's pass (mlt.py:1255-1284): the chains' image plus the
    directly visible environment (pt.direct_env_image, a QMC term outside
    the chains' path space) in COMPOSITED."""
    img, n_rays = render_pass(view, opts, res_x, res_y, instance, seed)
    env_img, env_rays = pt_mod.direct_env_image(view, res_x, res_y, instance, seed)
    img = img + env_img
    return pt_mod.composited_output(Vec3(img[:, 0], img[:, 1], img[:, 2]), n_rays + env_rays,
                                    torch.zeros(res_x * res_y, device=view.device))
