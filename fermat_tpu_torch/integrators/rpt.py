"""RPT, the reuse-based path tracer (fermat_tpu/integrators/rpt.py; Bekaert
et al. 2002).

One pass, two phases, as in JAX:

  Phase A (record): a PT walk. At the primary vertex x: the visible
  emitter, NEE with MIS against the BSDF continuation. The continuation
  hits the secondary vertex y, which is the pixel's VPL: y's NEE gives the
  incident-radiance estimate alpha2 along in_dir2, the walk continued from
  y by BSDF sampling gives alpha along in_dir (each folded with its cosine
  and pdf). The glossy part that x receives keeps the pixel's own sample.

  Phase B (reuse): the pixel grid is rolled by a per-pass offset and cut
  into tile_w x tile_h tiles of P pixels. Each receiver j evaluates every
  VPL k of its tile, C_jk = f_x^diffuse * cos * G' * [f_y alpha_k +
  f_y alpha2_k] / sum_i p(i, k) (Bekaert's pairwise MIS), and traces
  reuse_shadow_samples shadow rays to VPLs drawn from the CDF of its C_jk
  luminances.

Every hit is shaded with one fetch of the view's 52-column shade table
(K2), as the port's BPT does; the tracers are the view's own closest and
any-hit tracers (integrators/pt.view_tracers: the dense K1a/K1b up to 4096
triangles, the frontier K5a/K5b above that on a view with a cluster table),
with no shadow set, as in JAX (rpt.py:100). Above 2048 triangles a light
pick is K4's over the emissive subset (psfpt.sample_mesh_light), the same
triangle as JAX's pick over the full table. As in JAX, NEE samples the mesh
lights only (no analytic, point, directional or environment-map strategy),
no texture modulates a hit, and escaped rays take scene_env_radiance at
weight 1. Sampling decisions are detached at JAX's stop_gradient sites.

Where the port differs:
  * The pairwise phase evaluates the BSDFs over broadcast (tiles, P, 1)
    receiver and (tiles, 1, P) VPL operands, not over copies of them
    flattened to (tiles * P * P,) lanes: the same arithmetic a pair, without
    12 floats a pair of copied BSDF parameters on each side.
  * sum_i p(i, k) and the pick CDF are P sequential adds (`_sum_seq`,
    `_cumsum_seq`), the order in which XLA's CPU reduce and cumsum add;
    torch.sum and torch.cumsum add in another order, which moves the
    estimator's scale and a pick at a CDF boundary.
  * The tile offsets are hashed on the host from the pass's integer
    instance (`tile_offsets`), so the roll takes Python ints.
  * A resolution that does not tile evenly raises ValueError (JAX asserts).
  * On the frontier route, whose closest tracer returns no barycentrics,
    (u, v) come from the ray (pt.surface); JAX interpolates those hits at
    u = v = 0, a route it meets only on a TPU.
  * tracer="mega" raises NotImplementedError (JAX has no RPT megakernel).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from fermat_tpu_torch.bsdf.composite import GLOSSY_REFL, BsdfParams, f_and_pdf, f_split
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.camera import generate_camera_rays
from fermat_tpu_torch.core.math import Vec3, dot, orthonormal_basis, select, to_local, to_world
from fermat_tpu_torch.core.rng import M32, TiledSequence, _mul32, hash_u32
from fermat_tpu_torch.core.sampling import power_heuristic
from fermat_tpu_torch.integrators import psfpt as psf_mod
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.integrators.bpt import _add
from fermat_tpu_torch.scene.envmap import scene_env_radiance
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor
_BIG = 3.0e38


class RPTOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's RPTOptions (rpt.py:65-78)."""

    max_path_length: int = 6
    tile_w: int = 4  # the reuse tile is tile_w x tile_h pixels
    tile_h: int = 4
    reuse_shadow_samples: int = 2
    direct_lighting_nee: bool = True
    visible_lights: bool = True
    rr: bool = True
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    dims_per_bounce: int = 8


def _lum(v: Vec3) -> Tensor:
    return 0.2126 * v.x + 0.7152 * v.y + 0.0722 * v.z


def _sum_seq(a: Tensor, dim: int) -> Tensor:
    """Sum over `dim` (kept) by sequential adds, index 0 first."""
    parts = a.unbind(dim)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s.unsqueeze(dim)


def _cumsum_seq(a: Tensor, dim: int) -> Tensor:
    """Inclusive prefix sum over `dim` by sequential adds."""
    parts = a.unbind(dim)
    out = [parts[0]]
    for p in parts[1:]:
        out.append(out[-1] + p)
    return torch.stack(out, dim)


def tile_offsets(instance: int, seed: int, tile_w: int, tile_h: int) -> Tuple[int, int]:
    """The pass's tile roll (off_x, off_y) (rpt.py:395-396), in u32
    arithmetic on the host."""
    hx = hash_u32((_mul32(int(instance) & M32, 7919) + (int(seed) & M32)) & M32)
    hy = hash_u32((_mul32(int(instance) & M32, 104729) + ((int(seed) + 1) & M32)) & M32)
    return int(hx % tile_w), int(hy % tile_h)


def _shade(view: SceneView, tr, table: Tensor, hit, o: Vec3, d: Vec3):
    """psfpt's shaded vertex and its geometric normal flipped to the
    incoming side: rpt.py flips both normals (psfpt's vertex flips the
    shading normal alone)."""
    vx = psf_mod.shade(view, tr, table, hit, o, d)
    return vx, vx.sh.gn * torch.where(dot(vx.sh.gn, vx.wi) < 0.0, -1.0, 1.0)


def _light_towards(view: SceneView, pos: Vec3, u0: Tensor, u1: Tensor, u2: Tensor):
    """A light sample seen from pos: (Le, distance, unit direction, cosine
    at the light, the solid-angle pdf detached)."""
    lpos, ln, lle, lpdf_a = psf_mod.sample_mesh_light(view, u0, u1, u2)
    to_l = lpos - pos
    d2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
    dist = torch.sqrt(d2)
    wo = to_l * (1.0 / dist)
    cos_l = dot(ln, -wo)
    pdf_sa = (lpdf_a * d2 / torch.clamp_min(torch.abs(cos_l), 1e-8)).detach()
    return lle, dist, wo, cos_l, pdf_sa


class _Rays:
    """The rays counter (float32, as JAX's) and the rays of each pixel."""

    def __init__(self, n: int, device):
        self.total = torch.zeros((), dtype=torch.float32, device=device)
        self.lane = torch.zeros(n, dtype=torch.float32, device=device)

    def add(self, m: Tensor, lane: Optional[Tensor] = None) -> None:
        """Add the rays of the mask m; `lane` is m in pixel order where m
        is not."""
        mf = m.to(torch.float32)
        self.total = self.total + mf.sum()
        self.lane = self.lane + (mf if lane is None else lane)


class PhaseA(NamedTuple):
    """What phase A leaves for the reuse, (N,) lanes in pixel order: the
    radiance so far, the primary vertex x (its normals flipped to the
    camera's side, wi towards the camera), the VPL y and its two incident
    directions and alphas."""

    radiance: Vec3
    x_pos: Vec3
    x_gn: Vec3
    x_sn: Vec3
    x_wi: Vec3
    x_params: BsdfParams
    x_valid: Tensor
    y_pos: Vec3
    y_sn: Vec3
    y_params: BsdfParams
    y_valid: Tensor
    in_dir: Vec3  # y's continuation direction
    in_dir2: Vec3  # from y towards its light sample
    alpha: Vec3
    alpha2: Vec3


def render_pass(view: SceneView, opts: RPTOptions, res_x: int, res_y: int, instance: int,
                seed: int = 0, record: Optional[dict] = None):
    """One RPT pass (rpt.py:85-626). Returns ((N,) radiance Vec3, the rays
    counter, rays per pixel). With a dict `record`, phase A (`phase_a`, a
    PhaseA), the tile offsets and each reuse sample's (tiles, P) k_pick are
    put in it."""
    tw, th = opts.tile_w, opts.tile_h
    if res_x % tw or res_y % th:
        raise ValueError(f"RPT needs a resolution that tiles evenly: {res_x}x{res_y} by "
                         f"{tw}x{th} tiles")
    tr = pt_mod.view_tracers(view, opts.tracer, "RPT")
    seq = TiledSequence.create(seed).set_instance(instance)
    rays = _Rays(res_x * res_y, view.device)
    a = _phase_a(view, opts, tr, seq, res_x, res_y, rays)
    if record is not None:
        record["phase_a"] = a
    rad = reuse(view, opts, tr, seq, a, res_x, res_y, instance, seed, rays, record)
    return rad, rays.total, rays.lane


def _phase_a(view: SceneView, opts: RPTOptions, tr, seq, res_x: int, res_y: int,
             rays: _Rays) -> PhaseA:
    """Phase A (rpt.py:107-386): trace and record the VPLs."""
    dev = view.device
    n = res_x * res_y
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    eps = opts.ray_eps
    lobes = opts.lobes
    dpb = opts.dims_per_bounce
    table = view.mesh.shade_rows()
    has_lights = view.lights.has_lights
    count = rays.add

    jx, jy = seq.sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    hit = tr.closest(o, d, eps, _BIG, every)
    count(every)
    x_valid = hit.hit_mask
    # the directly visible environment
    radiance = select(~x_valid, scene_env_radiance(view, d))
    x, x_gn = _shade(view, tr, table, hit, o, d)

    if opts.visible_lights:
        radiance = _add(radiance, x_valid & (dot(x_gn, x.wi) > 0.0), x.sh.mats.emissive)

    # direct lighting at x: NEE with MIS against the BSDF continuation
    if opts.direct_lighting_nee:
        lle, dist, wo, cos_l, pdf_sa = _light_towards(view, x.sh.pos, *seq.sample_3d(pix, 2))
        wo_loc = to_local(wo, x.t_b, x.b_b, x.sn_f)
        fd, fg, bsdf_pdf = f_split(x.params, x.wi_loc, wo_loc, lobes)
        w_mis = power_heuristic(pdf_sa, bsdf_pdf).detach()
        cos_s = torch.abs(wo_loc.z)
        able = (x_valid & has_lights & (cos_l > 1e-6) & (pdf_sa > 1e-12)
                & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0))
        so = pt_mod._offset_origin(x.sh.pos, x_gn, wo, eps)
        occ = tr.anyhit(so, wo, 0.0, dist * (1.0 - 1e-3), able)
        count(able)
        s_ = cos_s * w_mis / torch.clamp_min(pdf_sa, 1e-12)
        radiance = _add(radiance, able & ~occ, Vec3((fd.x + fg.x) * lle.x * s_,
                                                    (fd.y + fg.y) * lle.y * s_,
                                                    (fd.z + fg.z) * lle.z * s_))

    # the continuation: sample the BSDF at x, trace to the secondary vertex y
    sx = bsdf_sample(x.params, x.wi_loc, *seq.sample_3d(pix, 5), lobes)
    d1 = to_world(sx.wo, x.t_b, x.b_b, x.sn_f)
    o1 = pt_mod._offset_origin(x.sh.pos, x_gn, d1, eps)
    go = x_valid & sx.valid
    hit_y = tr.closest(o1, d1, eps, _BIG, go)
    count(go)
    y_valid = go & hit_y.hit_mask
    # an escaped continuation: the pixel's own sky path, weight 1
    radiance = _add(radiance, go & ~hit_y.hit_mask, sx.g * scene_env_radiance(view, d1))
    y, y_gn = _shade(view, tr, table, hit_y, o1, d1)

    # the emitter seen through the continuation, MIS-weighted against NEE
    # at x (the pixel's own path: emitters are not reused)
    t_safe = torch.where(y_valid, hit_y.t, 1.0)
    pdf_sa_l = (view.lights.pdf_area_of(y.tri) * t_safe * t_safe
                / torch.clamp_min(torch.abs(dot(y_gn, y.wi)), 1e-8))
    w_em = power_heuristic(sx.pdf, pdf_sa_l).detach() if opts.direct_lighting_nee else 1.0
    y_le = y.sh.mats.emissive
    radiance = _add(radiance, y_valid & (dot(y_gn, y.wi) > 0.0),
                    Vec3(sx.g.x * y_le.x * w_em, sx.g.y * y_le.y * w_em,
                         sx.g.z * y_le.z * w_em))

    # NEE at y -> alpha2, the incident radiance of the light sample
    l2le, dist2, in_dir2, cos_l2, pdf2_sa = _light_towards(view, y.sh.pos,
                                                           *seq.sample_3d(pix, 10))
    able2 = y_valid & has_lights & (cos_l2 > 1e-6) & (pdf2_sa > 1e-12)
    so2 = pt_mod._offset_origin(y.sh.pos, y_gn, in_dir2, eps)
    occ2 = tr.anyhit(so2, in_dir2, 0.0, dist2 * (1.0 - 1e-3), able2)
    count(able2)
    inv_p2 = 1.0 / torch.clamp_min(pdf2_sa, 1e-12)
    # MIS against the continuation pdf at y (the walk below goes on by BSDF)
    wo2_loc = to_local(in_dir2, y.t_b, y.b_b, y.sn_f)
    pdf_b2 = f_split(y.params, y.wi_loc, wo2_loc, lobes)[2]
    w2_mis = power_heuristic(pdf2_sa, pdf_b2).detach()
    alpha2 = select(able2 & ~occ2, Vec3(l2le.x * inv_p2 * w2_mis, l2le.y * inv_p2 * w2_mis,
                                        l2le.z * inv_p2 * w2_mis))

    # the walk continued from y -> alpha, the radiance arriving along in_dir
    # (y's own scatter is applied again by the reuse formula)
    sy = bsdf_sample(y.params, y.wi_loc, *seq.sample_3d(pix, 13), lobes)
    in_dir = to_world(sy.wo, y.t_b, y.b_b, y.sn_f)
    alpha = Vec3.zeros(n, dev)
    thr = Vec3.full(n, 1.0, 1.0, 1.0, dev)
    alive = y_valid & sy.valid
    oz = pt_mod._offset_origin(y.sh.pos, y_gn, in_dir, eps)
    dz = in_dir
    prev_pdf = sy.pdf
    for b in range(2, opts.max_path_length):
        hz = tr.closest(oz, dz, eps, _BIG, alive)
        count(alive)
        zv = alive & hz.hit_mask
        # an escaped ray: the env radiance joins alpha, weight 1
        alpha = _add(alpha, alive & ~hz.hit_mask, thr * scene_env_radiance(view, dz))
        z, z_gn = _shade(view, tr, table, hz, oz, dz)

        # the emitter hit, MIS-weighted against NEE at the previous vertex
        tz = torch.where(zv, hz.t, 1.0)
        pdf_sa_z = (view.lights.pdf_area_of(z.tri) * tz * tz
                    / torch.clamp_min(torch.abs(dot(z_gn, z.wi)), 1e-8))
        w_z = power_heuristic(prev_pdf, pdf_sa_z).detach()
        z_le = z.sh.mats.emissive
        alpha = _add(alpha, zv & (dot(z_gn, z.wi) > 0.0),
                     Vec3(thr.x * z_le.x * w_z, thr.y * z_le.y * w_z, thr.z * z_le.z * w_z))

        # NEE at z
        lz_le, distz, woz, cos_lz, pdf_sa_lz = _light_towards(
            view, z.sh.pos, *seq.sample_3d(pix, 20 + b * dpb))
        woz_loc = to_local(woz, z.t_b, z.b_b, z.sn_f)
        fdz, fgz, pdf_bz = f_split(z.params, z.wi_loc, woz_loc, lobes)
        wz_mis = power_heuristic(pdf_sa_lz, pdf_bz).detach()
        cos_sz = torch.abs(woz_loc.z)
        ablez = (zv & has_lights & (cos_lz > 1e-6) & (pdf_sa_lz > 1e-12)
                 & ((fdz.x + fdz.y + fdz.z + fgz.x + fgz.y + fgz.z) > 0.0))
        soz = pt_mod._offset_origin(z.sh.pos, z_gn, woz, eps)
        occz = tr.anyhit(soz, woz, 0.0, distz * (1.0 - 1e-3), ablez)
        count(ablez)
        sc = cos_sz * wz_mis / torch.clamp_min(pdf_sa_lz, 1e-12)
        alpha = _add(alpha, ablez & ~occz, Vec3(thr.x * (fdz.x + fgz.x) * lz_le.x * sc,
                                                thr.y * (fdz.y + fgz.y) * lz_le.y * sc,
                                                thr.z * (fdz.z + fgz.z) * lz_le.z * sc))

        # scatter and Russian roulette
        sz = bsdf_sample(z.params, z.wi_loc, *seq.sample_3d(pix, 23 + b * dpb), lobes)
        thr = thr * sz.g
        alive = zv & sz.valid
        if opts.rr:
            u_rr = seq.sample_1d(pix, 26 + b * dpb)
            q = torch.clamp(torch.maximum(torch.maximum(thr.x, thr.y), thr.z), 0.05,
                            1.0).detach()
            alive = alive & (u_rr < q)
            thr = thr * (1.0 / q)
        thr = select(alive, thr)
        wz_world = to_world(sz.wo, z.t_b, z.b_b, z.sn_f)
        oz = pt_mod._offset_origin(z.sh.pos, z_gn, wz_world, eps)
        dz = wz_world
        prev_pdf = sz.pdf

    # the incident cosines and the sampling pdf folded into the alphas: alpha_k
    # estimates the integral of L_in * cos for its strategy
    cos_cont = torch.abs(dot(y.sn_f, in_dir))
    inv_pc = torch.where(sy.valid, 1.0 / torch.clamp_min(sy.pdf, 1e-12), 0.0)
    cos_nee = torch.abs(wo2_loc.z)
    alpha = Vec3(alpha.x * cos_cont * inv_pc, alpha.y * cos_cont * inv_pc,
                 alpha.z * cos_cont * inv_pc)
    alpha2 = alpha2 * cos_nee

    # the glossy part x receives: the pixel's own sample, not reused (the
    # lobe indicator on the sampled component)
    f_cont = f_and_pdf(y.params, to_local(in_dir, y.t_b, y.b_b, y.sn_f), y.wi_loc, lobes)[0]
    f_nee_y = f_and_pdf(y.params, wo2_loc, y.wi_loc, lobes)[0]
    lyx = Vec3(f_cont.x * alpha.x + f_nee_y.x * alpha2.x, f_cont.y * alpha.y
               + f_nee_y.y * alpha2.y, f_cont.z * alpha.z + f_nee_y.z * alpha2.z)
    inv_px = torch.where(sx.valid, 1.0 / torch.clamp_min(sx.pdf, 1e-12), 0.0)
    fx_g = _split_recv(x.params, x.wi_loc, sx.wo, lobes)[1]
    cos_x = torch.abs(sx.wo.z)
    radiance = _add(radiance, y_valid & (sx.component >= GLOSSY_REFL),
                    Vec3(fx_g.x * cos_x * inv_px * lyx.x, fx_g.y * cos_x * inv_px * lyx.y,
                         fx_g.z * cos_x * inv_px * lyx.z))
    return PhaseA(radiance, x.sh.pos, x_gn, x.sn_f, x.wi, x.params, x_valid, y.sh.pos, y.sn_f,
                  y.params, y_valid, in_dir, in_dir2, alpha, alpha2)


def reuse(view: SceneView, opts: RPTOptions, tr, seq, a: PhaseA, res_x: int, res_y: int,
          instance: int, seed: int, rays: _Rays, record: Optional[dict] = None) -> Vec3:
    """Phase B (rpt.py:388-626): the tile reuse over phase A's VPLs, traced
    with `tr` (pt.view_tracers) and sampled from `seq`; returns the pass's
    radiance."""
    dev = view.device
    n = res_x * res_y
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    eps = opts.ray_eps
    lobes = opts.lobes
    tw, th = opts.tile_w, opts.tile_h
    P = tw * th
    off_x, off_y = tile_offsets(instance, seed, tw, th)
    n_tx, n_ty = res_x // tw, res_y // th
    n_tiles = n_tx * n_ty
    if record is not None:
        record.update(offsets=(off_x, off_y), k_pick=[])

    def tile_of(t: Tensor) -> Tensor:
        img = torch.roll(t.reshape(res_y, res_x), shifts=(off_y, off_x), dims=(0, 1))
        return img.reshape(n_ty, th, n_tx, tw).permute(0, 2, 1, 3).reshape(n_tiles, P)

    def back(t: Tensor) -> Tensor:
        img = t.reshape(n_ty, n_tx, th, tw).permute(0, 2, 1, 3).reshape(res_y, res_x)
        return torch.roll(img, shifts=(-off_y, -off_x), dims=(0, 1)).reshape(n)

    tile3 = lambda v: Vec3(tile_of(v.x), tile_of(v.y), tile_of(v.z))
    # receiver j on axis 1, VPL k on axis 2
    rx = lambda v: Vec3(v.x[:, :, None], v.y[:, :, None], v.z[:, :, None])
    vk = lambda v: Vec3(v.x[:, None, :], v.y[:, None, :], v.z[:, None, :])

    def tile_params(p: BsdfParams, put) -> BsdfParams:
        """BsdfParams tiled, each field put on its side's axis."""
        f = lambda t: put(tile_of(t))
        v = lambda c: Vec3(f(c.x), f(c.y), f(c.z))
        return BsdfParams(v(p.diffuse), v(p.diffuse_trans), v(p.specular), f(p.roughness),
                          f(p.ior), f(p.opacity), v(p.reflectivity))

    T_xpos, T_xsn, T_xgn = tile3(a.x_pos), tile3(a.x_sn), tile3(a.x_gn)
    T_ypos = tile3(a.y_pos)
    T_xv, T_yv = tile_of(a.x_valid), tile_of(a.y_valid)
    ox, yk = rx(T_xpos), vk(T_ypos)
    cx = Vec3(yk.x - ox.x, yk.y - ox.y, yk.z - ox.z)
    cd2 = torch.clamp_min(cx.x * cx.x + cx.y * cx.y + cx.z * cx.z, 1e-12)
    cd = torch.sqrt(cd2)
    out = Vec3(cx.x / cd, cx.y / cd, cx.z / cd)  # (tiles, P, P)
    del cx, cd

    # receiver side: the diffuse f of x_j towards y_k and x_j's pdf of it
    T_xt, T_xb = orthonormal_basis(T_xsn)
    out_loc = to_local(out, rx(T_xt), rx(T_xb), rx(T_xsn))
    wi_loc_j = rx(to_local(tile3(a.x_wi), T_xt, T_xb, T_xsn))
    fd_jk, _fg, pdf_jk = f_split(tile_params(a.x_params, lambda t: t[:, :, None]), wi_loc_j,
                                 out_loc, lobes)
    del _fg

    # VPL side: f_y(in -> -out) and f_y(in2 -> -out), in VPL k's frame
    T_ysn = tile3(a.y_sn)
    T_yt, T_yb = orthonormal_basis(T_ysn)
    nout_loc = to_local(-out, vk(T_yt), vk(T_yb), vk(T_ysn))
    del out
    in_loc_k = vk(to_local(tile3(a.in_dir), T_yt, T_yb, T_ysn))
    in2_loc_k = vk(to_local(tile3(a.in_dir2), T_yt, T_yb, T_ysn))
    py = tile_params(a.y_params, lambda t: t[:, None, :])
    fL = f_and_pdf(py, in_loc_k, nout_loc, lobes)[0]
    fL2 = f_and_pdf(py, in2_loc_k, nout_loc, lobes)[0]

    # G' and the pairwise pdfs in area measure: p(j, k) = pdf_jk cos_y / d^2
    cos_y = torch.abs(nout_loc.z)
    cos_x_jk = torch.abs(out_loc.z)
    del nout_loc, out_loc
    gp = cos_y / cd2  # G' without the receiver's cosine (folded into f cos below)
    del cos_y, cd2
    valid_pair = T_xv[:, :, None] & T_yv[:, None, :]
    # receivers that are not valid never sample y_k: out of the MIS sum
    p_area = torch.where(valid_pair, pdf_jk.detach() * gp, 0.0)
    p_sum = _sum_seq(p_area, 1)  # sum_i p(i, k): (tiles, 1, P)
    del p_area, pdf_jk
    inv_psum = torch.where(p_sum > 0.0, 1.0 / torch.clamp_min(p_sum, 1e-30), 0.0)

    # Bekaert's estimator C_jk = f_x cos_x G' [fL alpha + fL2 alpha2] / sum_i p(i, k)
    a_k, a2_k = vk(tile3(a.alpha)), vk(tile3(a.alpha2))
    scale = cos_x_jk * gp * inv_psum
    del cos_x_jk, gp
    C = Vec3(*(torch.where(valid_pair, f_c * (l_c * a_c + l2_c * a2_c) * scale, 0.0)
               for f_c, l_c, a_c, l2_c, a2_c in zip(fd_jk, fL, a_k, fL2, a2_k)))
    del fd_jk, fL, fL2, scale, valid_pair

    # stochastic visibility: S connections a receiver from its C-luminance CDF
    lum_c = _lum(C)
    lum_c = torch.where(torch.isfinite(lum_c), torch.clamp_min(lum_c, 0.0), 0.0)
    cdf = _cumsum_seq(lum_c, 2)  # (tiles, P, P)
    tot = cdf[:, :, -1]
    S = opts.reuse_shadow_samples
    zero = torch.zeros((n_tiles, P), dtype=torch.float32, device=dev)
    acc = Vec3(zero, zero, zero)
    flat = lambda a: a.reshape(n_tiles * P)
    f3 = lambda v: Vec3(flat(v.x), flat(v.y), flat(v.z))
    able_v = flat((tot > 0.0) & T_xv)
    for si in range(S):
        r = tile_of(seq.sample_1d(pix, 60 + si)) * tot
        k_pick = torch.clamp_max((cdf <= r[:, :, None]).to(torch.int32).sum(2), P - 1)
        if record is not None:
            record["k_pick"].append(k_pick)
        kp = k_pick.long()
        pickk = lambda a: torch.gather(a, 2, kp[:, :, None])[:, :, 0]
        c_p = Vec3(pickk(C.x), pickk(C.y), pickk(C.z))
        lum_p = pickk(lum_c)
        # the shadow ray x_j -> y_{k_pick}
        ypk = Vec3(*(torch.gather(c, 1, kp) for c in T_ypos))
        to_y = ypk - T_xpos
        dd2 = torch.clamp_min(to_y.x * to_y.x + to_y.y * to_y.y + to_y.z * to_y.z, 1e-12)
        dd = torch.sqrt(dd2)
        dirn = Vec3(to_y.x / dd, to_y.y / dd, to_y.z / dd)
        so_v = pt_mod._offset_origin(f3(T_xpos), f3(T_xgn), f3(dirn), eps)
        occ_v = tr.anyhit(so_v, f3(dirn), 0.0, flat(dd) * (1.0 - 1e-3), able_v)
        rays.add(able_v, back(able_v.to(torch.float32)))
        vis = (~occ_v).reshape(n_tiles, P)
        # the estimator tot * (C_k / lum_k) * vis / S (RIS over the connections)
        amp = torch.where((lum_p > 0.0) & vis & (tot > 0.0),
                          tot / torch.clamp_min(lum_p, 1e-30) * (1.0 / S), 0.0)
        acc = Vec3(acc.x + c_p.x * amp, acc.y + c_p.y * amp, acc.z + c_p.z * amp)

    # back to pixel order, with the diffuse-received reuse added
    return Vec3(a.radiance.x + back(acc.x), a.radiance.y + back(acc.y),
                a.radiance.z + back(acc.z))


def _split_recv(p: BsdfParams, wi_loc: Vec3, wo_loc: Vec3, lobes):
    """The receiver side's diffuse and glossy f (f_split's two parts)."""
    fd, fg, _ = f_split(p, wi_loc, wo_loc, lobes)
    return fd, fg


def render_pass_fb(view: SceneView, opts: RPTOptions, res_x: int, res_y: int, instance: int,
                   seed: int = 0, pix: Tensor = None) -> "pt_mod._PassOutput":
    """The context's pass (rpt.py:635-656): the radiance in COMPOSITED, the
    other channels and the G-buffer empty."""
    if pix is not None:
        raise NotImplementedError("RPT renders the whole pixel grid (its tiles need it)")
    rad, n_rays, rays_lane = render_pass(view, opts, res_x, res_y, instance, seed)
    return pt_mod.composited_output(rad, n_rays, rays_lane)
