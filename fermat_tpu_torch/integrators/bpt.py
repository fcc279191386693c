"""Bidirectional path tracer with recursive MIS (fermat_tpu/integrators/bpt.py).

One pass: light subpaths are walked first and stored as L-1 slots of (N,)
lanes (JAX's (N, L) SoA slot arrays, kept here as a list of per-slot tensors:
JAX's `set_slot` rewrites all 21 slot arrays each bounce). Light tracing
(t=1) projects every stored light vertex to the camera and splats it with
`index_add_` into an (H*W, 3) image. The eye walk then runs PT-style with, at
each eye vertex: the s=0 emissive strategy, the s=1 NEE strategy, and s>=2
vertex connections against this lane's own light slots. The slots are
stacked once into (L-1)*N lanes, so light tracing is one evaluation and one
shadow launch over all of them, and so are each eye vertex's connections,
both sides' BSDFs in one evaluation: per lane the arithmetic of JAX's
per-slot loops, with the slots added in JAX's order. MIS is SmallVCM's
recursive dVCM/dVC form with the balance heuristic; light-subpath scatters
and light-side connection evals carry the adjoint shading-normal correction
(`_adjoint_corr`); textures modulate both subpaths (`_textured_params`,
level 0). Sampling decisions are detached at JAX's stop_gradient sites.

The pass traces with the view's own closest and any-hit tracers
(integrators/pt._raw_tracers: the dense K1a/K1b up to 4096 triangles, the
frontier K5a/K5b above that on a view with a cluster table, or the tracer
`tracer` names); shadow sets are ignored, as in JAX (bpt.py:200). Where the
closest tracer returns no barycentrics (the frontier route) the hit's (u, v)
are derived from the ray and the fetched triangle, as the PT pass does: a
literal port would shade such hits at the triangle's first vertex. JAX never
meets that route off a TPU. tracer="mega" raises NotImplementedError (JAX
has no BPT megakernel; its pass quietly walks a BVH there).

`single_connection` and `rr` are fields JAX's pass never reads; they do
nothing here either.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from fermat_tpu_torch.bsdf.composite import BsdfParams, f_and_pdf
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.camera import CameraSampler, generate_camera_rays
from fermat_tpu_torch.core.math import Vec3, dot, orthonormal_basis, select, to_local, to_world
from fermat_tpu_torch.core.rng import TiledSequence
from fermat_tpu_torch.core.sampling import INV_PI, square_to_cosine_hemisphere
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.scene.envmap import scene_env_radiance
from fermat_tpu_torch.scene.textures import modulate
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor


class BPTOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's BPTOptions (bpt.py:58-76)."""

    max_path_length: int = 6  # vertices per subpath
    light_tracing: bool = True  # t=1 strategies (camera splats)
    single_connection: bool = False  # read by no pass (JAX's neither)
    rr: bool = False  # read by no pass (JAX's neither)
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    dims_per_bounce: int = 8
    # the env tail trace off the last eye vertex: None = on when the view has
    # an environment map or a nonzero constant env
    env_tail: "object" = None


class LightVertices(NamedTuple):
    """The light-vertex slots (JAX's (N, L) SoA LightVertices), each field a
    list of per-slot (N,) lanes, stacked once after the light walk."""

    pos: List[Vec3]
    n: List[Vec3]  # shading normal, flipped to the incoming side
    gn: List[Vec3]  # geometric normal, flipped
    wi: List[Vec3]  # unit direction towards the previous vertex
    thr: List[Vec3]  # path throughput up to and including this vertex
    d_vcm: List[Tensor]
    d_vc: List[Tensor]
    # the textured material params at the vertex (JAX keeps its material id
    # and uv, material 0 at uv 0 where the slot is not valid: such lanes
    # add nothing)
    params: List[BsdfParams]
    valid: List[Tensor]


def _sg(*xs):
    return tuple(x.detach() for x in xs)


def _eval_both(params: BsdfParams, wi_loc: Vec3, wo_loc: Vec3, lobes):
    """f(wi->wo), pdf(wi->wo), pdf(wo->wi): the reverse pdf feeds the MIS
    recursion (bpt.py:117-122)."""
    f, pdf_fwd = f_and_pdf(params, wi_loc, wo_loc, lobes)
    _, pdf_rev = f_and_pdf(params, wo_loc, wi_loc, lobes)
    return (f, *_sg(pdf_fwd, pdf_rev))


def _textured_params(view: SceneView, mats, uv: Tensor) -> BsdfParams:
    """Material params of the hit lanes' material rows `mats`, the diffuse
    and specular albedos modulated by their maps at uv (N, 2), level 0
    (bpt.py:125-150)."""
    params = BsdfParams.from_materials(mats)
    if view.has_textures:
        uu, vv = uv[:, 0], uv[:, 1]
        params = params._replace(
            diffuse=modulate(params.diffuse, view.textures.sample(mats.diffuse_map, uu, vv)),
            specular=modulate(params.specular, view.textures.sample(mats.specular_map, uu, vv)))
    return params


def _adjoint_corr(wi: Vec3, wo: Vec3, sn: Vec3, gn: Vec3) -> Tensor:
    """Veach eq. 5.19 importance-transport correction for shading normals,
    |wi.sn * wo.gn| / |wi.gn * wo.sn|, clamped at 8 (bpt.py:153-162)."""
    num = torch.abs(dot(wi, sn) * dot(wo, gn))
    den = torch.clamp_min(torch.abs(dot(wi, gn) * dot(wo, sn)), 1e-8)
    return torch.clamp_max(num / den, 8.0)


def _sample_light(view: SceneView, u0: Tensor, u1: Tensor, u2: Tensor):
    """(pos, normal, Le, pdf_area) of a point on the full light table, Le
    modulated by the emitter's map on a textured view (bpt.py:211-221)."""
    if view.has_textures:
        pos, n, le, pdf_a, _, lu, lv, emap = view.lights.sample_ex(u0, u1, u2)
        return pos, n, modulate(le, view.textures.sample(emap, lu, lv)), pdf_a
    return view.lights.sample(u0, u1, u2)[:4]


class _Slots(NamedTuple):
    """The L-1 light slots stacked slot-major into S*N lanes (slot j at lanes
    j*N..(j+1)*N-1), with what the eye side reads of them that does not
    depend on the eye vertex (the shading frame and wi in it): computed once
    a pass."""

    pos: Vec3
    n: Vec3
    gn: Vec3
    wi: Vec3
    thr: Vec3
    d_vcm: Tensor
    d_vc: Tensor
    valid: Tensor
    t_b: Vec3
    b_b: Vec3
    wi_loc: Vec3
    params: BsdfParams


def _cat(xs):
    """Tensors, Vec3s or BsdfParams concatenated along the lanes."""
    if isinstance(xs[0], tuple):
        return type(xs[0])(*(_cat([x[k] for x in xs]) for k in range(len(xs[0]))))
    return torch.cat(xs)


def _stack_slots(lv: LightVertices) -> _Slots:
    pos, n, gn, wi, thr, d_vcm, d_vc, params, valid = (_cat(f) for f in lv)
    t_b, b_b = orthonormal_basis(n)
    return _Slots(pos, n, gn, wi, thr, d_vcm, d_vc, valid, t_b, b_b, to_local(wi, t_b, b_b, n),
                  params)


def _own(x):
    """x (a tensor, or a tuple of them) copied out of the fetched shade rows
    that its fields view, so that a stored light slot does not keep the
    whole (N, 52) fetch alive."""
    if isinstance(x, tuple):
        return type(x)(*(_own(c) for c in x))
    return x.clone()


def _per_lane(x: Tensor, s: int) -> Tensor:
    """(S*N,) slot-major lanes folded to (N,) sums."""
    return x.view(s, -1).sum(0)


def _has_env(view: SceneView, opts: BPTOptions) -> bool:
    """Whether the env tail runs (bpt.py:566-592), resolved on the host once
    a pass."""
    if opts.env_tail is not None:
        return bool(opts.env_tail)
    if view.env_map is not None:
        return True
    return bool((view.env != 0.0).any())


def _add(acc: Vec3, m: Tensor, a: Vec3) -> Vec3:
    return Vec3(acc.x + torch.where(m, a.x, 0.0), acc.y + torch.where(m, a.y, 0.0),
                acc.z + torch.where(m, a.z, 0.0))


def render_pass(view: SceneView, opts: BPTOptions, res_x: int, res_y: int, instance: int,
                seed: int = 0, pix: Tensor = None, sequence=None,
                return_splat_list: bool = False):
    """One BPT pass (bpt.py:165-609): light subpaths, light tracing, eye
    subpaths with their connections. Returns (per-lane eye-strategy
    radiance Vec3, the (H*W, 3) light-tracing splat image, the rays
    counter, rays per lane). `pix` are the lanes' pixel ids (duplicates
    allowed), the full grid by default; `sequence` replaces the sampler
    (PSSMLT's MatrixSequence). With `return_splat_list` it also returns each
    lane's light-tracing splats as (pixel (N, L-1) int32, -1 where not lit;
    rgb (N, L-1, 3))."""
    tr = pt_mod.view_tracers(view, opts.tracer, "BPT")
    dev = view.device
    if pix is None:
        pix = torch.arange(res_x * res_y, dtype=torch.int64, device=dev)
    n = pix.shape[0]
    L = opts.max_path_length
    eps = opts.ray_eps
    dpb = opts.dims_per_bounce
    lobes = opts.lobes
    seq = sequence if sequence is not None else TiledSequence.create(seed).set_instance(instance)
    cam_sampler = CameraSampler.create(view.camera, res_x / res_y)
    f32 = dict(dtype=torch.float32, device=dev)
    n_rays = torch.zeros((), **f32)
    rays_lane = torch.zeros(n, **f32)

    def count(m: Tensor, slots: int = 1):
        """Add the rays of the (slots*N,) mask m to both counters."""
        nonlocal n_rays, rays_lane
        mf = m.to(torch.float32)
        n_rays = n_rays + mf.sum()
        rays_lane = rays_lane + (mf if slots == 1 else _per_lane(mf, slots))

    # ---- phase 1: light subpaths (bpt.py:205-320) ----
    u0, u1 = seq.sample_2d(pix, 100)
    u2 = seq.sample_1d(pix, 102)
    lpos, ln, lle, lpdf_a = _sample_light(view, u0, u1, u2)
    has_light = view.lights.has_lights & (lpdf_a > 0.0)
    ue0, ue1 = seq.sample_2d(pix, 103)
    d_loc = square_to_cosine_hemisphere(ue0, ue1)
    lt, lb = orthonormal_basis(ln)
    d0 = to_world(d_loc, lt, lb, ln)
    cos_emit = torch.clamp_min(d_loc.z, 1e-8)
    pdf_emit_w = cos_emit * INV_PI
    pdf_emit, pdf_direct = _sg(lpdf_a * pdf_emit_w, lpdf_a)
    inv_pe = torch.where(has_light, 1.0 / torch.clamp_min(pdf_emit, 1e-20), 0.0)
    thr = Vec3(lle.x * cos_emit * inv_pe, lle.y * cos_emit * inv_pe, lle.z * cos_emit * inv_pe)
    d_vcm = pdf_direct / torch.clamp_min(pdf_emit, 1e-20)
    d_vc = cos_emit / torch.clamp_min(pdf_emit, 1e-20)
    o = pt_mod._offset_origin(lpos, ln, d0, eps)
    d = d0
    alive = has_light

    table = view.mesh.shade_rows()
    lv = LightVertices([], [], [], [], [], [], [], [], [])
    for j in range(L - 1):
        hit = tr.closest(o, d, eps, 3.0e38, alive)
        count(alive)
        valid = alive & hit.hit_mask
        _, sh, _, _ = pt_mod.surface(view, tr, table, hit, o, d)
        pos, gn = sh.pos, sh.gn
        wi = -d
        flip = torch.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f = gn * flip
        sn_f = sh.sn * flip
        cos_in = torch.clamp_min(torch.abs(dot(sn_f, wi)), 1e-8)
        t_safe = torch.where(valid, hit.t, 1.0)
        params = _textured_params(view, sh.mats, sh.uv)
        dv_vcm = d_vcm * (t_safe * t_safe) / cos_in
        dv_vc = d_vc / cos_in
        for field, value in zip(lv, (pos, sn_f, gn_f, wi, thr)):
            field.append(select(valid, value))
        lv.d_vcm.append(torch.where(valid, dv_vcm, 0.0))
        lv.d_vc.append(torch.where(valid, dv_vc, 0.0))
        lv.params.append(_own(params))
        lv.valid.append(valid)

        # scatter continuation
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        ub0, ub1, ub2 = seq.sample_3d(pix, 110 + j * dpb)
        s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, lobes)
        pdf_rev, = _sg(f_and_pdf(params, s.wo, wi_loc, lobes)[1])
        cos_out = torch.clamp_min(torch.abs(s.wo.z), 1e-8)
        pdf_fwd, = _sg(torch.clamp_min(s.pdf, 1e-20))
        d_vc = cos_out / pdf_fwd * (dv_vc * pdf_rev + dv_vcm)
        d_vcm = 1.0 / pdf_fwd
        wo_world = to_world(s.wo, t_b, b_b, sn_f)
        adj = _adjoint_corr(wi, wo_world, sn_f, gn_f)
        thr = Vec3(thr.x * s.g.x * adj, thr.y * s.g.y * adj, thr.z * s.g.z * adj)
        alive = valid & s.valid
        thr = select(alive, thr)
        o = pt_mod._offset_origin(pos, gn, wo_world, eps)
        d = wo_world

    S = L - 1
    sl = _stack_slots(lv) if S else None
    del lv  # the per-slot lanes, now stacked in sl

    # ---- phase 2: light tracing, every stored vertex to the camera
    # (bpt.py:322-384), all slots at once ----
    splat = torch.zeros((res_x * res_y, 3), **f32)
    if opts.light_tracing and S:
        eye = view.camera.eye
        vp, vn, vgn, vwi, vthr = sl.pos, sl.n, sl.gn, sl.wi, sl.thr
        to_cam = Vec3(eye.x - vp.x, eye.y - vp.y, eye.z - vp.z)
        dist2 = torch.clamp_min(dot(to_cam, to_cam), 1e-12)
        dist = torch.sqrt(dist2)
        wo = to_cam * (1.0 / dist)
        ix, iy = cam_sampler.invert(-wo)
        on_screen = (ix >= 0.0) & (ix < 1.0) & (iy >= 0.0) & (iy < 1.0)
        px_i = torch.clamp((ix * res_x).to(torch.int32), 0, res_x - 1)
        py_i = torch.clamp((iy * res_y).to(torch.int32), 0, res_y - 1)
        pixel = py_i * res_x + px_i
        wo_loc = to_local(wo, sl.t_b, sl.b_b, vn)
        f, pdf_fwd, pdf_rev = _eval_both(sl.params, sl.wi_loc, wo_loc, lobes)
        adj = _adjoint_corr(vwi, wo, vn, vgn)
        f = Vec3(f.x * adj, f.y * adj, f.z * adj)
        cos_cam = torch.abs(wo_loc.z)
        # area pdf of the eye strategy generating this vertex
        cam_pdf_a, = _sg(cam_sampler.pdf(-wo, projected=False) * cos_cam / dist2)
        able = sl.valid & on_screen & (cos_cam > 1e-6) & ((f.x + f.y + f.z) > 0.0)
        so = pt_mod._offset_origin(vp, vgn, wo, eps)
        occluded = tr.anyhit(so, wo, 0.0, dist * (1.0 - 1e-3), able)
        count(able, S)
        lit = able & ~occluded
        w_light = cam_pdf_a * (sl.d_vcm + sl.d_vc * pdf_rev)
        w = 1.0 / (w_light + 1.0)
        amp = torch.where(lit, cam_pdf_a * w, 0.0)
        rgb = torch.stack([vthr.x * f.x * amp, vthr.y * f.y * amp, vthr.z * f.z * amp], -1)
        splat.index_add_(0, pixel.long(), rgb)  # slot by slot, as JAX's scatters
        splat_pix = torch.where(lit, pixel, -1).view(S, n).T
        splat_rgb = rgb.view(S, n, 3).transpose(0, 1)
    else:
        splat_pix = torch.full((n, 0), -1, dtype=torch.int32, device=dev)
        splat_rgb = torch.zeros((n, 0, 3), **f32)

    # ---- phase 3: eye subpaths with s=0, s=1 and s>=2 (bpt.py:386-564) ----
    jx, jy = seq.sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)
    cam_pdf_w, = _sg(cam_sampler.pdf(d, projected=False))
    d_vcm = 1.0 / torch.clamp_min(cam_pdf_w, 1e-20)
    d_vc = torch.zeros(n, **f32)
    thr = Vec3.full(n, 1.0, 1.0, 1.0, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    radiance = Vec3.zeros(n, dev)
    for t_idx in range(L - 1):
        hit = tr.closest(o, d, eps, 3.0e38, alive)
        count(alive)
        valid = alive & hit.hit_mask
        # escaped eye rays pick up the environment, weight 1
        missed = alive & ~hit.hit_mask
        env_l = scene_env_radiance(view, d)
        radiance = _add(radiance, missed, Vec3(thr.x * env_l.x, thr.y * env_l.y,
                                               thr.z * env_l.z))
        tri_c, sh, _, _ = pt_mod.surface(view, tr, table, hit, o, d)
        pos, gn = sh.pos, sh.gn
        wi = -d
        flip = torch.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        gn_f = gn * flip
        sn_f = sh.sn * flip
        cos_in = torch.clamp_min(torch.abs(dot(sn_f, wi)), 1e-8)
        t_safe = torch.where(valid, hit.t, 1.0)
        d_vcm = d_vcm * (t_safe * t_safe) / cos_in
        d_vc = d_vc / cos_in
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        params = _textured_params(view, sh.mats, sh.uv)

        # s=0: an emissive hit
        le = sh.mats.emissive
        if view.has_textures:
            le = modulate(le, view.textures.sample(sh.mats.emissive_map, sh.uv[:, 0],
                                                   sh.uv[:, 1]))
        is_emitter = (le.x + le.y + le.z) > 0.0
        front = dot(gn, wi) > 0.0
        pdf_direct_a, = _sg(view.lights.pdf_area_of(tri_c))
        cos_l = torch.clamp_min(dot(gn, wi), 1e-8)
        pdf_emit, = _sg(pdf_direct_a * cos_l * INV_PI)
        if t_idx == 0:
            w = torch.ones(n, **f32)
        else:
            w = 1.0 / (1.0 + (pdf_direct_a * d_vcm + pdf_emit * d_vc))
        m = valid & is_emitter & front
        radiance = _add(radiance, m, Vec3(thr.x * le.x * w, thr.y * le.y * w,
                                          thr.z * le.z * w))

        # s=1: NEE
        un0, un1 = seq.sample_2d(pix, 200 + t_idx * dpb)
        un2 = seq.sample_1d(pix, 202 + t_idx * dpb)
        spos, snl, sle, spdf_a = _sample_light(view, un0, un1, un2)
        to_l = spos - pos
        ldist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
        ldist = torch.sqrt(ldist2)
        wo = to_l * (1.0 / ldist)
        cos_at_light = dot(snl, -wo)
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        f, pdf_fwd, pdf_rev = _eval_both(params, wi_loc, wo_loc, lobes)
        cos_here = torch.abs(wo_loc.z)
        abs_cos_light = torch.clamp_min(torch.abs(cos_at_light), 1e-8)
        pdf_light_sa, = _sg(spdf_a * ldist2 / abs_cos_light)
        w_light = pdf_fwd / torch.clamp_min(pdf_light_sa, 1e-20)
        emis_full, = _sg(spdf_a * torch.clamp_min(cos_at_light, 0.0) * INV_PI)
        w_cam = (emis_full * cos_here / (torch.clamp_min(pdf_light_sa, 1e-20) * abs_cos_light)
                 * (d_vcm + d_vc * pdf_rev))
        w = 1.0 / (w_light + 1.0 + w_cam)
        able = (valid & view.lights.has_lights & (cos_at_light > 1e-6) & (spdf_a > 0.0)
                & ((f.x + f.y + f.z) > 0.0))
        so = pt_mod._offset_origin(pos, gn, wo, eps)
        occluded = tr.anyhit(so, wo, 0.0, ldist * (1.0 - 1e-3), able)
        count(able)
        lit = able & ~occluded
        scale = cos_here * w / torch.clamp_min(pdf_light_sa, 1e-20)
        radiance = _add(radiance, lit, Vec3(thr.x * f.x * sle.x * scale,
                                            thr.y * f.y * sle.y * scale,
                                            thr.z * f.z * sle.z * scale))

        # s>=2: vertex connections to this lane's light slots, all slots at
        # once; both sides' BSDFs in one evaluation over 2*S*N lanes
        rep = lambda x: (type(x)(*(rep(c) for c in x)) if isinstance(x, tuple)
                         else x.repeat(S))
        vp, vn, vgn, vwi, vthr = sl.pos, sl.n, sl.gn, sl.wi, sl.thr
        conn = vp - rep(pos)
        cdist2 = torch.clamp_min(dot(conn, conn), 1e-12)
        cdist = torch.sqrt(cdist2)
        cdir = conn * (1.0 / cdist)
        co_loc = to_local(cdir, rep(t_b), rep(b_b), rep(sn_f))
        lwo_loc = to_local(-cdir, sl.t_b, sl.b_b, vn)
        f2, pdf_fwd2, pdf_rev2 = _eval_both(_cat([rep(params), sl.params]),
                                            _cat([rep(wi_loc), sl.wi_loc]),
                                            _cat([co_loc, lwo_loc]), lobes)
        half = S * n
        fe, fl = Vec3(*(c[:half] for c in f2)), Vec3(*(c[half:] for c in f2))
        pdf_e_fwd, pdf_l_fwd = pdf_fwd2[:half], pdf_fwd2[half:]
        pdf_e_rev, pdf_l_rev = pdf_rev2[:half], pdf_rev2[half:]
        cos_e = torch.abs(co_loc.z)
        ladj = _adjoint_corr(vwi, -cdir, vn, vgn)
        fl = Vec3(fl.x * ladj, fl.y * ladj, fl.z * ladj)
        cos_lv = torch.abs(lwo_loc.z)
        g = cos_e * cos_lv / cdist2
        pdf_e_fwd_a, pdf_l_fwd_a = _sg(pdf_e_fwd * cos_lv / cdist2, pdf_l_fwd * cos_e / cdist2)
        w_light = pdf_e_fwd_a * (sl.d_vcm + sl.d_vc * pdf_l_rev)
        w_cam = pdf_l_fwd_a * (rep(d_vcm) + rep(d_vc) * pdf_e_rev)
        w = 1.0 / (w_light + 1.0 + w_cam)
        able = (rep(valid) & sl.valid & (g > 0.0) & ((fe.x + fe.y + fe.z) > 0.0)
                & ((fl.x + fl.y + fl.z) > 0.0))
        so = pt_mod._offset_origin(rep(pos), rep(gn_f), cdir, eps)
        occluded = tr.anyhit(so, cdir, 0.0, cdist * (1.0 - 1e-3), able)
        count(able, S)
        amp = torch.where(able & ~occluded, g * w, 0.0)
        # no where: a NaN comes out as in JAX (bpt.py:538-543); the slots
        # add in JAX's order
        thr_s = rep(thr)
        add = [(thr_s.x * fe.x * vthr.x * fl.x * amp).view(S, n),
               (thr_s.y * fe.y * vthr.y * fl.y * amp).view(S, n),
               (thr_s.z * fe.z * vthr.z * fl.z * amp).view(S, n)]
        for j in range(S):
            radiance = Vec3(radiance.x + add[0][j], radiance.y + add[1][j],
                            radiance.z + add[2][j])

        # continue the eye walk
        ub0, ub1, ub2 = seq.sample_3d(pix, 300 + t_idx * dpb)
        s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, lobes)
        pdf_rev_w, = _sg(f_and_pdf(params, s.wo, wi_loc, lobes)[1])
        cos_out = torch.clamp_min(torch.abs(s.wo.z), 1e-8)
        pdf_fwd_w, = _sg(torch.clamp_min(s.pdf, 1e-20))
        d_vc = cos_out / pdf_fwd_w * (d_vc * pdf_rev_w + d_vcm)
        d_vcm = 1.0 / pdf_fwd_w
        wo_world = to_world(s.wo, t_b, b_b, sn_f)
        alive = valid & s.valid
        thr = select(alive, Vec3(thr.x * s.g.x, thr.y * s.g.y, thr.z * s.g.z))
        o = pt_mod._offset_origin(pos, gn, wo_world, eps)
        d = wo_world

    # the env tail: the escape ray off the last eye vertex (bpt.py:566-592)
    if _has_env(view, opts):
        hit = tr.closest(o, d, eps, 3.0e38, alive)
        count(alive)
        env_t = scene_env_radiance(view, d)
        radiance = _add(radiance, alive & ~hit.hit_mask,
                        Vec3(thr.x * env_t.x, thr.y * env_t.y, thr.z * env_t.z))

    if not return_splat_list:
        return radiance, splat, n_rays, rays_lane
    return radiance, splat, n_rays, rays_lane, splat_pix, splat_rgb


def render_pass_fb(view: SceneView, opts: BPTOptions, res_x: int, res_y: int, instance: int,
                   seed: int = 0, pix: Tensor = None) -> "pt_mod._PassOutput":
    """The context's pass (bpt.py:612-650): the eye-strategy radiance plus
    the light-tracing splats of each lane's pixel in COMPOSITED, the other
    channels and the G-buffer empty."""
    rad, splat, n_rays, rays_lane = render_pass(view, opts, res_x, res_y, instance, seed, pix)
    idx = (torch.arange(rad.x.shape[0], device=view.device) if pix is None else pix.long())
    s = splat[idx]
    return pt_mod.composited_output(Vec3(rad.x + s[:, 0], rad.y + s[:, 1], rad.z + s[:, 2]),
                                    n_rays, rays_lane)
