"""Wavefront path tracer with NEE + MIS (fermat_tpu/integrators/pt.py:476-1207).

One progressive pass traces the full pixel grid as masked lanes: every
per-bounce stage is a flat (N,)-lane tensor op, and the bounce loop is a
plain Python loop (the JAX version peels bounce 0 and runs a fori_loop over
the rest). Per bounce: closest trace (K1a) -> one 52-column shade-row fetch
(K2) -> constant-environment miss term -> emissive hit with MIS (pdf_area
fetch, K2) -> mesh-light NEE with f_split (light-row fetch, K2) and a
shadow any-hit (K1b) -> BSDF sample -> Russian roulette -> channel routing
-> hard zeroing of dead lanes. The G-buffer is taken at the first hit.
tracer="mega" runs the same pass as one kernel launch (ops/pt_mega.py).

Runs under torch.no_grad(): autograd through the pass (the `.detach()`
counterparts of pt.py:227-255) belongs to the differentiable slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fermat_tpu_torch.bsdf.composite import GLOSSY_REFL, BsdfParams, f_split
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.camera import generate_camera_rays
from fermat_tpu_torch.core.math import (Vec3, dot, orthonormal_basis, select, to_local,
                                        to_world)
from fermat_tpu_torch.core.rng import M32, TiledSequence
from fermat_tpu_torch.core.sampling import power_heuristic
from fermat_tpu_torch.ops import pt_mega
from fermat_tpu_torch.ops.trace import trace_any, trace_closest
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor

# framebuffer routing channels (pathtracer_vertex_processor.h)
CH_DIRECT = 0
CH_DIFFUSE = 1
CH_SPECULAR = 2

DENSE_MAX_TRIANGLES = 4096


class PTOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's PTOptions (pt.py:65-115).
    Values outside this slice raise NotImplementedError in render_pass."""

    max_path_length: int = 6
    direct_lighting_nee: bool = True
    direct_lighting_bsdf: bool = True
    indirect_lighting_nee: bool = True
    indirect_lighting_bsdf: bool = True
    visible_lights: bool = True
    nee: str = "mesh"
    rr: bool = True
    rr_start_bounce: int = 2
    queue_compaction: bool = False
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    sampler: str = "owen"
    dims_per_bounce: int = 8
    lobes: tuple = (True, True, True, True)
    clearcoat: bool = False
    glossy_model: str = "ggx"
    texture_filter: str = "bilinear"
    detach_nee: bool = False
    detach_emissive: bool = False
    debug_nee_no_shadow: bool = False
    debug_nee_fixed_light: bool = False
    debug_nee_cheap_eval: bool = False


def _trace_mode(n_triangles: int, opts: PTOptions) -> str:
    """tracer="mega" runs the whole pass in the megakernel (pt.py:502-511);
    the dense tracer serves tracer="auto" up to 4096 triangles
    (pt.py:214-224), as in JAX, which never routes "auto" to the megakernel.
    The wrappers launch the CUDA kernels on a CUDA view and run the plain
    versions on a CPU view."""
    if opts.tracer == "mega":
        return "mega"
    if opts.tracer != "auto":
        raise NotImplementedError(
            f"tracer={opts.tracer!r}: only 'auto' (dense) and 'mega' are ported")
    if n_triangles > DENSE_MAX_TRIANGLES:
        raise NotImplementedError(
            f"{n_triangles} triangles: scenes over {DENSE_MAX_TRIANGLES} need the "
            "large-scene tracer, a later slice")
    return "dense"


def _check_options(opts: PTOptions) -> None:
    later = {
        "sampler": (opts.sampler, "owen"),
        "nee": (opts.nee, "mesh"),
        "glossy_model": (opts.glossy_model, "ggx"),
        "queue_compaction": (opts.queue_compaction, False),
        "detach_nee": (opts.detach_nee, False),
        "detach_emissive": (opts.detach_emissive, False),
        "debug_nee_no_shadow": (opts.debug_nee_no_shadow, False),
        "debug_nee_fixed_light": (opts.debug_nee_fixed_light, False),
        "debug_nee_cheap_eval": (opts.debug_nee_cheap_eval, False),
    }
    for name, (value, ported) in later.items():
        if value != ported:
            raise NotImplementedError(f"PTOptions.{name}={value!r} is outside this slice")


class _PassOutput(NamedTuple):
    """Raw per-pixel sample images of one progressive pass ((N,) lanes)."""

    direct: Vec3
    diffuse: Vec3
    specular: Vec3
    composited: Vec3
    diffuse_albedo: Vec3
    specular_albedo: Vec3
    depth: Tensor
    tri: Tensor
    normal: Vec3
    position: Vec3
    uv: Tensor
    material: Tensor
    rays: Tensor  # scalar: closest + shadow rays traced this pass
    rays_lane: Tensor  # (N,) rays traced per lane


class Carry(NamedTuple):
    """Per-lane wavefront state threaded through the bounce loop."""

    o: Vec3
    d: Vec3
    thr: Vec3  # path throughput (includes 1/pdf)
    alive: Tensor
    prev_pdf: Tensor  # solid-angle pdf of the ray's BSDF sample
    channel: Tensor  # routing decided at the first scatter
    l_direct: Vec3
    l_diffuse: Vec3
    l_specular: Vec3
    g_depth: Tensor  # G-buffer at the first hit
    g_tri: Tensor
    g_normal: Vec3
    g_pos: Vec3
    g_uv: Tensor
    g_mat: Tensor
    g_diff_albedo: Vec3
    g_spec_albedo: Vec3
    rays: Tensor  # scalar f32 — total traced rays (closest + shadow)
    rays_lane: Tensor  # (N,) f32
    pix_u: Tensor  # pixel id per lane (int64 holding uint32)


def _offset_origin(pos: Vec3, gn: Vec3, d: Vec3, eps: float) -> Vec3:
    """Offset along the geometric normal on the side the ray departs; the
    side is taken with dot(gn, d) >= 0 (pt.py:433-436)."""
    side = torch.where(dot(gn, d) >= 0.0, 1.0, -1.0)
    return pos + gn * (side * eps)


def _add_routed(c: Carry, contrib: Vec3, mask: Tensor, channel: Tensor) -> Carry:
    def acc(dst: Vec3, sel: int) -> Vec3:
        return dst + select(mask & (channel == sel), contrib)

    return c._replace(
        l_direct=acc(c.l_direct, CH_DIRECT),
        l_diffuse=acc(c.l_diffuse, CH_DIFFUSE),
        l_specular=acc(c.l_specular, CH_SPECULAR),
    )


def _count(c: Carry, mask: Tensor) -> Carry:
    m = mask.to(torch.float32)
    return c._replace(rays=c.rays + m.sum(), rays_lane=c.rays_lane + m)


def _bounce(b: int, c: Carry, view: SceneView, opts: PTOptions, seq: TiledSequence,
            tris: Tensor, shade_tab: Tensor) -> Carry:
    first = b == 0
    n = c.alive.shape[0]
    eps = opts.ray_eps
    hit = trace_closest(tris, c.o, c.d, eps, 3.0e38, c.alive)
    c = _count(c, c.alive)
    valid = c.alive & hit.hit_mask
    missed = c.alive & ~hit.hit_mask
    # constant environment light: miss lanes pick up thr * env; no NEE
    # strategy samples the env, so the weight is 1
    env = view.env
    c = _add_routed(c, Vec3(c.thr.x * env[0], c.thr.y * env[1], c.thr.z * env[2]),
                    missed, c.channel)

    tri_c = torch.clamp_min(hit.tri, 0)
    sh = view.mesh.shade_fetch(tri_c, hit.u, hit.v, shade_tab)
    pos, gn, mats = sh.pos, sh.gn, sh.mats
    wi = -c.d  # towards the previous vertex

    # flip the shading frame to the ray side of the geometric surface
    flip = torch.where(dot(gn, wi) < 0.0, -1.0, 1.0)
    sn_f = sh.sn * flip
    t_b, b_b = orthonormal_basis(sn_f)
    wi_loc = to_local(wi, t_b, b_b, sn_f)
    params = BsdfParams.from_materials(mats)

    if first:  # G-buffer at the first hit
        c = c._replace(
            g_depth=torch.where(valid, hit.t, float("inf")),
            g_tri=torch.where(valid, hit.tri, -1),
            g_normal=select(valid, sn_f),
            g_pos=select(valid, pos),
            g_uv=torch.where(valid[:, None], sh.uv, 0.0),
            g_mat=torch.where(valid, sh.mat_id, -1),
            g_diff_albedo=select(valid, params.diffuse),
            g_spec_albedo=select(valid, params.specular),
        )

    # ---- emissive hit (pathtracer_core.h shade_vertex head) ----
    is_direct = b == 1
    show = opts.visible_lights if first else (
        opts.direct_lighting_bsdf or opts.indirect_lighting_bsdf)
    if show:
        le = select(dot(gn, wi) > 0.0, mats.emissive)
        if first:
            w_mis = torch.ones(n, dtype=torch.float32, device=pos.x.device)
        else:
            # MIS vs the NEE at vertex b-1 that could have sampled this emitter
            pdf_area = view.lights.pdf_area_of(tri_c)
            # miss lanes carry t = 3e38: t*t would overflow
            t_safe = torch.where(valid, hit.t, 1.0)
            dist2 = t_safe * t_safe
            cos_l = torch.abs(dot(gn, wi))
            pdf_sa = pdf_area * dist2 / torch.clamp_min(cos_l, 1e-8)
            nee_mask = opts.direct_lighting_nee if is_direct else opts.indirect_lighting_nee
            w_mis = power_heuristic(c.prev_pdf, pdf_sa) if nee_mask else torch.ones_like(pdf_sa)
            show_mask = opts.direct_lighting_bsdf if is_direct else opts.indirect_lighting_bsdf
            w_mis = w_mis * float(show_mask)
        contrib = Vec3(c.thr.x * le.x * w_mis, c.thr.y * le.y * w_mis, c.thr.z * le.z * w_mis)
        c = _add_routed(c, contrib, valid, c.channel)

    # ---- NEE: mesh lights ----
    base_dim = (2 + b * opts.dims_per_bounce) & M32
    nee_on = opts.direct_lighting_nee if first else opts.indirect_lighting_nee
    if nee_on:
        ul0, ul1, ul2 = seq.sample_3d(c.pix_u, base_dim)
        lpos, ln, lle, lpdf_a, _ = view.lights.sample(ul0, ul1, ul2)
        to_l = lpos - pos
        dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
        dist = torch.sqrt(dist2)
        wo = to_l * (1.0 / dist)
        cos_l = dot(ln, -wo)  # the light must face the shading point
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        fd, fg, bsdf_pdf = f_split(params, wi_loc, wo_loc, opts.lobes, opts.clearcoat,
                                   opts.glossy_model)
        pdf_sa = lpdf_a * dist2 / torch.clamp_min(torch.abs(cos_l), 1e-8)
        bsdf_on = opts.direct_lighting_bsdf if first else opts.indirect_lighting_bsdf
        w_mis = power_heuristic(pdf_sa, bsdf_pdf) if bsdf_on else torch.ones_like(pdf_sa)
        cos_s = torch.abs(wo_loc.z)
        able = (valid & view.lights.has_lights & (cos_l > 1e-6) & (pdf_sa > 1e-12)
                & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0))
        so = _offset_origin(pos, gn, wo, eps)
        occluded = trace_any(tris, so, wo, 0.0, dist * (1.0 - 1e-3), able)
        c = _count(c, able)
        lit = able & ~occluded
        scale = cos_s * w_mis / torch.clamp_min(pdf_sa, 1e-12)
        wX = c.thr.x * lle.x * scale
        wY = c.thr.y * lle.y * scale
        wZ = c.thr.z * lle.z * scale
        if first:
            # split routing: diffuse part -> DIFFUSE, glossy -> SPECULAR
            c = c._replace(
                l_diffuse=c.l_diffuse + select(lit, Vec3(fd.x * wX, fd.y * wY, fd.z * wZ)),
                l_specular=c.l_specular + select(lit, Vec3(fg.x * wX, fg.y * wY, fg.z * wZ)),
            )
        else:
            contrib = Vec3((fd.x + fg.x) * wX, (fd.y + fg.y) * wY, (fd.z + fg.z) * wZ)
            c = _add_routed(c, contrib, lit, c.channel)

    # ---- BSDF scatter + Russian roulette (shade_vertex tail) ----
    ub0, ub1, ub2 = seq.sample_3d(c.pix_u, (base_dim + 3) & M32)
    s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, opts.lobes, opts.clearcoat,
                    opts.glossy_model)
    wo_world = to_world(s.wo, t_b, b_b, sn_f)
    new_thr = Vec3(c.thr.x * s.g.x, c.thr.y * s.g.y, c.thr.z * s.g.z)
    new_alive = valid & s.valid & ((s.g.x + s.g.y + s.g.z) > 0.0)
    # pt.py:1104-1112; before rr_start_bounce q = 1, which keeps every lane
    # (u < 1) and scales by exactly 1, so the step is skipped there
    if opts.rr and not first and b >= opts.rr_start_bounce:
        u_rr = seq.sample_1d(c.pix_u, (base_dim + 6) & M32)
        q = torch.clamp(torch.maximum(torch.maximum(new_thr.x, new_thr.y), new_thr.z),
                        0.05, 1.0)
        new_alive = new_alive & (u_rr < q)
        inv_q = 1.0 / q
        new_thr = Vec3(new_thr.x * inv_q, new_thr.y * inv_q, new_thr.z * inv_q)

    # route the channel at the first scatter: glossy lobes -> SPECULAR
    if first:
        new_channel = torch.where(
            valid,
            torch.where(s.component >= GLOSSY_REFL, CH_SPECULAR, CH_DIFFUSE).to(torch.int32),
            c.channel)
    else:
        new_channel = c.channel

    # hard-zero dead lanes so their garbage values can never leak
    new_thr = select(new_alive, new_thr)
    return c._replace(
        o=_offset_origin(pos, gn, wo_world, eps),
        d=wo_world,
        thr=new_thr,
        alive=new_alive,
        prev_pdf=s.pdf,
        channel=new_channel,
    )


@torch.no_grad()
def render_pass(view: SceneView, opts: PTOptions, res_x: int, res_y: int,
                instance: int, seed: int = 0,
                tables: "pt_mega.MegaTables | None" = None) -> _PassOutput:
    """Trace one progressive pass over the full pixel grid
    (PathTracer::render, pathtracer_impl.h:197) on the view's device.
    tracer="mega" hands the whole pass to ops/pt_mega.render_pass_mega, with
    `tables` (built from the view when None); other tracers take none."""
    if _trace_mode(view.mesh.n_triangles, opts) == "mega":
        return pt_mega.render_pass_mega(view, opts, res_x, res_y, instance, seed, tables)
    if tables is not None:
        raise ValueError(f"tables are the megakernel's; tracer={opts.tracer!r} takes none")
    _check_options(opts)
    dev = view.device
    n = res_x * res_y
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    seq = TiledSequence.create(seed=seed).set_instance(instance)
    jx, jy = seq.sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)
    # built once per pass, outside the bounce loop
    shade_tab = view.mesh.shade_rows()
    tris = view.mesh.tri_soup()

    zero3 = Vec3.zeros(n, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    c = Carry(
        o=o, d=d,
        thr=Vec3.full(n, 1.0, 1.0, 1.0, dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
        prev_pdf=torch.zeros(n, **f32),
        channel=torch.full((n,), CH_DIRECT, **i32),
        l_direct=zero3, l_diffuse=zero3, l_specular=zero3,
        g_depth=torch.full((n,), float("inf"), **f32),
        g_tri=torch.full((n,), -1, **i32),
        g_normal=zero3, g_pos=zero3,
        g_uv=torch.zeros((n, 2), **f32),
        g_mat=torch.full((n,), -1, **i32),
        g_diff_albedo=zero3, g_spec_albedo=zero3,
        rays=torch.zeros((), **f32),
        rays_lane=torch.zeros(n, **f32),
        pix_u=pix,
    )
    # bounce 0 always runs, as the JAX version peels it (pt.py:1168-1177)
    for b in range(max(opts.max_path_length, 1)):
        c = _bounce(b, c, view, opts, seq, tris, shade_tab)

    comp = c.l_direct + c.l_diffuse + c.l_specular
    return _PassOutput(
        direct=c.l_direct, diffuse=c.l_diffuse, specular=c.l_specular, composited=comp,
        diffuse_albedo=c.g_diff_albedo, specular_albedo=c.g_spec_albedo,
        depth=c.g_depth, tri=c.g_tri, normal=c.g_normal, position=c.g_pos,
        uv=c.g_uv, material=c.g_mat, rays=c.rays, rays_lane=c.rays_lane,
    )
