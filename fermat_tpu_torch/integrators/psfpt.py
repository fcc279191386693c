"""Path-space-filtering path tracer, PSFPT (fermat_tpu/integrators/psfpt.py;
Binder et al. 2018).

A PT whose indirect radiance at the vertex of depth `psf_depth` is replaced
by the average over all paths that land in the same jittered spatial-hash
cell. One pass factors each path's contribution as

    L = L_direct + thr_psf * L_at_psf

where L_at_psf is accumulated with throughput RELATIVE to the PSF vertex
(set to 1 there), so no path throughput is divided out. After the walk the
lanes deposit L_at_psf into the persistent HashAccumulator (the cell sums
decay by temporal_decay a pass first) and read back their cell's average;
a lane whose slot another key owns, or that has no PSF vertex, keeps its
own estimate. An optional firefly clamp bounds L_at_psf's luminance.

As in JAX: NEE samples the mesh lights only (no analytic, point,
directional or environment-map strategy; escaped rays pick up
scene_env_radiance at weight 1), no texture modulates a hit or an emitter,
and shadow rays trace the view's own geometry, no shadow set. Each hit is
shaded with the PT pass's one fetch of the shade table; above 2048
triangles the light pick is K4's over the emissive subset, the same
triangle as JAX's pick over the full table. On the frontier route (u, v)
come from the ray (pt.surface); JAX would shade those hits at u = v = 0, a
route it meets only on a TPU. tracer="mega" raises NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fermat_tpu_torch.bsdf.composite import BsdfParams, f_split
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.camera import generate_camera_rays
from fermat_tpu_torch.core.math import Vec3, dot, orthonormal_basis, select, to_local, to_world
from fermat_tpu_torch.core.rng import TiledSequence
from fermat_tpu_torch.core.sampling import power_heuristic
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.scene.envmap import scene_env_radiance
from fermat_tpu_torch.scene.spatial_hash import HashAccumulator, hash_shading_point
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor


class PsfptOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's PsfptOptions (psfpt.py:37-52)."""

    max_path_length: int = 6
    psf_depth: int = 1  # the vertex whose outgoing indirect light is filtered
    cell_size: float = 0.05  # base hash cell size
    table_size: int = 1 << 18
    temporal_decay: float = 0.85  # 0 disables temporal reuse
    firefly_clamp: float = 0.0  # clamp L_at_psf's luminance (0 = off)
    rr: bool = True
    rr_start_bounce: int = 2
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    dims_per_bounce: int = 8
    lobes: tuple = (True, True, True, True)


class PsfptState(NamedTuple):
    cells: HashAccumulator


class PsfLanes(NamedTuple):
    """Each lane's PSF vertex: its slot, key and whether it has one."""

    slot: Tensor  # (N,) int32
    key: Tensor  # (N,) int64 holding a uint32
    has: Tensor  # (N,) bool


def init_state(view: SceneView, opts: PsfptOptions) -> PsfptState:
    return PsfptState(cells=HashAccumulator.create(opts.table_size, view.device))


def sample_mesh_light(view: SceneView, u0: Tensor, u1: Tensor, u2: Tensor):
    """(pos, normal, Le, pdf_area) of JAX's view.lights.sample: K4 over the
    emissive subset where the view has one, else the full table."""
    if view.lights.compact is not None:
        return pt_mod._sample_lights_compact(view.lights.compact, u0, u1, u2)[:4]
    return view.lights.sample(u0, u1, u2)[:4]


class Vertex(NamedTuple):
    """A hit as the psfpt and ptrl walks shade it (psfpt.py:96-108,
    ptrl.py:93-105): the fetched surface, its shading frame flipped to the
    ray's side, and its material's BSDF parameters."""

    tri: Tensor  # the hit triangle, clamped at 0
    sh: object  # scene.mesh.ShadeHit
    u: Tensor  # the barycentrics the hit was shaded at
    v: Tensor
    wi: Vec3  # towards the previous vertex
    sn_f: Vec3
    t_b: Vec3
    b_b: Vec3
    wi_loc: Vec3
    params: BsdfParams


def shade(view: SceneView, tr, table: Tensor, hit, o: Vec3, d: Vec3) -> Vertex:
    tri, sh, u, v = pt_mod.surface(view, tr, table, hit, o, d)
    wi = -d
    sn_f = sh.sn * torch.where(dot(sh.gn, wi) < 0.0, -1.0, 1.0)
    t_b, b_b = orthonormal_basis(sn_f)
    return Vertex(tri, sh, u, v, wi, sn_f, t_b, b_b, to_local(wi, t_b, b_b, sn_f),
                  BsdfParams.from_materials(sh.mats))


def emissive_weight(vx: Vertex, hit, valid: Tensor, prev_pdf: Tensor,
                    pdf_area: Tensor) -> Tensor:
    """The power-heuristic weight of an emissive hit against the previous
    vertex's NEE, whose area pdf of this point is pdf_area."""
    t_safe = torch.where(valid, hit.t, 1.0)
    cos_l = torch.abs(dot(vx.sh.gn, vx.wi))
    pdf_sa = pdf_area * t_safe * t_safe / torch.clamp_min(cos_l, 1e-8)
    return power_heuristic(prev_pdf, pdf_sa)


def nee(tr, vx: Vertex, lpos: Vec3, ln: Vec3, lle: Vec3, lpdf_a: Tensor, able: Tensor,
        lobes, eps: float):
    """One light sample's NEE with MIS against BSDF sampling: (its
    contribution before the path throughput, the lanes whose shadow ray was
    traced, the lit ones). `able` are the lanes that may sample."""
    pos = vx.sh.pos
    to_l = lpos - pos
    dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
    dist = torch.sqrt(dist2)
    wo = to_l * (1.0 / dist)
    cos_l = dot(ln, -wo)
    wo_loc = to_local(wo, vx.t_b, vx.b_b, vx.sn_f)
    fd, fg, bsdf_pdf = f_split(vx.params, vx.wi_loc, wo_loc, lobes)
    pdf_sa = lpdf_a * dist2 / torch.clamp_min(torch.abs(cos_l), 1e-8)
    w_mis = power_heuristic(pdf_sa, bsdf_pdf)
    cos_s = torch.abs(wo_loc.z)
    able = (able & (cos_l > 1e-6) & (pdf_sa > 1e-12)
            & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0))
    so = pt_mod._offset_origin(pos, vx.sh.gn, wo, eps)
    occluded = tr.anyhit(so, wo, 0.0, dist * (1.0 - 1e-3), able)
    scale = cos_s * w_mis / torch.clamp_min(pdf_sa, 1e-12)
    c = Vec3((fd.x + fg.x) * lle.x * scale, (fd.y + fg.y) * lle.y * scale,
             (fd.z + fg.z) * lle.z * scale)
    return c, able, able & ~occluded


def scatter(seq, pix: Tensor, base_dim: int, vx: Vertex, thr: Vec3, valid: Tensor, b: int,
            opts):
    """The BSDF sample and Russian roulette: (the sample, its world
    direction, the throughput times its weight and 1/q, the lanes alive, q
    or None before rr_start_bounce). Dead lanes keep their throughput."""
    ub0, ub1, ub2 = seq.sample_3d(pix, base_dim + 3)
    s = bsdf_sample(vx.params, vx.wi_loc, ub0, ub1, ub2, opts.lobes)
    wo_world = to_world(s.wo, vx.t_b, vx.b_b, vx.sn_f)
    thr = thr * s.g
    alive = valid & s.valid
    q = None
    if opts.rr and b >= opts.rr_start_bounce:
        u_rr = seq.sample_1d(pix, base_dim + 6)
        q = torch.clamp(torch.maximum(torch.maximum(thr.x, thr.y), thr.z), 0.05, 1.0)
        alive = alive & (u_rr < q)
        thr = thr * (1.0 / q)
    return s, wo_world, thr, alive, q


def render_pass(view: SceneView, opts: PsfptOptions, res_x: int, res_y: int, instance: int,
                state: PsfptState, seed: int = 0, with_psf: bool = False):
    """One pass (psfpt.py:62-258). Returns (per-pixel radiance Vec3, the new
    state, the rays counter, rays per lane), and with `with_psf` also the
    lanes' PsfLanes."""
    dev = view.device
    n = res_x * res_y
    f32 = dict(dtype=torch.float32, device=dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    seq = TiledSequence.create(seed).set_instance(instance)
    tr = pt_mod.view_tracers(view, opts.tracer, "PSFPT")
    table = view.mesh.shade_rows()
    eps = opts.ray_eps
    n_rays = torch.zeros((), **f32)
    rays_lane = torch.zeros(n, **f32)

    jx, jy = seq.sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)

    zero3 = Vec3.zeros(n, dev)
    thr = Vec3.full(n, 1.0, 1.0, 1.0, dev)
    rel = zero3  # throughput relative to the PSF vertex (0 before it exists)
    thr_psf = zero3
    l_direct = zero3
    l_psf = zero3
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, **f32)
    psf_slot = torch.zeros(n, dtype=torch.int32, device=dev)
    psf_key = torch.zeros(n, dtype=torch.int64, device=dev)
    has_psf = torch.zeros(n, dtype=torch.bool, device=dev)

    def count(m: Tensor):
        nonlocal n_rays, rays_lane
        mf = m.to(torch.float32)
        n_rays = n_rays + mf.sum()
        rays_lane = rays_lane + mf

    def add(c: Vec3, mask: Tensor):
        """Route a contribution: lanes before their PSF vertex into the
        direct sum (absolute weight), lanes past it into L_at_psf (weight
        relative to the vertex)."""
        nonlocal l_direct, l_psf
        to_psf = mask & has_psf
        to_dir = mask & ~has_psf
        l_direct = l_direct + select(to_dir, thr * c)
        l_psf = l_psf + select(to_psf, rel * c)

    for b in range(opts.max_path_length):
        hit = tr.closest(o, d, eps, 3.0e38, alive)
        count(alive)
        valid = alive & hit.hit_mask
        vx = shade(view, tr, table, hit, o, d)
        pos, gn = vx.sh.pos, vx.sh.gn

        # escaped rays pick up the environment, weight 1
        add(scene_env_radiance(view, d), alive & ~hit.hit_mask)

        # emissive hits with MIS against the previous vertex's NEE
        le = select(dot(gn, vx.wi) > 0.0, vx.sh.mats.emissive)
        if b == 0:
            w_mis = torch.ones(n, **f32)
        else:
            w_mis = emissive_weight(vx, hit, valid, prev_pdf, view.lights.pdf_area_of(vx.tri))
        add(le * w_mis, valid)

        # promote this vertex to the PSF vertex
        base_dim = 2 + b * opts.dims_per_bounce
        if b == opts.psf_depth:
            uj = seq.sample_1d(pix, base_dim + 7)
            slot, key = hash_shading_point(pos, vx.sn_f, view.camera.eye, opts.cell_size,
                                           opts.table_size, uj)
            newly = valid & ~has_psf
            psf_slot = torch.where(newly, slot, psf_slot)
            psf_key = torch.where(newly, key, psf_key)
            thr_psf = Vec3(*(torch.where(newly, a, p) for a, p in zip(thr, thr_psf)))
            rel = Vec3(*(torch.where(newly, 1.0, r) for r in rel))
            has_psf = has_psf | newly

        # NEE over the mesh lights
        ul0, ul1, ul2 = seq.sample_3d(pix, base_dim)
        c, able, lit = nee(tr, vx, *sample_mesh_light(view, ul0, ul1, ul2),
                           valid & view.lights.has_lights, opts.lobes, eps)
        count(able)
        add(c, lit)

        # scatter and Russian roulette; rel keeps its value on dead lanes
        s, wo_world, thr_g, alive, q = scatter(seq, pix, base_dim, vx, thr, valid, b, opts)
        rel = rel * s.g if q is None else rel * s.g * (1.0 / q)
        thr = select(alive, thr_g)
        prev_pdf = s.pdf
        o = pt_mod._offset_origin(pos, gn, wo_world, eps)
        d = wo_world

    # the firefly clamp on each path's PSF estimate
    if opts.firefly_clamp > 0.0:
        lum = 0.2126 * l_psf.x + 0.7152 * l_psf.y + 0.0722 * l_psf.z
        # a true division (a Python dividend would multiply by a reciprocal)
        s = torch.clamp_max(torch.full_like(lum, opts.firefly_clamp)
                            / torch.clamp_min(lum, 1e-8), 1.0)
        l_psf = l_psf * s

    # fill the hash, then read each lane's cell back
    cells = state.cells.decay(opts.temporal_decay)
    cells = cells.deposit(psf_slot, psf_key, l_psf.x, l_psf.y, l_psf.z, has_psf)
    avg, ok = cells.lookup(psf_slot, psf_key)
    use = has_psf & ok
    filt = Vec3(*(torch.where(use, a, p) for a, p in zip(avg, l_psf)))
    out = Vec3(l_direct.x + thr_psf.x * filt.x, l_direct.y + thr_psf.y * filt.y,
               l_direct.z + thr_psf.z * filt.z)
    if with_psf:
        return out, PsfptState(cells=cells), n_rays, rays_lane, PsfLanes(psf_slot, psf_key,
                                                                          has_psf)
    return out, PsfptState(cells=cells), n_rays, rays_lane
