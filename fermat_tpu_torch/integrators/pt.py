"""Wavefront path tracer with NEE + MIS (fermat_tpu/integrators/pt.py:476-1503).

One progressive pass traces the full pixel grid as masked lanes: every
per-bounce stage is a flat (N,)-lane tensor op, and the bounce loop is a
plain Python loop (the JAX version peels bounce 0 and runs a fori_loop over
the rest). Per bounce: closest trace -> the environment's miss term (the
constant `env`, or the environment map MIS-weighted against the previous
vertex's env NEE) -> one 52-column shade-row fetch (K2) -> emissive hit with
MIS (pdf_area fetch, K2) -> NEE with f_split and a shadow any-hit per
strategy: the mesh lights, the environment map, each analytic area light
(weight 1: BSDF rays never see them), each point light and each directional
light -> BSDF sample -> Russian roulette -> channel routing -> hard zeroing
of dead lanes. The G-buffer is taken at the first hit. Each bounce takes its
sampler dimensions from one stride: dims_per_bounce, at least 10 with an
environment map (its NEE pair at +8) and at least 10 + 2 L with L area lights
(light li's pair at +10 + 2 li).

Scenes of at most 4096 triangles trace with the dense tracer (K1a/K1b) and
sample lights from the full light table. Larger scenes trace over the
cluster table with the frontier tracer (K5a/K5b), take the barycentrics
from the shade-row fetch (MeshView.shade_fetch_ray), and, above 2048
triangles, pick lights from the emissive subset with K4. tracer="cluster"
(K6a/K6b) and tracer="binned" (K7a/K7b) trace the same function over the
same table at any size and return the barycentrics themselves.
tracer="bvh", and tracer="auto" above 4096 triangles on a view without a
cluster table, walk the view's skip-link triangle BVH (ops/bvh_trace.py;
SceneView.with_bvh() makes it; from_numpy takes JAX's).
tracer="mega" runs the whole pass as one kernel launch (ops/pt_mega.py).
`NarrowPass` runs the same bounces with live lanes compacted between them;
queue_compaction=True instead permutes the live lanes of the full-width
carry into a dense prefix before each later bounce and back after the
loop, a pure lane permutation, bit-equal to the masked pass.

NEE picks its light point from the mesh-light table (nee="mesh") or
uniformly from the view's presampled VPL set (nee="vpl", whose emissive-hit
MIS density is lum(Le) / vpls.norm). glossy_model="ltc" takes the LTC
glossy lobe (bsdf/ltc.py). The debug switches debug_nee_fixed_light,
debug_nee_cheap_eval and debug_nee_no_shadow bias the mesh-light NEE as
in JAX (a fixed point light, a diffuse-only f, no shadow ray), and
detach_nee / detach_emissive detach the NEE and emissive contributions at
JAX's stop_gradient sites.
NEE shadow rays of bounce 0 trace the view's direct shadow set and those of
later bounces its indirect one, when the scene has them (materials flagged
FLAG_SHADOW_*_IGNORE); a set's tracer is chosen from its own triangle count,
so a large scene whose flagged triangles are most of it traces those shadow
rays with the dense K1b.

`render_pass` follows the caller's grad mode. Under torch.enable_grad(),
with material tensors of the view that require grad (`materials.diffuse`,
`materials.roughness`, ... as leaf tensors, see SceneView.from_numpy) or an
environment scale `env` that does, the image is differentiable in them
through torch.autograd: the detached estimator of the JAX package
(GRADIENTS.md), with a `.detach()` at each of its stop_gradient sites.
Geometry, ray directions, hit distances, sampling pdfs, MIS weights and the
Russian-roulette probability carry no gradient; the tracers run on detached
inputs. The shade fetch's backward is K2's (ops/gather.py). RenderingContext,
NarrowPass and render_pass_narrow run under torch.no_grad(); tracer="mega"
raises when a material tensor requires grad (its gradient is
ops/pt_mega.render_grad_diffuse_mega). An emissive tensor that requires grad
needs a light table built on the device from the same tensors
(MeshLightsView.build_on_device), so that NEE's Le carries its gradient; a
table that does not follow it raises. The texels take their gradient through
the atlas's `_replace(texels=leaf)`, which drops the RGBA8 mirror.

Textured views (view.textures not None) modulate the diffuse and specular
albedos at each hit by their maps before the G-buffer is taken, bilinear at
level 0 (texture_filter="bilinear", the reference's lookup) or trilinear at
a ray-cone LOD (the carry's cone_width, grown by t * cone_spread a bounce);
an emitter's emissive map scales its Le at a hit and at an NEE sample, on
the full light table and on the emissive subset, when the view's emitters
carry maps (SceneView.textured_emitters). sampler="bluenoise" takes the
blue-noise-dithered sequence (core/rng.BlueNoiseSequence).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from fermat_tpu_torch.accel.traverse import Hit
from fermat_tpu_torch.bsdf.composite import GLOSSY_MODELS, GLOSSY_REFL, BsdfParams, f_split
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.camera import generate_camera_rays
from fermat_tpu_torch.core.math import (Vec3, dot, orthonormal_basis, select, to_local,
                                        to_world)
from fermat_tpu_torch.core.rng import M32, BlueNoiseSequence, TiledSequence
from fermat_tpu_torch.core.sampling import power_heuristic, square_to_uniform_triangle
from fermat_tpu_torch.core.sampling import INV_PI
from fermat_tpu_torch.ops import pt_mega
from fermat_tpu_torch.ops.binned_trace import trace_any_binned, trace_closest_binned
from fermat_tpu_torch.ops.bvh_trace import trace_any_bvh, trace_closest_bvh
from fermat_tpu_torch.ops.cdf_gather import cdf_pick_rows
from fermat_tpu_torch.ops.cluster_trace import trace_any_cluster, trace_closest_cluster
from fermat_tpu_torch.ops.frontier_trace import trace_any_frontier, trace_closest_frontier
from fermat_tpu_torch.ops.trace import trace_any, trace_closest
from fermat_tpu_torch.scene.envmap import scene_env_radiance
from fermat_tpu_torch.scene.lights import row_sample, row_uv
from fermat_tpu_torch.scene.textures import modulate
from fermat_tpu_torch.scene.view import DENSE_MAX_TRIANGLES, SceneView

Tensor = torch.Tensor

# framebuffer routing channels (pathtracer_vertex_processor.h)
CH_DIRECT = 0
CH_DIFFUSE = 1
CH_SPECULAR = 2


class PTOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's PTOptions (pt.py:65-115).
    A name outside a field's choices raises NotImplementedError in
    render_pass."""

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


_CLUSTER_TRACERS = ("frontier", "cluster", "binned")  # they need the view's cluster table


def _trace_mode(n_triangles: int, opts: PTOptions, has_clusters: bool) -> str:
    """Which tracer serves the pass (pt.py:214-224). tracer="mega" runs the
    whole pass in the megakernel and tracer="bvh" walks the triangle BVH at
    any size; tracer="auto" takes the dense tracer up to 4096 triangles, as
    in JAX, and above that the frontier tracer on a view with a cluster
    table and the BVH walk on one without. (JAX routes "auto" above 4096
    triangles to the frontier tracer on a TPU and to its BVH walk elsewhere;
    the port takes the frontier function on every device whose view has the
    table: the wrappers launch the CUDA kernels on a CUDA view and run the
    plain versions on a CPU view.) tracer="frontier", "cluster" and "binned"
    ask for one of the three cluster-table tracers at any size; they need
    the view's cluster table, which SceneView.build makes at every size, as
    in JAX. JAX's names "brute" (its dense brute force) and "pallas" (K1)
    take the dense route at any size: the port's dense tracer is K1 on a
    CUDA view and its plain twin, the brute force, on a CPU view."""
    mode = opts.tracer
    if mode in ("brute", "pallas"):
        return "dense"
    if mode == "auto":
        if n_triangles <= DENSE_MAX_TRIANGLES:
            return "dense"
        mode = "frontier" if has_clusters else "bvh"
    if mode in ("dense", "mega", "bvh"):
        return mode
    if mode not in _CLUSTER_TRACERS:
        raise NotImplementedError(
            f"tracer={opts.tracer!r}: the tracers are 'auto', 'dense', 'brute', 'pallas', "
            "'bvh', 'frontier', 'cluster', 'binned' and 'mega'")
    if not has_clusters:
        raise NotImplementedError(
            f"{n_triangles} triangles and no cluster table: tracer {mode!r} needs one "
            "(tracer='bvh' or 'auto' walks the BVH instead)")
    return mode


class _Tracers(NamedTuple):
    closest: Callable  # (o, d, tmin, tmax, active) -> Hit
    shadow_direct: Callable  # (o, d, tmin, tmax, active) -> occluded; bounce 0's NEE
    shadow_indirect: Callable  # the later bounces' NEE
    uv_from_ray: bool  # closest returns no barycentrics (shade_fetch_ray)


def _detach_args(o: Vec3, d: Vec3, tmin, tmax, active):
    """The tracer boundary's inputs detached (pt.py:227-244, _detach_rays
    and _detach_args): traversal carries no gradient."""
    dt = lambda a: a.detach() if isinstance(a, Tensor) else a
    return (Vec3(*(c.detach() for c in o)), Vec3(*(c.detach() for c in d)), dt(tmin),
            dt(tmax), dt(active))


def _detach_hit(h: Hit) -> Hit:
    """The tracer's hit detached on the way out (pt.py:247-255, _detach_hit)."""
    return Hit(t=h.t.detach(), tri=h.tri, u=h.u.detach(), v=h.v.detach())


def _pick_tracers(view: SceneView, opts: PTOptions) -> _Tracers:
    """The pass's closest and shadow tracers (pt.py:304-374), with detached
    inputs and hits. The module's tracer names are looked up at call time,
    so a caller can swap them. The cluster and binned tracers return the
    winner's u, v from the kernel, as in JAX (pt.py:311-325 sets no
    uv_from_ray)."""
    closest, anyhit, uv_from_ray = _raw_tracers(view, opts)
    direct, indirect = _pick_shadow_anyhits(view, opts, anyhit)
    shadow = lambda f: lambda *a: f(*_detach_args(*a))
    return _Tracers(lambda *a: _detach_hit(closest(*_detach_args(*a))), shadow(direct),
                    shadow(indirect), uv_from_ray)


def _need_bvh(bvh, what: str):
    if bvh is None:
        raise ValueError(
            f"the BVH walk serves {what}, which has no BVH: build it with "
            "view.with_bvh()")
    return bvh


def _anyhit(mode: str, tris, cl, bvh, what: str) -> Callable:
    """The occlusion tracer of one geometry: the dense soup `tris`, the
    cluster table `cl` or the BVH `bvh` over `tris`, by the route `mode`."""
    if mode == "bvh":
        bvh = _need_bvh(bvh, what)
        return lambda o, d, t0, t1, a: trace_any_bvh(bvh, tris, o, d, t0, t1, a)
    if mode == "frontier":
        return lambda o, d, t0, t1, a: trace_any_frontier(cl, o, d, t0, t1, a)
    if mode == "cluster":
        return lambda o, d, t0, t1, a: trace_any_cluster(cl, o, d, t0, t1, a)
    if mode == "binned":
        return lambda o, d, t0, t1, a: trace_any_binned(cl, o, d, t0, t1, a)
    return lambda o, d, t0, t1, a: trace_any(tris, o, d, t0, t1, a)


def _raw_tracers(view: SceneView, opts: PTOptions):
    """(closest, anyhit, uv_from_ray) of the view's own geometry."""
    mode = _trace_mode(view.mesh.n_triangles, opts, view.clusters is not None)
    cl = view.clusters
    tris = view.mesh.tri_soup() if mode in ("dense", "bvh") else None
    anyhit = _anyhit(mode, tris, cl, view.bvh, "the view")
    if mode == "bvh":
        bvh = view.bvh
        return lambda o, d, t0, t1, a: trace_closest_bvh(bvh, tris, o, d, t0, t1, a), anyhit, False
    if mode == "frontier":
        return (lambda o, d, t0, t1, a: trace_closest_frontier(cl, o, d, t0, t1, a,
                                                               with_uv=False), anyhit, True)
    if mode == "cluster":
        return lambda o, d, t0, t1, a: trace_closest_cluster(cl, o, d, t0, t1, a), anyhit, False
    if mode == "binned":
        return lambda o, d, t0, t1, a: trace_closest_binned(cl, o, d, t0, t1, a), anyhit, False
    return lambda o, d, t0, t1, a: trace_closest(tris, o, d, t0, t1, a), anyhit, False


def _pick_shadow_anyhits(view: SceneView, opts: PTOptions, anyhit: Callable):
    """(direct, indirect) NEE shadow tracers honouring the materials'
    FLAG_SHADOW_*_IGNORE bits (pt.py:357-374): each over its shadow set,
    with the route its own triangle count gives; the scene's own tracer
    where the view has no such set."""
    if view.shadow_sets is None:
        return anyhit, anyhit
    return tuple(anyhit if ss is None else
                 _anyhit(_trace_mode(ss.mesh.n_triangles, opts, True), ss.tris, ss.clusters,
                         ss.bvh, "a shadow set")
                 for ss in view.shadow_sets)


class ViewTracers(NamedTuple):
    """The view's own closest and any-hit tracers of the other renderers."""

    closest: Callable  # (o, d, tmin, tmax, active) -> Hit
    anyhit: Callable  # (o, d, tmin, tmax, active) -> occluded
    uv_from_ray: bool  # closest returns no barycentrics (shade_fetch_ray)


def view_tracers(view: SceneView, tracer: str, renderer: str) -> ViewTracers:
    """The closest and any-hit tracers of the view's own geometry, with
    detached inputs and hits, for the renderers that call JAX's
    _pick_tracers: no shadow sets (bpt.py:200, psfpt.py:78, ptrl.py:77).
    tracer="mega" raises NotImplementedError: the megakernel runs the PT
    pass only (JAX's `renderer` walks a BVH under that name)."""
    popts = PTOptions(tracer=tracer)
    if _trace_mode(view.mesh.n_triangles, popts, view.clusters is not None) == "mega":
        raise NotImplementedError(
            f"tracer='mega' runs the PT pass only: there is no {renderer} megakernel (JAX's "
            f"{renderer} walks a BVH under that name)")
    closest, anyhit, uv_from_ray = _raw_tracers(view, popts)
    return ViewTracers(lambda *a: _detach_hit(closest(*_detach_args(*a))),
                       lambda *a: anyhit(*_detach_args(*a)), uv_from_ray)


def surface(view: SceneView, tr: ViewTracers, table: Tensor, hit: Hit, o: Vec3, d: Vec3):
    """(clamped tri, ShadeHit, u, v) at the hit: JAX's interpolate and the
    hit's material row in one fetch of the shade table; (u, v) from the ray
    on a route whose tracer returns none (JAX shades those hits at u = v =
    0, a route it meets only on a TPU)."""
    tri_c = torch.clamp_min(hit.tri, 0)
    if tr.uv_from_ray:
        return (tri_c, *view.mesh.shade_fetch_ray_uv(tri_c, o, d, table))
    return tri_c, view.mesh.shade_fetch(tri_c, hit.u, hit.v, table), hit.u, hit.v


def _sample_lights_compact(compact: Tuple[Tensor, Tensor], ul0: Tensor, ul1: Tensor,
                           ul2: Tensor):
    """lights.sample() over the emissive subset (pt.py:169-211): the pick and
    the row fetch are one K4 call; the same triangle as a pick over all rows.
    Returns (pos, n, Le, pdf_area, (uv_u, uv_v, emissive map))."""
    rows, cdf = compact
    r = cdf_pick_rows(rows, cdf, ul2.detach()).detach()  # pt.py:195-196
    b0, b1 = square_to_uniform_triangle(ul0, ul1)
    return (*row_sample(r, b0, b1), row_uv(r, b0, b1))


# the names JAX's pass tells apart; JAX takes any other name for the
# field's default branch, the port refuses it
_CHOICES = {"sampler": ("owen", "bluenoise"), "texture_filter": ("bilinear", "trilinear"),
            "nee": ("mesh", "vpl"), "glossy_model": GLOSSY_MODELS}


def _check_options(opts: PTOptions) -> None:
    for name, known in _CHOICES.items():
        if getattr(opts, name) not in known:
            raise NotImplementedError(
                f"PTOptions.{name}={getattr(opts, name)!r}: the choices are {known}")


def _check_view(view: SceneView, opts: PTOptions) -> None:
    """nee="vpl" needs the view's VPL set. JAX's pass reads view.vpls.norm
    at every emissive hit after bounce 0 and fails there on a view without
    one (pt.py:752); the port refuses the view before the pass."""
    if opts.nee == "vpl" and view.vpls is None:
        raise ValueError("nee='vpl' on a view without a VPL set (nothing emits, or the view "
                         "was built with n_vpls=0 or from leaves without vpls.*)")


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
    cone_width: Tensor  # (N,) f32 ray-cone footprint radius (the trilinear LOD)
    pix_u: Tensor  # pixel id per lane (int64 holding uint32)
    lane0: Tensor  # original lane (pixel-grid) index, int32: NarrowPass folds by it


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


def _add_nee(c: Carry, first: bool, lit: Tensor, fd: Vec3, fg: Vec3, wX: Tensor,
             wY: Tensor, wZ: Tensor) -> Carry:
    """A NEE strategy's lit lanes into the accumulators: split routing at
    bounce 0 (the diffuse part -> DIFFUSE, the glossy part -> SPECULAR), the
    path's channel later."""
    if first:
        return c._replace(
            l_diffuse=c.l_diffuse + select(lit, Vec3(fd.x * wX, fd.y * wY, fd.z * wZ)),
            l_specular=c.l_specular + select(lit, Vec3(fg.x * wX, fg.y * wY, fg.z * wZ)),
        )
    contrib = Vec3((fd.x + fg.x) * wX, (fd.y + fg.y) * wY, (fd.z + fg.z) * wZ)
    return _add_routed(c, contrib, lit, c.channel)


def _detached(*xs):
    """Each tensor or Vec3 of xs detached (JAX's stop_gradient)."""
    return tuple(Vec3(*(a.detach() for a in x)) if isinstance(x, Vec3) else x.detach()
                 for x in xs)


def _stride(view: SceneView, opts: PTOptions) -> int:
    """Sampler dimensions per bounce (pt.py:779-787): sample_2d pairs
    dimensions by d >> 1, so the env NEE pair (+8) and each area light's
    pair (+10 + 2 li) start on even offsets no other strategy shares."""
    stride = opts.dims_per_bounce if view.env_map is None else max(opts.dims_per_bounce, 10)
    if view.area_lights is not None and view.area_lights.count > 0:
        stride = max(stride, 10 + 2 * view.area_lights.count)
    return stride


def _textured(view: SceneView, opts: PTOptions, sh, params: BsdfParams, cone_w: Tensor):
    """The hit's diffuse and specular albedos modulated by their maps
    (pt.py:663-687): bilinear at level 0, or trilinear at the ray-cone LOD
    lod_base + log2(cone width) + log2(the diffuse map's width), which the
    specular lookup shares."""
    tex, mats, uv = view.textures, sh.mats, sh.uv
    if opts.texture_filter == "trilinear":
        res0 = tex.width[torch.clamp_min(mats.diffuse_map, 0).long(), 0].to(torch.float32)
        lod = (sh.lod_base + torch.log2(torch.clamp_min(cone_w, 1e-8))
               + torch.log2(torch.clamp_min(res0, 1.0)))
        rgba_d = tex.sample(mats.diffuse_map, uv[:, 0], uv[:, 1], lod)
        rgba_s = tex.sample(mats.specular_map, uv[:, 0], uv[:, 1], lod)
    else:
        rgba_d = tex.sample_bilinear0(mats.diffuse_map, uv[:, 0], uv[:, 1])
        rgba_s = tex.sample_bilinear0(mats.specular_map, uv[:, 0], uv[:, 1])
    return params._replace(diffuse=modulate(params.diffuse, rgba_d),
                           specular=modulate(params.specular, rgba_s))


def _bounce(b: int, c: Carry, view: SceneView, opts: PTOptions, seq, tr: _Tracers,
            shade_tab: Tensor, cone_spread: Tensor) -> Carry:
    first = b == 0
    n = c.alive.shape[0]  # the carry's width: NarrowPass runs narrower ones
    eps = opts.ray_eps
    sh_anyhit = tr.shadow_direct if first else tr.shadow_indirect
    hit = tr.closest(c.o, c.d, eps, 3.0e38, c.alive)
    c = _count(c, c.alive)
    valid = c.alive & hit.hit_mask
    missed = c.alive & ~hit.hit_mask
    is_direct = b == 1
    env = view.env
    if view.env_map is None:
        # constant environment light: miss lanes pick up thr * env; no NEE
        # strategy samples it, so the weight is 1
        c = _add_routed(c, Vec3(c.thr.x * env[0], c.thr.y * env[1], c.thr.z * env[2]),
                        missed, c.channel)
    else:
        # the map's radiance scaled by env, MIS-weighted against the env NEE
        # of the previous vertex (pt.py:598-635); camera rays have no
        # competing strategy
        e_l = view.env_map.eval(c.d)
        e_l = Vec3(e_l.x * env[0], e_l.y * env[1], e_l.z * env[2])
        if first:
            w_env = torch.ones(n, dtype=torch.float32, device=c.prev_pdf.device)
        else:
            pdf_e = view.env_map.pdf(c.d).detach()  # pt.py:621
            nee_mask = opts.direct_lighting_nee if is_direct else opts.indirect_lighting_nee
            w_env = (power_heuristic(c.prev_pdf, pdf_e).detach() if nee_mask  # pt.py:622
                     else torch.ones_like(pdf_e))
            show_mask = opts.direct_lighting_bsdf if is_direct else opts.indirect_lighting_bsdf
            w_env = w_env * float(show_mask)
        c = _add_routed(c, Vec3(c.thr.x * e_l.x * w_env, c.thr.y * e_l.y * w_env,
                                c.thr.z * e_l.z * w_env), missed, c.channel)

    tri_c = torch.clamp_min(hit.tri, 0)
    if tr.uv_from_ray:  # the tracer returned no barycentrics (pt.py:643-647)
        sh = view.mesh.shade_fetch_ray(tri_c, c.o, c.d, shade_tab)
    else:
        sh = view.mesh.shade_fetch(tri_c, hit.u, hit.v, shade_tab)
    pos, gn, mats = sh.pos, sh.gn, sh.mats
    wi = -c.d  # towards the previous vertex

    # flip the shading frame to the ray side of the geometric surface
    flip = torch.where(dot(gn, wi) < 0.0, -1.0, 1.0)
    sn_f = sh.sn * flip
    t_b, b_b = orthonormal_basis(sn_f)
    wi_loc = to_local(wi, t_b, b_b, sn_f)
    params = BsdfParams.from_materials(mats)
    # textured emitters (pt.py:731-741, 806-821): statically skipped when no
    # emitter carries a map
    emissive_maps = bool(view.textured_emitters)
    if view.has_textures:
        # the ray-cone footprint (pt.py:660-662); only the trilinear LOD reads it
        if opts.texture_filter == "trilinear":
            c = c._replace(cone_width=c.cone_width + torch.where(valid, hit.t, 0.0) * cone_spread)
        params = _textured(view, opts, sh, params, c.cone_width)
    split = lambda wo_loc: f_split(params, wi_loc, wo_loc, opts.lobes, opts.clearcoat,
                                   opts.glossy_model)

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
    show = opts.visible_lights if first else (
        opts.direct_lighting_bsdf or opts.indirect_lighting_bsdf)
    if show:
        le = select(dot(gn, wi) > 0.0, mats.emissive)
        if emissive_maps:
            le = modulate(le, view.textures.sample(mats.emissive_map, sh.uv[:, 0], sh.uv[:, 1]))
        if first:
            w_mis = torch.ones(n, dtype=torch.float32, device=pos.x.device)
        else:
            # MIS vs the NEE at vertex b-1 that could have sampled this emitter
            if opts.nee == "vpl":  # the VPL density, lum(Le at the hit) / norm (pt.py:748-752)
                pdf_area = ((0.2126 * le.x + 0.7152 * le.y + 0.0722 * le.z)
                            / torch.clamp_min(view.vpls.norm, 1e-20))
            else:
                pdf_area = view.lights.pdf_area_of(tri_c)
            # miss lanes carry t = 3e38: t*t would overflow
            t_safe = torch.where(valid, hit.t, 1.0)
            dist2 = t_safe * t_safe
            cos_l = torch.abs(dot(gn, wi))
            pdf_sa = pdf_area * dist2 / torch.clamp_min(cos_l, 1e-8)
            nee_mask = opts.direct_lighting_nee if is_direct else opts.indirect_lighting_nee
            # pt.py:761
            w_mis = (power_heuristic(c.prev_pdf, pdf_sa).detach() if nee_mask
                     else torch.ones_like(pdf_sa))
            show_mask = opts.direct_lighting_bsdf if is_direct else opts.indirect_lighting_bsdf
            w_mis = w_mis * float(show_mask)
        contrib = Vec3(c.thr.x * le.x * w_mis, c.thr.y * le.y * w_mis, c.thr.z * le.z * w_mis)
        if opts.detach_emissive:  # pt.py:774-775
            contrib, = _detached(contrib)
        c = _add_routed(c, contrib, valid, c.channel)

    # ---- NEE: mesh lights ----
    base_dim = (2 + b * _stride(view, opts)) & M32
    nee_on = opts.direct_lighting_nee if first else opts.indirect_lighting_nee
    bsdf_on = opts.direct_lighting_bsdf if first else opts.indirect_lighting_bsdf
    if nee_on:
        ul0, ul1, ul2 = seq.sample_3d(c.pix_u, base_dim)
        if opts.debug_nee_fixed_light:  # pt.py:794-798
            f32 = dict(dtype=torch.float32, device=pos.x.device)
            lpos = Vec3(torch.zeros(n, **f32), torch.full((n,), 1.9, **f32), torch.zeros(n, **f32))
            ln = Vec3(torch.zeros(n, **f32), torch.full((n,), -1.0, **f32), torch.zeros(n, **f32))
            lle = Vec3.full(n, 10.0, 10.0, 10.0, pos.x.device)
            lpdf_a = torch.ones(n, **f32)
        elif opts.nee == "vpl":  # a uniform VPL pick, its Le textured at build (pt.py:799-802)
            lpos, ln, lle, lpdf_a, _ = view.vpls.sample(ul2)
        else:
            if view.lights.compact is not None:
                lpos, ln, lle, lpdf_a, luv = _sample_lights_compact(view.lights.compact, ul0,
                                                                    ul1, ul2)
            elif emissive_maps:
                lpos, ln, lle, lpdf_a, _, *luv = view.lights.sample_ex(ul0, ul1, ul2)
            else:
                lpos, ln, lle, lpdf_a, _ = view.lights.sample(ul0, ul1, ul2)
            if emissive_maps:
                luv_u, luv_v, lemap = luv
                lle = modulate(lle, view.textures.sample(lemap, luv_u, luv_v))
        to_l = lpos - pos
        dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
        dist = torch.sqrt(dist2)
        wo = to_l * (1.0 / dist)
        cos_l = dot(ln, -wo)  # the light must face the shading point
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        if opts.debug_nee_cheap_eval:  # a diffuse-only f (pt.py:832-838)
            lam = torch.where((wi_loc.z * wo_loc.z) > 0.0, INV_PI, 0.0)
            fd = Vec3(params.diffuse.x * lam, params.diffuse.y * lam, params.diffuse.z * lam)
            fg = Vec3.zeros(n, pos.x.device)
            bsdf_pdf = torch.abs(wo_loc.z) * INV_PI
        else:
            fd, fg, bsdf_pdf = split(wo_loc)
        pdf_sa = (lpdf_a * dist2 / torch.clamp_min(torch.abs(cos_l), 1e-8)).detach()  # pt.py:841
        # pt.py:846
        w_mis = (power_heuristic(pdf_sa, bsdf_pdf).detach() if bsdf_on
                 else torch.ones_like(pdf_sa))
        cos_s = torch.abs(wo_loc.z)
        able = (valid & view.lights.has_lights & (cos_l > 1e-6) & (pdf_sa > 1e-12)
                & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0))
        if opts.debug_nee_no_shadow:  # no shadow ray (pt.py:859-862)
            occluded = torch.zeros_like(able)
        else:
            so = _offset_origin(pos, gn, wo, eps)
            occluded = sh_anyhit(so, wo, 0.0, dist * (1.0 - 1e-3), able)
        c = _count(c, able)
        lit = able & ~occluded
        scale = cos_s * w_mis / torch.clamp_min(pdf_sa, 1e-12)
        if opts.detach_nee:  # pt.py:867-871
            scale, fd, fg, lle = _detached(scale, fd, fg, lle)
        c = _add_nee(c, first, lit, fd, fg, c.thr.x * lle.x * scale, c.thr.y * lle.y * scale,
                     c.thr.z * lle.z * scale)

    # ---- NEE: environment map (pt.py:893-949), importance-sampled from the
    # luminance * sin(theta) CDF; MIS vs the BSDF rays that miss ----
    if view.env_map is not None and nee_on:
        ue0, ue1 = seq.sample_2d(c.pix_u, (base_dim + 8) & M32)
        wo_e, pdf_e, le_e = view.env_map.sample(ue0, ue1)
        pdf_e = pdf_e.detach()  # pt.py:899
        le_e = Vec3(le_e.x * env[0], le_e.y * env[1], le_e.z * env[2])
        wo_le = to_local(wo_e, t_b, b_b, sn_f)
        fde, fge, bpdf_e = split(wo_le)
        # pt.py:909
        w_mis_e = (power_heuristic(pdf_e, bpdf_e).detach() if bsdf_on
                   else torch.ones_like(pdf_e))
        cos_se = torch.abs(wo_le.z)
        able_e = (valid & (pdf_e > 1e-12)
                  & ((fde.x + fde.y + fde.z + fge.x + fge.y + fge.z) > 0.0))
        so_e = _offset_origin(pos, gn, wo_e, eps)
        occ_e = sh_anyhit(so_e, wo_e, 0.0, 3.0e38, able_e)
        c = _count(c, able_e)
        scale_e = cos_se * w_mis_e / torch.clamp_min(pdf_e, 1e-12)
        if opts.detach_nee:  # pt.py:925-929
            scale_e, fde, fge, le_e = _detached(scale_e, fde, fge, le_e)
        c = _add_nee(c, first, able_e & ~occ_e, fde, fge, c.thr.x * le_e.x * scale_e,
                     c.thr.y * le_e.y * scale_e, c.thr.z * le_e.z * scale_e)

    # ---- NEE: analytic area lights (pt.py:951-1006); BSDF rays never see
    # them, so the weight is 1 ----
    n_area = 0 if view.area_lights is None else view.area_lights.count
    for li in range(n_area if nee_on else 0):
        ua0, ua1 = seq.sample_2d(c.pix_u, (base_dim + 10 + 2 * li) & M32)
        lpos, ln, lle, lpdf_a = view.area_lights.sample(li, ua0, ua1)
        to_l = lpos - pos
        dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
        dist = torch.sqrt(dist2)
        wo = to_l * (1.0 / dist)
        cos_l = dot(ln, -wo)
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        fd, fg, _ = split(wo_loc)
        pdf_sa = (lpdf_a * dist2 / torch.clamp_min(torch.abs(cos_l), 1e-8)).detach()  # pt.py:968
        cos_s = torch.abs(wo_loc.z)
        able = (valid & (cos_l > 1e-6) & (pdf_sa > 1e-12)
                & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0))
        so = _offset_origin(pos, gn, wo, eps)
        occluded = sh_anyhit(so, wo, 0.0, dist * (1.0 - 1e-3), able)
        c = _count(c, able)
        scale = cos_s / torch.clamp_min(pdf_sa, 1e-12)
        if opts.detach_nee:  # pt.py:983-986; Le keeps its gradient
            scale, fd, fg = _detached(scale, fd, fg)
        c = _add_nee(c, first, able & ~occluded, fd, fg, c.thr.x * lle.x * scale,
                     c.thr.y * lle.y * scale, c.thr.z * lle.z * scale)

    # ---- NEE: point lights (delta; pt.py:1008-1046) ----
    lp = view.point_lights
    for li in range(0 if lp is None else lp.count):
        to_l = Vec3(lp.px[li] - pos.x, lp.py[li] - pos.y, lp.pz[li] - pos.z)
        dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
        dist = torch.sqrt(dist2)
        wo = to_l * (1.0 / dist)
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        fd, fg, _ = split(wo_loc)
        cos_s = torch.abs(wo_loc.z)
        able = valid & ((fd.x + fg.x + fd.y + fg.y + fd.z + fg.z) > 0.0)
        so = _offset_origin(pos, gn, wo, eps)
        occluded = sh_anyhit(so, wo, 0.0, dist * (1.0 - 1e-3), able)
        c = _count(c, able)
        inv_d2 = 1.0 / dist2
        c = _add_nee(c, first, able & ~occluded, fd, fg, c.thr.x * lp.ix[li] * cos_s * inv_d2,
                     c.thr.y * lp.iy[li] * cos_s * inv_d2, c.thr.z * lp.iz[li] * cos_s * inv_d2)

    # ---- NEE: directional lights (pt.py:1048-1099); shadow rays to tmax 3e38 ----
    dl = view.dir_lights
    for li in range(0 if dl is None else dl.count):
        wo = Vec3(-dl.dir_x[li].expand(n), -dl.dir_y[li].expand(n), -dl.dir_z[li].expand(n))
        wo_loc = to_local(wo, t_b, b_b, sn_f)
        fd, fg, _ = split(wo_loc)
        cos_s = torch.abs(wo_loc.z)
        able = valid & ((fd.x + fg.x + fd.y + fg.y + fd.z + fg.z) > 0.0)
        so = _offset_origin(pos, gn, wo, eps)
        occluded = sh_anyhit(so, wo, 0.0, 3.0e38, able)
        c = _count(c, able)
        c = _add_nee(c, first, able & ~occluded, fd, fg, c.thr.x * dl.col_x[li] * cos_s,
                     c.thr.y * dl.col_y[li] * cos_s, c.thr.z * dl.col_z[li] * cos_s)

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
                        0.05, 1.0).detach()  # pt.py:1108
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


class _PassState(NamedTuple):
    """What every bounce of one pass shares, built once per pass, outside
    the bounce loop."""

    seq: "TiledSequence | BlueNoiseSequence"
    tr: _Tracers
    shade_tab: Tensor
    cone_spread: Tensor  # the primary ray cone's spread, about a pixel (pt.py:537)


def _pass_state(view: SceneView, opts: PTOptions, res_x: int, instance: int,
                seed: int, sequence=None) -> _PassState:
    if sequence is not None:  # the caller's sampler (pt.py:515-516)
        seq = sequence
    elif opts.sampler == "bluenoise":
        seq = BlueNoiseSequence.create(seed=seed, res_x=res_x).set_instance(instance)
    else:
        seq = TiledSequence.create(seed=seed).set_instance(instance)
    return _PassState(seq, _pick_tracers(view, opts),
                      view.mesh.shade_rows(), torch.tan(view.camera.fov * 0.5) * 2.0 / res_x)


def _first_bounce(view: SceneView, opts: PTOptions, st: _PassState, res_x: int,
                  res_y: int, pix: Tensor = None) -> Carry:
    """Camera rays through the lanes' pixel ids `pix` (the full pixel grid
    by default) and bounce 0 on them; bounce 0 always runs, as the JAX
    version peels it (pt.py:1168-1177)."""
    dev = view.device
    if pix is None:
        pix = torch.arange(res_x * res_y, dtype=torch.int64, device=dev)
    n = pix.shape[0]
    jx, jy = st.seq.sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)

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
        cone_width=torch.zeros(n, **f32),
        pix_u=pix,
        lane0=torch.arange(n, **i32),
    )
    return _bounce(0, c, view, opts, *st)


def render_pass(view: SceneView, opts: PTOptions, res_x: int, res_y: int,
                instance: int, seed: int = 0,
                tables: "pt_mega.MegaTables | None" = None, pix: Tensor = None,
                sequence=None):
    """Trace one progressive pass (PathTracer::render, pathtracer_impl.h:197)
    on the view's device. `pix` are the lanes' pixel ids (int64, duplicates
    allowed; the full pixel grid by default) and `sequence` replaces the
    pass's sampler (pt.py:476-501): the MCMC integrators drive the pass from
    their own primary samples (pssmlt.MatrixSequence). tracer="mega" hands
    the whole pass to ops/pt_mega.render_pass_mega, with `tables` (built from
    the view when None), and takes neither `pix` nor `sequence`; other
    tracers take no tables. NarrowPass runs the same bounces as segments of
    its own (_first_bounce, then one _bounce per segment on the compacted
    carry), in place of the JAX version's segment hooks (pt.py:484-501)."""
    if _trace_mode(view.mesh.n_triangles, opts, view.clusters is not None) == "mega":
        if pix is not None or sequence is not None:
            raise NotImplementedError(
                "tracer='mega' renders the full pixel grid with its own sampler: no pix or "
                "sequence")
        if torch.is_grad_enabled() and any(
                t.requires_grad for f in view.mesh.materials
                for t in (f if isinstance(f, Vec3) else (f,))):
            raise NotImplementedError(
                "tracer='mega' is not differentiable through autograd (nor is JAX's Pallas "
                "megakernel); its gradient is ops/pt_mega.render_grad_diffuse_mega")
        return pt_mega.render_pass_mega(view, opts, res_x, res_y, instance, seed, tables)
    if tables is not None:
        raise ValueError(f"tables are the megakernel's; tracer={opts.tracer!r} takes none")
    _check_options(opts)
    _check_view(view, opts)
    emissive = view.mesh.materials.emissive
    if (torch.is_grad_enabled() and any(t.requires_grad for t in emissive)
            and not view.lights.follows(emissive)):
        # NEE samples Le from the light table: one built on the host, or from
        # other tensors, would pass on only the emissive-hit half of the gradient
        raise NotImplementedError(
            "materials.emissive requires grad, but the light table does not follow it: "
            "rebuild it from the same mesh, view._replace(mesh=mesh, "
            "lights=MeshLightsView.build_on_device(mesh))")
    st = _pass_state(view, opts, res_x, instance, seed, sequence)
    c = _first_bounce(view, opts, st, res_x, res_y, pix)
    for b in range(1, opts.max_path_length):
        if opts.queue_compaction:
            c = _compact_carry(c)
        c = _bounce(b, c, view, opts, *st)
    if opts.queue_compaction:  # lane i holds the path that started at lane lane0[i]
        c = _permute_carry(c, c.lane0.long())
    return _assemble(_Accum(c.l_direct, c.l_diffuse, c.l_specular, c.rays_lane),
                     _gbuffer(c), c.rays)


def composited_output(comp: Vec3, rays: Tensor, rays_lane: Tensor) -> _PassOutput:
    """A pass output whose only image is COMPOSITED (the BPT and PSSMLT
    passes, context.py:104-135): the other channels zero, the G-buffer
    empty."""
    n, dev = comp.x.shape[0], comp.x.device
    zero3 = Vec3.zeros(n, dev)
    return _PassOutput(
        direct=zero3, diffuse=zero3, specular=zero3, composited=comp, diffuse_albedo=zero3,
        specular_albedo=zero3, depth=torch.full((n,), float("inf"), device=dev),
        tri=torch.full((n,), -1, dtype=torch.int32, device=dev), normal=zero3, position=zero3,
        uv=torch.zeros((n, 2), device=dev),
        material=torch.full((n,), -1, dtype=torch.int32, device=dev), rays=rays,
        rays_lane=rays_lane)


def direct_env_image(view: SceneView, res_x: int, res_y: int, instance: int,
                     seed: int = 0) -> Tuple[Tensor, Tensor]:
    """(H*W, 3) directly-visible environment radiance (the camera rays that
    miss) and the rays it traced (pt.py:439-475): the term the MCMC
    renderers add outside their chains, whose paths end on surfaces or
    escape only after a bounce. One camera ray a pixel from the
    TiledSequence of (seed, instance) at dimension 0, traced with the view's
    own closest tracer of tracer="auto". A view with no environment (no map,
    a zero constant; decided on the host) gives zeros and a zero count
    without tracing."""
    n, dev = res_x * res_y, view.device
    if view.env_map is None and not bool((view.env != 0.0).any()):
        return torch.zeros((n, 3), device=dev), torch.zeros((), device=dev)
    tr = view_tracers(view, "auto", "the direct environment term")
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    jx, jy = TiledSequence.create(seed).set_instance(instance).sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)
    hit = tr.closest(o, d, 1e-4, 3.0e38, torch.ones(n, dtype=torch.bool, device=dev))
    img = select(~hit.hit_mask, scene_env_radiance(view, d)).stack()
    return img, torch.full((), float(n), device=dev)


def _permute_carry(c: Carry, dest: Tensor) -> Carry:
    """The carry with lane i moved to lane dest[i] (dest a permutation of
    the lanes); the scalar ray counter stays."""
    n = c.alive.shape[0]

    def put(a):
        if isinstance(a, Vec3):
            return Vec3(*(put(x) for x in a))
        if a.dim() == 0 or a.shape[0] != n:
            return a
        return torch.empty_like(a).index_copy(0, dest, a)

    return Carry(*(put(a) for a in c))


def _compact_carry(c: Carry) -> Carry:
    """Live lanes to a dense prefix, dead lanes after them, each in lane
    order (pt.py:1144-1161, the queue-append analog by a cumsum): a pure
    reorder, whose accumulators, pixel ids and lane origins travel with
    their lane, so the estimator is bit-equal to the masked pass."""
    m = c.alive.to(torch.int64)
    live_pos = torch.cumsum(m, 0) - m
    dead_pos = m.sum() + torch.cumsum(1 - m, 0) - (1 - m)
    return _permute_carry(c, torch.where(c.alive, live_pos, dead_pos))


class _Accum(NamedTuple):
    """Full-width per-pixel accumulators the narrowing driver folds finished
    lanes into, by the carried lane0 (pt.py:1210-1217)."""

    direct: Vec3
    diffuse: Vec3
    specular: Vec3
    rays_lane: Tensor


def _gbuffer(c: Carry) -> tuple:
    """The first-hit G-buffer of a carry in pixel order (final after bounce 0)."""
    return (c.g_diff_albedo, c.g_spec_albedo, c.g_depth, c.g_tri, c.g_normal, c.g_pos,
            c.g_uv, c.g_mat)


def _assemble(acc: _Accum, g: tuple, rays: Tensor) -> _PassOutput:
    return _PassOutput(
        direct=acc.direct, diffuse=acc.diffuse, specular=acc.specular,
        composited=acc.direct + acc.diffuse + acc.specular,
        diffuse_albedo=g[0], specular_albedo=g[1], depth=g[2], tri=g[3], normal=g[4],
        position=g[5], uv=g[6], material=g[7], rays=rays, rays_lane=acc.rays_lane,
    )


class NarrowPass:
    """Host-driven narrowing-wavefront pass (pt.py:1220-1481): the
    reference's shrinking queues (path_trace_loop,
    pathtracer_kernels.h:310-391).

      * bounce 0 runs at full width (_first_bounce);
      * between bounces the live count is read back (the 4-byte readback
        the reference pays) and live lanes are compacted into the smallest
        power-of-2 width, no smaller than `min_width`, that holds them;
      * each later bounce runs as a one-bounce segment (_bounce) at that
        width, with the pass's sequence, tracers and shade table built once;
      * finished lanes' radiance folds into full-width accumulators by the
        carried lane0, so the estimator is the same sum re-associated
        (allclose to render_pass; `rays` and the G-buffer equal).

    PyTorch runs eagerly, so the segments are plain calls: there is no jit
    cache per width and no buffer donation to manage.
    """

    def __init__(self, view: SceneView, opts: PTOptions, res_x: int, res_y: int,
                 seed: int = 0, min_width: int = 1 << 13):
        if opts.tracer == "mega":
            raise ValueError("tracer='mega' runs the whole pass in one launch: no narrowing")
        if opts.queue_compaction:
            raise ValueError("narrowing replaces in-loop queue compaction")
        _trace_mode(view.mesh.n_triangles, opts, view.clusters is not None)
        _check_options(opts)
        _check_view(view, opts)
        self.view, self.opts, self.seed = view, opts, seed
        self.res_x, self.res_y = res_x, res_y
        self.n = res_x * res_y
        self.min_width = min(min_width, self.n)
        self.last_profile = []  # (bounce, live, width) of the last pass

    def _fold(self, c: Carry, acc: _Accum, identity: bool) -> Tuple[Carry, _Accum]:
        """Add every lane's radiance into the full-width accumulators and
        zero the lane copies. identity: no compaction yet, lane order is
        pixel order, so the scatter-add is a plain add."""
        if identity:
            addv = lambda dst, src: dst + src
            add1 = lambda dst, src: dst + src
        else:
            lane = c.lane0.long()
            add1 = lambda dst, src: dst.index_add(0, lane, src)
            addv = lambda dst, src: Vec3(add1(dst.x, src.x), add1(dst.y, src.y),
                                         add1(dst.z, src.z))
        acc = _Accum(direct=addv(acc.direct, c.l_direct),
                     diffuse=addv(acc.diffuse, c.l_diffuse),
                     specular=addv(acc.specular, c.l_specular),
                     rays_lane=add1(acc.rays_lane, c.rays_lane))
        w, dev = c.alive.shape[0], c.alive.device
        z3 = Vec3.zeros(w, dev)
        c = c._replace(l_direct=z3, l_diffuse=z3, l_specular=z3,
                       rays_lane=torch.zeros(w, dtype=torch.float32, device=dev))
        return c, acc

    def _shrink(self, c: Carry, acc: _Accum, live: int, wp: int, identity: bool):
        """Fold, then gather the live lanes into a wp-wide carry; fill lanes
        copy lane 0 and are dead with zero accumulators."""
        w = c.alive.shape[0]
        c, acc = self._fold(c, acc, identity)
        idx = torch.nonzero(c.alive)[:, 0]
        idx = torch.cat([idx, idx.new_zeros(wp - live)])

        def take(a):
            if isinstance(a, Vec3):
                return Vec3(*(take(x) for x in a))
            if a.dim() == 0 or a.shape[0] != w:
                return a  # the scalar ray counter
            return a.index_select(0, idx)

        c = Carry(*(take(a) for a in c))
        valid = torch.arange(wp, device=idx.device) < live
        return c._replace(alive=c.alive & valid), acc

    def _bucket(self, live: int) -> int:
        wp = self.min_width
        while wp < live:
            wp *= 2
        return min(wp, self.n)

    @torch.no_grad()
    def __call__(self, instance: int) -> _PassOutput:
        opts, view = self.opts, self.view
        st = _pass_state(view, opts, self.res_x, instance, self.seed)
        carry = _first_bounce(view, opts, st, self.res_x, self.res_y)
        g = _gbuffer(carry)
        dev = view.device
        zero3 = Vec3.zeros(self.n, dev)
        acc = _Accum(zero3, zero3, zero3, torch.zeros(self.n, dtype=torch.float32, device=dev))
        w, identity = self.n, True
        self.last_profile = []
        for b in range(1, opts.max_path_length):
            live = int(carry.alive.sum())  # the per-bounce readback
            if live == 0:
                break
            wp = self._bucket(live)
            if wp < w:
                carry, acc = self._shrink(carry, acc, live, wp, identity)
                w, identity = wp, False
            self.last_profile.append((b, live, w))
            carry = _bounce(b, carry, view, opts, *st)
        _, acc = self._fold(carry, acc, identity)
        return _assemble(acc, g, carry.rays)


def render_pass_narrow(view: SceneView, opts: PTOptions, res_x: int, res_y: int,
                       instance: int, seed: int = 0, min_width: int = 1 << 13) -> _PassOutput:
    """One pass through NarrowPass (pt.py:1484-1499). The JAX version caches
    the driver for its jitted segments; here building one costs nothing."""
    return NarrowPass(view, opts, res_x, res_y, seed, min_width)(instance)
