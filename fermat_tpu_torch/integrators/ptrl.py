"""Path tracer with clustered-RL (Q-learning) direct lighting
(fermat_tpu/integrators/ptrl.py, the context's factory context.py:169-240).

The NEE light sample is drawn from each shading point's hash cell's
Q-mixed cluster probabilities (integrators/rl.py): over the VTL set's
light-BVH cut (sampler="vtl") or over morton-sorted triangle chunks
(sampler="tri"). Emissive hits take MIS against the RL pdf of the previous
vertex's cell. Each lit NEE sample's unshadowed contribution luminance is
summed per (cell, cluster) with `index_add_` during the pass, and Q moves
toward the means after the pass (a TD step), so Q, and with it every MIS
pdf, stays fixed within a pass.

`start` builds the clusters (host numpy: the VTL set and its cut, or the
triangle chunks) and Q = 1; `step` runs a pass, and every adapt_every
passes first refines the cut on the host (LightCutHost.adapt on Q's mean
over the cells) and remaps Q's columns. The context carries a `PtrlRun`
from pass to pass.

As in JAX: shadow rays trace the view's own geometry (no shadow set), no
texture modulates a hit or an emitter, and there is no analytic or
environment NEE (escaped rays pick up scene_env_radiance at weight 1).
On the frontier route (u, v) come from the ray (pt.surface), for the
shading and for the VTL pdf of an emissive hit; JAX would use u = v = 0
there, a route it meets only on a TPU. tracer="mega" raises
NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fermat_tpu_torch.core.camera import generate_camera_rays
from fermat_tpu_torch.core.math import Vec3, dot, select
from fermat_tpu_torch.core.rng import TiledSequence
from fermat_tpu_torch.integrators import psfpt as psf_mod
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.integrators import rl
from fermat_tpu_torch.scene.envmap import scene_env_radiance
from fermat_tpu_torch.scene.mesh_lights import LightCutHost, VTLView, build_vtls, reclustered
from fermat_tpu_torch.scene.spatial_hash import hash_shading_point
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor

SAMPLERS = ("vtl", "tri")


class PtrlOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's PtrlOptions (ptrl.py:37-52)."""

    max_path_length: int = 6
    n_clusters: int = 16
    table_size: int = 1 << 14
    sampler: str = "vtl"  # "vtl" = light-BVH cut over VTLs; "tri" = morton chunks
    n_vtls: int = 1024  # VTL decomposition target
    adapt_every: int = 8  # cut refinement cadence (0 = a static cut)
    bias: float = 0.25  # uniform mixing floor
    learning_rate: float = 0.15
    cell_size: float = 0.1
    rr: bool = True
    rr_start_bounce: int = 2
    ray_eps: float = 1.0e-4
    tracer: str = "auto"
    dims_per_bounce: int = 8
    lobes: tuple = (True, True, True, True)


class PtrlState(NamedTuple):
    qstate: rl.RLState


class PtrlRun(NamedTuple):
    """What the context carries from pass to pass: the Q table, the light
    clusters (rl.RLClusters or a VTLView), the host cut of the VTL set
    (None for sampler="tri" or a scene that emits nothing) and the passes
    run so far."""

    state: PtrlState
    clusters: object
    cut: Optional[LightCutHost]
    passes: int


def init_state(view: SceneView, opts: PtrlOptions) -> PtrlState:
    return PtrlState(qstate=rl.RLState.create(opts.table_size, opts.n_clusters, view.device))


def start(view: SceneView, opts: PtrlOptions) -> PtrlRun:
    """The clusters built on the host and Q = 1 (context.py:175-187)."""
    if opts.sampler not in SAMPLERS:
        raise NotImplementedError(f"PtrlOptions.sampler={opts.sampler!r}: the choices are "
                                  f"{SAMPLERS}")
    if opts.sampler == "vtl":
        clusters, cut = build_vtls(view.mesh, target_clusters=opts.n_clusters,
                                   n_target_vtls=opts.n_vtls)
    else:
        clusters, cut = rl.build_clusters(view.mesh, opts.n_clusters), None
    return PtrlRun(init_state(view, opts), clusters, cut, 0)


def remap_q(q: Tensor, m: np.ndarray) -> Tensor:
    """q[:, :C] @ m.T with the columns past C kept (context.py:210-216). A
    row of m holds one 1 or two halves, so each new column is written as
    the sum of its nonzero terms, in column order: the matmul's value."""
    cols = []
    for j in range(m.shape[0]):
        terms = [q[:, k] * float(m[j, k]) for k in np.nonzero(m[j])[0]]
        col = terms[0]
        for t in terms[1:]:
            col = col + t
        cols.append(col)
    return torch.cat([torch.stack(cols, dim=1), q[:, m.shape[0]:]], dim=1)


def adapt(run: PtrlRun, opts: PtrlOptions) -> PtrlRun:
    """Count the pass; on every adapt_every-th one refine the cut by the
    mean Q of each cluster over the cells, and recluster and remap Q when
    it changed (context.py:196-217). The cut is changed in place."""
    run = run._replace(passes=run.passes + 1)
    cut = run.cut
    if cut is None or opts.adapt_every <= 0 or run.passes % opts.adapt_every:
        return run
    q = run.state.qstate.q
    value = q.mean(dim=0).cpu().numpy()[: cut.n_clusters]
    m = cut.adapt(value)
    if m is None:
        return run
    return run._replace(clusters=reclustered(run.clusters, cut),
                        state=PtrlState(rl.RLState(q=remap_q(q, m))))


def step(view: SceneView, opts: PtrlOptions, run: PtrlRun, res_x: int, res_y: int,
         instance: int, seed: int = 0):
    """The context's pass: adapt, then render. Returns (radiance, rays, rays
    per lane, the new PtrlRun)."""
    run = adapt(run, opts)
    out, state, rays, rays_lane = render_pass(view, opts, run.clusters, res_x, res_y, instance,
                                              run.state, seed)
    return out, rays, rays_lane, run._replace(state=state)


def render_pass(view: SceneView, opts: PtrlOptions, clusters, res_x: int, res_y: int,
                instance: int, state: PtrlState, seed: int = 0):
    """One pass (ptrl.py:62-229). Returns (per-pixel radiance Vec3, the new
    state, the rays counter, rays per lane)."""
    dev = view.device
    n = res_x * res_y
    f32 = dict(dtype=torch.float32, device=dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    seq = TiledSequence.create(seed).set_instance(instance)
    tr = pt_mod.view_tracers(view, opts.tracer, "PTRL")
    table = view.mesh.shade_rows()
    eps = opts.ray_eps
    n_rays = torch.zeros((), **f32)
    rays_lane = torch.zeros(n, **f32)
    qstate = state.qstate
    is_vtl = isinstance(clusters, VTLView)

    jx, jy = seq.sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res_x, res_y, jx, jy, pix)

    thr = Vec3.full(n, 1.0, 1.0, 1.0, dev)
    radiance = Vec3.zeros(n, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(n, **f32)
    prev_cell = torch.zeros(n, dtype=torch.int32, device=dev)
    kc = opts.table_size * opts.n_clusters
    r_sums = torch.zeros(kc, **f32)
    r_cnts = torch.zeros(kc, **f32)

    def count(m: Tensor):
        nonlocal n_rays, rays_lane
        mf = m.to(torch.float32)
        n_rays = n_rays + mf.sum()
        rays_lane = rays_lane + mf

    for b in range(opts.max_path_length):
        hit = tr.closest(o, d, eps, 3.0e38, alive)
        count(alive)
        valid = alive & hit.hit_mask
        vx = psf_mod.shade(view, tr, table, hit, o, d)
        pos, gn = vx.sh.pos, vx.sh.gn

        # escaped rays pick up the environment, weight 1
        radiance = radiance + select(alive & ~hit.hit_mask, thr * scene_env_radiance(view, d))

        # emissive hits with MIS against the RL pdf of the previous cell
        le = select(dot(gn, vx.wi) > 0.0, vx.sh.mats.emissive)
        if b == 0:
            w_mis = torch.ones(n, **f32)
        else:
            if is_vtl:
                pdf_area = rl.pdf_area_of_vtl(clusters, qstate, prev_cell, vx.tri, vx.u, vx.v,
                                              opts.bias)
            else:
                pdf_area = rl.pdf_area_of(clusters, qstate, prev_cell, vx.tri, opts.bias)
            w_mis = psf_mod.emissive_weight(vx, hit, valid, prev_pdf, pdf_area)
        radiance = radiance + select(valid, thr * le * w_mis)

        # RL NEE: the cell, a cluster by Q, a light point in it
        base_dim = 2 + b * opts.dims_per_bounce
        uj = seq.sample_1d(pix, base_dim + 7)
        cell, _ = hash_shading_point(pos, vx.sn_f, view.camera.eye, opts.cell_size,
                                     opts.table_size, uj)
        ul0, ul1, ul2 = seq.sample_3d(pix, base_dim)
        ul3 = seq.sample_1d(pix, base_dim + 5)
        if is_vtl:
            lpos, ln, lle, lpdf_a, _, lcl, _ = rl.sample_vtl(clusters, qstate, cell, ul0, ul1,
                                                             ul2, ul3, opts.bias)
        else:
            lpos, ln, lle, lpdf_a, _, lcl = rl.sample(clusters, qstate, view.lights.rows, cell,
                                                      ul0, ul1, ul2, ul3, opts.bias)
        c, able, lit = psf_mod.nee(tr, vx, lpos, ln, lle, lpdf_a, valid, opts.lobes, eps)
        count(able)
        radiance = radiance + select(lit, thr * c)

        # the TD rewards, applied after the pass
        reward = torch.where(lit, 0.2126 * c.x + 0.7152 * c.y + 0.0722 * c.z, 0.0)
        flat = torch.where(able, cell * opts.n_clusters + lcl, 0).long()
        r_sums.index_add_(0, flat, torch.where(able, reward, 0.0))
        r_cnts.index_add_(0, flat, able.to(torch.float32))

        # scatter and Russian roulette
        s, wo_world, thr, alive, _ = psf_mod.scatter(seq, pix, base_dim, vx, thr, valid, b,
                                                     opts)
        thr = select(alive, thr)
        prev_pdf = s.pdf
        prev_cell = cell
        o = pt_mod._offset_origin(pos, gn, wo_world, eps)
        d = wo_world

    q_new = rl.td_update(qstate, r_sums, r_cnts, opts.learning_rate)
    return radiance, PtrlState(qstate=q_new), n_rays, rays_lane
