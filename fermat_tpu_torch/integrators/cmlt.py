"""Charted Metropolis light transport, Pantaleoni 2017 (fermat_tpu/integrators/cmlt.py).

Chains live in primary sample space, one (s, t) chart each: a chain holds a
light-subpath coordinate vector u_L (N, DL), an eye-subpath vector u_E
(N, DE) and its chart (s, t), s + t - 1 segments. The evaluator traces both
subpaths to their full depth from the chain's own coordinates (`_walk`:
per-slot vertex records with the SmallVCM dVCM/dVC recursion and the
incoming pdfs), then takes each lane's chart end vertices with one-hot
selects and makes one connection and one shadow ray (`_connect`; s = -1
charts are eye paths escaping to the environment on segment t). A step is
a Kelemen mutation of both vectors (a large step also draws a new chart at
random), or, every swap_frequency-th step, a +-1 chart swap: the same path
re-expressed in the neighbouring chart by inverting the scatter decision
that changes sides (bsdf/inversion.py), accepted with the re-traced
luminance ratio times the moved decision's density ratio in area measure
times the proposal asymmetry. Seeding (`init_state`) takes n_seed_rounds
rounds of uniform candidates over every chart and resamples the chains
from one luminance CDF over all (round, chart, lane) candidates, whose mean
luminance is the image brightness b, the Metropolis normalization. Both
splats go through `index_add_`.

The chart list is built once on the host; `step_idx` is a host int, so the
swap cadence needs no readback; the chain key is a uint32 held in a Python
int, as PSSMLT's (core/rng.py). Every vertex is shaded with one fetch of the
shade table (K2); on the frontier route the walk derives each hit's (u, v)
from the ray, and a swap inverts the light pick at those (u, v). The
candidates' CDF is summed in float64 and rounded to float32, so that the
same chains are picked on every device (XLA's float32 prefix sum is within
an ulp or two of that). Shadow sets, analytic, point and directional lights
and textures are ignored, as in JAX; tracer="mega" raises
NotImplementedError.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from fermat_tpu_torch.bsdf import inversion as binv
from fermat_tpu_torch.bsdf.composite import f_and_pdf
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.math import Vec3, dot, orthonormal_basis, select, to_local, to_world
from fermat_tpu_torch.core.rng import M32, hash_combine, uniform_from_bits
from fermat_tpu_torch.core.sampling import INV_PI, square_to_cosine_hemisphere
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.integrators.bpt import _eval_both
from fermat_tpu_torch.integrators.mlt import (_Ctx, _Vtx, _cam_eye, _fsum, _log_ratio, _lum,
                                              _make_ctx, _sel, _trace, _where3)
from fermat_tpu_torch.integrators.pssmlt import _counter
from fermat_tpu_torch.scene.envmap import scene_env_radiance
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor
_BIG = 3.0e38


class CMLTOptions(NamedTuple):
    """The fields and defaults of fermat_tpu's CMLTOptions (cmlt.py:78-98)."""

    max_path_length: int = 6  # K: max segments (at least 3)
    n_chains: int = 0  # 0 -> one chain per pixel
    swap_frequency: int = 3  # every Nth step proposes a chart swap
    large_step_prob: float = 0.3
    small_step_size: float = 1.0 / 64.0
    n_seed_rounds: int = 8  # candidate rounds: the brightness b's samples
    lobes: tuple = (True, True, True, True)
    ray_eps: float = 1.0e-4
    tracer: str = "auto"


# the coordinate layout: u_L [0:3] the light point (barycentrics and the CDF
# pick), [3:5] the emission direction, [5+3j : 8+3j] the scatter at y_{j+1};
# u_E [0:2] the screen point, [2+3i : 5+3i] the scatter at x_{i+1}

def _dims_l(K: int) -> int:
    return 5 + 3 * max(K - 3, 0)


def _dims_e(K: int) -> int:
    return 2 + 3 * (K - 1)


def charts(K: int) -> List[Tuple[int, int]]:
    """Every (s, t) chart of at most K segments, then the env-terminated
    (-1, t) charts, t = 2..K (cmlt.py:527-531, :802-806): t = 1, the
    directly visible environment, is the context's own QMC term."""
    out = [(s_, t_) for t_ in range(2, K + 2) for s_ in range(0, K + 2 - t_)]
    return out + [(-1, t_) for t_ in range(2, K + 1)]


class CMLTState(NamedTuple):
    u_l: Tensor  # (N, DL)
    u_e: Tensor  # (N, DE)
    s: Tensor  # (N,) int32 chart light-vertex count
    t: Tensor  # (N,) int32 chart eye-vertex count (>= 2)
    lum: Tensor  # (N,) current path luminance
    contrib: Tensor  # (N, 3)
    pixel: Tensor  # (N,) int64 pixel ids
    brightness: Tensor  # () b
    key: int  # uint32 chain key
    step_idx: int  # steps taken (the swap cadence)

    @staticmethod
    def from_numpy(arrays: dict, device) -> "CMLTState":
        """From JAX's CMLTState arrays by field name."""
        t = lambda k, dt: torch.from_numpy(np.array(arrays[k], dtype=dt)).to(device)
        return CMLTState(u_l=t("u_l", np.float32), u_e=t("u_e", np.float32),
                         s=t("s", np.int32), t=t("t", np.int32), lum=t("lum", np.float32),
                         contrib=t("contrib", np.float32), pixel=t("pixel", np.int64),
                         brightness=t("brightness", np.float32), key=int(arrays["key"]),
                         step_idx=int(arrays["step_idx"]))


# ---------------------------------------------------------------------------
# The charted bidirectional evaluator
# ---------------------------------------------------------------------------

class _Slot(NamedTuple):
    """One subpath vertex of a walk (vertex_storage.h analog): gn and sn in
    vtx are flipped to the incoming side."""

    tri: Tensor
    u: Tensor
    v: Tensor
    valid: Tensor
    vtx: _Vtx
    wi: Vec3
    thr: Vec3
    dvcm: Tensor
    dvc: Tensor
    pdf_in: Tensor  # solid-angle pdf of the decision that made this vertex
    cos_in: Tensor  # |dot(sn, wi)|
    d2: Tensor  # squared length of the incoming segment


class _Walk(NamedTuple):
    e: List[_Slot]  # eye slots i: x_{i+1}
    e_d: List[Vec3]  # the eye walk's direction a step (escape candidates)
    e_esc: List[Tensor]  # escaped at this step
    l0_tri: Tensor  # the light point y_0
    l0_pos: Vec3
    l0_n: Vec3
    l0_le: Vec3
    l0_pdf_a: Tensor
    l0_valid: Tensor
    l: List[_Slot]  # light slots j: y_{j+1}


def _walk(ctx: _Ctx, u_l: Tensor, u_e: Tensor):
    """Both subpaths traced to full depth from explicit primary coordinates
    (cmlt.py:178-351): (the _Walk, rays)."""
    view, opts = ctx.view, ctx.opts
    K = opts.max_path_length
    LS = K - 2
    n = u_e.shape[0]
    eps, lobes = opts.ray_eps, opts.lobes
    dev = view.device
    n_rays = torch.zeros((), dtype=torch.float32, device=dev)
    col = lambda u, c: u[:, c].contiguous()

    def scatter(vx, sn_f, wi, uu, base):
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)
        sm = bsdf_sample(vx.params, wi_loc, col(uu, base), col(uu, base + 1),
                         col(uu, base + 2), lobes)
        pdf_rev = f_and_pdf(vx.params, sm.wo, wi_loc, lobes)[1]
        return sm, pdf_rev, to_world(sm.wo, t_b, b_b, sn_f)

    def incoming(hit, vx, d, valid):
        """wi, the normals flipped to its side, |cos| there and the hit's t."""
        wi = -d
        flip = torch.where(dot(vx.gn, wi) < 0.0, -1.0, 1.0)
        gn_f, sn_f = vx.gn * flip, vx.sn * flip
        cos_in = torch.clamp_min(torch.abs(dot(sn_f, wi)), 1e-8)
        t_safe = torch.where(valid, hit.t, 1.0)
        return wi, gn_f, sn_f, cos_in, t_safe

    # ---- the light subpath ----
    lpos, ln, lle, lpdf_a, ltri = view.lights.sample(col(u_l, 0), col(u_l, 1), col(u_l, 2))
    has_light = view.lights.has_lights & (lpdf_a > 0.0)
    d_loc = square_to_cosine_hemisphere(col(u_l, 3), col(u_l, 4))
    lt, lb = orthonormal_basis(ln)
    d = to_world(d_loc, lt, lb, ln)
    cos_emit = torch.clamp_min(d_loc.z, 1e-8)
    pdf_emit = lpdf_a * cos_emit * INV_PI
    inv_pe = torch.where(has_light, 1.0 / torch.clamp_min(pdf_emit, 1e-20), 0.0)
    l_thr = Vec3(lle.x * cos_emit * inv_pe, lle.y * cos_emit * inv_pe, lle.z * cos_emit * inv_pe)
    l_dvcm = lpdf_a / torch.clamp_min(pdf_emit, 1e-20)
    l_dvc = cos_emit / torch.clamp_min(pdf_emit, 1e-20)
    pdf_in_sa = cos_emit * INV_PI  # the emission direction's solid-angle pdf
    o = pt_mod._offset_origin(lpos, ln, d, eps)
    alive = has_light
    L = []
    for j in range(LS):
        hit, hu, hv, vx = _trace(ctx, o, d, alive)
        n_rays = n_rays + _fsum(alive)
        valid = alive & hit.hit_mask
        wi, gn_f, sn_f, cos_in, t_safe = incoming(hit, vx, d, valid)
        dvcm = l_dvcm * (t_safe * t_safe) / cos_in
        dvc = l_dvc / cos_in
        L.append(_Slot(torch.where(valid, hit.tri, 0), torch.where(valid, hu, 0.0),
                       torch.where(valid, hv, 0.0), valid, vx._replace(gn=gn_f, sn=sn_f), wi,
                       select(valid, l_thr), torch.where(valid, dvcm, 0.0),
                       torch.where(valid, dvc, 0.0), pdf_in_sa, cos_in,
                       torch.clamp_min(t_safe * t_safe, 1e-12)))
        if j + 1 < LS:
            sm, pdf_rev, wo_w = scatter(vx, sn_f, wi, u_l, 5 + 3 * j)
            cos_out = torch.clamp_min(torch.abs(sm.wo.z), 1e-8)
            pdf_fwd = torch.clamp_min(sm.pdf, 1e-20)
            l_dvc = (cos_out / pdf_fwd) * (dvc * pdf_rev + dvcm)
            l_dvcm = 1.0 / pdf_fwd
            pdf_in_sa = pdf_fwd
            alive = valid & sm.valid
            l_thr = select(alive, Vec3(l_thr.x * sm.g.x, l_thr.y * sm.g.y, l_thr.z * sm.g.z))
            o = pt_mod._offset_origin(vx.pos, vx.gn, wo_w, eps)
            d = wo_w

    # ---- the eye subpath ----
    d = ctx.cam.sample_direction(col(u_e, 0), col(u_e, 1))
    o = _cam_eye(ctx)
    f32 = dict(dtype=torch.float32, device=dev)
    e_dvcm = torch.zeros(n, **f32)  # light tracing excluded
    e_dvc = torch.zeros(n, **f32)
    e_thr = Vec3.full(n, 1.0, 1.0, 1.0, dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    pdf_in_sa = torch.zeros(n, **f32)  # the camera slot's: no swap reads it
    E, e_d, e_esc = [], [], []
    for i in range(K):
        hit, hu, hv, vx = _trace(ctx, o, d, alive)
        n_rays = n_rays + _fsum(alive)
        valid = alive & hit.hit_mask
        e_d.append(d)
        e_esc.append(alive & ~hit.hit_mask)
        wi, gn_f, sn_f, cos_in, t_safe = incoming(hit, vx, d, valid)
        e_dvcm = e_dvcm * (t_safe * t_safe) / cos_in
        e_dvc = e_dvc / cos_in
        E.append(_Slot(torch.where(valid, hit.tri, 0), torch.where(valid, hu, 0.0),
                       torch.where(valid, hv, 0.0), valid, vx._replace(gn=gn_f, sn=sn_f), wi,
                       e_thr, e_dvcm, e_dvc, pdf_in_sa, cos_in,
                       torch.clamp_min(t_safe * t_safe, 1e-12)))
        if i + 1 < K:
            sm, pdf_rev, wo_w = scatter(vx, sn_f, wi, u_e, 2 + 3 * i)
            cos_out = torch.clamp_min(torch.abs(sm.wo.z), 1e-8)
            pdf_fwd = torch.clamp_min(sm.pdf, 1e-20)
            e_dvc = (cos_out / pdf_fwd) * (e_dvc * pdf_rev + e_dvcm)
            e_dvcm = 1.0 / pdf_fwd
            pdf_in_sa = pdf_fwd
            alive = valid & sm.valid
            e_thr = select(alive, Vec3(e_thr.x * sm.g.x, e_thr.y * sm.g.y, e_thr.z * sm.g.z))
            o = pt_mod._offset_origin(vx.pos, vx.gn, wo_w, eps)
            d = wo_w
    return _Walk(E, e_d, e_esc, ltri, lpos, ln, lle, lpdf_a, has_light, L), n_rays


def _fields(idx: Tensor, slots: List[_Slot], *names):
    """The named fields of slot idx of each lane (zeros out of range)."""
    return _sel(idx, [tuple(getattr(sl, k) for k in names) for sl in slots])


def _pick(cond, a, b):
    """where(cond, a, b) over Vec3s or tensors; a Python bool picks one."""
    if isinstance(cond, bool):
        return a if cond else b
    return _where3(cond, a, b) if isinstance(a, Vec3) else torch.where(cond, a, b)


def _connect(ctx: _Ctx, rec: _Walk, s, t):
    """The MIS-weighted contribution F_{s,t} of each lane's chart
    (cmlt.py:354-491): (F, rays). s and t are (N,) lanes, or Python ints (a
    chart of the seeding's enumeration), which take their slots directly and
    compute their own strategy alone: bit for bit what the lanes' one-hot
    selects give there, without the other strategies' work or a shadow
    launch with no lane (s = 0 and the env charts)."""
    view, opts = ctx.view, ctx.opts
    lobes, eps = opts.lobes, opts.ray_eps
    n, dev = rec.e_esc[0].shape[0], view.device
    lanes = isinstance(s, Tensor)
    take = _fields if lanes else (
        lambda idx, slots, *names: tuple(getattr(slots[idx], k) for k in names))
    is0, is1, is2, is_env = s == 0, s == 1, s >= 2, s < 0
    n_rays = torch.zeros((), dtype=torch.float32, device=dev)
    F = Vec3.zeros(n, dev)

    if lanes or not is_env:
        ex_valid, ex_tri, ex, ex_wi, ex_thr, ex_dvcm, ex_dvc = take(
            t - 2, rec.e, "valid", "tri", "vtx", "wi", "thr", "dvcm", "dvc")
        et, eb = orthonormal_basis(ex.sn)
        wi_loc = to_local(ex_wi, et, eb, ex.sn)

    # ---- s = 0: an emissive hit at x_{t-1} ----
    if lanes or is0:
        le = ex.le
        front = dot(ex.gn, ex_wi) > 0.0
        pdf_direct_a = view.lights.pdf_area_of(ex_tri)
        cos_l0 = torch.clamp_min(dot(ex.gn, ex_wi), 1e-8)
        pdf_emit_hit = pdf_direct_a * cos_l0 * INV_PI
        w_cam0 = pdf_direct_a * ex_dvcm + pdf_emit_hit * ex_dvc
        w0 = _pick(t == 2, 1.0, 1.0 / (1.0 + w_cam0)) if lanes or t != 2 else 1.0
        m0 = ex_valid & front & ((le.x + le.y + le.z) > 0.0)
        F = F0 = select(m0, Vec3(ex_thr.x * le.x * w0, ex_thr.y * le.y * w0,
                                 ex_thr.z * le.z * w0))

    # ---- a connection to y_0 (s = 1) or to y_{s-1} (s >= 2) ----
    if lanes or s >= 1:
        if lanes or is2:
            ly_valid, ly, ly_wi, ly_thr, ly_dvcm, ly_dvc = take(
                s - 2, rec.l, "valid", "vtx", "wi", "thr", "dvcm", "dvc")
            ly_pos = _pick(is2, ly.pos, rec.l0_pos)
            ly_sn = _pick(is2, ly.sn, rec.l0_n)
            ly_valid = _pick(is2, ly_valid, rec.l0_valid)
        else:
            ly_pos, ly_sn, ly_valid = rec.l0_pos, rec.l0_n, rec.l0_valid
        conn = ly_pos - ex.pos
        cd2 = torch.clamp_min(dot(conn, conn), 1e-12)
        cd = torch.sqrt(cd2)
        cdir = conn * (1.0 / cd)
        co_loc = to_local(cdir, et, eb, ex.sn)
        fe, pdf_e_fwd, pdf_e_rev = _eval_both(ex.params, wi_loc, co_loc, lobes)
        cos_e = torch.abs(co_loc.z)
        cos_at_l = dot(rec.l0_n, -cdir)
        F1 = F2 = ok2 = None
        if lanes or is1:  # mlt.py's presample s = 1 block
            abs_cos_l = torch.clamp_min(torch.abs(cos_at_l), 1e-8)
            pdf_l_sa = rec.l0_pdf_a * cd2 / abs_cos_l
            w_light1 = pdf_e_fwd / torch.clamp_min(pdf_l_sa, 1e-20)
            emis_full = rec.l0_pdf_a * torch.clamp_min(cos_at_l, 0.0) * INV_PI
            w_cam1 = (emis_full * cos_e / (torch.clamp_min(pdf_l_sa, 1e-20) * abs_cos_l)
                      * (ex_dvcm + ex_dvc * pdf_e_rev))
            w1 = 1.0 / (w_light1 + 1.0 + w_cam1)
            scale1 = cos_e * w1 / torch.clamp_min(pdf_l_sa, 1e-20)
            l0_le = rec.l0_le
            F1 = Vec3(ex_thr.x * fe.x * l0_le.x * scale1, ex_thr.y * fe.y * l0_le.y * scale1,
                      ex_thr.z * fe.z * l0_le.z * scale1)
        if lanes or is2:  # mlt.py's presample s >= 2 block
            lt_b, lb_b = orthonormal_basis(ly_sn)
            lwi_loc = to_local(ly_wi, lt_b, lb_b, ly_sn)
            lwo_loc = to_local(-cdir, lt_b, lb_b, ly_sn)
            fl, pdf_l_fwd, pdf_l_rev = _eval_both(ly.params, lwi_loc, lwo_loc, lobes)
            cos_lv = torch.abs(lwo_loc.z)
            g2 = cos_e * cos_lv / cd2
            pdf_e_fwd_a = pdf_e_fwd * cos_lv / cd2
            pdf_l_fwd_a = pdf_l_fwd * cos_e / cd2
            w_light2 = pdf_e_fwd_a * (ly_dvcm + ly_dvc * pdf_l_rev)
            w_cam2 = pdf_l_fwd_a * (ex_dvcm + ex_dvc * pdf_e_rev)
            amp2 = g2 * (1.0 / (w_light2 + 1.0 + w_cam2))
            F2 = Vec3(ex_thr.x * fe.x * ly_thr.x * fl.x * amp2,
                      ex_thr.y * fe.y * ly_thr.y * fl.y * amp2,
                      ex_thr.z * fe.z * ly_thr.z * fl.z * amp2)
            ok2 = (g2 > 0.0) & ((fl.x + fl.y + fl.z) > 0.0)
        # one shadow ray for the connection lanes
        need_vis = ex_valid & ly_valid & ((fe.x + fe.y + fe.z) > 0.0) & _pick(
            is1, cos_at_l > 1e-6, ok2)
        if lanes:
            need_vis = ~is0 & (s >= 1) & need_vis
        so = pt_mod._offset_origin(ex.pos, ex.gn, cdir, eps)
        occ = ctx.tr.anyhit(so, cdir, 0.0, cd * (1.0 - 1e-3), need_vis)
        n_rays = _fsum(need_vis)
        F = select(need_vis & ~occ, _pick(is1, F1, F2))
        if lanes:
            F = _where3(is0, F0, F)

    # ---- s = -1: an eye path escaping on segment t, weight 1 ----
    if lanes or is_env:
        last = len(rec.e_esc) - 1
        esc_ok, d_esc, thr_esc = (
            _sel(torch.clamp(t - 1, 0, last), [(e, d, sl.thr) for e, d, sl in
                                               zip(rec.e_esc, rec.e_d, rec.e)])
            if lanes else (rec.e_esc[min(max(t - 1, 0), last)], rec.e_d[min(max(t - 1, 0), last)],
                           rec.e[min(max(t - 1, 0), last)].thr))
        e_l = scene_env_radiance(view, d_esc)
        env = Vec3(thr_esc.x * e_l.x, thr_esc.y * e_l.y, thr_esc.z * e_l.z)
        F = _where3(is_env & esc_ok, env, select(~is_env, F)) if lanes else select(esc_ok, env)
    # dead lanes and infinite paths carry an exact zero
    return select(torch.isfinite(F.x + F.y + F.z), F), n_rays


def _eval_chart(ctx: _Ctx, u_l: Tensor, u_e: Tensor, s, t):
    """The full charted evaluation (cmlt.py:494-503): (contrib (N, 3),
    pixel (N,) int64, the walk, rays)."""
    rec, nr1 = _walk(ctx, u_l, u_e)
    F, nr2 = _connect(ctx, rec, s, t)
    px = torch.clamp((u_e[:, 0] * ctx.res_x).to(torch.int32), 0, ctx.res_x - 1)
    py = torch.clamp((u_e[:, 1] * ctx.res_y).to(torch.int32), 0, ctx.res_y - 1)
    return F.stack(), (py * ctx.res_x + px).long(), rec, nr1 + nr2


# ---------------------------------------------------------------------------
# Seeding (sample_seeds and the st counters, cmlt.cu:687-714)
# ---------------------------------------------------------------------------

def _uniforms(seed: int, ctr: Tensor) -> Tensor:
    return uniform_from_bits(hash_combine(seed, ctr))


def init_state(view: SceneView, opts: CMLTOptions, res_x: int, res_y: int, n: int,
               seed: int = 0) -> CMLTState:
    """Seed n chains (cmlt.py:510-598): n_seed_rounds rounds of uniform
    candidates, each evaluated in every chart; the chains are drawn by
    stratified inversion of one luminance CDF over all (round, chart, lane)
    candidates, their coordinates re-derived from the counter hashes, and
    the candidates' mean luminance is the brightness b."""
    K = opts.max_path_length
    if K < 3:
        raise ValueError("CMLT needs max_path_length >= 3")
    DL, DE = _dims_l(K), _dims_e(K)
    dev = view.device
    ctx = _make_ctx(view, opts, res_x, res_y, n, "CMLT")
    key0 = (seed * 2654435761 + 777) & M32
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    cl = charts(K)
    total = torch.zeros((), dtype=torch.float32, device=dev)
    lum_parts = []
    for r in range(opts.n_seed_rounds):
        seed_r = hash_combine(key0, r * 7 + 1), hash_combine(key0, r * 7 + 2)
        rec, _ = _walk(ctx, _uniforms(seed_r[0], _counter(n, DL, dev)),
                       _uniforms(seed_r[1], _counter(n, DE, dev)))
        for s_, t_ in cl:
            F, _ = _connect(ctx, rec, s_, t_)
            lum = _lum(*F)
            total = total + lum.mean()
            lum_parts.append(lum)
        del rec
    lums = torch.cat(lum_parts)  # (R * C * n,)
    del lum_parts
    c = len(cl)
    cdf = torch.cumsum(lums.double(), 0).float()
    del lums
    tot = torch.clamp_min(cdf[-1], 1e-20)
    u_pick = ((torch.arange(n, dtype=torch.float32, device=dev)
               + _uniforms(key0 ^ 0x515CA, lane)) / float(n)) * tot
    idx = torch.clamp(torch.searchsorted(cdf, u_pick), 0, cdf.shape[0] - 1)
    del cdf
    r_idx, ci_idx, lane_idx = idx // (c * n), (idx // n) % c, idx % n

    def remat(d, tag):
        ctr = (lane_idx[:, None] * d + torch.arange(d, dtype=torch.int64, device=dev)) & M32
        seed_r = hash_combine(key0, (r_idx * 7 + tag) & M32)
        return uniform_from_bits(hash_combine(seed_r[:, None], ctr))

    u_l, u_e = remat(DL, 1), remat(DE, 2)
    s_pick = torch.tensor([s_ for s_, _ in cl], dtype=torch.int32, device=dev)[ci_idx]
    t_pick = torch.tensor([t_ for _, t_ in cl], dtype=torch.int32, device=dev)[ci_idx]
    contrib, pixel, _, _ = _eval_chart(ctx, u_l, u_e, s_pick, t_pick)
    lum = _lum(contrib[:, 0], contrib[:, 1], contrib[:, 2])
    return CMLTState(u_l=u_l, u_e=u_e, s=s_pick, t=t_pick, lum=torch.clamp_min(lum, 0.0),
                     contrib=contrib, pixel=pixel,
                     brightness=total / float(opts.n_seed_rounds),
                     key=key0 ^ 0x5BD1E995, step_idx=0)


# ---------------------------------------------------------------------------
# Chain steps
# ---------------------------------------------------------------------------

def _mutate(u: Tensor, key: int, opts: CMLTOptions) -> Tensor:
    """Kelemen mutation (cmlt.py:605-619): fresh uniforms with probability
    large_step_prob, else an exponential small step of either sign in every
    dimension, wrapped into [0, 1)."""
    n, d = u.shape
    ctr = _counter(n, d, u.device)
    r1 = _uniforms(key, ctr)
    r2 = _uniforms(key ^ 0x9E3779B9, ctr)
    large = _uniforms(key ^ 0x85EBCA6B, torch.arange(n, dtype=torch.int64, device=u.device))
    s1, s2 = 1.0 / 1024.0, opts.small_step_size
    mag = s2 * torch.exp(_log_ratio(s1, s2) * r1)
    rem = torch.fmod(u + torch.where(r2 < 0.5, mag, -mag), 1.0)  # jnp.mod: the divisor's sign
    return torch.where((large < opts.large_step_prob)[:, None], r1,
                       torch.where(rem < 0.0, rem + 1.0, rem))


def _splat(splat: Tensor, state: CMLTState, contrib_p: Tensor, pixel_p: Tensor,
           lum_p: Tensor, a: Tensor) -> None:
    """The expected-value splats of both paths (cmlt.py:622-630)."""
    b = state.brightness
    lum_c = torch.clamp_min(state.lum, 0.0)
    w_old = torch.where(lum_c > 0.0, (1.0 - a) * b / torch.clamp_min(lum_c, 1e-12), 0.0)
    w_new = torch.where(lum_p > 0.0, a * b / torch.clamp_min(lum_p, 1e-12), 0.0)
    splat.index_add_(0, state.pixel, state.contrib * w_old[:, None])
    splat.index_add_(0, pixel_p, contrib_p * w_new[:, None])


def _put(u: Tensor, cols: dict) -> Tensor:
    """u with column c replaced by where(mask, value, u[:, c]) for each
    c: (mask, value) of cols."""
    u = u.clone()
    for c, (m, val) in cols.items():
        u[:, c] = torch.where(m, val, u[:, c])
    return u


def _swap_proposal(ctx: _Ctx, rec: _Walk, state: CMLTState, key: int):
    """The +-1 chart-swap proposal from the replayed path (cmlt.py:633-782):
    (u_l', u_e', s', t', ok, pdf_removed / pdf_added x P_rev / P_fwd)."""
    view, opts = ctx.view, ctx.opts
    K = opts.max_path_length
    LS = K - 2
    s, t = state.s, state.t
    lane = torch.arange(s.shape[0], dtype=torch.int64, device=s.device)
    u_dir = _uniforms(key ^ 0x51A9C3, lane)
    u_aux1 = _uniforms(key ^ 0x7E1D22, lane)
    u_aux2 = _uniforms(key ^ 0x3C6EF3, lane)

    k_seg = s + t - 1
    can_up = (s >= 0) & (t >= 3) & (s + 1 <= k_seg - 1)  # t' >= 2
    can_dn = s >= 1  # env charts (s = -1) sit swaps out
    both = can_up & can_dn
    go_up = torch.where(both, u_dir < 0.5, can_up)
    p_fwd = torch.where(both, 0.5, 1.0)
    s_new = torch.where(go_up, s + 1, s - 1)
    t_new = torch.where(go_up, t - 1, t + 1)
    # the reverse proposal's probability from (s', t'), which must exist
    can_up_r = (t_new >= 3) & (s_new + 1 <= k_seg - 1)
    can_dn_r = s_new >= 1
    p_rev = torch.where(can_up_r & can_dn_r, 0.5, 1.0)
    valid = (can_up | can_dn) & torch.where(go_up, can_dn_r, can_up_r)

    # ---- the chart's end vertices ----
    ex_tri, ex_u, ex_v, ex_valid, ex, ex_wi, ex_pdf_in, ex_cos_in, ex_d2 = _fields(
        t - 2, rec.e, "tri", "u", "v", "valid", "vtx", "wi", "pdf_in", "cos_in", "d2")
    is2 = s >= 2
    ly_valid, ly, ly_wi, ly_pdf_in, ly_cos_in, ly_d2 = _fields(
        s - 2, rec.l, "valid", "vtx", "wi", "pdf_in", "cos_in", "d2")
    ly_pos = _where3(is2, ly.pos, rec.l0_pos)
    ly_sn = _where3(is2, ly.sn, rec.l0_n)
    ly_valid = torch.where(is2, ly_valid, rec.l0_valid)

    # the connection segment x_{t-1} -> y_{s-1}, whose generator changes
    conn = ly_pos - ex.pos
    cd2 = torch.clamp_min(dot(conn, conn), 1e-12)
    cdir = conn * (1.0 / torch.sqrt(cd2))

    # ==== +1: x_{t-1} moves to the light side ====
    # removed: the eye scatter at x_{t-2} that made x_{t-1}
    pdf_rm_up = ex_pdf_in * ex_cos_in / ex_d2
    # added, s == 0: the light pick of x_{t-1}'s triangle at its (u, v)
    pdf_pick = view.lights.pdf_area_of(ex_tri)
    su0 = torch.clamp(1.0 - ex_u, 1e-6, 1.0)
    inv_u0 = su0 * su0
    inv_u1 = torch.clamp(ex_v / su0, 0.0, 1.0)
    cdf = view.lights.cdf
    cdf_hi = cdf[torch.clamp_min(ex_tri, 0).long()]
    cdf_lo = torch.where(ex_tri > 0, cdf[torch.clamp_min(ex_tri - 1, 0).long()], 0.0)
    inv_u2 = cdf_lo + u_aux1 * torch.clamp_min(cdf_hi - cdf_lo, 1e-12)
    # added, s == 1: the emission direction at y_0 towards x_{t-1}
    lt0, lb0 = orthonormal_basis(rec.l0_n)
    demit_loc = to_local(-cdir, lt0, lb0, rec.l0_n)
    em_u0, em_u1, ok_em = binv.invert_cosine_hemisphere(demit_loc)
    pdf_em_sa = torch.clamp_min(demit_loc.z, 0.0) * INV_PI
    # added, s >= 2: the BSDF scatter at y_{s-1} towards x_{t-1}
    lyt, lyb = orthonormal_basis(ly_sn)
    inv_l = binv.invert(ly.params, to_local(ly_wi, lyt, lyb, ly_sn),
                        to_local(-cdir, lyt, lyb, ly_sn), u_aux1, u_aux2, opts.lobes)
    cos_at_v = torch.abs(dot(ex.sn, cdir))
    pdf_add_up = torch.where(s == 0, pdf_pick,
                             torch.where(s == 1, pdf_em_sa, inv_l.pdf) * cos_at_v / cd2)
    ok_up = ex_valid & ly_valid & (t >= 3) & torch.where(
        s == 0, pdf_pick > 0.0, torch.where(s == 1, ok_em, inv_l.ok))
    up = go_up & valid
    w0, w1 = up & (s == 0), up & (s == 1)
    cols = {0: (w0, inv_u0), 1: (w0, inv_u1), 2: (w0, inv_u2), 3: (w1, em_u0), 4: (w1, em_u1)}
    for j in range(max(LS - 1, 0)):  # the scatter at y_{j+1}: s - 2 == j
        wj = up & (s == j + 2)
        for k, val in enumerate((inv_l.u0, inv_l.u1, inv_l.u2)):
            cols[5 + 3 * j + k] = (wj, val)
    u_l_new = _put(state.u_l, cols)

    # ==== -1: y_{s-1} moves to the eye side ====
    # removed: the light-side generation of y_{s-1} (s == 1: the pick of y_0)
    pdf_rm_dn = torch.where(s == 1, rec.l0_pdf_a, ly_pdf_in * ly_cos_in / ly_d2)
    # added: the eye scatter at x_{t-1} towards y_{s-1}
    ext, exb = orthonormal_basis(ex.sn)
    inv_e = binv.invert(ex.params, to_local(ex_wi, ext, exb, ex.sn),
                        to_local(cdir, ext, exb, ex.sn), u_aux1, u_aux2, opts.lobes)
    pdf_add_dn = inv_e.pdf * torch.abs(dot(ly_sn, cdir)) / cd2
    ok_dn = ex_valid & ly_valid & inv_e.ok
    dn = ~go_up & valid
    cols = {}
    for i in range(K - 1):  # the scatter at x_{i+1}: t - 1 == i + 1
        wi_m = dn & (t == i + 2)
        for k, val in enumerate((inv_e.u0, inv_e.u1, inv_e.u2)):
            cols[2 + 3 * i + k] = (wi_m, val)
    u_e_new = _put(state.u_e, cols)

    pdf_removed = torch.where(go_up, pdf_rm_up, pdf_rm_dn)
    pdf_added = torch.where(go_up, pdf_add_up, pdf_add_dn)
    ok = (valid & torch.where(go_up, ok_up, ok_dn) & (pdf_added > 1e-30)
          & torch.isfinite(pdf_removed) & torch.isfinite(pdf_added) & (pdf_removed > 0.0))
    ratio = torch.where(ok, pdf_removed / torch.clamp_min(pdf_added, 1e-30) * (p_rev / p_fwd),
                        0.0)
    return u_l_new, u_e_new, s_new, t_new, ok, ratio


def is_swap_step(opts: CMLTOptions, step_idx: int) -> bool:
    """Whether chain step step_idx proposes a chart swap (cmlt.py:795-799)."""
    freq = opts.swap_frequency
    return freq > 0 and step_idx % freq == freq - 1


def step(view: SceneView, opts: CMLTOptions, res_x: int, res_y: int,
         state: CMLTState) -> Tuple[CMLTState, Tensor, Tensor]:
    """One chain step of every lane (cmlt.py:785-882): a Kelemen mutation
    or, every swap_frequency-th step, a +-1 chart swap. Returns (state, the
    (H*W, 3) splat in per-pixel-mean units, rays)."""
    n = state.u_e.shape[0]
    dev = view.device
    ctx = _make_ctx(view, opts, res_x, res_y, n, "CMLT")
    key = hash_combine(state.key, 0xA511E9)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    splat = torch.zeros((res_x * res_y, 3), dtype=torch.float32, device=dev)
    if is_swap_step(opts, state.step_idx):
        # replay the current path for its vertex records
        _, _, rec, nr1 = _eval_chart(ctx, state.u_l, state.u_e, state.s, state.t)
        u_l_p, u_e_p, s_p, t_p, ok, ratio = _swap_proposal(ctx, rec, state, key)
        del rec
        contrib_p, pixel_p, _, nr2 = _eval_chart(ctx, u_l_p, u_e_p, s_p, t_p)
        nr = nr1 + nr2
        lum_p = _lum(contrib_p[:, 0], contrib_p[:, 1], contrib_p[:, 2])
        a = torch.clamp(lum_p / torch.clamp_min(state.lum, 1e-12) * ratio, 0.0, 1.0)
        a = torch.where(ok & (state.lum > 0.0), a,
                        torch.where(ok & (lum_p > 0.0), 1.0, 0.0))
        acc_salt = 0xC2B2AF
    else:
        u_l_p = _mutate(state.u_l, hash_combine(key, 1), opts)
        u_e_p = _mutate(state.u_e, hash_combine(key, 2), opts)
        # a large step also proposes a chart drawn uniformly (a symmetric
        # independence move over the chart dimension)
        cl = charts(opts.max_path_length)
        big = _uniforms(key ^ 0x77AA11, lane) < opts.large_step_prob
        ci = torch.clamp_max((_uniforms(key ^ 0x33CC55, lane) * len(cl)).to(torch.int32),
                             len(cl) - 1).long()
        s_p = torch.where(big, torch.tensor([c[0] for c in cl], dtype=torch.int32,
                                            device=dev)[ci], state.s)
        t_p = torch.where(big, torch.tensor([c[1] for c in cl], dtype=torch.int32,
                                            device=dev)[ci], state.t)
        contrib_p, pixel_p, _, nr = _eval_chart(ctx, u_l_p, u_e_p, s_p, t_p)
        lum_p = _lum(contrib_p[:, 0], contrib_p[:, 1], contrib_p[:, 2])
        a = torch.clamp(lum_p / torch.clamp_min(state.lum, 1e-12), 0.0, 1.0)
        a = torch.where(state.lum <= 0.0, 1.0, a)
        acc_salt = 0xC2B2AE
    _splat(splat, state, contrib_p, pixel_p, lum_p, a)
    acc = _uniforms(key ^ acc_salt, lane) < a
    acc2 = acc[:, None]
    state = CMLTState(
        u_l=torch.where(acc2, u_l_p, state.u_l), u_e=torch.where(acc2, u_e_p, state.u_e),
        s=torch.where(acc, s_p, state.s), t=torch.where(acc, t_p, state.t),
        lum=torch.where(acc, lum_p, state.lum), contrib=torch.where(acc2, contrib_p, state.contrib),
        pixel=torch.where(acc, pixel_p, state.pixel), brightness=state.brightness,
        key=hash_combine(key, 0xDEADBEEF), step_idx=state.step_idx + 1)
    scale = float(np.float32(res_x * res_y) / np.float32(n))  # JAX's float32 ratio
    return state, splat * scale, nr


def render_step_fb(view: SceneView, opts: CMLTOptions, res_x: int, res_y: int, instance: int,
                   seed: int, state: CMLTState):
    """The context's pass (context.py:65-101): one step, plus the directly
    visible environment (pt.direct_env_image) in COMPOSITED. Returns
    (the pass output, the new state)."""
    state, splat, rays = step(view, opts, res_x, res_y, state)
    env_img, env_rays = pt_mod.direct_env_image(view, res_x, res_y, instance, seed)
    img = splat + env_img
    out = pt_mod.composited_output(Vec3(img[:, 0], img[:, 1], img[:, 2]), rays + env_rays,
                                   torch.zeros(res_x * res_y, device=view.device))
    return out, state
