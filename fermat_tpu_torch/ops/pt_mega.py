"""K3a / K3b — the whole-pass PT megakernel and its replay-gradient twin
(fermat_tpu/ops/pallas_pt_mega.py).

For scenes of at most MEGA_T_MAX triangles, MEGA_M_MAX materials and
MEGA_L_MAX emissive triangles, one launch runs a whole progressive pass:
camera ray, per-bounce closest hit with the winner's attributes, constant
environment on a miss, emissive hit with MIS, mesh-light NEE (CDF pick over
the emissive subset, shadow any-hit), composite-BSDF sampling, Russian
roulette, channel routing and the first-hit G-buffer. The replay kernel
retraces the same paths (same QMC, same RR) and accumulates
d loss / d materials.diffuse for a per-pixel adjoint.

On CUDA tables the wrappers launch `_mega_forward` / `_mega_grad` of
csrc/mega.cu; on CPU tables they run the plain versions `_mega_plain` /
`_mega_grad_plain`, lane-wise PyTorch transcriptions of the Pallas kernels
built from the port's own rng, sampling, math and composite-BSDF functions.

The scene tables keep the JAX row content and column order, without the
TPU's lane replication:
  tri   (T, 53)  MeshView.shade_rows() ++ pdf_area
  mat   (M, 52)  MaterialTable.packed_rows() ++ 33 E-PWL coefficients
  light (L, 17)  the emissive subset's first 16 light-row columns ++ its CDF
  cam   (24,)    eye, U, V, W, env, eps, cone spread, 1/res_x, 1/res_y,
                 res_x, res_x*res_y, 0, 0, 0

Parity traps of the megakernel, followed here and in mega.cu (the Pallas
line numbers are of pallas_pt_mega.py):
  * the G-buffer `tri` is a hit flag, 1 or -1 (:521, :1109), and
    `material` is round(mat id) (:1113);
  * E comes from the 32-knot PWL `e_fn` (:375-381), not the bilinear table;
  * the camera ray multiplies by inv_rx = float32(1/res_x) from the table
    (:460-461), the pixel coordinate goes int32 -> float32 (:458-459);
  * the NEE direction is to_l / dist (:586), a division;
  * a dead lane gets t_lim = -1 (:494), a hit is t < 3e38; NEE traces with
    tmin 0 and t_lim = dist * (1 - 1e-3) (:603-606);
  * the light pick is count(cdf <= u2) over the emissive subset, clipped to
    n_lights - 1 (:391-394);
  * RR uses q = 1 before rr_start_bounce (:637-648), which keeps and scales
    by exactly 1, so the sample is not drawn there;
  * K3b: a term whose f is exactly 0 at a vertex contributes 0 (:765-770),
    and clearcoat is gated out (mega_grad_eligible).

Unlike the JAX path, which renders an ineligible view silently, the port
raises NotImplementedError: mega.cu sizes its shared memory by the caps.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from fermat_tpu_torch.bsdf import ggx
from fermat_tpu_torch.bsdf.composite import (GLOSSY_REFL, BsdfParams, diffuse_refl_unit,
                                             f_split)
from fermat_tpu_torch.bsdf.composite import sample as bsdf_sample
from fermat_tpu_torch.core.camera import camera_frame
from fermat_tpu_torch.core.math import Vec3, dot, normalize, orthonormal_basis, to_local, to_world
from fermat_tpu_torch.core.rng import M32, TiledSequence
from fermat_tpu_torch.core.sampling import power_heuristic, square_to_uniform_triangle
from fermat_tpu_torch.ops import _cuda
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel, check_cuda_tensor
from fermat_tpu_torch.ops.gather import _gather_plain
from fermat_tpu_torch.ops.trace import _any_plain, _closest_plain

Tensor = torch.Tensor

MEGA_T_MAX = 128  # triangle cap (the kernel stages all rows in shared memory)
MEGA_M_MAX = 32  # material cap
MEGA_L_MAX = 32  # emissive-triangle cap
GRAD_M_MAX = 16  # replay state is O(M) per lane
_BIG = 3.0e38
_E_KNOTS = 32
N_OUT = 27  # ld xyz, lf xyz, ls xyz, depth, hit, n xyz, p xyz, uv, mat, da xyz, sa xyz, rays
TRI_COLS, MAT_COLS, LIGHT_COLS, CAM_COLS = 53, 52, 17, 24
BLOCK = 128  # mega.cu kBlock; K3b's partial buffer has a row per BLOCK pixels
N_OPTS = 14

FORWARD = CudaKernel(
    "mega_forward", "mega.cu", "fermat_mega_forward",
    [P, I, P, I, P, I, P, ctypes.c_uint, ctypes.c_uint, I, I, P, P],
    replaces="fermat_tpu/ops/pallas_pt_mega.py:705 (_mega_impl, kernel _mega_kernel :427)",
)
GRAD = CudaKernel(
    "mega_grad", "mega.cu", "fermat_mega_grad",
    [P, I, P, I, P, I, P, ctypes.c_uint, ctypes.c_uint, I, I, P, P, P, I],
    replaces="fermat_tpu/ops/pallas_pt_mega.py:1015 (_mega_grad_impl, kernel "
             "_mega_grad_kernel :745)",
)


class MegaTables(NamedTuple):
    tri: Tensor  # (T, 53)
    mat: Tensor  # (M, 52)
    light: Tensor  # (max(L, 1), 17)
    cam: Tensor  # (24,)
    n_tris: int
    n_mats: int
    n_lights: int  # max(L, 1): a scene without emitters gets one dead row


@functools.lru_cache(maxsize=None)
def _albedo_table_f64() -> np.ndarray:
    return np.asarray(ggx._build_albedo_table(), np.float64)


def _e_pwl_coeffs(roughness: np.ndarray) -> np.ndarray:
    """(M, 33) exact PWL rebuild of the F=1 albedo lookup at fixed roughness
    (pallas_pt_mega.py:101-125): E(c) = v0 + sum_j a_j relu(c - k_j),
    k_j = (j + 0.5)/32, reproduces the bilinear lookup with flat ends."""
    tab = _albedo_table_f64()
    res = _E_KNOTS
    r = np.clip(roughness, 0.0, 1.0) * res - 0.5
    r0 = np.clip(np.floor(r), 0, res - 1).astype(np.int64)
    r1 = np.minimum(r0 + 1, res - 1)
    fr = np.clip(r - r0, 0.0, 1.0)
    rows = tab[r0] * (1.0 - fr)[:, None] + tab[r1] * fr[:, None]  # (M, 32)
    s = (rows[:, 1:] - rows[:, :-1]) / (1.0 / res)  # segment slopes
    a = np.zeros((rows.shape[0], res), np.float64)
    a[:, 0] = s[:, 0]
    a[:, 1:31] = s[:, 1:] - s[:, :-1]
    a[:, 31] = -s[:, 30]
    return np.concatenate([rows[:, :1], a], axis=1).astype(np.float32)


def _n_emissive(view) -> int:
    return int((view.lights.pdf_area > 0.0).sum())


def mega_eligible(view, opts) -> bool:
    """The static gate of pallas_pt_mega.py:136-162 on the port's SceneView:
    the megakernel's scene has mesh emitters and a constant environment
    only, so an environment map, point, directional or analytic area
    lights, shadow sets or textures keep a view out. glossy_model="ltc"
    keeps an option set out too: JAX's gate lets it through, but its
    megakernel cannot run it (its LTC fetch fails to broadcast inside the
    kernel), so the port's megakernel has no LTC lobe."""
    n_t = view.mesh.n_triangles
    if n_t == 0 or n_t > MEGA_T_MAX:
        return False
    if view.env_map is not None or view.area_lights is not None or view.has_textures:
        return False
    if view.point_lights is not None or view.dir_lights is not None:
        return False
    if view.shadow_sets is not None:
        return False
    if view.mesh.materials.roughness.shape[0] > MEGA_M_MAX:
        return False
    if opts.nee != "mesh" or opts.queue_compaction or opts.glossy_model != "ggx":
        return False
    if opts.debug_nee_no_shadow or opts.debug_nee_fixed_light or opts.debug_nee_cheap_eval:
        return False
    return _n_emissive(view) <= MEGA_L_MAX


def mega_grad_eligible(view, opts) -> bool:
    """mega_eligible, no clearcoat (the delta coat's g is not f-linear) and
    at most GRAD_M_MAX materials (pallas_pt_mega.py:1001-1008)."""
    if not mega_eligible(view, opts) or opts.clearcoat:
        return False
    return view.mesh.materials.roughness.shape[0] <= GRAD_M_MAX


def build_mega_tables(view, res_x: int, res_y: int, eps: float) -> MegaTables:
    """The scene tables of pallas_pt_mega.py:165-215, built on the host in
    float32 and moved to the view's device."""
    cpu = lambda t: t.detach().cpu()
    mesh = view.mesh
    mats = mesh.materials
    n_mats = int(mats.roughness.shape[0])
    mid = cpu(mesh.material_id)
    if n_mats == 0 or bool(((mid < 0) | (mid >= n_mats)).any()):
        raise ValueError("build_mega_tables: a triangle's material id is outside the table")
    pdf_area = cpu(view.lights.pdf_area)
    tri = torch.cat([cpu(mesh.shade_rows()), pdf_area[:, None]], dim=1)
    e_coef = torch.from_numpy(_e_pwl_coeffs(cpu(mats.roughness).numpy()))
    mat = torch.cat([cpu(mats.packed_rows()), e_coef], dim=1)

    l_mask = (pdf_area > 0.0).numpy()
    l_rows = cpu(view.lights.rows).numpy()[l_mask][:, :16]
    l_cdf = cpu(view.lights.cdf).numpy()[l_mask]
    n_lights = int(l_rows.shape[0])
    if n_lights == 0:  # one dead row: pdf_area 0 makes every NEE sample unable
        l_rows = np.zeros((1, 16), np.float32)
        l_cdf = np.ones((1,), np.float32)
    light = torch.from_numpy(
        np.concatenate([l_rows, l_cdf[:, None]], axis=1).astype(np.float32))

    cam = view.camera.to("cpu")
    u, v, w = camera_frame(cam, res_x / res_y)
    cone_spread = float(np.tan(float(cam.fov) * 0.5) * 2.0 / res_x)
    env = cpu(view.env)
    f = lambda a: [float(a.x), float(a.y), float(a.z)]
    c_row = torch.tensor(
        f(cam.eye) + f(u) + f(v) + f(w) + [float(env[0]), float(env[1]), float(env[2])]
        + [eps, cone_spread, 1.0 / res_x, 1.0 / res_y, float(res_x), float(res_x * res_y),
           0.0, 0.0, 0.0],
        dtype=torch.float32)
    dev = view.device
    return MegaTables(
        tri=tri.contiguous().to(dev), mat=mat.contiguous().to(dev),
        light=light.contiguous().to(dev), cam=c_row.to(dev),
        n_tris=int(mesh.n_triangles), n_mats=n_mats, n_lights=max(n_lights, 1),
    )


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise NotImplementedError(
            f"tracer='mega': {what} is outside the megakernel's caps ({MEGA_T_MAX} "
            f"triangles, {MEGA_M_MAX} materials, {MEGA_L_MAX} emitters, mesh NEE, no "
            "environment map, point, directional or area lights, no shadow sets, no "
            "queue compaction, no debug NEE switches); the kernel sizes its shared "
            "memory by them, so the view is refused rather than rendered")


def _opt_vector(opts) -> list:
    lobes = tuple(bool(x) for x in opts.lobes)
    if len(lobes) != 4:
        raise ValueError(f"lobes must have 4 entries, got {opts.lobes!r}")
    return [int(x) for x in (*lobes, opts.clearcoat, opts.rr, opts.rr_start_bounce,
                              opts.dims_per_bounce, opts.direct_lighting_nee,
                              opts.direct_lighting_bsdf, opts.indirect_lighting_nee,
                              opts.indirect_lighting_bsdf, opts.visible_lights,
                              max(opts.max_path_length, 1))]


def main_switches(opts) -> bool:
    """Whether K3a/K3b run these options on their build with the main
    path's option switches as constants (mega.cu `MEGA_MAIN_SWITCHES`);
    asks the built library, so it needs the CUDA toolchain."""
    fn = _cuda._library(FORWARD.source).fermat_mega_main_switches
    fn.argtypes, fn.restype = [P], I
    ov = (ctypes.c_int * N_OPTS)(*_opt_vector(opts))
    return bool(fn(ctypes.addressof(ov)))


# ---------------------------------------------------------------------------
# Plain versions (lane-wise PyTorch transcription of the Pallas kernels)
# ---------------------------------------------------------------------------

def _pwl_e_fn(ecoef: Tensor):
    """e_fn hook of the megakernel (pallas_pt_mega.py:375-381) for per-lane
    (N, 33) coefficients; clamp and clamp_min propagate NaN as jnp.clip and
    jnp.maximum do."""
    def e_fn(_roughness, cos_t):
        c = torch.clamp(torch.abs(cos_t), 0.0, 1.0)
        acc = ecoef[:, 0]
        for j in range(_E_KNOTS):
            acc = acc + ecoef[:, 1 + j] * torch.clamp_min(c - (j + 0.5) / _E_KNOTS, 0.0)
        return acc
    return e_fn


def _vec(t: Tensor, c: int) -> Vec3:
    return Vec3(t[..., c], t[..., c + 1], t[..., c + 2])


def _plain_pass(tb: MegaTables, opts, res_x: int, n: int, instance: int, seed: int,
                adjoint: Tensor = None):
    """One pass of _mega_kernel (adjoint None) -> (27, N) lanes, or of
    _mega_grad_kernel -> (N, M, 3) per-lane gradient terms. The forward
    lanes are computed in both cases; the replay adds U and G."""
    # pos + gn * (side * eps): side is +-1, so it rounds like the Pallas
    # kernel's gn * side * eps (:415-421)
    from fermat_tpu_torch.integrators.pt import _offset_origin

    dev = tb.tri.device
    f32 = dict(dtype=torch.float32, device=dev)
    grad = adjoint is not None
    M = tb.n_mats
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    seq = TiledSequence.create(seed, instance)
    cam = tb.cam
    eye, cam_u, cam_v, cam_w = _vec(cam, 0), _vec(cam, 3), _vec(cam, 6), _vec(cam, 9)
    env = (cam[12], cam[13], cam[14])
    eps, inv_rx, inv_ry = cam[15], cam[17], cam[18]
    lanes = lambda s: s.expand(n)
    tris9 = tb.tri[:, :9].t().contiguous()
    cdf_l = tb.light[:, 16]

    # camera ray (pallas_pt_mega.py:453-471)
    jx, jy = seq.sample_2d(pix, 0)
    pxf = (pix % res_x).to(torch.int32).to(torch.float32)
    pyf = (pix // res_x).to(torch.int32).to(torch.float32)
    dx_c = ((pxf + jx) * inv_rx) * 2.0 - 1.0
    dy_c = ((pyf + jy) * inv_ry) * 2.0 - 1.0
    d = normalize(Vec3(dx_c * cam_u.x + dy_c * cam_v.x + cam_w.x,
                       dx_c * cam_u.y + dy_c * cam_v.y + cam_w.y,
                       dx_c * cam_u.z + dy_c * cam_v.z + cam_w.z))
    o = Vec3(lanes(eye.x), lanes(eye.y), lanes(eye.z))
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    zero = torch.zeros(n, **f32)
    thr = Vec3(zero + 1.0, zero + 1.0, zero + 1.0)
    prev_pdf = zero
    channel = torch.zeros(n, dtype=torch.int32, device=dev)
    acc = [Vec3(zero, zero, zero) for _ in range(3)]  # direct, diffuse, specular
    rays = zero
    gbuf = None
    if grad:
        adj = Vec3(adjoint[:, 0], adjoint[:, 1], adjoint[:, 2])
        U = torch.zeros((n, M, 3), **f32)
        G = torch.zeros((n, M, 3), **f32)
        mat_ids = torch.arange(M, device=dev)

    def add_routed(contrib: Vec3, mask: Tensor, ch: Tensor) -> None:
        for k in range(3):
            w = mask & (ch == k)
            acc[k] = Vec3(acc[k].x + torch.where(w, contrib.x, 0.0),
                          acc[k].y + torch.where(w, contrib.y, 0.0),
                          acc[k].z + torch.where(w, contrib.z, 0.0))

    def add_g(sel: Vec3, local: Vec3 = None, mk: Tensor = None) -> Tensor:
        """G += sel * U (+ where(mk, local, 0)), per (lane, material, channel)."""
        s3 = torch.stack([sel.x, sel.y, sel.z], dim=1)[:, None, :]
        out = G + s3 * U
        if local is not None:
            l3 = torch.stack([local.x, local.y, local.z], dim=1)[:, None, :]
            out = out + torch.where(mk[:, :, None], l3, 0.0)
        return out

    for b in range(max(opts.max_path_length, 1)):
        first = b == 0
        t_lim = torch.where(alive, _BIG, -1.0)
        rays = rays + torch.where(alive, 1.0, 0.0)
        # closest hit; the strict tt < tb loop of :231-314 keeps the lowest
        # index on ties, as _closest_plain does; the winner's row is then
        # fetched (zeros on a miss, like the carry's initial values)
        hit = _closest_plain(tris9, o, d, lanes(eps), t_lim, alive)
        valid = (hit.tri >= 0) & alive
        missed = alive & ~valid
        row = _gather_plain(tb.tri, hit.tri)
        ub, vb, ht = hit.u, hit.v, hit.t
        p0, e1, e2, gn = _vec(row, 0), _vec(row, 3), _vec(row, 6), _vec(row, 9)
        n0, n1, n2 = _vec(row, 12), _vec(row, 15), _vec(row, 18)
        midf, pdf_area_hit = row[:, 27], row[:, 52]
        pos = Vec3(p0.x + e1.x * ub + e2.x * vb, p0.y + e1.y * ub + e2.y * vb,
                   p0.z + e1.z * ub + e2.z * vb)
        w = 1.0 - ub - vb
        sn = normalize(Vec3(n0.x * w + n1.x * ub + n2.x * vb, n0.y * w + n1.y * ub + n2.y * vb,
                            n0.z * w + n1.z * ub + n2.z * vb))
        uv_x = row[:, 21] * w + row[:, 23] * ub + row[:, 25] * vb
        uv_y = row[:, 22] * w + row[:, 24] * ub + row[:, 26] * vb

        add_routed(Vec3(thr.x * env[0], thr.y * env[1], thr.z * env[2]), missed, channel)
        if grad:
            G = add_g(Vec3(torch.where(missed, adj.x * thr.x * env[0], 0.0),
                           torch.where(missed, adj.y * thr.y * env[1], 0.0),
                           torch.where(missed, adj.z * thr.z * env[2], 0.0)))

        wi = Vec3(-d.x, -d.y, -d.z)
        flip = torch.where(dot(gn, wi) < 0.0, -1.0, 1.0)
        sn_f = Vec3(sn.x * flip, sn.y * flip, sn.z * flip)
        t_b, b_b = orthonormal_basis(sn_f)
        wi_loc = to_local(wi, t_b, b_b, sn_f)

        mid = torch.round(midf).long()
        mrow = tb.mat.index_select(0, mid)
        params = BsdfParams(diffuse=_vec(mrow, 0), specular=_vec(mrow, 3),
                            diffuse_trans=_vec(mrow, 9), reflectivity=_vec(mrow, 12),
                            roughness=mrow[:, 15], ior=mrow[:, 16], opacity=mrow[:, 17])
        emissive = _vec(mrow, 6)
        e_fn = _pwl_e_fn(mrow[:, 19:19 + 33])
        if grad:
            mk = valid[:, None] & (mid[:, None] == mat_ids[None, :])

        if first:
            sel = lambda a, fill=0.0: torch.where(valid, a, fill)
            gbuf = [sel(ht, float("inf")), torch.where(valid, 1.0, -1.0),
                    sel(sn_f.x), sel(sn_f.y), sel(sn_f.z), sel(pos.x), sel(pos.y), sel(pos.z),
                    sel(uv_x), sel(uv_y), sel(midf, -1.0),
                    sel(params.diffuse.x), sel(params.diffuse.y), sel(params.diffuse.z),
                    sel(params.specular.x), sel(params.specular.y), sel(params.specular.z)]

        # emissive hit + MIS (:539-572)
        show = opts.visible_lights if first else (
            opts.direct_lighting_bsdf or opts.indirect_lighting_bsdf)
        if show:
            front_e = dot(gn, wi) > 0.0
            le = Vec3(torch.where(front_e, emissive.x, 0.0), torch.where(front_e, emissive.y, 0.0),
                      torch.where(front_e, emissive.z, 0.0))
            if first:
                w_mis = zero + 1.0
            else:
                is_direct = b == 1
                t_safe = torch.where(valid, ht, 1.0)
                dist2 = t_safe * t_safe
                cos_l = torch.abs(dot(gn, wi))
                pdf_sa = pdf_area_hit * dist2 / torch.clamp_min(cos_l, 1e-8)
                nee_mask = opts.direct_lighting_nee if is_direct else opts.indirect_lighting_nee
                w_mis = power_heuristic(prev_pdf, pdf_sa) if nee_mask else zero + 1.0
                show_mask = opts.direct_lighting_bsdf if is_direct else opts.indirect_lighting_bsdf
                w_mis = w_mis * float(show_mask)
            add_routed(Vec3(thr.x * le.x * w_mis, thr.y * le.y * w_mis, thr.z * le.z * w_mis),
                       valid, channel)
            if grad:
                G = add_g(Vec3(torch.where(valid, adj.x * thr.x * le.x * w_mis, 0.0),
                               torch.where(valid, adj.y * thr.y * le.y * w_mis, 0.0),
                               torch.where(valid, adj.z * thr.z * le.z * w_mis, 0.0)))

        # NEE over the emissive subset (:574-627)
        base_dim = (2 + b * opts.dims_per_bounce) & M32
        nee_on = opts.direct_lighting_nee if first else opts.indirect_lighting_nee
        if nee_on:
            ul0, ul1, ul2 = seq.sample_3d(pix, base_dim)
            idx = (cdf_l[None, :] <= ul2[:, None]).sum(dim=1)
            lrow = tb.light.index_select(0, torch.clamp_max(idx, tb.n_lights - 1))
            b0, b1 = square_to_uniform_triangle(ul0, ul1)
            lp0, le1, le2 = _vec(lrow, 0), _vec(lrow, 3), _vec(lrow, 6)
            lpos = Vec3(lp0.x + le1.x * b0 + le2.x * b1, lp0.y + le1.y * b0 + le2.y * b1,
                        lp0.z + le1.z * b0 + le2.z * b1)
            ln, lle, lpdf_a = _vec(lrow, 9), _vec(lrow, 12), lrow[:, 15]
            to_l = Vec3(lpos.x - pos.x, lpos.y - pos.y, lpos.z - pos.z)
            dist2 = torch.clamp_min(dot(to_l, to_l), 1e-12)
            dist = torch.sqrt(dist2)
            wo = Vec3(to_l.x / dist, to_l.y / dist, to_l.z / dist)
            cos_l = dot(ln, Vec3(-wo.x, -wo.y, -wo.z))
            wo_loc = to_local(wo, t_b, b_b, sn_f)
            fd, fg, bsdf_pdf = f_split(params, wi_loc, wo_loc, opts.lobes, opts.clearcoat,
                                       opts.glossy_model, e_fn=e_fn)
            pdf_sa = lpdf_a * dist2 / torch.clamp_min(torch.abs(cos_l), 1e-8)
            bsdf_on = opts.direct_lighting_bsdf if first else opts.indirect_lighting_bsdf
            w_mis = power_heuristic(pdf_sa, bsdf_pdf) if bsdf_on else zero + 1.0
            cos_s = torch.abs(wo_loc.z)
            able = (valid & (cos_l > 1e-6) & (pdf_sa > 1e-12)
                    & ((fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0))
            so = _offset_origin(pos, gn, wo, eps)
            occluded = _any_plain(tris9, so, wo, zero, torch.where(able, dist * (1.0 - 1e-3), -1.0),
                                  able)
            rays = rays + torch.where(able, 1.0, 0.0)
            lit = able & ~occluded
            scale = cos_s * w_mis / torch.clamp_min(pdf_sa, 1e-12)
            wX, wY, wZ = thr.x * lle.x * scale, thr.y * lle.y * scale, thr.z * lle.z * scale
            if first:
                lf, ls = acc[1], acc[2]
                acc[1] = Vec3(lf.x + torch.where(lit, fd.x * wX, 0.0),
                              lf.y + torch.where(lit, fd.y * wY, 0.0),
                              lf.z + torch.where(lit, fd.z * wZ, 0.0))
                acc[2] = Vec3(ls.x + torch.where(lit, fg.x * wX, 0.0),
                              ls.y + torch.where(lit, fg.y * wY, 0.0),
                              ls.z + torch.where(lit, fg.z * wZ, 0.0))
            else:
                add_routed(Vec3((fd.x + fg.x) * wX, (fd.y + fg.y) * wY, (fd.z + fg.z) * wZ),
                           lit, channel)
            if grad:  # the NEE vertex's local factor kd / f (:916-932)
                kd = diffuse_refl_unit(params, wi_loc, wo_loc, opts.clearcoat, e_fn, opts.lobes)
                ft = Vec3(fd.x + fg.x, fd.y + fg.y, fd.z + fg.z)
                nn = Vec3(torch.where(lit, adj.x * ft.x * wX, 0.0),
                          torch.where(lit, adj.y * ft.y * wY, 0.0),
                          torch.where(lit, adj.z * ft.z * wZ, 0.0))
                G = add_g(nn, Vec3(nn.x * kd.x * _safe_inv(ft.x), nn.y * kd.y * _safe_inv(ft.y),
                                   nn.z * kd.z * _safe_inv(ft.z)), mk)

        # BSDF scatter + RR (:629-648)
        ub0, ub1, ub2 = seq.sample_3d(pix, (base_dim + 3) & M32)
        s = bsdf_sample(params, wi_loc, ub0, ub1, ub2, opts.lobes, opts.clearcoat,
                        opts.glossy_model, e_fn=e_fn)
        wo_world = to_world(s.wo, t_b, b_b, sn_f)
        new_thr = Vec3(thr.x * s.g.x, thr.y * s.g.y, thr.z * s.g.z)
        new_alive = valid & s.valid & ((s.g.x + s.g.y + s.g.z) > 0.0)
        if opts.rr and not first and b >= opts.rr_start_bounce:
            u_rr = seq.sample_1d(pix, (base_dim + 6) & M32)
            q = torch.clamp(torch.maximum(torch.maximum(new_thr.x, new_thr.y), new_thr.z),
                            0.05, 1.0)
            new_alive = new_alive & (u_rr < q)
            inv_q = 1.0 / q
            new_thr = Vec3(new_thr.x * inv_q, new_thr.y * inv_q, new_thr.z * inv_q)
        if grad:  # d log(thr * g) / d a at this vertex: kd(wo) / f(wo) (:955-965)
            kd_s = diffuse_refl_unit(params, wi_loc, s.wo, opts.clearcoat, e_fn, opts.lobes)
            r3 = torch.stack([kd_s.x * _safe_inv(s.f.x), kd_s.y * _safe_inv(s.f.y),
                              kd_s.z * _safe_inv(s.f.z)], dim=1)[:, None, :]
            U = U + torch.where((mk & new_alive[:, None])[:, :, None], r3, 0.0)
        if first:
            channel = torch.where(valid, torch.where(s.component >= GLOSSY_REFL, 2, 1),
                                  channel).to(torch.int32)
        thr = Vec3(torch.where(new_alive, new_thr.x, 0.0), torch.where(new_alive, new_thr.y, 0.0),
                   torch.where(new_alive, new_thr.z, 0.0))
        o = _offset_origin(pos, gn, wo_world, eps)
        d = wo_world
        alive = new_alive
        prev_pdf = s.pdf

    if grad:
        return G
    ld, lf, ls = acc
    return torch.stack([ld.x, ld.y, ld.z, lf.x, lf.y, lf.z, ls.x, ls.y, ls.z,
                        *gbuf, rays])


def _safe_inv(x: Tensor) -> Tensor:
    return torch.where(x > 0.0, 1.0 / torch.where(x <= 0.0, 1.0, x), 0.0)


def _mega_plain(tb: MegaTables, opts, res_x: int, n: int, instance: int, seed: int) -> Tensor:
    """Plain version of K3a: the (27, N) output lanes of one pass."""
    return _plain_pass(tb, opts, res_x, n, instance, seed)


def _mega_grad_plain(tb: MegaTables, opts, res_x: int, n: int, instance: int, seed: int,
                     adjoint: Tensor) -> Tensor:
    """Plain version of K3b: (M, 3) d loss / d diffuse, summed over lanes."""
    return _plain_pass(tb, opts, res_x, n, instance, seed, adjoint).sum(dim=0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_tables(tb: MegaTables, dev) -> None:
    for name, t, cols in (("tri", tb.tri, TRI_COLS), ("mat", tb.mat, MAT_COLS),
                          ("light", tb.light, LIGHT_COLS)):
        check_cuda_tensor(t, name, torch.float32, 2, dev)
        if t.shape[1] != cols:
            raise ValueError(f"{name} table must have {cols} columns, got {tuple(t.shape)}")
    check_cuda_tensor(tb.cam, "cam", torch.float32, 1, dev)
    if tb.cam.shape[0] != CAM_COLS:
        raise ValueError(f"cam table must have {CAM_COLS} entries, got {tuple(tb.cam.shape)}")
    if not (0 < tb.n_tris <= MEGA_T_MAX and tb.tri.shape[0] == tb.n_tris):
        raise ValueError(f"tri table: {tb.n_tris} triangles, cap {MEGA_T_MAX}")
    if not (0 < tb.n_mats <= MEGA_M_MAX and tb.mat.shape[0] == tb.n_mats):
        raise ValueError(f"mat table: {tb.n_mats} materials, cap {MEGA_M_MAX}")
    if not (0 < tb.n_lights <= MEGA_L_MAX and tb.light.shape[0] == tb.n_lights):
        raise ValueError(f"light table: {tb.n_lights} rows, cap {MEGA_L_MAX}")


def _table_args(tb: MegaTables) -> list:
    return [tb.tri.data_ptr(), tb.n_tris, tb.mat.data_ptr(), tb.n_mats,
            tb.light.data_ptr(), tb.n_lights, tb.cam.data_ptr()]


def _mega_forward(tb: MegaTables, opts, res_x: int, n: int, instance: int,
                  seed: int) -> Tensor:
    """K3a: (27, N) f32 output lanes of one pass (SoA, so stores coalesce)."""
    if tb.tri.device.type == "cpu":
        return _mega_plain(tb, opts, res_x, n, instance, seed)
    dev = tb.tri.device
    _check_tables(tb, dev)
    ov = (ctypes.c_int * N_OPTS)(*_opt_vector(opts))
    out = torch.empty((N_OUT, n), dtype=torch.float32, device=dev)
    FORWARD.launch(dev, *_table_args(tb), int(seed) & M32, int(instance) & M32, res_x, n,
                   ctypes.addressof(ov), out.data_ptr())
    return out


def _mega_grad(tb: MegaTables, opts, res_x: int, n: int, instance: int, seed: int,
               adjoint: Tensor) -> Tensor:
    """K3b: (M, 3) d loss / d diffuse. The kernel reduces each block in
    shared memory into a row of a (blocks, M, 3) partial buffer, summed here;
    its persistent grid fills the first rows and writes zeros in the rest."""
    if tb.tri.device.type == "cpu":
        return _mega_grad_plain(tb, opts, res_x, n, instance, seed, adjoint)
    dev = tb.tri.device
    _check_tables(tb, dev)
    if tb.n_mats > GRAD_M_MAX:
        raise ValueError(f"mega_grad: {tb.n_mats} materials, cap {GRAD_M_MAX}")
    check_cuda_tensor(adjoint, "adjoint", torch.float32, 2, dev)
    if tuple(adjoint.shape) != (n, 3):
        raise ValueError(f"adjoint must be ({n}, 3), got {tuple(adjoint.shape)}")
    ov = (ctypes.c_int * N_OPTS)(*_opt_vector(opts))
    blocks = max(-(-n // BLOCK), 1)
    partial = torch.empty((blocks, tb.n_mats, 3), dtype=torch.float32, device=dev)
    GRAD.launch(dev, *_table_args(tb), int(seed) & M32, int(instance) & M32, res_x, n,
                ctypes.addressof(ov), adjoint.data_ptr(), partial.data_ptr(), blocks)
    return partial.sum(dim=0)


def _prepare(view, opts, res_x: int, res_y: int, tables):
    from fermat_tpu_torch.integrators.pt import _check_options

    _check_options(opts)
    if opts.glossy_model != "ggx":
        raise NotImplementedError(
            f"tracer='mega' with glossy_model={opts.glossy_model!r}: the megakernel has the "
            "GGX lobe only. JAX's mega_eligible admits 'ltc', but JAX's megakernel then fails "
            "(its LTC table fetch does not broadcast inside the Pallas kernel), so there is "
            "no reference to port; the dense tracer renders the LTC lobe")
    _require(mega_eligible(view, opts), "this view or option set")
    return tables if tables is not None else build_mega_tables(view, res_x, res_y, opts.ray_eps)


@torch.no_grad()
def render_pass_mega(view, opts, res_x: int, res_y: int, instance: int, seed: int = 0,
                     tables: MegaTables = None):
    """One progressive pass through the megakernel (pallas_pt_mega.py:1072).

    Returns the pass output of integrators.pt.render_pass; `tri` is a hit
    flag (1 or -1), not the triangle id, and `rays_lane` is the kernel's
    per-lane ray count. `tables` are build_mega_tables(view, ...); without
    them they are built from the view for this call, as in JAX."""
    from fermat_tpu_torch.integrators.pt import _PassOutput

    tb = _prepare(view, opts, res_x, res_y, tables)
    n = res_x * res_y
    out = _mega_forward(tb, opts, res_x, n, instance, seed)
    v = lambda k: Vec3(out[k], out[k + 1], out[k + 2])
    ld, lf, ls = v(0), v(3), v(6)
    return _PassOutput(
        direct=ld, diffuse=lf, specular=ls,
        composited=Vec3(ld.x + lf.x + ls.x, ld.y + lf.y + ls.y, ld.z + lf.z + ls.z),
        diffuse_albedo=v(20), specular_albedo=v(23), depth=out[9],
        tri=torch.where(out[10] > 0.0, 1, -1).to(torch.int32),
        normal=v(11), position=v(14), uv=torch.stack([out[17], out[18]], dim=-1),
        material=torch.round(out[19]).to(torch.int32),
        rays=out[26].sum(), rays_lane=out[26],
    )


@torch.no_grad()
def render_grad_diffuse_mega(view, opts, res_x: int, res_y: int, instance: int,
                             adjoint: Tensor, seed: int = 0,
                             tables: MegaTables = None) -> Tensor:
    """d loss / d materials.diffuse, (M, 3), for the per-pixel adjoint
    dL/d composited ((N, 3) f32); replays the paths of render_pass_mega with
    the same arguments (pallas_pt_mega.py:1049)."""
    _require(mega_grad_eligible(view, opts), "this view or option set (replay gradient: "
             f"also no clearcoat and at most {GRAD_M_MAX} materials)")
    tb = _prepare(view, opts, res_x, res_y, tables)
    adjoint = adjoint.to(device=tb.tri.device, dtype=torch.float32).contiguous()
    return _mega_grad(tb, opts, res_x, res_x * res_y, instance, seed, adjoint)
