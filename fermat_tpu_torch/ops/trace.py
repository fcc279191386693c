"""K1a / K1b — dense closest-hit and any-hit tracers for small scenes
(fermat_tpu/ops/pallas_trace.py:184-310).

On CUDA tensors `trace_closest` / `trace_any` launch the hand-written kernels
of csrc/trace.cu; on CPU tensors they run `_closest_plain` / `_any_plain`,
which compute the same function tile by tile. Semantics follow the Pallas
kernel (see csrc/trace.cu for the list), with one repair: a tile with no
hit reports +inf instead of the kernel's 3e38 sentinel, so a caller's
tmax > 3e38 can no longer turn a miss into a phantom hit on the tile's
first triangle (pallas_trace.py:117-127).

`tris` is the (9, T) soup from MeshView.tri_soup().
"""
from __future__ import annotations

import struct

import torch

from fermat_tpu_torch.accel.traverse import Hit
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel, check_cuda_tensor

Tensor = torch.Tensor

TILE = 128
_EPS_DET = 1e-12

CLOSEST = CudaKernel(
    "trace_closest", "trace.cu", "fermat_trace_closest",
    [P] * 10 + [I, I] + [P] * 4,
    replaces="fermat_tpu/ops/pallas_trace.py:146 (_trace_impl, kernel _trace_kernel :65)",
)
ANY = CudaKernel(
    "trace_any", "trace.cu", "fermat_trace_any",
    [P] * 10 + [I, I, P],
    replaces="fermat_tpu/ops/pallas_trace.py:264 (_any_impl, kernel _any_kernel :213)",
)


# The lanes of a Python number: one buffer per value (by its float64 bits, so
# -0.0 apart from 0.0) and device, grown as needed and shared by every call
# that asks for that number, so that a tracer call launches no fill for its
# tmin or tmax (the path passes the same numbers at every bounce). No
# wrapper and no plain version writes into a lane buffer or returns one.
_LANES: dict = {}


def _lanes(x, n: int, device) -> Tensor:
    """(n,) float32 lanes of a tensor or a Python number (a read-only view
    of the number's cached buffer)."""
    if not isinstance(x, (int, float)):
        return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n).contiguous()
    device = torch.device(device)
    key = (struct.pack("<d", x), device)
    buf = _LANES.get(key)
    if buf is None or buf.shape[0] < n:
        buf = torch.full((n,), x, dtype=torch.float32, device=device)
        _LANES[key] = buf
    return buf[:n]


def _mt(tile: Tensor, o: Vec3, d: Vec3):
    """Moller-Trumbore of every ray against a (9, k) tile -> (N, k) t, u, v
    and the det test; operation order as pallas_trace.py:92-108."""
    return mt_test([r[None, :] for r in tile], (o.x[:, None], o.y[:, None], o.z[:, None]),
                   (d.x[:, None], d.y[:, None], d.z[:, None]))


def mt_test(tri9, o3, d3):
    """Moller-Trumbore on broadcastable tensors: tri9 = (p0x, p0y, p0z, e1x,
    e1y, e1z, e2x, e2y, e2z), o3/d3 = ray components. Returns t, u, v and
    `inside` (|det| > 1e-12 and the barycentric test); the operation order
    is that of the CUDA kernels' hit tests."""
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = tri9
    ox, oy, oz = o3
    dx, dy, dz = d3
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    det_ok = torch.abs(det) > _EPS_DET
    inv_det = torch.where(det_ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    inside = det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
    return tt, uu, vv, inside


def _closest_plain(tris: Tensor, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
                   active: Tensor) -> Hit:
    """Plain PyTorch version of K1a: 128-triangle tiles, first column wins
    inside a tile, strict compares across tiles (pallas_trace.py:84-130)."""
    n = o.x.shape[0]
    dev = o.x.device
    t_best = tmax
    tri_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    for s in range(0, tris.shape[1], TILE):
        tile = tris[:, s:s + TILE]
        k = tile.shape[1]
        tt, uu, vv, inside = _mt(tile, o, d)
        # an inactive lane is a guaranteed miss (pallas_trace.py:198-200)
        ok = inside & active[:, None] & (tt > tmin[:, None]) & (tt < t_best[:, None])
        tt = torch.where(ok, tt, float("inf"))
        t_new = tt.min(dim=1).values
        got = t_new < t_best
        col = torch.arange(k, dtype=torch.int32, device=dev)
        kmin = torch.where(tt == t_new[:, None], col, k).min(dim=1).values
        kmin_c = kmin.clamp(max=k - 1).long()[:, None]
        t_best = torch.where(got, t_new, t_best)
        tri_best = torch.where(got, s + kmin, tri_best)
        u_best = torch.where(got, uu.gather(1, kmin_c)[:, 0], u_best)
        v_best = torch.where(got, vv.gather(1, kmin_c)[:, 0], v_best)
    t = torch.where(tri_best < 0, tmax, t_best)  # a miss returns the caller's tmax
    return Hit(t=t, tri=tri_best, u=u_best, v=v_best)


def _any_plain(tris: Tensor, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
               active: Tensor) -> Tensor:
    """Plain PyTorch version of K1b (pallas_trace.py:213-310)."""
    occ = torch.zeros(o.x.shape[0], dtype=torch.bool, device=o.x.device)
    for s in range(0, tris.shape[1], TILE):
        tt, _, _, inside = _mt(tris[:, s:s + TILE], o, d)
        ok = inside & (tt > tmin[:, None]) & (tt < tmax[:, None])
        occ = occ | ok.any(dim=1)
    return occ & active


def _lane_args(o: Vec3, tmin, tmax, active):
    """tmin, tmax and active as (n,) lanes; a missing mask is every lane,
    cached like a number's lanes."""
    n, dev = o.x.shape[0], o.x.device
    if active is None:
        key = ("every lane", dev)
        buf = _LANES.get(key)
        if buf is None or buf.shape[0] < n:
            buf = torch.ones(n, dtype=torch.bool, device=dev)
            _LANES[key] = buf
        active = buf[:n]
    return _lanes(tmin, n, dev), _lanes(tmax, n, dev), active


def _kernel_args(tris, o, d, tmin, tmax, active):
    """Checked launch inputs (rays, tmin, tmax, active, tris) as contiguous
    tensors. The caller holds them until the launch is enqueued: a copy
    freed earlier could be handed to the outputs' torch.empty."""
    dev = o.x.device
    rays = [c.contiguous() for c in (*o, *d)]
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        check_cuda_tensor(t, name, torch.float32, 1, dev)
    check_cuda_tensor(active, "active", torch.bool, 1, dev)
    check_cuda_tensor(tris, "tris", torch.float32, 2, dev)
    if tris.shape[0] != 9:
        raise ValueError(f"tris must be (9, T), got {tuple(tris.shape)}")
    return [*rays, tmin, tmax, active, tris]


def trace_closest(tris: Tensor, o: Vec3, d: Vec3, tmin, tmax,
                  active: Tensor = None) -> Hit:
    """Closest hit over the whole soup; t = tmax and tri = -1 on a miss."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _closest_plain(tris, o, d, tmin, tmax, active)
    n, dev = o.x.shape[0], o.x.device
    args = _kernel_args(tris, o, d, tmin, tmax, active)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    CLOSEST.launch(dev, *(a.data_ptr() for a in args), tris.shape[1], n, t.data_ptr(),
                   tri.data_ptr(), u.data_ptr(), v.data_ptr())
    return Hit(t=t, tri=tri, u=u, v=v)


def trace_any(tris: Tensor, o: Vec3, d: Vec3, tmin, tmax,
              active: Tensor = None) -> Tensor:
    """Occlusion flag per ray inside (tmin, tmax), masked by `active`."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _any_plain(tris, o, d, tmin, tmax, active)
    n, dev = o.x.shape[0], o.x.device
    args = _kernel_args(tris, o, d, tmin, tmax, active)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    ANY.launch(dev, *(a.data_ptr() for a in args), tris.shape[1], n, occ.data_ptr())
    return occ
