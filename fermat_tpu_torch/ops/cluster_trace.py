"""K6a / K6b — the cluster tracer: closest hit and occlusion over the
cluster table, visiting clusters near to far per block of rays
(fermat_tpu/ops/pallas_cluster_trace.py).

The function is K5's (ops/frontier_trace.py: entry margin E', ties to the
smallest original triangle id, occlusion in any entered cluster), so the
answer equals K5's bit for bit; the closest hit also returns the winner's
Moller-Trumbore u, v, as the Pallas kernel does from inside the kernel
(pallas_cluster_trace.py:235-242), and the path tracer uses them directly.

On CUDA tensors `trace_closest_cluster` / `trace_any_cluster` co-sort the
rays (`_sort_perm`, when there are at least 4 blocks of them), launch the
kernels of csrc/cluster.cu (one CTA per block of sorted rays: block-min
entries of every cluster, then the clusters in ascending block-min order)
and un-permute the answer. On CPU tensors they run the shared plain
versions, which do not depend on the order of the rays.

Divergences from the Pallas kernels, each deliberate and shared with K5:
the margin E' and the smallest-id tie rule in place of E < t_best and the
first-visited triangle; no phantom hit at tmax = inf (the Pallas kernel
starts t_best at tmax, so an all-miss tile's 3e38 counts as a hit there,
:226-241 and :254); inactive lanes are masked by `active` rather than by
tmax = -1 (:463-464), and a miss returns t = tmax either way. The one
limit of the port: the E' row of C_pad floats lives in shared memory, so a
table of more than ~50,000 clusters at BLOCK = 512 raises
NotImplementedError (the counterpart of the Pallas kernel's VMEM budget).
The Pallas wrappers' `block` and `sort` options are not kept: every block
is BLOCK rays, and the rays are co-sorted whenever there are 4 blocks.
"""
from __future__ import annotations

from typing import Optional

import torch

from fermat_tpu_torch.accel.cluster import ClusterView
from fermat_tpu_torch.accel.traverse import Hit
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.core.morton import morton3d
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel
from fermat_tpu_torch.ops.frontier_trace import (_any_plain, _closest_uv_plain, _ray_args,
                                                 _table_args)
from fermat_tpu_torch.ops.trace import _lane_args

Tensor = torch.Tensor

BLOCK = 512  # rays a CTA, one thread each
MAX_SMEM = 231_424  # csrc/cluster.cu kMaxSmem

CLOSEST = CudaKernel(
    "trace_closest_cluster", "cluster.cu", "fermat_cluster_closest",
    [P] * 10 + [I, I, P, P, I, I] + [P] * 4,
    replaces="fermat_tpu/ops/pallas_cluster_trace.py:348 (_closest_impl, kernel "
             "_closest_kernel :165, phase 1 _group_near_phase :100, pallas_call :365)",
)
ANY = CudaKernel(
    "trace_any_cluster", "cluster.cu", "fermat_cluster_any",
    [P] * 10 + [I, I, P, P, I, I, P],
    replaces="fermat_tpu/ops/pallas_cluster_trace.py:390 (_any_impl, kernel _any_kernel "
             ":268, pallas_call :405)",
)


def _sort_perm(clusters: ClusterView, o: Vec3, d: Vec3) -> Tensor:
    """Coherence permutation (pallas_cluster_trace.py:423-446): the top 15
    bits of the origin's morton code in the table's bounds, then the 3-bit
    direction octant, stable argsort."""
    lo = [clusters.lo_x.min(), clusters.lo_y.min(), clusters.lo_z.min()]
    hi = [clusters.hi_x.max(), clusters.hi_y.max(), clusters.hi_z.max()]
    inv = [1.0 / torch.clamp_min(h - l, 1e-20) for l, h in zip(lo, hi)]
    m = morton3d((o.x - lo[0]) * inv[0], (o.y - lo[1]) * inv[1], (o.z - lo[2]) * inv[2]) >> 15
    octant = ((d.x < 0).to(torch.int64) * 4 + (d.y < 0).to(torch.int64) * 2
              + (d.z < 0).to(torch.int64))
    return torch.argsort((m << 3) | octant, stable=True)


def smem_bytes(c_pad: int) -> int:
    """Dynamic shared memory of one CTA (csrc/cluster.cu smem_bytes)."""
    return 16 * 128 * 3 + 4 * (9 * BLOCK + c_pad + 3 * 32)


def _launch_args(cl: ClusterView, o: Vec3, d: Vec3, tmin, tmax, active):
    """Checked launch inputs, held by the caller until the launch is
    enqueued, and the (Cp, C_pad) sizes."""
    boxes = _table_args(cl, o.x.device)
    c_pad = cl.rows.shape[0]
    if smem_bytes(c_pad) > MAX_SMEM:
        raise NotImplementedError(
            f"{c_pad} clusters at block {BLOCK}: the E' row needs {smem_bytes(c_pad)} "
            f"bytes of shared memory, over the card's {MAX_SMEM}")
    return [*_ray_args(o, d, tmin, tmax, active), boxes], boxes.shape[1], c_pad


def _sorted(cl: ClusterView, o: Vec3, d: Vec3, lanes):
    """(perm or None, o, d, lanes) with the rays co-sorted when
    n >= 4 * BLOCK (pallas_cluster_trace.py:465-471)."""
    if o.x.shape[0] < 4 * BLOCK:
        return None, o, d, lanes
    perm = _sort_perm(cl, o, d)
    g = lambda v: Vec3(v.x[perm], v.y[perm], v.z[perm])
    return perm, g(o), g(d), [a[perm] for a in lanes]


def _unsort(perm: Optional[Tensor], a: Tensor) -> Tensor:
    if perm is None:
        return a
    out = torch.empty_like(a)
    out[perm] = a
    return out


def trace_closest_cluster(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                          active: Optional[Tensor] = None) -> Hit:
    """Closest hit over the cluster table; t = tmax, tri = -1 and u = v = 0
    on a miss."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _closest_uv_plain(clusters, o, d, tmin, tmax, active)
    perm, so, sd, (s0, s1, sa) = _sorted(clusters, o, d, [tmin, tmax, active])
    n, dev = o.x.shape[0], o.x.device
    args, cp, c_pad = _launch_args(clusters, so, sd, s0, s1, sa)
    f32 = dict(dtype=torch.float32, device=dev)
    t, u, v = torch.empty(n, **f32), torch.empty(n, **f32), torch.empty(n, **f32)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    CLOSEST.launch(dev, *(a.data_ptr() for a in args), cp, c_pad, clusters.rows.data_ptr(),
                   clusters.count.data_ptr(), n, BLOCK, t.data_ptr(), tri.data_ptr(),
                   u.data_ptr(), v.data_ptr())
    return Hit(t=_unsort(perm, t), tri=_unsort(perm, tri), u=_unsort(perm, u),
               v=_unsort(perm, v))


def trace_any_cluster(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                      active: Optional[Tensor] = None) -> Tensor:
    """Occlusion flag per ray inside (tmin, tmax), masked by `active`."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _any_plain(clusters, o, d, tmin, tmax, active)
    perm, so, sd, (s0, s1, sa) = _sorted(clusters, o, d, [tmin, tmax, active])
    n, dev = o.x.shape[0], o.x.device
    args, cp, c_pad = _launch_args(clusters, so, sd, s0, s1, sa)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    ANY.launch(dev, *(a.data_ptr() for a in args), cp, c_pad, clusters.rows.data_ptr(),
               clusters.count.data_ptr(), n, BLOCK, occ.data_ptr())
    return _unsort(perm, occ)
