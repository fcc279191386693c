"""K8a / K8b — the subcluster tracer: closest hit and occlusion over the
32-triangle leaves of accel/cluster.build_subclusters
(fermat_tpu/ops/pallas_sub_trace.py).

The function is K5's (ops/frontier_trace.py: entry margin E' per leaf box,
ties to the smallest original triangle id, occlusion in any entered leaf,
no phantom hit at tmax = inf), over the finer leaves; u, v of the winner
come from `_recompute_uv`, as in JAX's trace_closest_sub (:458). A leaf
box holds its triangles, so for a hit that K5 finds the finer box's entry
lies before it as the cluster's does, and the answer is K5's on every ray
where the margin absorbs the box arithmetic's rounding (the tests and
chip_smoke.py hold it to K5 bit for bit on their rays).

On CUDA tensors `trace_closest_sub` / `trace_any_sub` co-sort the rays
(cluster_trace._sort_perm, when there are at least 4 blocks of them),
launch the kernels of csrc/sub.cu and un-permute the answer: one CTA per
block of BLOCK rays, the block-min E' of every leaf in shared memory, then
per step the four nearest still-needed leaves (csrc/sub.cu kPick) staged
together as one 128-slot composite (the GPU reading of the Pallas kernel's four-phase
composite tile). On CPU tensors they run K5's plain versions over the
subcluster table (`_closest_uv_plain`, `_any_plain`).

Divergences from the Pallas kernels, each deliberate and shared with K5
and K6: the margin E' and the smallest-id tie rule in place of E < t_best
and the first-visited triangle; no phantom hit at tmax = inf; inactive lanes
masked by `active`. The Pallas wrappers' `block`, `sort`, `nc` and
`return_visits` options are not kept: a block is K6's BLOCK rays, and the
leaves staged a step are a constant of the kernel.
The E' row of Ns floats lives in shared memory, so a table of more than
~51,600 leaves raises NotImplementedError (csrc/sub.cu holds the layout
and the limit), the counterpart of the Pallas kernel's E-matrix budget
(`_check_cs`, :76).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fermat_tpu_torch.accel.cluster import SUB, SubclusterView
from fermat_tpu_torch.accel.traverse import Hit
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel, _library
from fermat_tpu_torch.ops.cluster_trace import BLOCK, _sorted, _unsort
from fermat_tpu_torch.ops.frontier_trace import (_any_plain, _closest_uv_plain, _ray_args,
                                                 _recompute_uv, _table_args)
from fermat_tpu_torch.ops.trace import _lane_args

Tensor = torch.Tensor

# BLOCK: rays a CTA, one thread each, as K6's (cluster_trace.BLOCK = 512)

CLOSEST = CudaKernel(
    "trace_closest_sub", "sub.cu", "fermat_sub_closest",
    [P] * 10 + [I, I, P, P, I, I, P, P],
    replaces="fermat_tpu/ops/pallas_sub_trace.py:346 (_closest_impl, kernel _closest_kernel "
             ":109, pallas_call :364)",
)
ANY = CudaKernel(
    "trace_any_sub", "sub.cu", "fermat_sub_any",
    [P] * 10 + [I, I, P, P, I, I, P],
    replaces="fermat_tpu/ops/pallas_sub_trace.py:389 (_any_impl, kernel _any_kernel :237, "
             "pallas_call :404)",
)


def _check_smem(ns: int) -> None:
    """Raise NotImplementedError when a CTA's shared memory (the layout and
    limit of csrc/sub.cu, read through fermat_sub_smem) cannot hold the E'
    row of `ns` leaves."""
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    _library(CLOSEST.source).fermat_sub_smem(BLOCK, ns, ctypes.byref(need), ctypes.byref(limit))
    if need.value > limit.value:
        raise NotImplementedError(
            f"{ns} subclusters at block {BLOCK}: the E' row needs {need.value} bytes of "
            f"shared memory, over the card's {limit.value}")


def _launch_args(subs: SubclusterView, o: Vec3, d: Vec3, tmin, tmax, active):
    """Checked launch inputs, held by the caller until the launch is
    enqueued, and the (Cs, Ns) sizes."""
    boxes = _table_args(subs, o.x.device, width=SUB)
    ns = subs.rows.shape[0]
    _check_smem(ns)
    return [*_ray_args(o, d, tmin, tmax, active), boxes], boxes.shape[1], ns


def trace_closest_sub(subs: SubclusterView, o: Vec3, d: Vec3, tmin, tmax,
                      active: Optional[Tensor] = None) -> Hit:
    """Closest hit over the subcluster table; t = tmax, tri = -1 and
    u = v = 0 on a miss."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _closest_uv_plain(subs, o, d, tmin, tmax, active)
    perm, so, sd, (s0, s1, sa) = _sorted(subs, o, d, [tmin, tmax, active])
    n, dev = o.x.shape[0], o.x.device
    args, cs, ns = _launch_args(subs, so, sd, s0, s1, sa)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    CLOSEST.launch(dev, *(a.data_ptr() for a in args), cs, ns, subs.rows.data_ptr(),
                   subs.count.data_ptr(), n, BLOCK, t.data_ptr(), tri.data_ptr())
    t, tri = _unsort(perm, t), _unsort(perm, tri)
    u, v = _recompute_uv(subs, o, d, tri)
    return Hit(t=t, tri=tri, u=u, v=v)


def trace_any_sub(subs: SubclusterView, o: Vec3, d: Vec3, tmin, tmax,
                  active: Optional[Tensor] = None) -> Tensor:
    """Occlusion flag per ray inside (tmin, tmax), masked by `active`."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _any_plain(subs, o, d, tmin, tmax, active)
    perm, so, sd, (s0, s1, sa) = _sorted(subs, o, d, [tmin, tmax, active])
    n, dev = o.x.shape[0], o.x.device
    args, cs, ns = _launch_args(subs, so, sd, s0, s1, sa)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    ANY.launch(dev, *(a.data_ptr() for a in args), cs, ns, subs.rows.data_ptr(),
               subs.count.data_ptr(), n, BLOCK, occ.data_ptr())
    return _unsort(perm, occ)
