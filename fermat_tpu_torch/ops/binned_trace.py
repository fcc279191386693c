"""K7a / K7b — the binned tracer: closest hit and occlusion over the
cluster table as rounds of per-ray visits binned by cluster
(fermat_tpu/ops/pallas_binned_trace.py).

The function is K5's (ops/frontier_trace.py), so the answer equals K5's bit
for bit; the closest hit also returns the winner's Moller-Trumbore u, v, as
the Pallas kernel does from inside the kernel (:233-238), and the path
tracer uses them directly.

On CUDA tensors `trace_closest_binned` / `trace_any_binned` run the round
loop of `_rounds` over the kernels of csrc/binned.cu; each round:

  1. the scan (SCAN_CLOSEST / SCAN_ANY, a helper kernel in place of JAX's
     XLA `_frontier_scan`, :109-182): each live ray's next cluster, the
     smallest (E', cid) strictly after its cursor with E' <= its best t, or
     for occlusion the smallest entered cid after its cursor (min by cid,
     :166-169);
  2. the rays with no next cluster leave the live set for good (t_best
     only falls and the cursor only rises), which is the one readback a
     round; the rest are sorted by cid, stably;
  3. the test kernel (K7a / K7b): one CTA per BLOCK sorted rays tests up
     to U_STEPS distinct clusters, only the rays whose cid matches, and
     folds each tested ray's result into its state in place, cursor
     included (JAX's merge, :394-405); untested rays retry next round.

The loop keeps JAX's liveness cap of 4 * Cp rounds (:373-378) and raises
if it is reached rather than return a cut answer. On CPU tensors the
wrappers run the shared plain versions of the function.

`_scan_plain` and `_test_plain` (through `_plain_steps`) are plain versions
of one round's two kernels. No wrapper calls them: they exist so that the
tests can run `_rounds`, its retries and its cap, on the CPU. BLOCK and
U_STEPS are module constants, not options of the wrappers (the Pallas
wrappers' `block` and `u_steps`): the tests set them to force retries.

Divergences from the Pallas kernels, each deliberate and shared with K5:
the margin E' (the scan orders by E', not E) and the smallest-id tie rule;
inactive lanes are masked by `active` rather than by tmax = -1 (:492-493),
and a miss returns t = tmax. JAX's merge starts each round's hit at -1
(:251), so it shows no phantom hit at tmax = inf; the port has none either.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from fermat_tpu_torch.accel.cluster import ClusterView
from fermat_tpu_torch.accel.traverse import Hit
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel
from fermat_tpu_torch.ops.frontier_trace import (_INT_MAX, _any_plain, _chunks,
                                                 _closest_uv_plain, _ray_args, _slack,
                                                 _table_args, _tile, cluster_entries)
from fermat_tpu_torch.ops.trace import _lane_args, mt_test

Tensor = torch.Tensor

BLOCK = 512  # rays a CTA of the test kernel
U_STEPS = 8  # most distinct clusters a CTA tests per round
SENT = _INT_MAX  # "no next cluster" (csrc/binned.cu kSent)

_SCAN_ARGS = [I, P, I] + [P] * 8 + [P] * 5 + [I, I, P, P]
_TEST_ARGS = [I, P, P, P, I, I, I] + [P] * 8 + [P] * 2 + [P] * 7
SCAN_CLOSEST = CudaKernel(
    "binned_scan_closest", "binned.cu", "fermat_binned_scan", _SCAN_ARGS,
    replaces="helper: fermat_tpu/ops/pallas_binned_trace.py:109 (_frontier_scan, XLA, "
             "ordered=True)",
)
SCAN_ANY = CudaKernel(
    "binned_scan_any", "binned.cu", "fermat_binned_scan", _SCAN_ARGS,
    replaces="helper: fermat_tpu/ops/pallas_binned_trace.py:109 (_frontier_scan, XLA, "
             "ordered=False)",
)
CLOSEST = CudaKernel(
    "trace_closest_binned", "binned.cu", "fermat_binned_test", _TEST_ARGS,
    replaces="fermat_tpu/ops/pallas_binned_trace.py:320 (_run_kernel, pallas_call :341, "
             "kernel _binned_closest_kernel :189; round loop _closest_impl :362)",
)
ANY = CudaKernel(
    "trace_any_binned", "binned.cu", "fermat_binned_test", _TEST_ARGS,
    replaces="fermat_tpu/ops/pallas_binned_trace.py:320 (_run_kernel, pallas_call :341, "
             "kernel _binned_any_kernel :264; round loop _any_impl :426)",
)


class _State(NamedTuple):
    """Per-lane state of one trace, updated in place by the test step."""

    t_best: Tensor
    id_best: Tensor  # int32, _INT_MAX = no hit yet
    u: Tensor
    v: Tensor
    last_e: Tensor  # the cursor: (E', cid) of the last tested cluster
    last_c: Tensor
    occ: Tensor  # bool


class _Rays(NamedTuple):
    o: Vec3
    d: Vec3
    tmin: Tensor
    tmax: Tensor


def _new_state(tmax: Tensor) -> _State:
    n, dev = tmax.shape[0], tmax.device
    return _State(t_best=tmax.clone(),
                  id_best=torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev),
                  u=torch.zeros(n, dtype=torch.float32, device=dev),
                  v=torch.zeros(n, dtype=torch.float32, device=dev),
                  last_e=torch.full((n,), float("-inf"), dtype=torch.float32, device=dev),
                  last_c=torch.full((n,), -1, dtype=torch.int32, device=dev),
                  occ=torch.zeros(n, dtype=torch.bool, device=dev))


def _scan_plain(cl: ClusterView, rays: _Rays, st: _State, live: Tensor, closest: bool):
    """Plain version of the scan kernel -> (E', cid) of each live ray's next
    cluster, (+inf, SENT) where there is none."""
    m, dev = live.shape[0], live.device
    ent = torch.full((m,), float("inf"), dtype=torch.float32, device=dev)
    cid = torch.full((m,), SENT, dtype=torch.int32, device=dev)
    c_pad = cl.rows.shape[0]
    col = torch.arange(c_pad, dtype=torch.int32, device=dev)
    for sl in _chunks(m, c_pad):
        g = live[sl].long()
        pick = lambda a: a[g]
        e = _slack(cluster_entries(cl, Vec3(*map(pick, rays.o)), Vec3(*map(pick, rays.d)),
                                   pick(rays.tmin), pick(rays.tmax))[:, :c_pad])
        entered = e < float("inf")
        lc = st.last_c[g][:, None]
        if closest:
            le = st.last_e[g][:, None]
            elig = (entered & (e <= st.t_best[g][:, None])
                    & ((e > le) | ((e == le) & (col > lc))))
            e_m = torch.where(elig, e, float("inf"))
            best = e_m.min(dim=1).values
            c_m = torch.where(elig & (e_m == best[:, None]), col, SENT).min(dim=1).values
            ent[sl] = torch.where(c_m == SENT, float("inf"), best)
        else:
            elig = entered & (col > lc) & ~st.occ[g][:, None]
            c_m = torch.where(elig, col, SENT).min(dim=1).values
        cid[sl] = c_m
    return ent, cid


def _test_plain(cl: ClusterView, rays: _Rays, st: _State, live: Tensor, cid: Tensor,
                ent: Tensor, closest: bool) -> None:
    """Plain version of the test kernel on rays sorted by cid: in each block
    of BLOCK rays the first U_STEPS distinct clusters are tested, and each
    tested ray folds its result into `st` in place."""
    m, dev = live.shape[0], live.device
    pos = torch.arange(m, device=dev)
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = (cid[1:] != cid[:-1]) | (pos[1:] // BLOCK != pos[:-1] // BLOCK)
    run = torch.cumsum(start.long(), 0)
    first = run[(pos // BLOCK) * BLOCK]  # the run of the block's first ray
    tested = torch.nonzero(run - first < U_STEPS)[:, 0]
    g = live[tested].long()
    tri9, ids = _tile(cl, cid[tested].long())
    col = lambda a: a[g][:, None]
    tt, uu, vv, inside = mt_test(tri9, tuple(map(col, rays.o)), tuple(map(col, rays.d)))
    ok = inside & (tt > col(rays.tmin)) & (tt < col(rays.tmax)) & (ids >= 0)
    st.last_c[g] = cid[tested]
    if not closest:
        st.occ[g] = st.occ[g] | ok.any(dim=1)
        return
    e = ent[tested]
    ok = ok & (tt >= e[:, None])
    tt = torch.where(ok, tt, float("inf"))
    t_new = tt.min(dim=1).values
    win = ok & (tt == t_new[:, None])
    id_new = torch.where(win, ids, _INT_MAX).min(dim=1).values
    k = (win & (ids == id_new[:, None])).to(torch.int64).argmax(dim=1, keepdim=True)
    t_cur, i_cur = st.t_best[g], st.id_best[g]
    better = ok.any(dim=1) & ((t_new < t_cur) | ((t_new == t_cur) & (id_new < i_cur)))
    st.t_best[g] = torch.where(better, t_new, t_cur)
    st.id_best[g] = torch.where(better, id_new, i_cur)
    st.u[g] = torch.where(better, uu.gather(1, k)[:, 0], st.u[g])
    st.v[g] = torch.where(better, vv.gather(1, k)[:, 0], st.v[g])
    st.last_e[g] = e


def _kernel_steps(cl: ClusterView, rays: _Rays, active: Tensor, closest: bool):
    """The scan and test steps of `_rounds` as launches of csrc/binned.cu."""
    dev = rays.tmax.device
    boxes = _table_args(cl, dev)
    args = _ray_args(rays.o, rays.d, rays.tmin, rays.tmax, active)[:8]
    ptrs = [a.data_ptr() for a in args]
    c_pad = cl.rows.shape[0]
    scan_k, test_k = (SCAN_CLOSEST, CLOSEST) if closest else (SCAN_ANY, ANY)

    def scan(st: _State, live: Tensor):
        m = live.shape[0]
        ent = torch.empty(m, dtype=torch.float32, device=dev)
        cid = torch.empty(m, dtype=torch.int32, device=dev)
        scan_k.launch(dev, int(closest), live.data_ptr(), m, *ptrs, st.t_best.data_ptr(),
                      st.last_e.data_ptr(), st.last_c.data_ptr(), st.occ.data_ptr(),
                      boxes.data_ptr(), boxes.shape[1], c_pad, ent.data_ptr(), cid.data_ptr())
        return ent, cid

    def test(st: _State, live: Tensor, cid: Tensor, ent: Tensor):
        test_k.launch(dev, int(closest), live.data_ptr(), cid.data_ptr(), ent.data_ptr(),
                      live.shape[0], BLOCK, U_STEPS, *ptrs, cl.rows.data_ptr(),
                      cl.count.data_ptr(), *(a.data_ptr() for a in st))

    return scan, test, args + [boxes]


def _plain_steps(cl: ClusterView, rays: _Rays, closest: bool):
    """The scan and test steps of `_rounds` as their plain versions (tests only)."""
    return (lambda st, live: _scan_plain(cl, rays, st, live, closest),
            lambda st, live, cid, ent: _test_plain(cl, rays, st, live, cid, ent, closest))


def _rounds(cl: ClusterView, rays: _Rays, active: Tensor, scan: Callable, test: Callable):
    """The round loop -> (final state, rounds run)."""
    st = _new_state(rays.tmax)
    live = torch.nonzero(active)[:, 0].to(torch.int32)
    cap = 4 * cl.lo_x.shape[1]  # JAX's liveness bound (:376-378)
    rounds = 0
    while live.shape[0]:
        ent, cid = scan(st, live)
        keep = torch.nonzero(cid != SENT)[:, 0]  # the readback of the round
        if keep.shape[0] == 0:
            break
        if rounds == cap:
            raise RuntimeError(f"binned trace: {keep.shape[0]} rays still live after {cap} "
                               "rounds (the liveness cap, 4 x Cp)")
        cid, order = torch.sort(cid[keep], stable=True)
        keep = keep[order]
        live, ent = live[keep], ent[keep]
        test(st, live, cid, ent)
        rounds += 1
    return st, rounds


def trace_closest_binned(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                         active: Optional[Tensor] = None) -> Hit:
    """Closest hit over the cluster table; t = tmax, tri = -1 and u = v = 0
    on a miss."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _closest_uv_plain(clusters, o, d, tmin, tmax, active)
    rays = _Rays(o, d, tmin, tmax)
    scan, test, _held = _kernel_steps(clusters, rays, active, True)
    st, _ = _rounds(clusters, rays, active, scan, test)
    return _hit(st, tmax)


def _hit(st: _State, tmax: Tensor) -> Hit:
    tri = torch.where(st.id_best == _INT_MAX, -1, st.id_best)
    miss = tri < 0
    return Hit(t=torch.where(miss, tmax, st.t_best), tri=tri,
               u=torch.where(miss, 0.0, st.u), v=torch.where(miss, 0.0, st.v))


def trace_any_binned(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                     active: Optional[Tensor] = None) -> Tensor:
    """Occlusion flag per ray inside (tmin, tmax), masked by `active`."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _any_plain(clusters, o, d, tmin, tmax, active)
    rays = _Rays(o, d, tmin, tmax)
    scan, test, _held = _kernel_steps(clusters, rays, active, False)
    st, _ = _rounds(clusters, rays, active, scan, test)
    return st.occ
