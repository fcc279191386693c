"""The per-ray hit record (fermat_tpu/accel/traverse.py:36-46) and the
plain lockstep skip-link BVH walk (traverse.py:48-83, 107-240).

The tracers that fill the record are in fermat_tpu_torch/ops: the dense ones
and their plain brute-force versions in trace.py, the ones over the cluster
table in frontier_trace.py, cluster_trace.py and binned_trace.py, and the
walk's kernel in bvh_trace.py. The table tracers follow the Pallas kernels'
semantics rather than fermat_tpu's brute twin, which leaves a stale `t` on
inactive lanes (traverse.py:319-321) where the kernels return `tmax`.

`walk_closest` / `walk_any` are JAX's `trace_closest` / `trace_any`
(traverse.py:140, :196) over a BvhView (accel/bvh.py), and JAX's
`trace_closest_brute` / `trace_any_brute` are the dense tracers' plain
versions, ops/trace.py's `trace_closest` / `trace_any` on a CPU tensor: every ray keeps one node cursor, from node 0 (-1
for an inactive lane); each step runs the slab test of the cursor's box
within [tmin, t] (closest: t is the best hit so far; any: tmax), at a leaf
the leaf_size Moller-Trumbore tests of its prims in order (-1 slots
skipped; a closest hit needs t < best, so the first of equal t wins), and
moves the cursor to `child` on a box hit at an inner node and to `skip`
otherwise. The any-hit walk stops a ray at its first hit. They serve the
PT pass on the CPU and are the plain versions of ops/bvh_trace.py's kernel
on the card, which runs the same steps a ray in the same order. A miss
returns t = tmax and tri = -1 (an inactive lane too).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from fermat_tpu_torch.core.math import Vec3

Tensor = torch.Tensor

# the lockstep loop reads its live count back every this many steps: a
# finished ray's cursor stays at -1, so the steps between are no-ops for it
_SYNC_EVERY = 16
_INF = float("inf")


class Hit(NamedTuple):
    """Per-ray hit record (src/ray.h Hit analog)."""

    t: Tensor
    tri: Tensor  # int32, -1 = miss
    u: Tensor
    v: Tensor

    @property
    def hit_mask(self) -> Tensor:
        return self.tri >= 0


def _safe_inv(d: Tensor) -> Tensor:
    """1/d, or +-1e20 where |d| <= 1e-20 (traverse.py:107-108)."""
    return torch.where(torch.abs(d) > 1e-20, 1.0 / torch.where(d == 0.0, 1.0, d),
                       1e20 * torch.where(d >= 0.0, 1.0, -1.0))


def _slab_test(bvh, n: Tensor, o: Vec3, inv_d: Vec3, tmin: Tensor, tmax: Tensor) -> Tensor:
    """Ray-box slab test of node n (clamped indices) within [tmin, tmax]
    (traverse.py:111-137)."""
    t0x = (bvh.lo_x[n] - o.x) * inv_d.x
    t1x = (bvh.hi_x[n] - o.x) * inv_d.x
    t0y = (bvh.lo_y[n] - o.y) * inv_d.y
    t1y = (bvh.hi_y[n] - o.y) * inv_d.y
    t0z = (bvh.lo_z[n] - o.z) * inv_d.z
    t1z = (bvh.hi_z[n] - o.z) * inv_d.z
    near = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                         torch.maximum(torch.minimum(t0z, t1z), tmin))
    far = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                        torch.minimum(torch.maximum(t0z, t1z), tmax))
    return near <= far


def intersect_triangles(tris: Tensor, tri_idx: Tensor, o: Vec3, d: Vec3, tmin, tmax):
    """Moller-Trumbore of the triangles tri_idx of the (9, T) soup
    (traverse.py:48-83), of any shape whose last axis is the lanes of the
    rays o, d, tmin, tmax; tri_idx must hold valid indices. Returns (t, u,
    v, hit_ok) with tmin < t < tmax."""
    from fermat_tpu_torch.ops.trace import mt_test  # ops/trace.py imports Hit from here

    tri9 = tris.index_select(1, tri_idx.reshape(-1).long()).reshape(9, *tri_idx.shape)
    tt, uu, vv, inside = mt_test(tri9.unbind(0), tuple(o), tuple(d))
    return tt, uu, vv, inside & (tt > tmin) & (tt < tmax)


def _walk(bvh, tris: Tensor, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor, active: Tensor,
          any_hit: bool, stats: bool) -> dict:
    """The lockstep walk. Returns {t, tri, u, v, occ} per ray, and with
    `stats` the counts {visits, tests} (int32 per ray: nodes whose box was
    tested, triangles tested). The loop runs over the slots of the rays
    still walking: every _SYNC_EVERY steps, when at most half of them are,
    the finished slots' answers go to their lanes and the loop narrows to
    the rest; each ray's steps, and so its answer, are unchanged."""
    n, dev = o.x.shape[0], o.x.device
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    out = {"t": tmax.clone(), "tri": torch.full((n,), -1, **i32), "u": torch.zeros(n, **f32),
           "v": torch.zeros(n, **f32), "occ": torch.zeros(n, dtype=torch.bool, device=dev)}
    if stats:
        out.update(visits=torch.zeros(n, **i32), tests=torch.zeros(n, **i32))
    lane = torch.nonzero(active)[:, 0]
    take = lambda a: a.index_select(0, lane)
    inv_d = (_safe_inv(d.x), _safe_inv(d.y), _safe_inv(d.z))
    rays = [take(c) for c in (*o, *d, *inv_d, tmin, tmax)]
    st = {k: take(a) for k, a in out.items()}
    node = torch.zeros(lane.shape[0], **i32)
    last = bvh.prims.shape[0] - 1
    step = 0
    while True:
        if step % _SYNC_EVERY == 0:
            live = node >= 0
            n_live = int(live.sum())
            if 2 * n_live <= node.shape[0]:
                for k, a in st.items():
                    out[k].index_copy_(0, lane, a)
                if n_live == 0:
                    return out
                keep = torch.nonzero(live)[:, 0]
                take = lambda a: a.index_select(0, keep)
                lane, node, rays = take(lane), take(node), [take(c) for c in rays]
                st = {k: take(a) for k, a in st.items()}
        step += 1
        ro, rd, inv_d = Vec3(*rays[:3]), Vec3(*rays[3:6]), Vec3(*rays[6:9])
        r_tmin, r_tmax = rays[9], rays[10]
        live = node >= 0
        nd = torch.clamp_min(node, 0).long()
        t_far = r_tmax if any_hit else st["t"]
        hit_box = _slab_test(bvh, nd, ro, inv_d, r_tmin, t_far) & live
        leaf = bvh.is_leaf[nd]
        do_leaf = hit_box & leaf
        start = bvh.prim_start[nd]
        # the leaf's leaf_size tests at once, (leaf_size, lanes); a closest
        # hit then takes them in order, each against the t the last one left
        slots = start[None, :] + torch.arange(bvh.leaf_size, device=dev, dtype=torch.int32)[:, None]
        tid = bvh.prims[torch.clamp_max(slots, last).long()]
        valid = do_leaf[None, :] & (tid >= 0)
        tid_c = torch.clamp_min(tid, 0)
        th, uh, vh, ok = intersect_triangles(tris, tid_c, ro, rd, r_tmin,
                                             r_tmax if any_hit else _INF)
        ok = valid & ok
        if stats:
            st["tests"] += valid.sum(0, dtype=torch.int32)
        if any_hit:
            hit_any = ok.any(0)
        else:
            for k in range(bvh.leaf_size):
                closer = ok[k] & (th[k] < st["t"])
                st["t"] = torch.where(closer, th[k], st["t"])
                st["tri"] = torch.where(closer, tid_c[k], st["tri"])
                st["u"] = torch.where(closer, uh[k], st["u"])
                st["v"] = torch.where(closer, vh[k], st["v"])
        if stats:
            st["visits"] += live.to(torch.int32)
        nxt = torch.where(hit_box & ~leaf, bvh.child[nd], bvh.skip[nd])
        if any_hit:
            st["occ"] = st["occ"] | hit_any
            nxt = torch.where(st["occ"], -1, nxt)  # early out
        node = torch.where(live, nxt, node)


def walk_closest(bvh, tris: Tensor, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
                 active: Tensor, stats: bool = False):
    """Closest hit of each ray over the BVH of the (9, T) soup `tris`;
    tmin, tmax (n,) float32 lanes, active (n,) bool. Returns a Hit, and
    with `stats` also the (visits, tests) counts per ray."""
    r = _walk(bvh, tris, o, d, tmin, tmax, active, False, stats)
    hit = Hit(t=r["t"], tri=r["tri"], u=r["u"], v=r["v"])
    return (hit, r["visits"], r["tests"]) if stats else hit


def walk_any(bvh, tris: Tensor, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
             active: Tensor, stats: bool = False):
    """Occlusion of each ray inside (tmin, tmax) over the BVH; stops a ray
    at its first hit. Returns the (n,) bool flag, and with `stats` also the
    (visits, tests) counts per ray."""
    r = _walk(bvh, tris, o, d, tmin, tmax, active, True, stats)
    return (r["occ"], r["visits"], r["tests"]) if stats else r["occ"]
