"""K5a / K5b — closest hit and occlusion over the cluster table of a large
scene (fermat_tpu/ops/pallas_frontier_trace.py).

On CUDA tensors `trace_closest_frontier` / `trace_any_frontier` co-sort the
rays (from 4 blocks of rays up: the key of csrc/frontier.cu's key_kernel,
JAX's `_sort_key`, whose plain version is `_sort_key_plain`, then a stable
`torch.argsort`) and launch the hand-written kernels of csrc/frontier.cu
(one thread per sorted ray, a stack walk over the top-level BVH of
accel/cluster.py stored as 64-byte node records, the 128-triangle cluster
as the leaf); the kernel reads ray perm[i] and writes its answer there, so
no ray lane is gathered or scattered. On CPU tensors they run
`_closest_plain` / `_any_plain`, which visit every ray's clusters in the
order of their box entries. Both compute one function, so they agree bit
for bit whatever order they visit clusters or rays in:

  * a cluster's entry E is the slab entry of the ray into its box, clipped
    to [tmin, tmax] (pallas_frontier_trace.py:157-201, the `lox <= hix`
    emptiness test included); a cluster the ray misses has no entry;
  * E' = E * (1 - 2^-10) - 2^-12 lowers it by a margin for rounding: a
    cluster is visited while E' <= the ray's best t so far, and a triangle
    counts only with E' <= t. That makes the answer independent of the
    visit order (a hit that the box arithmetic puts before its own box's
    entry, by less than the margin, still counts, and one further in front
    counts nowhere);
  * a closest hit is Moller-Trumbore with |det| > 1e-12 (pallas_cluster_trace
    ._mt_tile, :71-97) and tmin < t < tmax; the smallest t wins, then the
    smallest original triangle id among equal t;
  * occlusion is any such hit in a cluster the ray enters, without the E'
    test (any visit order finds one if there is one).

Divergences from the Pallas kernels, each deliberate:
  * the Pallas kernels cull with E < t_best and no margin and take the
    first-visited triangle among equal t across clusters, so their tie
    winner depends on the visit order; tests compare t and hit masks and
    allow tri ties there (tests/test_frontier_trace.py:35-48);
  * no phantom hit: the Pallas kernel's all-miss tile value 3e38 counts as
    a hit when tmax > 3e38 (:318-325); here a miss has no value at all, so
    a ray with tmax = inf misses as it should;
  * the co-sort carries a permutation into the kernel instead of sorting
    the nine ray arrays along (`_cosort_rays`, :96), and it counts a ray
    dead where `active` is off (JAX sets such a ray's tmax to -1 first); no
    per-block `visits` output, which belongs to the TPU's ray blocks; and
    no VMEM gate on the cluster count (`_check_cp`, :141): there is no E
    matrix here.

The cluster tracer (K6, ops/cluster_trace.py) and the binned tracer (K7,
ops/binned_trace.py) compute this function too, and also return the
winner's Moller-Trumbore u, v; their plain versions are the ones here
(`_closest_uv_plain`, `_any_plain`), and so are the checks of their inputs.
The plain versions take any leaf table with ClusterView's fields (boxes,
rows (C, W, 12) of any leaf width W, count, the soup): the subcluster
tracer (K8, ops/sub_trace.py) computes the same function over the
32-triangle leaves of accel/cluster.build_subclusters, and its plain
versions are these, over that table.
"""
from __future__ import annotations

from typing import Optional

import torch

from fermat_tpu_torch.accel.cluster import ClusterView
from fermat_tpu_torch.accel.traverse import Hit
from fermat_tpu_torch.core.math import Vec3, ray_barycentrics
from fermat_tpu_torch.core.morton import morton3d
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel, check_cuda_tensor
from fermat_tpu_torch.ops.trace import _lane_args, mt_test

Tensor = torch.Tensor

SLACK_MUL = 1.0 - 2.0 ** -10  # both exact in float32
SLACK_ADD = 2.0 ** -12
_INT_MAX = 2 ** 31 - 1
_CHUNK_ELEMS = 1 << 26  # rays x clusters per chunk of the plain versions
BLOCK = 128  # threads a CTA of csrc/frontier.cu
SORT_MIN = 4 * BLOCK  # the rays are co-sorted from 4 blocks up, as in JAX
MAX_STACK = 64  # csrc/frontier.cu kMaxStack: stack entries a thread can have

KEY = CudaKernel(
    "frontier_sort_key", "frontier.cu", "fermat_frontier_sort_key",
    [P] * 9 + [P, I, P],
    replaces="fermat_tpu/ops/pallas_frontier_trace.py:61 (_sort_key, XLA; the "
             "co-sort _cosort_rays :96)",
)
CLOSEST = CudaKernel(
    "trace_closest_frontier", "frontier.cu", "fermat_frontier_closest",
    [P] * 9 + [P, P, P, P, I, I, P, P],
    replaces="fermat_tpu/ops/pallas_frontier_trace.py:489 (_closest_impl, kernel "
             "_closest_kernel :204, entry matrix _build_entry_matrix :157)",
)
ANY = CudaKernel(
    "trace_any_frontier", "frontier.cu", "fermat_frontier_any",
    [P] * 9 + [P, P, P, P, I, I, P],
    replaces="fermat_tpu/ops/pallas_frontier_trace.py:537 (_any_impl, kernel _any_kernel :352)",
)


def _inv(c: Tensor) -> Tensor:
    return torch.where(torch.abs(c) > 1e-20, 1.0 / torch.where(c == 0.0, 1.0, c),
                       torch.where(c >= 0.0, 1e20, -1e20))


def cluster_entries(cl: ClusterView, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor) -> Tensor:
    """(N, Cp) slab entry of every ray into every cluster box, +inf where the
    ray misses the box within [tmin, tmax] or the box is empty; operation
    order as _build_entry_matrix (pallas_frontier_trace.py:182-201)."""
    col = lambda v: v[:, None]
    idx, idy, idz = _inv(col(d.x)), _inv(col(d.y)), _inv(col(d.z))
    ox, oy, oz = col(o.x), col(o.y), col(o.z)
    t0x = (cl.lo_x - ox) * idx
    t1x = (cl.hi_x - ox) * idx
    t0y = (cl.lo_y - oy) * idy
    t1y = (cl.hi_y - oy) * idy
    t0z = (cl.lo_z - oz) * idz
    t1z = (cl.hi_z - oz) * idz
    near = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                         torch.maximum(torch.minimum(t0z, t1z), col(tmin)))
    far = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                        torch.minimum(torch.maximum(t0z, t1z), col(tmax)))
    keep = (near <= far) & (cl.lo_x <= cl.hi_x)
    return torch.where(keep, near, float("inf"))


def _slack(e: Tensor) -> Tensor:
    return e * SLACK_MUL - SLACK_ADD


def _chunks(n: int, cp: int):
    step = max(1, _CHUNK_ELEMS // max(cp, 1))
    for s in range(0, n, step):
        yield slice(s, min(n, s + step))


def _visits(cl: ClusterView, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor, active: Tensor):
    """Each ray's clusters nearest entry first: (E' sorted (N, Cp), cluster
    ids (N, Cp)); rays that are not active enter none."""
    e = cluster_entries(cl, o, d, tmin, tmax)
    e = torch.where(active[:, None], _slack(e), float("inf"))
    return torch.sort(e, dim=1)


def _tile(cl: ClusterView, c: Tensor):
    """The W triangle slots of leaves c: (p0x .. e2z as (m, W)), ids (m, W)."""
    rows = cl.rows[c]
    return [rows[..., k] for k in range(9)], rows[..., 9].to(torch.int32)


def _closest_plain(cl: ClusterView, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
                   active: Tensor):
    """Plain PyTorch version of K5a -> (t, tri): every ray's entered clusters
    in entry order while E' <= its best t (the module docstring's function)."""
    n, dev = o.x.shape[0], o.x.device
    t_best = tmax.clone()
    id_best = torch.full((n,), _INT_MAX, dtype=torch.int32, device=dev)
    for sl in _chunks(n, cl.lo_x.shape[1]):
        es, order = _visits(cl, Vec3(*(c[sl] for c in o)), Vec3(*(c[sl] for c in d)),
                            tmin[sl], tmax[sl], active[sl])
        tb, ib = t_best[sl], id_best[sl]  # views: updated in place
        for k in range(es.shape[1]):
            go = (es[:, k] <= tb) & (es[:, k] < float("inf"))
            rows = torch.nonzero(go)[:, 0]
            if rows.numel() == 0:
                break  # entries are sorted: no ray of the chunk goes further
            r = rows + sl.start
            tri9, ids = _tile(cl, order[rows, k])
            col = lambda v: v[r][:, None]
            tt, _, _, inside = mt_test(tri9, (col(o.x), col(o.y), col(o.z)),
                                       (col(d.x), col(d.y), col(d.z)))
            ok = (inside & (tt > col(tmin)) & (tt < col(tmax)) & (ids >= 0)
                  & (tt >= es[rows, k][:, None]))
            tt = torch.where(ok, tt, float("inf"))
            t_new = tt.min(dim=1).values
            id_new = torch.where(ok & (tt == t_new[:, None]), ids, _INT_MAX).min(dim=1).values
            t_cur, i_cur = tb[rows], ib[rows]
            better = ok.any(dim=1) & ((t_new < t_cur) | ((t_new == t_cur) & (id_new < i_cur)))
            tb[rows] = torch.where(better, t_new, t_cur)
            ib[rows] = torch.where(better, id_new, i_cur)
    tri = torch.where(id_best == _INT_MAX, -1, id_best)
    return torch.where(tri < 0, tmax, t_best), tri


def _any_plain(cl: ClusterView, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
               active: Tensor) -> Tensor:
    """Plain PyTorch version of K5b: a hit in any cluster the ray enters."""
    n, dev = o.x.shape[0], o.x.device
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    for sl in _chunks(n, cl.lo_x.shape[1]):
        es, order = _visits(cl, Vec3(*(c[sl] for c in o)), Vec3(*(c[sl] for c in d)),
                            tmin[sl], tmax[sl], active[sl])
        oc = occ[sl]
        for k in range(es.shape[1]):
            rows = torch.nonzero((es[:, k] < float("inf")) & ~oc)[:, 0]
            if rows.numel() == 0:
                break
            r = rows + sl.start
            tri9, ids = _tile(cl, order[rows, k])
            col = lambda v: v[r][:, None]
            tt, _, _, inside = mt_test(tri9, (col(o.x), col(o.y), col(o.z)),
                                       (col(d.x), col(d.y), col(d.z)))
            ok = inside & (tt > col(tmin)) & (tt < col(tmax)) & (ids >= 0)
            oc[rows] = ok.any(dim=1)
    return occ


def _sort_key_plain(cl: ClusterView, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
                    active: Tensor) -> Tensor:
    """Plain version of key_kernel (int32): pallas_frontier_trace._sort_key
    (:61-89), (dead << 27) | (octant << 24) | (morton3d(origin normalised
    to the cluster boxes) >> 6), dead = ~active | (tmax <= tmin). A NaN
    coordinate takes cell 0 (JAX leaves it unspecified)."""
    nrm = cl.key_norm
    cells = [torch.nan_to_num((c - nrm[k]) * nrm[3 + k], nan=0.0) for k, c in enumerate(o)]
    m = morton3d(*cells) >> 6
    octant = ((d.x < 0).to(torch.int64) * 4 + (d.y < 0).to(torch.int64) * 2
              + (d.z < 0).to(torch.int64))
    dead = (~active | (tmax <= tmin)).to(torch.int64)
    return ((dead << 27) | (octant << 24) | m).to(torch.int32)


def _recompute_uv(cl: ClusterView, o: Vec3, d: Vec3, tri: Tensor):
    """Barycentrics of the winning triangle from the original soup
    (pallas_frontier_trace.py:_recompute_uv, :417-455). ray_barycentrics
    has trace.mt_test's operation order, and a winner passed its
    |det| > 1e-12 test, so these are also the u, v that the cluster and
    binned kernels compute for it (pallas_cluster_trace.py:235-242), bit
    for bit; 0 on a miss."""
    i = torch.clamp_min(tri, 0).long()
    g = lambda v: Vec3(v.x[i], v.y[i], v.z[i])
    u, v = ray_barycentrics(o, d, g(cl.p0), g(cl.e1), g(cl.e2))
    ok = tri >= 0
    return torch.where(ok, u, 0.0), torch.where(ok, v, 0.0)


def _closest_uv_plain(cl: ClusterView, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
                      active: Tensor) -> Hit:
    """Plain version of the cluster and binned closest-hit kernels (K6a,
    K7a): K5a's function and the winner's MT u, v."""
    t, tri = _closest_plain(cl, o, d, tmin, tmax, active)
    u, v = _recompute_uv(cl, o, d, tri)
    return Hit(t=t, tri=tri, u=u, v=v)


def _ray_args(o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor, active: Tensor) -> list:
    """Checked ray inputs (ox .. dz, tmin, tmax, active) as contiguous
    tensors. The caller holds them until the launch is enqueued: a copy
    freed earlier could be handed to the outputs' torch.empty."""
    dev = o.x.device
    rays = [c.contiguous() for c in (*o, *d)]
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        check_cuda_tensor(t, name, torch.float32, 1, dev)
    check_cuda_tensor(active, "active", torch.bool, 1, dev)
    return [*rays, tmin, tmax, active]


def _table_args(cl: ClusterView, dev, tree: bool = False, width: int = 128) -> Tensor:
    """Checks the leaf table a kernel reads (`width` triangle slots a leaf)
    and returns the (6, Cp) boxes as one contiguous tensor; with `tree`,
    the frontier kernel's table instead, which reads no boxes: the rows,
    counts, node records and sort bounds (returns None)."""
    check_cuda_tensor(cl.rows, "rows", torch.float32, 3, dev)
    check_cuda_tensor(cl.count, "count", torch.int32, 1, dev)
    c_pad = cl.rows.shape[0]
    if tuple(cl.rows.shape[1:]) != (width, 12) or cl.count.shape[0] != c_pad:
        raise ValueError(f"malformed {type(cl).__name__}: rows (C, {width}, 12), count (C,)")
    if cl.rows.data_ptr() % 16:
        raise ValueError(f"{type(cl).__name__}.rows must be 16-byte aligned (read as float4)")
    if not tree:
        boxes = cl.boxes().contiguous()
        check_cuda_tensor(boxes, "boxes", torch.float32, 2, dev)
        if boxes.shape[0] != 6 or boxes.shape[1] < c_pad:
            raise ValueError(f"malformed {type(cl).__name__}: boxes (6, Cp >= C)")
        return boxes
    check_cuda_tensor(cl.nodes, "nodes", torch.float32, 2, dev)
    check_cuda_tensor(cl.key_norm, "key_norm", torch.float32, 1, dev)
    if (cl.nodes.shape[1] != 16 or cl.key_norm.shape[0] != 6
            or not 1 <= int(cl.depth) <= MAX_STACK):
        raise ValueError(f"malformed ClusterView: nodes (n, 16), key_norm (6,), depth in "
                         f"[1, {MAX_STACK}]")
    if cl.nodes.data_ptr() % 16:
        raise ValueError("ClusterView.nodes must be 16-byte aligned (read as float4)")
    return None


def _launch_args(cl: ClusterView, o: Vec3, d: Vec3, tmin, tmax, active) -> list:
    """K5's checked launch inputs up to n, held by the caller until the
    launch is enqueued: the rays, the permutation from the co-sort (0, the
    identity, below SORT_MIN rays; the sort key is key_kernel's, launched
    here), the node records, the rows, the counts and the tree's depth."""
    dev, n = o.x.device, o.x.shape[0]
    _table_args(cl, dev, tree=True)
    rays = _ray_args(o, d, tmin, tmax, active)
    perm = torch.argsort(_key(cl, rays), stable=True) if n >= SORT_MIN else None
    return [*rays, perm, cl.nodes, cl.rows, cl.count, int(cl.depth), n]


def _key(cl: ClusterView, rays: list) -> Tensor:
    """key_kernel's sort key of the checked rays (_ray_args)."""
    n, dev = rays[0].shape[0], rays[0].device
    key = torch.empty(n, dtype=torch.int32, device=dev)
    KEY.launch(dev, *(a.data_ptr() for a in rays), cl.key_norm.data_ptr(), n, key.data_ptr())
    return key


def sort_key(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
             active: Optional[Tensor] = None) -> Tensor:
    """The co-sort key of each ray (int32), as the frontier wrappers sort by
    it: key_kernel on CUDA tensors, _sort_key_plain on CPU tensors."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _sort_key_plain(clusters, o, d, tmin, tmax, active)
    _table_args(clusters, o.x.device, tree=True)
    return _key(clusters, _ray_args(o, d, tmin, tmax, active))


def _ptrs(args: list) -> list:
    return [a if isinstance(a, int) else 0 if a is None else a.data_ptr() for a in args]


def trace_closest_frontier(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                           active: Optional[Tensor] = None, with_uv: bool = True) -> Hit:
    """Closest hit over the cluster table; t = tmax and tri = -1 on a miss.
    with_uv=False leaves u = v = 0 for callers that take the barycentrics
    from their own row fetch (MeshView.shade_fetch_ray)."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        t, tri = _closest_plain(clusters, o, d, tmin, tmax, active)
    else:
        n, dev = o.x.shape[0], o.x.device
        args = _launch_args(clusters, o, d, tmin, tmax, active)
        t = torch.empty(n, dtype=torch.float32, device=dev)
        tri = torch.empty(n, dtype=torch.int32, device=dev)
        CLOSEST.launch(dev, *_ptrs(args), t.data_ptr(), tri.data_ptr())
    if with_uv:
        u, v = _recompute_uv(clusters, o, d, tri)
    else:
        u = v = torch.zeros_like(t)
    return Hit(t=t, tri=tri, u=u, v=v)


def trace_any_frontier(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                       active: Optional[Tensor] = None) -> Tensor:
    """Occlusion flag per ray inside (tmin, tmax), masked by `active`."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _any_plain(clusters, o, d, tmin, tmax, active)
    n, dev = o.x.shape[0], o.x.device
    args = _launch_args(clusters, o, d, tmin, tmax, active)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    ANY.launch(dev, *_ptrs(args), occ.data_ptr())
    return occ
