"""The large-scene tracer's pieces against the JAX package, on the CPU:

  * accel/cluster.build_clusters bit-equal to fermat_tpu's (table and boxes);
  * K5a / K5b's plain versions (ops/frontier_trace.py) against
    fermat_tpu.ops.pallas_frontier_trace live in Pallas interpret mode, at
    the sizes of tests/test_frontier_trace.py (512 rays, random_soup(1500)
    and random_soup(1000)), with the active mask and per-ray tmax. As there:
    hit masks equal, t within rtol 1e-5 / atol 1e-5 (XLA:CPU contracts
    a*b+c into FMA, so t is not bit-equal), the same triangle on >= 99% of
    hits (exact-t ties: the JAX kernel keeps the first cluster it visits,
    the port the smallest triangle id); occlusion flags equal;
  * the JAX kernel's phantom hit at tmax = inf, pinned (the port misses);
  * the plain versions against the port's dense tracer (a brute force over
    every triangle), which they equal bit for bit: the same hits, t and
    triangle ids, on the scene and on random rays;
  * K4's plain version (ops/cdf_gather.py) against fermat_tpu's
    cdf_pick_rows in interpret mode with N >= 4096, so the Pallas kernel
    runs and not its fallback: equal rows, NaN and out-of-range u included;
  * what K5's kernel design rests on: the ray sort key's plain version
    bit-equal to JAX's `_sort_key`; the plain versions' answers the same
    bits in any ray order (which makes the co-sort legal); the 64-byte node
    records reproducing the tree's boxes and refs child for child; and the
    deepest stack a walk over the records reaches within the stack the
    kernel gets (the tree's depth, at most csrc/frontier.cu's 64 entries).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fermat_tpu.accel.cluster import build_clusters as jax_build_clusters  # noqa: E402
from fermat_tpu.core.math import Vec3 as JVec3  # noqa: E402
from fermat_tpu.ops.pallas_cdf_gather import cdf_pick_rows as jax_cdf_pick_rows  # noqa: E402
from fermat_tpu.ops.pallas_frontier_trace import (  # noqa: E402
    _sort_key as jax_sort_key,
    trace_any_frontier as jax_any,
    trace_closest_frontier as jax_closest,
)
from fermat_tpu.scene import procedural as jproc  # noqa: E402
from fermat_tpu_torch.accel.cluster import MAX_DEPTH, build_clusters  # noqa: E402
from fermat_tpu_torch.core.camera import generate_camera_rays  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.core.rng import TiledSequence  # noqa: E402
from fermat_tpu_torch.ops import cdf_gather  # noqa: E402
from fermat_tpu_torch.ops import frontier_trace as ft  # noqa: E402
from fermat_tpu_torch.ops import trace as dense  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

N_RAYS = 512
BLOCK = 256


def _rays(seed, n=N_RAYS, spread=12.0):
    """Random rays, made with numpy and normalised in float32 (both sides get
    the same floats)."""
    r = np.random.default_rng(seed)
    o = (r.random((n, 3)).astype(np.float32) - 0.5) * spread
    d = r.standard_normal((n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _masks(seed, n=N_RAYS):
    r = np.random.default_rng(seed)
    return r.random(n) < 0.5, (2.0 + 6.0 * r.random(n)).astype(np.float32)


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


class _Soup:
    def __init__(self, n_tris, seed):
        self.jmesh = jproc.random_soup(n_tris, seed=seed).device_view()
        self.jcl = jax_build_clusters(self.jmesh)
        self.mesh = tproc.random_soup(n_tris, seed=seed).device_view("cpu")
        self.cl = build_clusters(self.mesh)


@pytest.fixture(scope="module")
def soup1500():
    return _Soup(1500, 5)


@pytest.fixture(scope="module")
def soup1000():
    return _Soup(1000, 9)


@pytest.mark.parametrize("scene,method", [("big_room400", "sah"), ("soup1500", "sah"),
                                          ("soup1500", "median"), ("soup1500", "morton")])
def test_build_clusters_bit_equal_to_jax(scene, method):
    if scene == "big_room400":
        jm, tm = jproc.big_room(400), tproc.big_room(400)
    else:
        jm, tm = jproc.random_soup(1500, seed=5), tproc.random_soup(1500, seed=5)
    jcl = jax_build_clusters(jm.device_view(), method=method)
    cl = build_clusters(tm.device_view("cpu"), method=method)
    assert np.array_equal(np.asarray(jcl.tri), cl.tri)
    for f in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z"):
        assert np.array_equal(np.asarray(getattr(jcl, f)), getattr(cl, f).numpy()), f
    # the kernel's extras: a row per triangle slot, real counts, every real
    # cluster a leaf of the top-level tree exactly once
    assert np.array_equal(cl.rows.permute(0, 2, 1).numpy(), cl.tri[:, :12, :])
    assert np.array_equal(cl.count.numpy(), (cl.tri[:, 9, :] >= 0).sum(1))
    leaves = sorted((~cl.node_ref[cl.node_ref < 0]).tolist())
    assert leaves == torch.nonzero(cl.count > 0)[:, 0].tolist()


def _assert_closest_close(t_port, tri_port, t_jax, tri_jax, mask=None):
    hit_p, hit_j = tri_port >= 0, np.asarray(tri_jax) >= 0
    if mask is not None:
        hit_p, hit_j = hit_p & mask, hit_j & mask
    np.testing.assert_array_equal(hit_p, hit_j)
    np.testing.assert_allclose(t_port[hit_j], np.asarray(t_jax)[hit_j], rtol=1e-5, atol=1e-5)
    assert (tri_port[hit_j] == np.asarray(tri_jax)[hit_j]).mean() >= 0.99


def test_closest_matches_jax_frontier(soup1500):
    o, d = _rays(1)
    act, tmax_v = _masks(11)
    # full range, then the active mask with per-ray tmax (one compiled program)
    for active, tmax in ((None, np.full(N_RAYS, 3e38, np.float32)), (act, tmax_v)):
        jh = jax_closest(soup1500.jcl, _jv(o), _jv(d), jnp.float32(1e-4), jnp.asarray(tmax),
                         None if active is None else jnp.asarray(active), block=BLOCK)
        h = ft.trace_closest_frontier(soup1500.cl, _tv(o), _tv(d), 1e-4, torch.from_numpy(tmax),
                                      None if active is None else torch.from_numpy(active))
        _assert_closest_close(h.t.numpy(), h.tri.numpy(), jh.t, jh.tri, active)
        m = h.tri.numpy() >= 0
        assert m.mean() > 0.1
        # barycentrics recomputed from the winning id, as _recompute_uv does
        np.testing.assert_allclose(h.u.numpy()[m], np.asarray(jh.u)[m], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(h.v.numpy()[m], np.asarray(jh.v)[m], rtol=1e-4, atol=1e-5)
        if active is not None:  # inactive lanes miss with t = tmax
            assert (h.tri.numpy()[~active] == -1).all()
            np.testing.assert_array_equal(h.t.numpy()[~active], tmax[~active])


def test_any_matches_jax_frontier(soup1000):
    o, d = _rays(2)
    act, tmax_v = _masks(31)
    for active, tmax in ((None, np.full(N_RAYS, 8.0, np.float32)), (act, tmax_v)):
        j_occ = np.asarray(jax_any(soup1000.jcl, _jv(o), _jv(d), jnp.float32(1e-4),
                                   jnp.asarray(tmax),
                                   None if active is None else jnp.asarray(active),
                                   block=BLOCK))
        occ = ft.trace_any_frontier(soup1000.cl, _tv(o), _tv(d), 1e-4, torch.from_numpy(tmax),
                                    None if active is None else torch.from_numpy(active))
        np.testing.assert_array_equal(occ.numpy(), j_occ)
        assert 0.0 < j_occ.mean() < 1.0


def test_tmax_inf_phantom_hit_in_jax_is_a_miss_here():
    """With tmax = inf the Pallas kernel's all-miss tile value 3e38 beats
    t_best (pallas_frontier_trace.py:318-325), and the tile's smallest lane
    id becomes the ray's: -1 when the tile has a padding lane, a real
    triangle when the cluster is full. So a ray that hits nothing, in a
    block whose first visited cluster is full, reports a hit at t = 3e38.
    With morton clusters of a 1024-triangle soup every cluster is full. The
    port keeps +inf as its no-hit value: its tmax = inf answer equals its
    tmax = 3e38 answer, misses included."""
    jmesh = jproc.random_soup(1024, seed=5).device_view()
    jcl = jax_build_clusters(jmesh, method="morton")
    cl = build_clusters(tproc.random_soup(1024, seed=5).device_view("cpu"), method="morton")
    assert np.array_equal(np.asarray(jcl.tri), cl.tri)
    assert bool((cl.count == 128).all())
    o, d = _rays(1, n=256)
    jh = jax_closest(jcl, _jv(o), _jv(d), jnp.float32(1e-4),
                     jnp.asarray(np.full(256, np.inf, np.float32)), None, block=BLOCK)
    h_inf = ft.trace_closest_frontier(cl, _tv(o), _tv(d), 1e-4, float("inf"))
    h_big = ft.trace_closest_frontier(cl, _tv(o), _tv(d), 1e-4, 3e38)
    phantom = (np.asarray(jh.tri) >= 0) & (h_big.tri.numpy() < 0)
    assert phantom.any()
    np.testing.assert_array_equal(np.asarray(jh.t)[phantom], np.float32(3e38))
    assert torch.equal(h_inf.tri, h_big.tri)
    m = h_big.tri >= 0
    assert torch.equal(h_inf.t[m], h_big.t[m]) and bool(torch.isinf(h_inf.t[~m]).all())


@pytest.fixture(scope="module")
def room():
    view = SceneView.build(tproc.big_room(400), tproc.big_room_camera(), "cpu")
    return view, view.mesh.tri_soup()


def _camera_rays(view, res):
    pix = torch.arange(res * res)
    jx, jy = TiledSequence.create(0, 0).sample_2d(pix, 0)
    o, d, _ = generate_camera_rays(view.camera, res, res, jx, jy, pix)
    return o, d


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_plain_versions_equal_the_dense_brute_force(room, rays):
    view, tris = room
    if rays == "camera":
        o, d = _camera_rays(view, 32)
    else:
        ro, rd = _rays(5, n=1024, spread=14.0)
        o, d = _tv(ro + np.float32([0.0, 4.0, 0.0])), _tv(rd)
    n = o.x.shape[0]
    g = torch.Generator().manual_seed(3)
    active = torch.rand(n, generator=g) < 0.8
    tmax = torch.rand(n, generator=g) * 12.0
    for t0, t1, act in ((1e-4, 3e38, None), (1e-4, float("inf"), None), (0.0, tmax, active)):
        h = ft.trace_closest_frontier(view.clusters, o, d, t0, t1, act)
        ref = dense.trace_closest(tris, o, d, t0, t1, act)
        assert torch.equal(h.tri, ref.tri) and torch.equal(h.t, ref.t)
        assert 0.2 < float((h.tri >= 0).float().mean())
        occ = ft.trace_any_frontier(view.clusters, o, d, t0, t1, act)
        assert torch.equal(occ, dense.trace_any(tris, o, d, t0, t1, act))


@pytest.mark.parametrize("n_rows,cols", [(2, 23), (544, 23), (7, 5)])
def test_cdf_pick_plain_matches_jax(n_rows, cols):
    rng = np.random.default_rng(n_rows)
    w = rng.random(n_rows) + 1e-3
    cdf = (np.cumsum(w) / w.sum()).astype(np.float32)
    rows = rng.random((n_rows, cols)).astype(np.float32)
    u = rng.random(4096).astype(np.float32)
    u[:n_rows] = cdf  # exact boundaries
    u[n_rows:n_rows + 4] = [np.nan, 1.0, 1.5, -0.25]  # NaN -> 0, past the end -> L-1
    want = np.asarray(jax_cdf_pick_rows(jnp.asarray(rows), jnp.asarray(cdf), jnp.asarray(u)))
    got = cdf_gather.cdf_pick_rows(torch.from_numpy(rows), torch.from_numpy(cdf),
                                   torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[n_rows], rows[0])  # the NaN lane
    np.testing.assert_array_equal(got[n_rows + 2], rows[-1])


def test_sort_key_plain_bit_equal_to_jax(soup1500):
    """_sort_key_plain (the plain version of csrc/frontier.cu's key_kernel)
    against pallas_frontier_trace._sort_key on the same rays, with JAX's
    dead-lane convention (tmax -1 where a lane is off): dead lanes by mask
    and by tmax <= tmin, negative direction components, and origins on the
    table's bounds and outside them."""
    n = 4096
    o, d = _rays(21, n=n, spread=14.0)
    bounds = np.array([[float(np.asarray(getattr(soup1500.jcl, f"{s}_{a}")).min() if s == "lo"
                             else np.asarray(getattr(soup1500.jcl, f"{s}_{a}")).max())
                        for a in "xyz"] for s in ("lo", "hi")], np.float32)
    o[:8] = bounds[0]  # on the low corner: cell 0
    o[8:16] = bounds[1]  # on the high corner: cell 1023
    o[16:24, 0] = bounds[1, 0] + 5.0  # past the bounds: clamped
    d[24:32] = -np.abs(d[24:32])  # every component negative
    r = np.random.default_rng(22)
    active = r.random(n) < 0.8
    tmin = np.where(r.random(n) < 0.1, 5.0, 1e-4).astype(np.float32)
    tmax = (1.0 + 8.0 * r.random(n)).astype(np.float32)  # some below tmin: dead
    want = np.asarray(jax_sort_key(soup1500.jcl, _jv(o), _jv(d), jnp.asarray(tmin),
                                   jnp.where(jnp.asarray(active), jnp.asarray(tmax), -1.0)))
    got = ft._sort_key_plain(soup1500.cl, _tv(o), _tv(d), torch.from_numpy(tmin),
                             torch.from_numpy(tmax), torch.from_numpy(active))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    dead = ~active | (tmax <= tmin)
    assert dead.any() and (~dead).any() and (got.numpy()[dead] >> 27 == 1).all()
    cells = got.numpy()[:16] & 0xFFFFFF
    assert (cells[:8] == 0).all() and (cells[8:16] == 0xFFFFFF).all()


@pytest.mark.parametrize("scene", ["room", "soup1500"])
def test_plain_versions_do_not_depend_on_ray_order(scene, room, soup1500):
    """The answers of _closest_plain / _any_plain on the rays in a permuted
    order are the same bits, permuted: what lets K5 trace the rays in their
    sorted order."""
    cl = room[0].clusters if scene == "room" else soup1500.cl
    ro, rd = _rays(23, n=1024, spread=14.0)
    o, d = _tv(ro + np.float32([0.0, 4.0, 0.0])), _tv(rd)
    r = np.random.default_rng(24)
    active = torch.from_numpy(r.random(1024) < 0.8)
    tmin = torch.full((1024,), 1e-4)
    tmax = torch.from_numpy((2.0 + 10.0 * r.random(1024)).astype(np.float32))
    perm = torch.from_numpy(r.permutation(1024))
    pv = lambda v: Vec3(*(c[perm] for c in v))
    t, tri = ft._closest_plain(cl, o, d, tmin, tmax, active)
    tp, trip = ft._closest_plain(cl, pv(o), pv(d), tmin[perm], tmax[perm], active[perm])
    assert torch.equal(t[perm].view(torch.int32), tp.view(torch.int32))
    assert torch.equal(tri[perm], trip) and bool((tri >= 0).any())
    occ = ft._any_plain(cl, o, d, tmin, tmax, active)
    assert torch.equal(occ[perm], ft._any_plain(cl, pv(o), pv(d), tmin[perm], tmax[perm],
                                                 active[perm]))
    assert bool(occ.any()) and not bool(occ.all())


def _record_children(cl):
    """Each record's two children as (box (2, 6) lo xyz hi xyz, refs (2,))."""
    rec = cl.nodes.numpy()
    lo = lambda a, b, c: np.stack([rec[:, a], rec[:, b], rec[:, c]], 1)
    boxes = np.stack([np.concatenate([lo(0, 2, 8), lo(1, 3, 9)], 1),
                      np.concatenate([lo(4, 6, 10), lo(5, 7, 11)], 1)], 1)
    refs = rec[:, 12:14].copy().view(np.int32)
    return boxes, refs


@pytest.mark.parametrize("scene", ["room", "soup1500"])
def test_node_records_reproduce_the_tree(scene, room, soup1500):
    """The (n_inner, 16) records hold every inner node's two children: the
    node_box rows bit for bit and the refs (a record index for an inner
    child, ~cluster for a leaf), in DFS order; each leaf's box is its
    cluster's box bit for bit."""
    cl = room[0].clusters if scene == "room" else soup1500.cl
    nb, nr = cl.node_box.numpy(), cl.node_ref.numpy()
    inner = np.nonzero(nr >= 0)[0]
    rec_of = {int(node): k for k, node in enumerate(inner)}
    boxes, refs = _record_children(cl)
    assert boxes.shape[0] == inner.size and inner[0] == 0
    for k, node in enumerate(inner):
        for side, child in enumerate((node + 1, nr[node])):
            assert np.array_equal(boxes[k, side].view(np.int32), nb[child].view(np.int32))
            want = rec_of[int(child)] if nr[child] >= 0 else nr[child]
            assert refs[k, side] == want
    leaf = nr < 0
    assert np.array_equal(nb[leaf].view(np.int32),
                          cl.boxes().numpy()[:, ~nr[leaf]].T.view(np.int32))
    assert cl.rows.shape[0] >= int((cl.count > 0).sum()) == int(leaf.sum())


def test_one_cluster_tree_is_one_record():
    cl = build_clusters(tproc.random_soup(100, seed=3).device_view("cpu"))
    boxes, refs = _record_children(cl)
    assert boxes.shape[0] == 1 and int(cl.depth) == 1
    assert refs[0, 0] == ~0 and (boxes[0, 1, :3] > boxes[0, 1, 3:]).all()  # an empty box


def _deepest_stack(cl, o, d, tmin, tmax):
    """Deepest stack of csrc/frontier.cu's walk over the records with no
    culling (the kernels' walks cull, so they push a subset): the nearer
    child next, the farther one pushed."""
    boxes, refs = _record_children(cl)
    boxes, refs = torch.from_numpy(boxes), torch.from_numpy(refs).long()
    inv = [ft._inv(c) for c in d]
    m = o.x.shape[0]
    stack = torch.zeros((m, MAX_DEPTH + 4), dtype=torch.long)
    sp = torch.zeros(m, dtype=torch.long)
    cur = torch.zeros(m, dtype=torch.long)  # a record; < 0: a leaf
    alive = torch.ones(m, dtype=torch.bool)
    deepest = 0
    while bool(alive.any()):
        sel = torch.nonzero(alive & (cur >= 0))[:, 0]
        entries = []
        for side in range(2):
            b = boxes[cur[sel], side]
            t0 = [(b[:, k] - c[sel]) * iv[sel] for k, (c, iv) in enumerate(zip(o, inv))]
            t1 = [(b[:, 3 + k] - c[sel]) * iv[sel] for k, (c, iv) in enumerate(zip(o, inv))]
            near = torch.stack([torch.minimum(a, b) for a, b in zip(t0, t1)] + [tmin[sel]]).amax(0)
            far = torch.stack([torch.maximum(a, b) for a, b in zip(t0, t1)] + [tmax[sel]]).amin(0)
            entries.append(((near <= far) & (b[:, 0] <= b[:, 3]), near))
        (hl, el), (hr, er) = entries
        lf = el <= er
        both = hl & hr
        far_ref = torch.where(lf, refs[cur[sel], 1], refs[cur[sel], 0])
        stack[sel[both], sp[sel[both]]] = far_ref[both]
        sp[sel[both]] += 1
        nxt = torch.where(both, torch.where(lf, refs[cur[sel], 0], refs[cur[sel], 1]),
                          torch.where(hl, refs[cur[sel], 0], refs[cur[sel], 1]))
        go = hl | hr
        cur[sel[go]] = nxt[go]
        deepest = max(deepest, int(sp.max()))
        pop = torch.cat([sel[~go], torch.nonzero(alive & (cur < 0))[:, 0]])
        has = sp[pop] > 0
        sp[pop[has]] -= 1
        cur[pop[has]] = stack[pop[has], sp[pop[has]]]
        alive[pop[~has]] = False
    return deepest


@pytest.mark.parametrize("scene", ["room", "soup1500"])
def test_deepest_stack_fits_the_kernel_stack(scene, room, soup1500):
    """The stack K5 gets is the tree's depth (csrc/frontier.cu: at most one
    entry per level below the root), at most its 64 entries under the
    builder's depth cap; on camera-like and random rays the deepest stack a
    walk reaches stays within it."""
    cl = room[0].clusters if scene == "room" else soup1500.cl
    assert 1 <= int(cl.depth) <= MAX_DEPTH <= ft.MAX_STACK
    ro, rd = _rays(25, n=2048, spread=16.0)
    o, d = _tv(ro), _tv(rd)
    n = o.x.shape[0]
    deepest = _deepest_stack(cl, o, d, torch.zeros(n), torch.full((n,), 3e38))
    assert 1 <= deepest <= int(cl.depth)
