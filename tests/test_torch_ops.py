"""The port's kernel modules (plain versions, on the CPU) against fermat_tpu's
Pallas kernels, run in interpret mode as fermat_tpu's own tests run them.

Gather: exact. Tracers: equal occlusion flags and equal hit ids, except on
a lane whose two nearest hits tie (the boxes' bottom faces lie in the floor's
plane, so their t differ by an ulp); t within rtol 1e-6 and atol 1e-6 (an
ulp of the scene's coordinates, |x| <= 5), u and v, which carry 1/det,
within atol 1e-5 (measured 1.6e-6 at worst): XLA:CPU contracts the
Moller-Trumbore products into FMA and the port's plain version does not (on
the card the port builds its kernels with --fmad=false to round like the
plain version).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fermat_tpu.accel.traverse import trace_any_brute, trace_closest_brute
from fermat_tpu.core.math import Vec3 as JV
from fermat_tpu.ops.gather import _pallas_onehot_gather, one_hot_matmul_gather
from fermat_tpu.ops.pallas_trace import trace_any_pallas, trace_closest_pallas
from fermat_tpu.scene import procedural as jproc
from fermat_tpu_torch.accel.cluster import build_clusters, build_subclusters
from fermat_tpu_torch.core.math import Vec3 as TV
from fermat_tpu_torch.ops import binned_trace as tbinned
from fermat_tpu_torch.ops import cluster_trace as tcluster
from fermat_tpu_torch.ops import frontier_trace as tfrontier
from fermat_tpu_torch.ops import gather as tgather
from fermat_tpu_torch.ops import sub_trace as tsub
from fermat_tpu_torch.ops import trace as ttrace
from fermat_tpu_torch.scene import procedural as tproc

N = 1024


@pytest.mark.parametrize("rows,cols", [(36, 52), (300, 23)])
def test_gather_rows_exact(rows, cols):
    r = np.random.default_rng(rows)
    table = r.standard_normal((rows, cols)).astype(np.float32)
    idx = r.integers(0, rows, N).astype(np.int32)
    got = tgather.gather_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_pallas_onehot_gather(table, idx)))
    np.testing.assert_array_equal(got, np.asarray(one_hot_matmul_gather(table, idx)))


def test_gather_out_of_range_rows_are_zero():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3) + 1.0
    idx = torch.tensor([-1, 0, 3, 4, 100], dtype=torch.int32)
    got = tgather.gather_rows(table, idx)
    want = _pallas_onehot_gather(jnp.asarray(table.numpy()), jnp.asarray(idx.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[[0, 3, 4]] == 0).all()


def _scene(name):
    if name == "cornell":
        return (jproc.cornell_box(glossy_boxes=True).device_view(),
                tproc.cornell_box(glossy_boxes=True).device_view("cpu"))
    return jproc.random_soup(300).device_view(), tproc.random_soup(300).device_view("cpu")


@pytest.fixture(scope="module", params=["cornell", "soup300"])
def rays(request):
    jmesh, tmesh = _scene(request.param)
    r = np.random.default_rng(11)
    if request.param == "cornell":
        o = r.uniform([-1, 0, -1], [1, 2, 1], (N, 3)).T.astype(np.float32)
    else:
        o = r.uniform(-5, 5, (3, N)).astype(np.float32)
    d = r.standard_normal((3, N)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    active = r.random(N) < 0.85
    tmax = r.uniform(0.0, 4.0, N).astype(np.float32)
    return jmesh, tmesh, o, d, active, tmax


def _t(rays_np):
    return TV(*map(torch.from_numpy, rays_np))


def test_trace_closest_matches_pallas_and_brute(rays):
    jmesh, tmesh, o, d, active, _ = rays
    want = trace_closest_pallas(jmesh, JV(*map(jnp.asarray, o)), JV(*map(jnp.asarray, d)),
                                1e-4, 3.0e38, jnp.asarray(active))
    got = ttrace.trace_closest(tmesh.tri_soup(), _t(o), _t(d), 1e-4, 3.0e38,
                               torch.from_numpy(active))
    tri, t = got.tri.numpy(), got.t.numpy()
    np.testing.assert_allclose(t, np.asarray(want.t), rtol=1e-6, atol=1e-6)
    tie = tri != np.asarray(want.tri)
    assert tie.sum() <= 2 and (tri[tie] >= 0).all() and (np.asarray(want.tri)[tie] >= 0).all()
    same = ~tie
    np.testing.assert_allclose(got.u.numpy()[same], np.asarray(want.u)[same], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.v.numpy()[same], np.asarray(want.v)[same], rtol=1e-6, atol=1e-5)
    hit = tri >= 0
    assert hit.any() and not hit[~active].any()
    assert (got.t.numpy()[~hit] == np.float32(3.0e38)).all()  # a miss returns tmax
    brute = trace_closest_brute(jmesh, JV(*map(jnp.asarray, o)), JV(*map(jnp.asarray, d)),
                                1e-4, 3.0e38, jnp.asarray(active))
    np.testing.assert_array_equal(tri[active & same], np.asarray(brute.tri)[active & same])
    np.testing.assert_allclose(t[active], np.asarray(brute.t)[active], rtol=1e-6, atol=1e-6)


def test_trace_any_matches_pallas_and_brute(rays):
    jmesh, tmesh, o, d, active, tmax = rays
    jo, jd = JV(*map(jnp.asarray, o)), JV(*map(jnp.asarray, d))
    want = trace_any_pallas(jmesh, jo, jd, 0.0, jnp.asarray(tmax), jnp.asarray(active))
    got = ttrace.trace_any(tmesh.tri_soup(), _t(o), _t(d), 0.0, torch.from_numpy(tmax),
                           torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.any() and not got.all() and not got[~active].any()
    brute = trace_any_brute(jmesh, jo, jd, 0.0, jnp.asarray(tmax), jnp.asarray(active))
    np.testing.assert_array_equal(got, np.asarray(brute))


def test_tmax_above_pallas_sentinel_is_no_phantom_hit():
    """A ray that misses everything reports tri = -1 even with tmax = inf
    (the Pallas kernel's 3e38 no-hit sentinel is repaired in the port)."""
    tris = tproc.cornell_box().device_view("cpu").tri_soup()
    o = TV(*(torch.tensor([v]) for v in (0.0, 5.0, 0.0)))  # above the box
    d = TV(*(torch.tensor([v]) for v in (0.0, 1.0, 0.0)))  # pointing away
    hit = ttrace.trace_closest(tris, o, d, 1e-4, float("inf"))
    assert int(hit.tri[0]) == -1 and float(hit.t[0]) == float("inf")


def test_lanes_keep_each_number_apart():
    """The cached lanes of a Python number (ops/trace._lanes): one buffer per
    value with its sign (-0.0 apart from 0.0), grown as needed, returned as
    an (n,) slice holding the value's float32 bits; tensors pass through."""
    dev = torch.device("cpu")
    bits = lambda t: t.view(torch.int32)
    a = ttrace._lanes(0.0, 8, dev)
    b = ttrace._lanes(-0.0, 4, dev)
    c = ttrace._lanes(0.0, 16, dev)  # grows the 0.0 buffer
    d = ttrace._lanes(3.0e38, 3, dev)
    assert a.shape == (8,) and b.shape == (4,) and c.shape == (16,) and d.shape == (3,)
    assert bool((bits(a) == 0).all()) and bool((bits(c) == 0).all())
    assert bool((bits(b) == bits(torch.tensor(-0.0))).all())
    assert bool((d == torch.tensor(3.0e38, dtype=torch.float32)).all())
    assert ttrace._lanes(0.0, 5, dev).data_ptr() == c.data_ptr()  # reused
    t = torch.arange(4, dtype=torch.float32)
    assert torch.equal(ttrace._lanes(t, 4, dev), t)


# the five tracer wrappers that take their tmin / tmax lanes from _lanes:
# (the table they trace, closest-hit, any-hit)
_TRACERS = {
    "dense": (lambda m: m.tri_soup(), ttrace.trace_closest, ttrace.trace_any),
    "frontier": (build_clusters, tfrontier.trace_closest_frontier,
                 tfrontier.trace_any_frontier),
    "cluster": (build_clusters, tcluster.trace_closest_cluster, tcluster.trace_any_cluster),
    "binned": (build_clusters, tbinned.trace_closest_binned, tbinned.trace_any_binned),
    "sub": (build_subclusters, tsub.trace_closest_sub, tsub.trace_any_sub),
}


@pytest.fixture(scope="module", params=["cornell_box", "big_room400"])
def lane_scene(request):
    mesh = (tproc.cornell_box(glossy_boxes=True) if request.param == "cornell_box"
            else tproc.big_room(400)).device_view("cpu")
    lo, hi = mesh.tri_soup()[0:3].min(dim=1).values, mesh.tri_soup()[0:3].max(dim=1).values
    r = np.random.default_rng(5)
    n = 512
    o = r.uniform(0.0, 1.0, (3, n)).astype(np.float32) * (hi - lo).numpy()[:, None] \
        + lo.numpy()[:, None]
    d = r.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    active = torch.from_numpy(r.uniform(size=n) < 0.8)
    return mesh, TV(*map(torch.from_numpy, o)), TV(*map(torch.from_numpy, d)), active


@pytest.mark.parametrize("tracer", list(_TRACERS))
def test_tracer_wrappers_share_no_lane_buffer(lane_scene, tracer):
    """Every tracer wrapper with number tmin / tmax (the cached lanes, and
    the cached every-lane mask) answers as with freshly filled lanes, and
    none of its outputs shares storage with a cached lane buffer, even
    after the caller writes into the outputs."""
    mesh, o, d, active = lane_scene
    build, closest, any_hit = _TRACERS[tracer]
    table = build(mesh)
    n = o.x.shape[0]
    fresh = lambda x: torch.full((n,), x, dtype=torch.float32)

    def traced():
        return (closest(table, o, d, 1e-4, 3.0e38, active),
                any_hit(table, o, d, 0.0, 2.5, active),
                any_hit(table, o, d, 0.0, 2.5))

    hit, occ, occ_all = traced()
    want_hit = closest(table, o, d, fresh(1e-4), fresh(3.0e38), active)
    want_occ = any_hit(table, o, d, fresh(0.0), fresh(2.5), active)
    want_all = any_hit(table, o, d, fresh(0.0), fresh(2.5), torch.ones(n, dtype=torch.bool))
    outs = [*hit, occ, occ_all]
    wants = [*want_hit, want_occ, want_all]
    assert all(torch.equal(a, b) for a, b in zip(outs, wants))
    assert bool((hit.tri >= 0).any()) and bool(occ.any()) and not bool(occ.all())
    cached = {b.untyped_storage().data_ptr() for b in ttrace._LANES.values()}
    assert not any(t.untyped_storage().data_ptr() in cached for t in outs)
    for t in outs:  # the caller writes into what it was given
        t.fill_(True if t.dtype == torch.bool else -7)
    again = traced()
    assert all(torch.equal(a, b) for a, b in zip([*again[0], *again[1:]], wants))
