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
from fermat_tpu_torch.core.math import Vec3 as TV
from fermat_tpu_torch.ops import gather as tgather
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


def test_const_lanes_keep_each_number_apart():
    """K1a's cached constant lanes (ops/trace._const_lanes): one buffer per
    value with its sign (-0.0 apart from 0.0), grown as needed, returned as
    an (n,) slice holding the value's float32 bits; tensors pass through."""
    dev = torch.device("cpu")
    bits = lambda t: t.view(torch.int32)
    a = ttrace._const_lanes(0.0, 8, dev)
    b = ttrace._const_lanes(-0.0, 4, dev)
    c = ttrace._const_lanes(0.0, 16, dev)  # grows the 0.0 buffer
    d = ttrace._const_lanes(3.0e38, 3, dev)
    assert a.shape == (8,) and b.shape == (4,) and c.shape == (16,) and d.shape == (3,)
    assert bool((bits(a) == 0).all()) and bool((bits(c) == 0).all())
    assert bool((bits(b) == bits(torch.tensor(-0.0))).all())
    assert bool((d == torch.tensor(3.0e38, dtype=torch.float32)).all())
    assert ttrace._const_lanes(0.0, 5, dev).data_ptr() == c.data_ptr()  # reused
    t = torch.arange(4, dtype=torch.float32)
    assert torch.equal(ttrace._const_lanes(t, 4, dev), t)
