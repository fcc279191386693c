"""The subcluster tracer's pieces against the JAX package, on the CPU:

  * accel/cluster.build_subclusters bit-equal to fermat_tpu's: the leaves in
    their slot order (the four-phase (Ns * 4, 16, 128) tile of the JAX
    package, rebuilt here from the port's rows) and the per-subcluster
    boxes;
  * K8a / K8b's plain versions (K5's, ops/frontier_trace.py, over the
    subcluster table) equal to the port's dense tracer (a brute force over
    every triangle) bit for bit, and to K5's answer over the cluster table;
  * against fermat_tpu.ops.pallas_sub_trace live in Pallas interpret mode,
    at the sizes of tests/test_sub_trace.py (512 rays, random_soup(1500)
    and random_soup(1000), block 128), with the active mask and per-ray
    tmax: hit masks equal, t within rtol 1e-5 / atol 1e-5 (XLA:CPU contracts
    a*b+c into FMA), the same triangle on >= 99% of hits (exact-t ties: the
    JAX kernel keeps the first-visited triangle, the port the smallest id),
    u and v within 1e-5 where the triangle agrees; occlusion flags equal;
  * tmax = inf (the JAX kernel's phantom hit, which the port does not
    have) and inactive lanes.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fermat_tpu.accel.cluster import build_subclusters as jax_build_subclusters  # noqa: E402
from fermat_tpu.ops.pallas_sub_trace import (  # noqa: E402
    trace_any_sub as jax_any,
    trace_closest_sub as jax_closest,
)
from fermat_tpu.scene import procedural as jproc  # noqa: E402
from fermat_tpu_torch.accel.cluster import SUB, build_subclusters  # noqa: E402
from fermat_tpu_torch.ops import frontier_trace as ft  # noqa: E402
from fermat_tpu_torch.ops import sub_trace as st  # noqa: E402
from fermat_tpu_torch.ops import trace as dense  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402
from test_torch_frontier import (_assert_closest_close, _camera_rays, _jv, _masks,  # noqa: E402
                                 _rays, _tv)

N_RAYS = 512
BLOCK = 128


def tri4_of(subs) -> np.ndarray:
    """The JAX package's four-phase tile (cluster.py:146-154) from the
    port's rows: tile [s*4 + p] holds subcluster s at lanes [32p, 32p + 32),
    rows p0 e1 e2 id and six zero rows; -1 ids off-phase."""
    rows = subs.rows.numpy()  # (Ns, 32, 12)
    ns = rows.shape[0]
    tri4 = np.zeros((ns, 4, 16, 128), np.float32)
    tri4[:, :, 9, :] = -1.0
    for p in range(4):
        tri4[:, p, :10, 32 * p: 32 * p + 32] = rows[:, :, :10].transpose(0, 2, 1)
    return tri4.reshape(ns * 4, 16, 128)


class _Soup:
    def __init__(self, n_tris, seed):
        self.jsv = jax_build_subclusters(jproc.random_soup(n_tris, seed=seed).device_view())
        self.subs = build_subclusters(tproc.random_soup(n_tris, seed=seed).device_view("cpu"))


@pytest.fixture(scope="module")
def soup1500():
    return _Soup(1500, 5)


@pytest.fixture(scope="module")
def soup1000():
    return _Soup(1000, 9)


@pytest.mark.parametrize("scene", ["big_room400", "soup1500"])
def test_build_subclusters_bit_equal_to_jax(scene):
    if scene == "big_room400":
        jm, tm = jproc.big_room(400), tproc.big_room(400)
    else:
        jm, tm = jproc.random_soup(1500, seed=5), tproc.random_soup(1500, seed=5)
    jsv = jax_build_subclusters(jm.device_view())
    subs = build_subclusters(tm.device_view("cpu"))
    assert np.array_equal(np.asarray(jsv.tri4), tri4_of(subs))
    for f in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z"):
        assert np.array_equal(np.asarray(getattr(jsv, f)), getattr(subs, f).numpy()), f
    # the kernel's extras: real counts (a prefix of each leaf's slots), and
    # every triangle in exactly one slot
    ids = subs.rows[:, :, 9]
    assert torch.equal(subs.count, (ids >= 0).sum(1).to(torch.int32))
    assert bool((torch.arange(SUB)[None, :] < subs.count[:, None]).eq(ids >= 0).all())
    assert sorted(ids[ids >= 0].long().tolist()) == list(range(tm.n_triangles))
    assert subs.n_subclusters == jsv.n_subclusters


@pytest.fixture(scope="module")
def room():
    view = SceneView.build(tproc.big_room(400), tproc.big_room_camera(), "cpu")
    return view, build_subclusters(view.mesh), view.mesh.tri_soup()


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_plain_versions_equal_the_dense_brute_force_and_k5(room, rays):
    view, subs, tris = room
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
        h = st.trace_closest_sub(subs, o, d, t0, t1, act)
        ref = dense.trace_closest(tris, o, d, t0, t1, act)
        assert torch.equal(h.tri, ref.tri) and torch.equal(h.t, ref.t)
        k5 = ft.trace_closest_frontier(view.clusters, o, d, t0, t1, act)
        assert torch.equal(h.tri, k5.tri) and torch.equal(h.u, k5.u) and torch.equal(h.v, k5.v)
        assert 0.2 < float((h.tri >= 0).float().mean())
        occ = st.trace_any_sub(subs, o, d, t0, t1, act)
        assert torch.equal(occ, dense.trace_any(tris, o, d, t0, t1, act))
        assert torch.equal(occ, ft.trace_any_frontier(view.clusters, o, d, t0, t1, act))


def test_closest_matches_jax_sub(soup1500):
    o, d = _rays(1)
    act, tmax_v = _masks(11)
    for active, tmax in ((None, np.full(N_RAYS, 3e38, np.float32)), (act, tmax_v)):
        jh = jax_closest(soup1500.jsv, _jv(o), _jv(d), jnp.float32(1e-4), jnp.asarray(tmax),
                         None if active is None else jnp.asarray(active), block=BLOCK)
        h = st.trace_closest_sub(soup1500.subs, _tv(o), _tv(d), 1e-4, torch.from_numpy(tmax),
                                 None if active is None else torch.from_numpy(active))
        _assert_closest_close(h.t.numpy(), h.tri.numpy(), jh.t, jh.tri, active)
        m = h.tri.numpy() >= 0
        assert m.mean() > 0.1
        same = m & (h.tri.numpy() == np.asarray(jh.tri))
        np.testing.assert_allclose(h.u.numpy()[same], np.asarray(jh.u)[same], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(h.v.numpy()[same], np.asarray(jh.v)[same], rtol=1e-5,
                                   atol=1e-5)


def test_any_matches_jax_sub(soup1000):
    o, d = _rays(2)
    act, tmax_v = _masks(31)
    for active, tmax in ((None, np.full(N_RAYS, 8.0, np.float32)), (act, tmax_v)):
        j_occ = np.asarray(jax_any(soup1000.jsv, _jv(o), _jv(d), jnp.float32(1e-4),
                                   jnp.asarray(tmax),
                                   None if active is None else jnp.asarray(active),
                                   block=BLOCK))
        occ = st.trace_any_sub(soup1000.subs, _tv(o), _tv(d), 1e-4, torch.from_numpy(tmax),
                               None if active is None else torch.from_numpy(active))
        np.testing.assert_array_equal(occ.numpy(), j_occ)
        assert 0.0 < j_occ.mean() < 1.0


def test_tmax_inf_and_the_active_mask(soup1500):
    """With tmax = inf the port misses where nothing is hit (the Pallas
    kernel's all-miss value 3e38 beats t_best = inf there, as in the
    frontier kernel): its tmax = inf answer equals its tmax = 3e38 answer,
    misses included. Inactive lanes miss with t = tmax and are not
    occluded."""
    o, d = _rays(4, n=256)
    h_inf = st.trace_closest_sub(soup1500.subs, _tv(o), _tv(d), 1e-4, float("inf"))
    h_big = st.trace_closest_sub(soup1500.subs, _tv(o), _tv(d), 1e-4, 3e38)
    assert torch.equal(h_inf.tri, h_big.tri)
    m = h_big.tri >= 0
    assert 0.0 < float(m.float().mean()) < 1.0
    assert torch.equal(h_inf.t[m], h_big.t[m]) and bool(torch.isinf(h_inf.t[~m]).all())
    act, tmax = _masks(7, n=256)
    act_t, tmax_t = torch.from_numpy(act), torch.from_numpy(tmax)
    h = st.trace_closest_sub(soup1500.subs, _tv(o), _tv(d), 1e-4, tmax_t, act_t)
    assert bool((h.tri[~act_t] == -1).all()) and torch.equal(h.t[~act_t], tmax_t[~act_t])
    assert bool((h.u[~act_t] == 0.0).all()) and bool((h.v[~act_t] == 0.0).all())
    occ = st.trace_any_sub(soup1500.subs, _tv(o), _tv(d), 1e-4, tmax_t, act_t)
    assert not bool(occ[~act_t].any()) and bool(occ[act_t].any())
