"""The cluster tracer (K6) and the binned tracer (K7) against the JAX
package, on the CPU:

  * core/morton.morton3d bit-equal to fermat_tpu's on finite inputs, and
    the cluster tracer's co-sort `_sort_perm` equal to JAX's permutation
    on ties-free keys;
  * the plain versions of K6a/K6b/K7a/K7b (the function they share with
    K5, ops/frontier_trace.py, plus the winner's MT u, v) against
    fermat_tpu's trace_closest_cluster / trace_any_cluster /
    trace_closest_binned / trace_any_binned live in Pallas interpret mode,
    at the sizes of tests/test_cluster_trace.py and test_binned_trace.py
    (512 rays, random_soup(1500) and random_soup(1000)), with the active
    mask and per-ray tmax, and JAX's K7 also at u_steps=1, block=64. Hit masks
    equal, t within rtol/atol 1e-5 (XLA:CPU contracts a*b+c into FMA), the
    same triangle on >= 99% of hits (among equal t the JAX kernels keep the
    first triangle they visit, the port the smallest id), u and v within
    1e-5 where the triangle agrees, occlusion flags equal;
  * JAX K6's phantom hit at tmax = inf, pinned (the port misses); JAX K7
    shows none;
  * the binned round loop (`_rounds`) with the plain versions of its scan,
    counting sort and test kernels equals the function bit for bit, with
    small queues, work items and batches, and with the rays shuffled within
    each bin; a loop that never advances raises at the liveness cap;
  * the build key of each csrc/ library follows the shared header it
    includes (csrc/cluster_common.cuh);
  * the port's PT pass on big_room(400), 24x24, 4 bounces, with
    tracer="cluster" and tracer="binned", against the stored golden
    tests/golden/torch_port_bigroom_cluster_24.npz (JAX render_pass with
    each tracer: channels, first-hit triangle, `rays`; the scene view is
    torch_port_bigroom_24.npz's), within the tolerances of
    tests/test_torch_bigroom.py. Written by `JAX_PLATFORMS=cpu python
    tests/test_torch_cluster.py`;
  * the cluster table at every size, as in JAX: SceneView.build of the
    CornellBox carries JAX's table, and its pass with tracer="binned"
    matches the dense pass (tests/test_binned_trace.py:90-108).
"""
import os
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu.accel.cluster import build_clusters as jax_build_clusters  # noqa: E402
from fermat_tpu.core.math import Vec3 as JVec3  # noqa: E402
from fermat_tpu.core.morton import morton3d as jax_morton3d  # noqa: E402
from fermat_tpu.ops import pallas_binned_trace as jbt  # noqa: E402
from fermat_tpu.ops import pallas_cluster_trace as jct  # noqa: E402
from fermat_tpu.scene import procedural as jproc  # noqa: E402
from fermat_tpu_torch.accel.cluster import build_clusters  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.core.morton import morton3d  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.ops import _cuda as cuda_build  # noqa: E402
from fermat_tpu_torch.ops import binned_trace as bt  # noqa: E402
from fermat_tpu_torch.ops import cluster_trace as ct  # noqa: E402
from fermat_tpu_torch.ops import frontier_trace as ft  # noqa: E402
from fermat_tpu_torch.ops.trace import _lanes  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_cluster_24.npz")
VIEW_GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
TRACERS = ("cluster", "binned")
CHANNELS = ("composited", "direct", "diffuse", "specular")
N_RAYS = 512


def _rays(seed, n=N_RAYS, spread=12.0):
    """Random rays made with numpy, normalised in float32 (both sides get the
    same floats)."""
    r = np.random.default_rng(seed)
    o = (r.random((n, 3)).astype(np.float32) - 0.5) * spread
    d = r.standard_normal((n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _masks(seed, n=N_RAYS):
    r = np.random.default_rng(seed)
    return r.random(n) < 0.5, (2.0 + 6.0 * r.random(n)).astype(np.float32)


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _jv(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _soup(n_tris, seed):
    jcl = jax_build_clusters(jproc.random_soup(n_tris, seed=seed).device_view())
    return jcl, build_clusters(tproc.random_soup(n_tris, seed=seed).device_view("cpu"))


@pytest.fixture(scope="module")
def soup1500():
    return _soup(1500, 5)


@pytest.fixture(scope="module")
def soup1000():
    return _soup(1000, 9)


def test_morton3d_bit_equal_to_jax():
    r = np.random.default_rng(3)
    xyz = (r.random((3, 4096)) * 1.4 - 0.2).astype(np.float32)  # clipped at both ends
    xyz[:, :8] = np.float32([0.0, 1.0, 0.5, 1023.0 / 1024.0, -0.0, 2.0, 1e-7, 0.999])[None, :]
    want = np.asarray(jax_morton3d(*(jnp.asarray(a) for a in xyz))).astype(np.int64)
    got = morton3d(*(torch.from_numpy(a) for a in xyz)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == 2 ** 30 - 1 and len(np.unique(got)) > 3000


def test_sort_perm_equals_jax_on_ties_free_keys(soup1500):
    jcl, cl = soup1500
    o, d = _rays(4, n=2048)
    # the sort key (morton cell << 3 | octant), to keep one ray per key: the
    # stable argsorts of both packages then have one answer
    lo = np.float32([cl.lo_x.min(), cl.lo_y.min(), cl.lo_z.min()])
    hi = np.float32([cl.hi_x.max(), cl.hi_y.max(), cl.hi_z.max()])
    q = torch.from_numpy(((o - lo) * (np.float32(1.0) / (hi - lo))).astype(np.float32))
    key = (morton3d(q[:, 0], q[:, 1], q[:, 2]).numpy() >> 15 << 3) | (
        (d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2 + (d[:, 2] < 0))
    _, first = np.unique(key, return_index=True)
    o, d = o[np.sort(first)], d[np.sort(first)]
    got = ct._sort_perm(cl, _tv(o), _tv(d)).numpy()
    want = np.asarray(jct._sort_perm(jcl, _jv(o), _jv(d)))
    np.testing.assert_array_equal(got, want)
    assert len(o) > 1000 and not np.array_equal(got, np.arange(len(o)))


def _assert_closest_close(h, jh, active):
    hit_p, hit_j = h.tri.numpy() >= 0, np.asarray(jh.tri) >= 0
    if active is not None:
        hit_p, hit_j = hit_p & active, hit_j & active
        assert (h.tri.numpy()[~active] == -1).all()
    np.testing.assert_array_equal(hit_p, hit_j)
    m = hit_j
    np.testing.assert_allclose(h.t.numpy()[m], np.asarray(jh.t)[m], rtol=1e-5, atol=1e-5)
    same = h.tri.numpy()[m] == np.asarray(jh.tri)[m]
    assert same.mean() >= 0.99 and m.mean() > 0.1
    for a, b in ((h.u, jh.u), (h.v, jh.v)):  # the kernel's own u, v
        np.testing.assert_allclose(a.numpy()[m][same], np.asarray(b)[m][same], rtol=1e-5,
                                   atol=1e-5)


_JAX = {"cluster": (jct.trace_closest_cluster, jct.trace_any_cluster),
        "binned": (jbt.trace_closest_binned, jbt.trace_any_binned)}
_PORT = {"cluster": (ct.trace_closest_cluster, ct.trace_any_cluster),
         "binned": (bt.trace_closest_binned, bt.trace_any_binned)}
# options of the JAX wrappers; the port's have none (its CPU side runs the
# plain versions, which no block size or round budget changes)
_CASES = [("cluster", dict(block=256)), ("binned", dict(block=256)),
          ("binned", dict(block=64, u_steps=1))]


@pytest.mark.parametrize("tracer,kw", _CASES)
def test_closest_matches_jax(soup1500, tracer, kw):
    jcl, cl = soup1500
    o, d = _rays(1)
    act, tmax_v = _masks(11)
    # full range, then the active mask with per-ray tmax (one compiled program)
    for active, tmax in ((None, np.full(N_RAYS, 3e38, np.float32)), (act, tmax_v)):
        jh = _JAX[tracer][0](jcl, _jv(o), _jv(d), jnp.float32(1e-4), jnp.asarray(tmax),
                             None if active is None else jnp.asarray(active), **kw)
        h = _PORT[tracer][0](cl, _tv(o), _tv(d), 1e-4, torch.from_numpy(tmax),
                             None if active is None else torch.from_numpy(active))
        _assert_closest_close(h, jh, active)
        if active is not None:  # inactive lanes miss with t = tmax
            np.testing.assert_array_equal(h.t.numpy()[~active], tmax[~active])


@pytest.mark.parametrize("tracer,kw", _CASES)
def test_any_matches_jax(soup1000, tracer, kw):
    jcl, cl = soup1000
    o, d = _rays(2)
    act, tmax_v = _masks(31)
    for active, tmax in ((None, np.full(N_RAYS, 8.0, np.float32)), (act, tmax_v)):
        j_occ = np.asarray(_JAX[tracer][1](jcl, _jv(o), _jv(d), jnp.float32(1e-4),
                                           jnp.asarray(tmax),
                                           None if active is None else jnp.asarray(active),
                                           **kw))
        occ = _PORT[tracer][1](cl, _tv(o), _tv(d), 1e-4, torch.from_numpy(tmax),
                               None if active is None else torch.from_numpy(active))
        np.testing.assert_array_equal(occ.numpy(), j_occ)
        assert 0.0 < j_occ.mean() < 1.0


@pytest.mark.parametrize("tracer", TRACERS)
def test_tmax_inf(soup1500, tracer):
    """With tmax = inf JAX K6 starts t_best at inf (:254), so the first
    cluster a block visits turns an all-miss ray into a hit on its slot 0 at
    t = 3e38 (:226-241); JAX K7's round starts at id -1 (:251), so its
    misses stay misses. The port misses in both, and its tmax = inf answer
    equals its tmax = 3e38 answer."""
    jcl, cl = soup1500
    o, d = _rays(1, n=256)
    jh = _JAX[tracer][0](jcl, _jv(o), _jv(d), jnp.float32(1e-4),
                         jnp.asarray(np.full(256, np.inf, np.float32)), None, block=128)
    h_inf = _PORT[tracer][0](cl, _tv(o), _tv(d), 1e-4, float("inf"))
    h_big = _PORT[tracer][0](cl, _tv(o), _tv(d), 1e-4, 3e38)
    assert torch.equal(h_inf.tri, h_big.tri)
    m = h_big.tri >= 0
    assert torch.equal(h_inf.t[m], h_big.t[m]) and bool(torch.isinf(h_inf.t[~m]).all())
    phantom = (np.asarray(jh.tri) >= 0) & ~m.numpy()
    if tracer == "cluster":
        assert phantom.sum() > 10
        np.testing.assert_array_equal(np.asarray(jh.t)[phantom], np.float32(3e38))
    else:
        assert not phantom.any()
        np.testing.assert_array_equal(np.asarray(jh.tri) >= 0, m.numpy())


def _shuffled_bins(seed):
    """A counting-sort order that shuffles the rays within each bin."""
    gen = torch.Generator().manual_seed(seed)

    def order(cids):
        jitter = torch.randperm(cids.shape[0], generator=gen)
        return torch.argsort(cids.long() * cids.shape[0] + jitter)
    return order


def _loop_rays(tmax, n=N_RAYS):
    o, d = _rays(6, n=n)
    act, tmax_v = _masks(12)
    active = (torch.from_numpy(act) if tmax == "per-ray"
              else torch.ones(n, dtype=torch.bool))
    t1 = {"3e38": _lanes(3e38, n, "cpu"), "per-ray": torch.from_numpy(tmax_v),
          "inf": _lanes(float("inf"), n, "cpu")}[tmax]
    return bt._Rays(_tv(o), _tv(d), _lanes(1e-4, n, "cpu"), t1), active


@pytest.mark.parametrize("block,queue", [(64, 1), (256, 8)])
@pytest.mark.parametrize("tmax", ["3e38", "per-ray", "inf"])
def test_binned_rounds_equal_the_function(soup1500, block, queue, tmax, monkeypatch):
    """The round loop over the plain versions of its scan, counting sort and
    test (one visit of each live ray a round, a queue of QUEUE keys a scan,
    ROUND_BATCH rounds between readbacks) gives the function's answer bit
    for bit; a queue of 1 and batches of 2 force rescans and many batches."""
    batch = 2 if queue == 1 else 16
    monkeypatch.setattr(bt, "BLOCK", block)
    monkeypatch.setattr(bt, "QUEUE", queue)
    monkeypatch.setattr(bt, "ROUND_BATCH", batch)
    _, cl = soup1500
    rays, active = _loop_rays(tmax)
    o, d, t0, t1 = rays
    bt.LOOP.reset()
    lp, rounds = bt._rounds(cl, rays, active, True, bt._plain_run(cl, rays, active, True))
    h, ref = bt._hit(lp), ft._closest_uv_plain(cl, o, d, t0, t1, active)
    for a, b in zip(h, ref):
        assert torch.equal(a, b)
    assert bt.LOOP.readbacks == rounds // batch + 1 and bt.LOOP.rounds == rounds
    lp, _ = bt._rounds(cl, rays, active, False, bt._plain_run(cl, rays, active, False))
    assert torch.equal(lp.occ, ft._any_plain(cl, o, d, t0, t1, active))
    assert rounds > 1 and bool((ref.tri >= 0).any())
    # a queue of 1 scans the boxes once a visit or more, a queue of 8 less
    # often than it visits (about once a traced ray here)
    assert (bt.LOOP.scans >= bt.LOOP.pairs) if queue == 1 else (bt.LOOP.scans < bt.LOOP.pairs)


def test_binned_rounds_ignore_the_order_within_a_bin(soup1500, monkeypatch):
    """Rays shuffled within each bin of every round's counting sort give
    the same bits."""
    monkeypatch.setattr(bt, "BLOCK", 32)
    monkeypatch.setattr(bt, "QUEUE", 4)
    _, cl = soup1500
    rays, active = _loop_rays("per-ray")
    for closest in (True, False):
        lp, _ = bt._rounds(cl, rays, active, closest, bt._plain_run(cl, rays, active, closest))
        lq, _ = bt._rounds(cl, rays, active, closest,
                           bt._plain_run(cl, rays, active, closest, order=_shuffled_bins(3)))
        for a, b in ((lp.t_best, lq.t_best), (lp.id_best, lq.id_best), (lp.u, lq.u),
                     (lp.v, lq.v)) if closest else ((lp.occ, lq.occ),):
            assert torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                               b.view(torch.int32) if b.is_floating_point() else b)


@pytest.mark.parametrize("closest", [True, False])
def test_binned_steps_compare_as_the_kernels_promise(soup1500, closest, monkeypatch):
    """`_state_diff`, which holds each kernel step to its plain version on
    the card, finds nothing between two step-by-step runs whose counting
    sorts order each bin differently, and finds a changed field."""
    monkeypatch.setattr(bt, "BLOCK", 32)
    monkeypatch.setattr(bt, "QUEUE", 4)
    _, cl = soup1500
    rays, active = _loop_rays("per-ray")
    run_a = bt._plain_run(cl, rays, active, closest)
    run_b = bt._plain_run(cl, rays, active, closest, order=_shuffled_bins(5))
    a = bt._new_loop(N_RAYS, cl.rows.shape[0], closest, "cpu")
    for t in a:
        t.zero_()
    b = bt._Loop(*(t.clone() for t in a))
    for r in range(4):
        for step in (bt.STEP_SCAN, bt.STEP_BIN, bt.STEP_TEST):
            first = r == 0 and step == bt.STEP_SCAN
            run_a(a, 1, first, step)
            run_b(b, 1, first, step)
            assert bt._state_diff(a, b, closest) == [], (r, step)
    assert int(a.ctl[bt.CTL_LIVE]) > 0 and not torch.equal(a.lists, b.lists)
    lane = int(a.lists[0, 0])
    a.qhead[lane] += 1
    a.lists[2, 0] = -1
    assert bt._state_diff(a, b, closest) == ["qhead"] + (["rescan"] if int(a.ctl[2]) else [])


def test_binned_rounds_hold_the_liveness_cap(soup1500, monkeypatch):
    monkeypatch.setattr(bt, "BLOCK", 32)
    monkeypatch.setattr(bt, "QUEUE", 1)
    _, cl = soup1500
    o, d = _rays(6, n=64)
    t0, t1 = _lanes(1e-4, 64, "cpu"), _lanes(3e38, 64, "cpu")
    rays = bt._Rays(_tv(o), _tv(d), t0, t1)
    every = torch.ones(64, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="liveness cap"):
        bt._rounds(cl, rays, every, True,  # a test step that never advances a cursor
                   bt._plain_run(cl, rays, every, True, advance=False))


def test_binned_kernel_names_have_their_family():
    """Every kernel of csrc/binned.cu falls in a family of
    `binned_trace.kernel_family` (phase 6 and the K7 tool split the device
    time by it), and the module's constants are the source's: the scan's
    group of boxes under one union box and a queue depth the library is
    built for."""
    src = (Path(bt.__file__).parent / "csrc" / "binned.cu").read_text()
    names = set(re.findall(r"__global__ void (?:__launch_bounds__\(\w+\) )?(\w+)\(", src))
    assert len(names) == 4, names
    assert sorted(bt.kernel_family(n) for n in names) == ["bin", "bin", "scan", "test"]
    assert bt.kernel_family("void frontier_kernel<true>(Args)") == "other"
    assert f"constexpr int kGroup = {bt.SCAN_GROUP};" in src
    assert f"(k == 1 || k == {bt.QUEUE})" in src


@pytest.mark.parametrize("source,includes", [("frontier.cu", True), ("cluster.cu", True),
                                             ("binned.cu", True), ("trace.cu", False)])
def test_build_key_follows_the_shared_header(tmp_path, monkeypatch, source, includes):
    """K5, K6 and K7 keep one copy of their arithmetic in
    csrc/cluster_common.cuh: editing it must rebuild exactly its users."""
    for f in cuda_build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = cuda_build._lib_path(source)
    header = tmp_path / "cluster_common.cuh"
    header.write_bytes(header.read_bytes() + b"// edited\n")
    assert (cuda_build._lib_path(source) != before) == includes


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def gview():
    g = np.load(VIEW_GOLDEN)
    return SceneView.from_numpy({k[5:]: g[k] for k in g.files if k.startswith("view.")}, "cpu")


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("tracer", TRACERS)
def test_render_pass_matches_jax_golden(golden, gview, tracer):
    assert gview.mesh.n_triangles == 4836 and int(golden["n_boxes"]) == 400
    res = int(golden["res"])
    opts = tpt.PTOptions(max_path_length=int(golden["max_path_length"]),
                         lobes=tuple(bool(x) for x in golden["lobes"]), tracer=tracer)
    out = tpt.render_pass(gview, opts, res, res, int(golden["instance"]), int(golden["seed"]))
    want_rays = float(golden[f"{tracer}.rays"])
    assert abs(float(out.rays) - want_rays) <= 0.005 * want_rays
    for c in CHANNELS:
        assert_image_close(getattr(out, c).stack().numpy(), golden[f"{tracer}.{c}"].reshape(-1, 3))
    assert (out.tri.numpy() == golden[f"{tracer}.tri"].ravel()).mean() >= 0.99
    # the three cluster-table tracers trace one function
    ref = tpt.render_pass(gview, opts._replace(tracer="frontier"), res, res,
                          int(golden["instance"]), int(golden["seed"]))
    assert torch.equal(out.tri, ref.tri) and float(out.rays) == float(ref.rays)


@pytest.mark.parametrize("tracer", TRACERS)
def test_context_drives_both_drivers(tracer):
    """tracer= passes through RenderingContext to the monolithic pass and to
    NarrowPass (narrow=1), which accumulate the same image."""
    storage = tproc.big_room(400)
    make = lambda **kw: RenderingContext.create(storage, tproc.big_room_camera(), 12, 8,
                                                device="cpu", max_path_length=3,
                                                tracer=tracer, **kw)
    a, b = make(narrow=1), make()
    a.render(1)
    b.render_batch(1)
    assert isinstance(a._pass[3], tpt.NarrowPass) and a._pass[1].tracer == tracer
    np.testing.assert_allclose(a.fb.composited.numpy(), b.fb.composited.numpy(), atol=2e-5,
                               rtol=1e-5)
    assert float(a.gbuffer["rays"]) == float(b.gbuffer["rays"]) > 0


def test_cornell_view_carries_jax_cluster_table():
    from fermat_tpu.scene.view import SceneView as JView

    jv = JView.build(jproc.cornell_box(glossy_boxes=True), jproc.cornell_camera())
    tv = SceneView.build(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(), "cpu")
    assert tv.clusters is not None and tv.mesh.n_triangles == 36
    assert np.array_equal(np.asarray(jv.clusters.tri), tv.clusters.tri)
    for f in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z"):
        assert np.array_equal(np.asarray(getattr(jv.clusters, f)), getattr(tv.clusters, f).numpy())


def test_cornell_binned_pass_matches_dense():
    """tests/test_binned_trace.py:90-108 on the port: the CornellBox with
    tracer="binned" against the dense tracer, rtol 2e-4 / atol 2e-5."""
    view = SceneView.build(tproc.cornell_box(), tproc.cornell_camera(), "cpu")
    base = dict(max_path_length=3, rr=False)
    ref = tpt.render_pass(view, tpt.PTOptions(**base), 32, 32, 2)
    out = tpt.render_pass(view, tpt.PTOptions(tracer="binned", **base), 32, 32, 2)
    np.testing.assert_allclose(out.composited.stack().numpy(), ref.composited.stack().numpy(),
                               rtol=2e-4, atol=2e-5)
    assert float(out.rays) == float(ref.rays)


def write_golden() -> None:
    import jax

    from fermat_tpu.core.camera import Camera
    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.scene.procedural import big_room
    from fermat_tpu.scene.view import SceneView as JaxView

    vg = np.load(VIEW_GOLDEN)
    res, mpl, seed, n_boxes = (int(vg[k]) for k in ("res", "max_path_length", "seed", "n_boxes"))
    lobes = tuple(bool(x) for x in vg["lobes"])
    view = JaxView.build(big_room(n_boxes), Camera.create(eye=(0.0, 3.0, 10.0),
                                                          aim=(0.0, 1.5, 0.0)))
    leaves, _ = jax.tree_util.tree_flatten_with_path(view)
    for p, a in leaves:  # the stored view is this view
        k = "view." + jax.tree_util.keystr(p).lstrip(".")
        if k in vg.files:
            assert np.array_equal(np.asarray(a), vg[k]), k
    img = lambda v: np.stack([np.asarray(c) for c in v], -1).reshape(res, res, 3)
    out = {}
    for tracer in TRACERS:
        opts = PTOptions(max_path_length=mpl, lobes=lobes, tracer=tracer)
        o = jax.jit(lambda i: render_pass(view, opts, res, res, i, seed))(jnp.uint32(0))
        out.update({f"{tracer}.rays": float(o.rays),
                    f"{tracer}.tri": np.asarray(o.tri).reshape(res, res),
                    **{f"{tracer}.{c}": img(getattr(o, c)) for c in CHANNELS}})
        print(f"{tracer}: rays={float(o.rays)}")
    np.savez_compressed(
        GOLDEN, res=res, max_path_length=mpl, seed=seed, instance=0, n_boxes=n_boxes,
        lobes=np.asarray(lobes), scene=f"big_room(n_boxes={n_boxes})",
        camera="eye (0, 3, 10), aim (0, 1.5, 0)", view="torch_port_bigroom_24.npz", **out)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden()
