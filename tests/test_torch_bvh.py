"""The skip-link BVH walk of fermat_tpu_torch (accel/bvh.py, accel/traverse.py,
ops/bvh_trace.py) against fermat_tpu's trace_closest / trace_any, and the PT
pass routed through it (tracer="bvh").

The walk's plain lockstep version serves the CPU and is the kernel's plain
twin on the card (tests/test_torch_cuda.py holds csrc/bvh.cu to it there).
Here it is held to JAX's walk over the same trees, JAX's own (from_numpy of
its leaves) and the port's, which is JAX's array for array: the Python
builder below 4096 triangles and the native builder of native/ above
(random_soup(5000)), as JAX routes them, on
512 rays a scene with a quarter of the lanes inactive: the first-hit
triangle and the occlusion flag equal, t, u, v within 1e-5 (XLA:CPU
contracts a*b+c into FMAs). Only tie-free rays are compared: rays whose
nearest hit is not within 1e-5 relative of a second triangle's (the
CornellBox's quads share their diagonals), whose hit is not within 1e-4 of
the occlusion query's tmax, and that do not graze an edge (u, v and 1 - u - v
above 1e-4). The pass is held to the stored frontier golden of
tests/test_torch_bigroom.py (big_room(400), 24x24), at its tolerances.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu.accel.bvh import build_bvh_for_mesh as jbuild  # noqa: E402
from fermat_tpu.accel.traverse import trace_any as jany  # noqa: E402
from fermat_tpu.accel.traverse import trace_closest as jclosest  # noqa: E402
from fermat_tpu.core.math import Vec3 as JV  # noqa: E402
from fermat_tpu.scene import procedural as jproc  # noqa: E402
from fermat_tpu_torch.accel.bvh import BvhView, build_bvh_for_mesh  # noqa: E402
from fermat_tpu_torch.accel.traverse import walk_any, walk_closest  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.ops import bvh_trace  # noqa: E402
from fermat_tpu_torch.ops.trace import mt_test  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.materials import FLAG_SHADOW_DIRECT_IGNORE  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

N_RAYS, TMIN = 512, 1e-4
BIGROOM = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
CHANNELS = ("composited", "direct", "diffuse", "specular")
SCENES = {
    # name: (port storage, JAX storage, ray origins' box (lo, hi))
    "soup5000": (lambda: tproc.random_soup(5000), lambda: jproc.random_soup(5000),
                 (-6.0, 6.0)),
    "cornell": (lambda: tproc.cornell_box(glossy_boxes=True),
                lambda: jproc.cornell_box(glossy_boxes=True), (-0.95, 0.95)),
}


def _jax_bvh_view(jb) -> BvhView:
    """The port's BvhView of a JAX BvhView's arrays."""
    a = lambda x: np.asarray(x)
    return BvhView.from_arrays(np.stack([a(jb.lo_x), a(jb.lo_y), a(jb.lo_z)], 1),
                               np.stack([a(jb.hi_x), a(jb.hi_y), a(jb.hi_z)], 1), a(jb.skip),
                               a(jb.prim_start), a(jb.is_leaf), a(jb.prims), a(jb.child),
                               jb.leaf_size, "cpu")


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    make_t, make_j, (lo, hi) = SCENES[request.param]
    tmesh = make_t().device_view(torch.device("cpu"))
    jmesh = make_j().device_view()
    r = np.random.default_rng(17)
    o = r.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    if request.param == "cornell":
        o[:, 1] += 1.0  # the box spans y in [0, 2]
    d = r.standard_normal((N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = r.random(N_RAYS) < 0.75
    tmax = r.uniform(0.05, 3.0, N_RAYS).astype(np.float32)
    return dict(name=request.param, tmesh=tmesh, jmesh=jmesh, jbvh=jbuild(jmesh), o=o, d=d,
                active=active, tmax=tmax)


def _tie_free(s) -> np.ndarray:
    """Rays whose nearest hit is unambiguous (see the module docstring)."""
    tris = s["tmesh"].tri_soup()
    o = [torch.from_numpy(s["o"][:, k])[:, None] for k in range(3)]
    d = [torch.from_numpy(s["d"][:, k])[:, None] for k in range(3)]
    tt, uu, vv, inside = mt_test([r[None, :] for r in tris], o, d)
    tt = torch.where(inside & (tt > TMIN), tt, float("inf")).numpy()
    best = np.sort(tt, axis=1)[:, :2]
    k = np.argmin(tt, axis=1)
    rows = np.arange(N_RAYS)
    u, v = uu.numpy()[rows, k], vv.numpy()[rows, k]
    clear = ~np.isfinite(best[:, 0]) | (best[:, 1] > best[:, 0] * (1 + 1e-5) + 1e-7)
    inner = ~np.isfinite(best[:, 0]) | ((u > 1e-4) & (v > 1e-4) & (1 - u - v > 1e-4))
    off_tmax = np.abs(best[:, 0] - s["tmax"]) > 1e-4 * s["tmax"]
    return clear & inner & off_tmax


def _jax_answers(s):
    jv = lambda a: JV(*(jnp.asarray(a[:, k]) for k in range(3)))
    h = jclosest(s["jbvh"], s["jmesh"], jv(s["o"]), jv(s["d"]), jnp.float32(TMIN),
                 jnp.float32(3e38), jnp.asarray(s["active"]))
    occ = jany(s["jbvh"], s["jmesh"], jv(s["o"]), jv(s["d"]), jnp.float32(TMIN),
               jnp.asarray(s["tmax"]), jnp.asarray(s["active"]))
    return [np.asarray(x) for x in h], np.asarray(occ)


@pytest.mark.parametrize("tree", ["jax", "port"])
def test_walk_matches_jax(scene, tree):
    bvh = _jax_bvh_view(scene["jbvh"]) if tree == "jax" else build_bvh_for_mesh(scene["tmesh"])
    tv = lambda a: Vec3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))
    n = N_RAYS
    act = torch.from_numpy(scene["active"])
    hit = walk_closest(bvh, scene["tmesh"].tri_soup(), tv(scene["o"]), tv(scene["d"]),
                       torch.full((n,), TMIN), torch.full((n,), 3e38), act)
    occ = walk_any(bvh, scene["tmesh"].tri_soup(), tv(scene["o"]), tv(scene["d"]),
                   torch.full((n,), TMIN), torch.from_numpy(scene["tmax"]), act)
    (t, tri, u, v), jocc = _jax_answers(scene)
    keep = _tie_free(scene)
    assert keep.mean() > 0.9, keep.mean()
    assert (tri[keep & scene["active"]] >= 0).mean() > 0.3  # the rays do hit
    assert np.array_equal(hit.tri.numpy()[keep], tri[keep])
    assert np.array_equal(occ.numpy()[keep], jocc[keep])
    for got, want in ((hit.t, t), (hit.u, u), (hit.v, v)):
        np.testing.assert_allclose(got.numpy()[keep], want[keep], rtol=1e-5, atol=1e-5)
    # inactive lanes miss and keep the caller's tmax
    off = ~scene["active"]
    assert (hit.tri.numpy()[off] == -1).all() and not occ.numpy()[off].any()
    assert (hit.t.numpy()[off] == np.float32(3e38)).all()


def test_port_tree_equals_jax_python_build():
    """Below 4096 triangles JAX builds with the same Python builder: the
    trees are equal, array for array."""
    jb = jbuild(jproc.cornell_box(glossy_boxes=True).device_view())
    tb = build_bvh_for_mesh(tproc.cornell_box(glossy_boxes=True).device_view(
        torch.device("cpu")))
    want = _jax_bvh_view(jb)
    for f in BvhView._fields:
        a, b = getattr(tb, f), getattr(want, f)
        if f == "nodes":  # int bits in float lanes: -1 reads as a NaN
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert (a == b) if f == "leaf_size" else torch.equal(a, b), f


def test_bvh_view_records():
    """BvhView.nodes packs (lo, skip) and (hi, child or -1 - prim_start)
    with the ints as float bits; a leaf past the prims array raises."""
    b = build_bvh_for_mesh(tproc.cornell_box().device_view(torch.device("cpu")))
    bits = b.nodes.view(torch.int32)
    assert torch.equal(bits[:, 3], b.skip)
    assert torch.equal(bits[:, 7], torch.where(b.is_leaf, -1 - b.prim_start, b.child))
    assert torch.equal(b.nodes[:, 0], b.lo_x) and torch.equal(b.nodes[:, 6], b.hi_z)
    assert torch.equal(b.child, torch.arange(1, b.n_nodes + 1, dtype=torch.int32))
    lo = torch.stack([b.lo_x, b.lo_y, b.lo_z], 1).numpy()
    hi = torch.stack([b.hi_x, b.hi_y, b.hi_z], 1).numpy()
    with pytest.raises(ValueError, match="prims"):
        BvhView.from_arrays(lo, hi, b.skip.numpy(), b.prim_start.numpy(), b.is_leaf.numpy(),
                            b.prims.numpy()[:-4], b.child.numpy(), 4, "cpu")


def test_wrappers_run_the_plain_walk_on_the_cpu():
    """On CPU tensors the wrappers are the plain walk (no launch), with
    Python-number tmin/tmax and a missing mask as every lane; the walk's
    counts: no visit on an inactive lane, at most leaf_size tests a visit."""
    mesh = tproc.cornell_box(glossy_boxes=True).device_view(torch.device("cpu"))
    bvh = build_bvh_for_mesh(mesh)
    tris = mesh.tri_soup()
    r = np.random.default_rng(4)
    n = N_RAYS
    o = Vec3(*(torch.from_numpy(r.uniform(-0.9, 0.9, n).astype(np.float32)) + (k == 1)
               for k in range(3)))
    d = Vec3(*torch.from_numpy(r.standard_normal((3, n)).astype(np.float32)))
    act = torch.from_numpy(r.random(n) < 0.75)
    before = (bvh_trace.CLOSEST.launches, bvh_trace.ANY.launches)
    got = bvh_trace.trace_closest_bvh(bvh, tris, o, d, TMIN, 3e38, act)
    want, visits, tests = walk_closest(bvh, tris, o, d, torch.full((n,), TMIN),
                                       torch.full((n,), 3e38), act, stats=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    occ = bvh_trace.trace_any_bvh(bvh, tris, o, d, TMIN, 2.0)
    occ_w, v_any, _ = walk_any(bvh, tris, o, d, torch.full((n,), TMIN), torch.full((n,), 2.0),
                               torch.ones(n, dtype=torch.bool), stats=True)
    assert torch.equal(occ, occ_w)
    assert (bvh_trace.CLOSEST.launches, bvh_trace.ANY.launches) == before
    assert (visits[~act] == 0).all() and (visits[act] >= 1).all()
    assert (tests <= visits * bvh.leaf_size).all() and int(tests.sum()) > 0
    assert int(v_any.sum()) > 0


def test_port_tree_equals_jax_native_build():
    """From 4096 triangles both packages build with the native C++ builder of
    native/fermat_native.cpp (the port from its own build of the source): the
    trees are equal, array for array; use_native=False keeps the Python
    builder, whose tree differs."""
    jb = jbuild(jproc.random_soup(5000, seed=1).device_view())
    mesh = tproc.random_soup(5000, seed=1).device_view(torch.device("cpu"))
    tb = build_bvh_for_mesh(mesh)
    want = _jax_bvh_view(jb)
    for f in BvhView._fields:
        a, b = getattr(tb, f), getattr(want, f)
        if f == "nodes":
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert (a == b) if f == "leaf_size" else torch.equal(a, b), f
    py = build_bvh_for_mesh(mesh, use_native=False)
    assert py.n_nodes != tb.n_nodes or not torch.equal(py.prims, tb.prims)


def test_from_numpy_takes_the_jax_bvh_leaves():
    """from_numpy takes JAX's bvh[<flat index i>] leaves (here the native
    builder's tree of big_room(400)) when they are there, and builds none
    when they are not."""
    g = np.load(BIGROOM)
    arrays = {k[5:]: g[k] for k in g.files if k.startswith("view.")}
    bare = {k: v for k, v in arrays.items() if not k.startswith("bvh[")}
    assert SceneView.from_numpy(bare, "cpu").bvh is None
    bvh = SceneView.from_numpy(arrays, "cpu").bvh
    assert bvh.leaf_size == 4 and bvh.n_nodes == arrays["bvh[<flat index 6>]"].shape[0]
    assert np.array_equal(bvh.prims.numpy(), arrays["bvh[<flat index 9>]"])
    assert np.array_equal(bvh.lo_x.numpy(), arrays["bvh[<flat index 0>]"])


def test_bvh_pass_matches_the_frontier_golden():
    """tracer="bvh" on big_room(400) over JAX's (native) tree against the
    stored frontier pass: the same closest hits, so the golden's tolerances
    (tests/test_torch_bigroom.py)."""
    g = np.load(BIGROOM)
    view = SceneView.from_numpy({k[5:]: g[k] for k in g.files if k.startswith("view.")}, "cpu")
    res = int(g["res"])
    opts = tpt.PTOptions(max_path_length=int(g["max_path_length"]), tracer="bvh",
                         lobes=tuple(bool(x) for x in g["lobes"]))
    out = tpt.render_pass(view, opts, res, res, int(g["instance"]), int(g["seed"]))
    assert abs(float(out.rays) - float(g["rays"])) <= 0.005 * float(g["rays"])
    assert (out.tri.numpy() == g["tri"].ravel()).mean() >= 0.99
    for c in CHANNELS:
        got, want = getattr(out, c).stack().numpy(), g[c].reshape(-1, 3)
        near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
        assert near.mean() >= 0.99, (c, near.mean())
        np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


def test_shadow_sets_walk_their_own_bvh():
    """With tracer="bvh" a shadow set is walked over its own BVH (built by
    with_bvh() beside the view's); the pass equals the dense one."""
    storage = tproc.cornell_box(glossy_boxes=True)
    for m in storage.materials:
        if m.name.startswith("box"):
            m.flags |= FLAG_SHADOW_DIRECT_IGNORE
    view = SceneView.build(storage, tproc.cornell_camera(), "cpu").with_bvh()
    ss = view.shadow_sets[0]
    assert view.shadow_sets[1] is None and ss.bvh is not None
    assert ss.mesh.n_triangles < view.mesh.n_triangles
    opts = tpt.PTOptions(max_path_length=2)
    seen = []
    anyhit = tpt.trace_any_bvh
    tpt.trace_any_bvh = lambda bvh, *a: seen.append(bvh) or anyhit(bvh, *a)
    try:
        out = tpt.render_pass(view, opts._replace(tracer="bvh"), 8, 8, 0)
    finally:
        tpt.trace_any_bvh = anyhit
    assert seen[0] is ss.bvh and seen[1] is view.bvh
    ref = tpt.render_pass(view, opts, 8, 8, 0)
    assert torch.equal(out.tri, ref.tri) and float(out.rays) == float(ref.rays)
    np.testing.assert_allclose(out.composited.stack().numpy(), ref.composited.stack().numpy(),
                               rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="shadow set"):
        bare = view._replace(shadow_sets=(ss._replace(bvh=None), None))
        tpt.render_pass(bare, opts._replace(tracer="bvh"), 4, 4, 0)
