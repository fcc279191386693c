"""The PT pass's light model in fermat_tpu_torch against fermat_tpu: shadow
sets, analytic area lights, point and directional lights, and the lat-long
environment map with importance-sampled NEE and MIS.

The pieces are held to the JAX functions on numpy-seeded inputs. Whole passes
are held to a stored golden, tests/golden/torch_port_lights_24.npz, written
by `JAX_PLATFORMS=cpu python tests/test_torch_lights.py`: JAX's render_pass
on the CPU at 24x24, seed 0, instance 0, the scene's lobes, with the four
channels, the first-hit triangle, `rays` and each scene view's leaves, so that
the card can be held to JAX without JAX. Its configurations:
  A       the blocker CornellBox of tests/test_shadow_masks.py: a panel under
          the light flagged FLAG_SHADOW_DIRECT_IGNORE and the boxes flagged
          FLAG_SHADOW_INDIRECT_IGNORE, so both shadow sets are built and they
          differ; max_path_length=3;
  B_nee   floor_quad under tests/test_envmap.py's patchy map, env NEE + MIS,
          max_path_length=2;
  B_bsdf  the same view, BSDF sampling only (no NEE);
  C       the glossy CornellBox with an analytic disk and rect, a point light
          and a directional light entering through the open side;
          max_path_length=4;
  D       big_room(400) (4,836 triangles) with tracer="frontier", a 64x128
          sky map and the clutter flagged FLAG_SHADOW_INDIRECT_IGNORE, so the
          indirect shadow set is the 36-triangle room; max_path_length=4.
It also holds jax.grad of the mean composited image with respect to the
(M, 3) diffuse on B_nee and C and to the (3,) env scale on B_nee
(tests/test_torch_grad.py reads them).

Tolerances, those of tests/test_torch_pt.py: `rays` within 0.5%; at least 99%
of pixels within atol 1e-4, rtol 1e-3 on every channel; channel means within
1e-3 relative. The first-hit triangle is equal on A-C and on at least 99% of
D's pixels (tests/test_torch_bigroom.py says why). Only
test_jax_output_still_matches_golden renders with JAX: C and B_nee, one jitted
pass each.
"""
import collections
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.core.sampling import square_to_uniform_disk  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.ops import pt_mega  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import analytic_lights as tal  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.envmap import EnvMapView  # noqa: E402
from fermat_tpu_torch.scene.materials import FLAG_SHADOW_DIRECT_IGNORE  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_lights_24.npz")
RES, SEED, INSTANCE = 24, 0, 0
CHANNELS = ("composited", "direct", "diffuse", "specular")
# name: (scene, PTOptions fields beyond the scene's lobes and clearcoat)
CONFIGS = {
    "A": ("A", dict(max_path_length=3)),
    "B_nee": ("B", dict(max_path_length=2)),
    "B_bsdf": ("B", dict(max_path_length=2, direct_lighting_nee=False,
                         indirect_lighting_nee=False)),
    "C": ("C", dict(max_path_length=4)),
    "D": ("D", dict(max_path_length=4, tracer="frontier")),
}
# the gradient cases: (config, leaf) -> d mean(composited) / d leaf
GRADS = (("B_nee", "diffuse"), ("B_nee", "env"), ("C", "diffuse"))
DirLight = collections.namedtuple("DirLight", "direction color")
AREA_DEFS = [dict(kind="disk", pos=(-0.4, 1.7, 0.3), normal=(0.2, -1.0, 0.1),
                  color=(6.0, 5.0, 4.0), radius=0.25),
             dict(kind="rect", pos=(0.5, 1.5, -0.4), normal=(-0.3, -1.0, 0.2),
                  color=(2.0, 3.0, 4.0), u_extent=0.3, v_extent=0.15)]
POINT_DEFS = [((0.3, 1.2, 0.5), (1.5, 1.2, 0.9))]
DIR_DEFS = [DirLight((0.25, -0.5, -1.0), (0.8, 0.7, 0.6))]


def patchy_map(h=16, w=32):
    """tests/test_envmap.py's map: a gradient with a hot patch."""
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.linspace(0.1, 1.0, w)[None, :]
    img[..., 1] = 0.3
    img[4:6, 10:13, :] = [20.0, 5.0, 1.0]
    return img


def sky_map(h=64, w=128, seed=5):
    """A seeded sky: a vertical gradient, a small bright sun and noise."""
    rng = np.random.default_rng(seed)
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    img = np.empty((h, w, 3), np.float32)
    img[...] = (np.stack([0.4 + 0.6 * v, 0.6 + 0.3 * v, 1.0 - 0.2 * v], 1)[:, None, :]
                * (v[:, None, None] < 0.55) + 0.05)
    img += rng.random((h, w, 3), dtype=np.float32) * 0.1
    img[h // 6:h // 6 + 2, w // 3:w // 3 + 3] = 40.0
    return img


def build_scene(key: str, pkg: str):
    """(storage, camera, SceneView.build keywords) of scene `key` with the
    package `pkg` ("fermat_tpu" or "fermat_tpu_torch")."""
    proc = importlib.import_module(pkg + ".scene.procedural")
    mats = importlib.import_module(pkg + ".scene.materials")
    mesh = importlib.import_module(pkg + ".scene.mesh")
    cam = importlib.import_module(pkg + ".core.camera").Camera
    if key == "A":
        base = proc.cornell_box(light_size=2.0)
        for m in base.materials:
            if m.name == "box":
                m.flags = mats.FLAG_SHADOW_INDIRECT_IGNORE
        vs, tris, ids = [], [], []
        proc._quad(vs, tris, ids, [-0.99, 1.9, 0.99], [0.99, 1.9, 0.99],
                   [0.99, 1.9, -0.99], [-0.99, 1.9, -0.99], 0)
        m = mats.HostMaterial("blocker")
        m.diffuse = (0.2, 0.2, 0.2)
        m.flags = mats.FLAG_SHADOW_DIRECT_IGNORE
        t = np.asarray(tris, np.int32)
        panel = mesh.MeshStorage(vertices=np.asarray(vs, np.float32), triangles=t,
                                 normal_indices=np.full_like(t, -1),
                                 uv_indices=np.full_like(t, -1),
                                 material_ids=np.asarray(ids, np.int32), materials=[m])
        return base.merge(panel), proc.cornell_camera(), {}
    if key == "B":
        return (proc.floor_quad(1.0, (0.7, 0.7, 0.7)),
                cam.create((0.0, 2.0, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 0.7),
                dict(env_map=patchy_map()))
    if key == "C":
        return (proc.cornell_box(glossy_boxes=True), proc.cornell_camera(),
                dict(area_light_defs=AREA_DEFS, point_light_defs=POINT_DEFS,
                     dir_light_defs=DIR_DEFS))
    room = proc.big_room(400)
    for m in room.materials:
        if m.name == "clutter":
            m.flags = mats.FLAG_SHADOW_INDIRECT_IGNORE
    return (room, cam.create((0.0, 3.0, 10.0), (0.0, 1.5, 0.0)), dict(env_map=sky_map()))


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


_VIEWS = {}


def golden_view(golden, key: str) -> SceneView:
    if key not in _VIEWS:
        p = f"{key}.view."
        _VIEWS[key] = SceneView.from_numpy({k[len(p):]: golden[k] for k in golden.files
                                            if k.startswith(p)}, "cpu")
    return _VIEWS[key]


def golden_opts(golden, name: str, **kw) -> tpt.PTOptions:
    _, fields = CONFIGS[name]
    return tpt.PTOptions(lobes=tuple(bool(x) for x in golden[f"{name}.lobes"]),
                         clearcoat=bool(golden[f"{name}.clearcoat"]), **{**fields, **kw})


def check_against_golden(out, golden, name: str, tri_share: float = 1.0) -> None:
    want_rays = float(golden[f"{name}.rays"])
    assert abs(float(out.rays) - want_rays) <= 0.005 * want_rays, (float(out.rays), want_rays)
    same_tri = (out.tri.numpy() == golden[f"{name}.tri"]).mean()
    assert same_tri >= tri_share, same_tri
    for c in CHANNELS:
        assert_image_close(getattr(out, c).stack().numpy(), golden[f"{name}.{c}"].reshape(-1, 3))


# ---- pieces against the JAX functions ----

def _jv(a):
    import jax.numpy as jnp

    from fermat_tpu.core.math import Vec3 as JVec3
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _unit_dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("img", [patchy_map(), sky_map(64, 128),
                                 np.zeros((4, 8, 3), np.float32)],
                         ids=["patchy", "sky64x128", "black"])
def test_env_map_matches_jax(img):
    """build's weights and total bit-equal, its CDF within 1e-5 relative
    (summed in float64 here, in float32 by XLA); on the JAX CDF, pdf and
    sample within 2e-5 and eval within 1e-4 relative (atan2, acos, sin and
    cos round differently in XLA:CPU and torch: a one-ulp move of u shifts a
    bilinear weight by up to W ulps of the texel difference), the chosen
    texel equal on all but a boundary lane in a thousand."""
    from fermat_tpu.scene.envmap import EnvMapView as JEnv

    j = JEnv.build(img)
    t = EnvMapView.build(img, "cpu")
    assert np.array_equal(t.weight.numpy(), np.asarray(j.weight))
    assert t.total.numpy() == np.asarray(j.total)
    np.testing.assert_allclose(t.cdf.numpy(), np.asarray(j.cdf), rtol=1e-5, atol=0)
    t = EnvMapView.from_arrays(img, np.asarray(j.weight), np.asarray(j.cdf),
                               np.asarray(j.total), "cpu")
    d = _unit_dirs(4096, 1)
    tv = Vec3(*(torch.from_numpy(d[:, k].copy()) for k in range(3)))
    e, je = t.eval(tv), j.eval(_jv(d))
    for a, b in zip(e, je):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t.pdf(tv).numpy(), np.asarray(j.pdf(_jv(d))), rtol=2e-5)
    rng = np.random.default_rng(2)
    u = rng.random((2, 4096), dtype=np.float32)
    td, tpdf, trad = t.sample(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    jd, jpdf, jrad = j.sample(*(np.asarray(x) for x in u))
    # the same texel: the same radiance and a direction within a texel's width
    same = np.all([a.numpy() == np.asarray(b) for a, b in zip(trad, jrad)]
                  + [np.abs(a.numpy() - np.asarray(b)) < 1e-3 for a, b in zip(td, jd)], axis=0)
    assert same.mean() >= 0.999, same.mean()
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=0, atol=2e-5)
    # pdf ~ 1 / sqrt(1 - y^2): within 3 degrees of a pole a one-ulp y moves it
    # by far more than an ulp, so it is held away from the poles
    far = same & (np.abs(np.asarray(jd[1])) < 0.9986)
    np.testing.assert_allclose(tpdf.numpy()[far], np.asarray(jpdf)[far], rtol=2e-5)
    assert np.isfinite(tpdf.numpy()).all() and (tpdf.numpy() > 0).all()


@pytest.mark.parametrize("kind", ["disk", "rect"])
def test_area_lights_match_jax(kind):
    from fermat_tpu.scene.analytic_lights import AreaLightsView as JArea

    defs = [d for d in AREA_DEFS if d["kind"] == kind]
    j, t = JArea.build(defs), tal.AreaLightsView.build(defs, "cpu")
    assert np.array_equal(t.kind, np.asarray(j.kind))
    for f in tal.AreaLightsView._fields[1:]:
        assert np.array_equal(np.asarray(getattr(t, f)), np.asarray(getattr(j, f))), f
    u = np.random.default_rng(3).random((2, 2048), dtype=np.float32)
    got = t.map(0, torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    want = j.map(0, *(np.asarray(x) for x in u))
    for a, b in zip(got[:3], want[:3]):
        for k in range(3):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), rtol=1e-6, atol=1e-6)
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert t.pdf_area(0) == j.pdf_area(0)
    assert all(torch.equal(a, b) for a, b in zip(
        torch.utils._pytree.tree_leaves(t.sample(0, torch.from_numpy(u[0]),
                                                 torch.from_numpy(u[1]))),
        torch.utils._pytree.tree_leaves(got)))


def test_tessellated_lights_match_jax():
    from fermat_tpu.scene import analytic_lights as jal
    from fermat_tpu.scene.procedural import floor_quad as jfloor

    for fn, args in ((("add_rect_light", ((0.0, 2.0, 0.0), (0.1, -1.0, 0.0), 0.7, 0.4,
                                          (6.0, 6.0, 6.0)))),
                     ("add_disk_light", ((0.5, 2.0, 0.0), (0.0, -1.0, 0.2), 0.6,
                                         (8.0, 8.0, 8.0), 12))):
        a = getattr(jal, fn)(jfloor(3.0), *args)
        b = getattr(tal, fn)(tproc.floor_quad(3.0), *args)
        for f in ("vertices", "triangles", "normal_indices", "uv_indices", "material_ids"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (fn, f)
        assert [(m.name, m.diffuse, m.emissive) for m in a.materials] == \
            [(m.name, m.diffuse, m.emissive) for m in b.materials]


def test_square_to_uniform_disk_matches_jax():
    from fermat_tpu.core.sampling import square_to_uniform_disk as jdisk

    u = np.random.default_rng(4).random((2, 4096), dtype=np.float32)
    u[:, :3] = [[0.5, 0.5, 0.0], [0.5, 0.2, 0.5]]  # the center and the axes
    got = square_to_uniform_disk(torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    for a, b in zip(got, jdisk(*(np.asarray(x) for x in u))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_mesh_filtered_matches_jax():
    a, _, _ = build_scene("A", "fermat_tpu")
    b, _, _ = build_scene("A", "fermat_tpu_torch")
    keep = np.random.default_rng(6).random(a.n_triangles) < 0.6
    fa, fb = a.filtered(keep), b.filtered(keep)
    for f in ("vertices", "triangles", "normals", "normal_indices", "uvs", "uv_indices",
              "material_ids"):
        x, y = getattr(fa, f), getattr(fb, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert fb.materials is b.materials and fb.vertices is b.vertices


def test_which_shadow_sets_get_built():
    """tests/test_shadow_masks.py:64-74 on the port, with both bits."""
    assert SceneView.build(tproc.cornell_box(), tproc.cornell_camera(), "cpu").shadow_sets is None
    storage, cam, _ = build_scene("A", "fermat_tpu_torch")
    for m in storage.materials:
        if m.name == "box":
            m.flags = 0
    view = SceneView.build(storage, cam, "cpu")
    sd, si = view.shadow_sets
    assert si is None and sd.mesh.n_triangles == view.mesh.n_triangles - 2
    assert sd.tris.shape == (9, view.mesh.n_triangles - 2)
    assert int(sd.clusters.count.sum()) == sd.mesh.n_triangles
    # the kept triangles' ids in the set's cluster table index its own soup
    ids = np.sort(sd.clusters.tri[:, 9][sd.clusters.tri[:, 9] >= 0].astype(np.int64))
    assert np.array_equal(ids, np.arange(sd.mesh.n_triangles))


def test_empty_shadow_set_is_refused_as_in_jax():
    """A bit that every material sets leaves an empty shadow set: the JAX
    build fails on it (its BVH build asserts), and the port refuses it."""
    from fermat_tpu.scene.procedural import cornell_box as jcornell
    from fermat_tpu.scene.procedural import cornell_camera as jcam
    from fermat_tpu.scene.view import SceneView as JView

    j, t = jcornell(), tproc.cornell_box()
    for m in (*j.materials, *t.materials):
        m.flags = FLAG_SHADOW_DIRECT_IGNORE
    with pytest.raises(AssertionError, match="empty"):
        JView.build(j, jcam())
    with pytest.raises(ValueError, match="empty"):
        SceneView.build(t, tproc.cornell_camera(), "cpu")


@pytest.mark.parametrize("key", ["A", "B", "C", "D"])
def test_port_build_equals_the_jax_view(golden, key):
    """SceneView.build of the port's own scene holds the JAX view's leaves:
    mesh, lights, shadow-set meshes and cluster tables, area, point and
    directional lights bit-equal; the env map's CDF within 1e-5 relative."""
    storage, cam, kw = build_scene(key, "fermat_tpu_torch")
    own = SceneView.build(storage, cam, "cpu", **kw)
    ref = golden_view(golden, key)
    flat = lambda v: dict(zip(*_named_leaves(v)))
    a, b = flat(own), flat(ref)
    # the cluster tables: the leaves JAX stores (the port derives the rest);
    # a small scene's view from JAX's leaves carries none
    jax_leaf = lambda k: "clusters." not in k or k.split("clusters.")[1] in (
        "tri", "lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z")
    keys = [k for k in b if jax_leaf(k)]
    assert keys and set(keys) <= set(a)
    for k in keys:
        if k == "env_map.cdf":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=0)
        else:
            assert a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes(), k
    assert (own.shadow_sets is None) == (ref.shadow_sets is None)


def _named_leaves(view):
    """(names, numpy arrays) of a port view's tensors and host arrays."""
    names, arrays = [], []

    def walk(p, x):
        if x is None:
            return
        if isinstance(x, (torch.Tensor, np.ndarray)):
            names.append(p)
            arrays.append(x.numpy() if isinstance(x, torch.Tensor) else x)
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(f"{p}.{f}" if p else f, getattr(x, f))
        elif isinstance(x, tuple):
            for i, y in enumerate(x):
                walk(f"{p}[{i}]", y)

    walk("", view)
    return names, arrays


# ---- whole passes against the golden ----

@pytest.mark.parametrize("name", list(CONFIGS))
def test_pass_matches_jax_golden(golden, name):
    out = tpt.render_pass(golden_view(golden, CONFIGS[name][0]), golden_opts(golden, name),
                          RES, RES, INSTANCE, SEED)
    check_against_golden(out, golden, name, 0.99 if name == "D" else 1.0)
    assert float(out.rays_lane.sum()) == float(out.rays)


def test_mixed_route_matches_jax_golden(golden, monkeypatch):
    """D with tracer="auto": closest rays over the cluster table (K5a's
    plain version), the indirect shadow set (36 triangles) with the dense
    any-hit (K1b's), bounce 0's shadow rays over the whole scene (K5b's)."""
    view = golden_view(golden, "D")
    calls = collections.Counter()

    def counted(n, real):
        def f(*a):
            calls[(n, a[0] is view.clusters)] += 1
            return real(*a)
        return f

    for n in ("trace_any", "trace_any_frontier"):
        monkeypatch.setattr(tpt, n, counted(n, getattr(tpt, n)))
    out = tpt.render_pass(view, golden_opts(golden, "D", tracer="auto"), RES, RES, INSTANCE,
                          SEED)
    # bounce 0: mesh-light and env NEE over the whole scene; bounces 1-3 the same
    # two strategies over the indirect set's soup
    assert calls == {("trace_any_frontier", True): 2, ("trace_any", False): 6}, calls
    check_against_golden(out, golden, "D", 0.99)


def test_narrow_pass_equals_monolithic_on_d(golden):
    view = golden_view(golden, "D")
    opts = golden_opts(golden, "D")
    mono = tpt.render_pass(view, opts, RES, RES, INSTANCE, SEED)
    narrow = tpt.render_pass_narrow(view, opts, RES, RES, INSTANCE, SEED, min_width=64)
    assert float(narrow.rays) == float(mono.rays) and torch.equal(narrow.tri, mono.tri)
    assert torch.equal(narrow.rays_lane, mono.rays_lane)
    for c in CHANNELS:
        np.testing.assert_allclose(getattr(narrow, c).stack().numpy(),
                                   getattr(mono, c).stack().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["A", "B", "C", "D"])
def test_lit_views_are_not_mega_eligible(golden, key):
    view = golden_view(golden, key)
    assert not pt_mega.mega_eligible(view, tpt.PTOptions())
    if key != "D":  # within the megakernel's size caps, refused for its lights alone
        with pytest.raises(NotImplementedError, match="mega"):
            tpt.render_pass(view, tpt.PTOptions(tracer="mega", max_path_length=2), 4, 4, 0)


def test_context_takes_the_lights_and_still_refuses_textures(tmp_path):
    """The context takes the lights; textures, refused until they were
    ported, now come with them: texture_dir is passed through to the view,
    and the lit, textured view still keeps off the megakernel."""
    storage, cam, _ = build_scene("C", "fermat_tpu_torch")
    ctx = RenderingContext.create(storage, cam, 8, 8, device="cpu", max_path_length=2,
                                  dir_lights=DIR_DEFS, point_lights=POINT_DEFS,
                                  env_map=sky_map(8, 16))
    ctx.render(1)
    v = ctx.view
    assert v.dir_lights.count == 1 and v.point_lights.count == 1 and v.env_map is not None
    assert torch.equal(v.env, torch.ones(3))  # a zero env_radiance is promoted with a map
    assert np.isfinite(ctx.hdr_image()).all() and ctx.hdr_image().mean() > 0.0
    tproc.set_texture_names(storage, tproc.write_cornell_textures(str(tmp_path), size=8))
    tctx = RenderingContext.create(storage, cam, 8, 8, device="cpu", max_path_length=2,
                                   dir_lights=DIR_DEFS, texture_dir=str(tmp_path))
    tctx.render(1)
    assert tctx.view.has_textures and tctx.view.textures.count == 5
    assert np.isfinite(tctx.hdr_image()).all() and tctx.hdr_image().mean() > 0.0
    assert not pt_mega.mega_eligible(tctx.view, tpt.PTOptions())


# ---- the golden's writer and its live check ----

def _jax_leaves(view) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(view)
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(a) for p, a in flat}


def _jax_views(keys):
    from fermat_tpu.scene.view import SceneView as JView

    return {k: JView.build(s, c, **kw) for k in keys
            for s, c, kw in [build_scene(k, "fermat_tpu")]}


def _jax_opts(lobes_clearcoat, name):
    from fermat_tpu.integrators.pt import PTOptions

    lobes, clearcoat = lobes_clearcoat
    return PTOptions(lobes=lobes, clearcoat=clearcoat, **CONFIGS[name][1])


def _jax_pass(views, lobes, name):
    """JAX's render_pass of configuration `name`: the four channels as
    (N, 3), the first-hit triangle and rays."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import render_pass

    opts = _jax_opts(lobes[CONFIGS[name][0]], name)
    view = views[CONFIGS[name][0]]
    # the view is closed over: its area lights' kind and extents are host
    # numbers that steer Python branches, so it cannot be a jit argument
    out = jax.jit(lambda i: render_pass(view, opts, RES, RES, i, SEED))(
        jnp.uint32(INSTANCE))
    res = {c: np.asarray(getattr(out, c).stack()) for c in CHANNELS}
    res.update(tri=np.asarray(out.tri), rays=float(out.rays))
    return res


def _scene_lobes(keys):
    from fermat_tpu.bsdf.composite import scene_clearcoat, scene_lobes

    out = {}
    for k in keys:
        s, _, _ = build_scene(k, "fermat_tpu")
        out[k] = (tuple(bool(x) for x in scene_lobes(s.materials)),
                  bool(scene_clearcoat(s.materials)))
    return out


def test_jax_output_still_matches_golden(golden):
    """JAX's pass today on C and B_nee (one jitted pass each) equals the
    stored golden."""
    views = _jax_views(("B", "C"))
    lobes = _scene_lobes(("B", "C"))
    for name in ("C", "B_nee"):
        got = _jax_pass(views, lobes, name)
        assert got["rays"] == float(golden[f"{name}.rays"]), name
        assert np.array_equal(got["tri"], golden[f"{name}.tri"]), name
        for c in CHANNELS:
            np.testing.assert_allclose(golden[f"{name}.{c}"].reshape(-1, 3), got[c],
                                       rtol=1e-5, atol=1e-6)


def _jax_grad(view, opts, leaf: str):
    """(loss, grad) of the mean composited image of one pass with respect to
    the (M, 3) diffuse or the (3,) env scale."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import render_pass

    def with_leaf(x):
        if leaf == "env":
            return view._replace(env=x)
        m = view.mesh.materials
        d = type(m.diffuse)(x[:, 0], x[:, 1], x[:, 2])
        return view._replace(mesh=view.mesh._replace(materials=m._replace(diffuse=d)))

    x0 = view.env if leaf == "env" else jnp.stack(
        [view.mesh.materials.diffuse.x, view.mesh.materials.diffuse.y,
         view.mesh.materials.diffuse.z], axis=1)
    loss = lambda x: jnp.mean(render_pass(with_leaf(x), opts, RES, RES, jnp.uint32(INSTANCE),
                                          SEED).composited.stack())
    lv, g = jax.jit(jax.value_and_grad(loss))(x0)
    return float(lv), np.asarray(g)


def write_golden() -> None:
    keys = ("A", "B", "C", "D")
    views = _jax_views(keys)
    lobes = _scene_lobes(keys)
    out = {"res": RES, "seed": SEED, "instance": INSTANCE,
           # read by chip_smoke.py, which imports no test module
           "configs": json.dumps(CONFIGS), "grads": json.dumps(GRADS)}
    for k in keys:
        out.update({f"{k}.view.{n}": a for n, a in _jax_leaves(views[k]).items()
                    if "bvh" not in n and not n.startswith("vpls.")})
    for name in CONFIGS:
        got = _jax_pass(views, lobes, name)
        out.update({f"{name}.{c}": got[c].reshape(RES, RES, 3) for c in CHANNELS})
        out.update({f"{name}.tri": got["tri"], f"{name}.rays": got["rays"],
                    f"{name}.lobes": np.asarray(lobes[CONFIGS[name][0]][0]),
                    f"{name}.clearcoat": lobes[CONFIGS[name][0]][1]})
        print(f"{name}: rays {got['rays']}, mean {got['composited'].mean(0)}")
    for name, leaf in GRADS:
        lv, g = _jax_grad(views[CONFIGS[name][0]], _jax_opts(lobes[CONFIGS[name][0]], name),
                          leaf)
        out[f"{name}.grad.{leaf}"], out[f"{name}.loss"] = g, lv
        print(f"{name} d/d {leaf}: loss {lv}, max|g| {np.abs(g).max()}")
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden()
