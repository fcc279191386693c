"""The remaining PT options of fermat_tpu_torch against fermat_tpu: nee="vpl"
(the VPL set and its pick), glossy_model="ltc" (the LTC lobe), queue
compaction, the three debug_nee_* switches, detach_nee and detach_emissive,
and the stream-compaction primitives of ops/compact.py.

The passes are held to a stored golden, tests/golden/torch_port_options_24.npz,
written by `JAX_PLATFORMS=cpu python tests/test_torch_options.py` (~2 min:
six JAX passes and three jax.grad compiles): JAX render_pass at 24x24 on
cornell_box(glossy_boxes=True, light_size=2.0), max_path_length=4, seed 0,
instance 0, the scene's lobes, under each option of PASSES; jax.grad of the
mean composited image under each case of GRADS (max_path_length=3, rr=False:
d/d diffuse with detach_nee, d/d emissive with detach_emissive through a
light table built from the same tensors, d/d diffuse under nee="vpl"); the
JAX view's leaves (with its VPL set) and the configurations as JSON, so that
the card can be held to JAX without JAX.

Tolerances, those of tests/test_torch_pt.py: `rays` within 0.5%, at least
99% of pixels within atol 1e-4, rtol 1e-3 on every channel, channel means
within 1e-3 relative, the first-hit triangle equal; gradients within 1e-5 of
max|g| (tests/test_torch_grad.py). The VPL rows and norm are numpy on both
sides and bit-equal; the LTC lobe is held to test_torch_bsdf.py's tolerance;
the compaction primitives are exact.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu.core.math import Vec3 as JV  # noqa: E402
from fermat_tpu_torch.bsdf import ltc as tltc  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.ops import compact as tcomp  # noqa: E402
from fermat_tpu_torch.ops import pt_mega  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.lights import MeshLightsView, host_arrays  # noqa: E402
from fermat_tpu_torch.scene.mesh_lights import build_vpls, textured_tri_energies  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_options_24.npz")
RES, MPL, SEED, INSTANCE = 24, 4, 0, 0
CHANNELS = ("composited", "direct", "diffuse", "specular")
PASSES = {
    "vpl": dict(nee="vpl"),
    "ltc": dict(glossy_model="ltc"),
    "compact": dict(queue_compaction=True),
    "no_shadow": dict(debug_nee_no_shadow=True),
    "fixed_light": dict(debug_nee_fixed_light=True),
    "cheap_eval": dict(debug_nee_cheap_eval=True),
}
GRAD_BASE = dict(max_path_length=3, rr=False)
GRADS = {
    # name: (PTOptions fields beyond GRAD_BASE and the lobes, material field)
    "detach_nee": (dict(detach_nee=True), "diffuse"),
    "detach_emissive": (dict(detach_emissive=True), "emissive"),
    "vpl": (dict(nee="vpl"), "diffuse"),
}
GRAD_RTOL = 1e-5


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def gview(golden):
    return SceneView.from_numpy({k[5:]: golden[k] for k in golden.files
                                 if k.startswith("view.")}, "cpu")


def _opts(golden, **kw) -> tpt.PTOptions:
    return tpt.PTOptions(lobes=tuple(bool(x) for x in golden["lobes"]),
                         clearcoat=bool(golden["clearcoat"]), **kw)


# ---- whole passes against the golden ----

@pytest.mark.parametrize("name", list(PASSES))
def test_pass_matches_jax_golden(golden, gview, name):
    out = tpt.render_pass(gview, _opts(golden, max_path_length=MPL, **PASSES[name]), RES, RES,
                          INSTANCE, SEED)
    want_rays = float(golden[f"{name}.rays"])
    assert abs(float(out.rays) - want_rays) <= 0.005 * want_rays, (float(out.rays), want_rays)
    assert np.array_equal(out.tri.numpy(), golden[f"{name}.tri"].ravel())
    for c in CHANNELS:
        assert_image_close(getattr(out, c).stack().numpy(), golden[f"{name}.{c}"].reshape(-1, 3))
    assert float(out.rays_lane.sum()) == float(out.rays)


def test_compaction_is_bit_equal_to_the_masked_pass(golden, gview):
    """queue_compaction permutes lanes and back: every output equals the
    masked pass bit for bit (pt.py:1144-1185)."""
    opts = _opts(golden, max_path_length=MPL)
    a = tpt.render_pass(gview, opts, RES, RES, 1, SEED)
    b = tpt.render_pass(gview, opts._replace(queue_compaction=True), RES, RES, 1, SEED)
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        x, y = (x.stack(), y.stack()) if isinstance(x, Vec3) else (x, y)
        assert torch.equal(x, y), f
    with pytest.raises(ValueError, match="narrowing"):
        tpt.NarrowPass(gview, opts._replace(queue_compaction=True), RES, RES)


def test_no_shadow_drops_the_mesh_shadow_rays(golden, gview):
    """debug_nee_no_shadow traces no mesh-NEE shadow ray (the count of rays
    still books them, as JAX's does), and its image is brighter."""
    calls = []
    any_ = tpt.trace_any
    tpt.trace_any = lambda *a: calls.append(1) or any_(*a)
    try:
        opts = _opts(golden, max_path_length=2)
        ref = tpt.render_pass(gview, opts, 8, 8, 0, SEED)
        n_ref = len(calls)
        out = tpt.render_pass(gview, opts._replace(debug_nee_no_shadow=True), 8, 8, 0, SEED)
    finally:
        tpt.trace_any = any_
    assert n_ref == 2 and len(calls) == n_ref
    assert float(out.composited.stack().sum()) >= float(ref.composited.stack().sum())


def _port_grad(view, opts, field: str):
    x = getattr(view.mesh.materials, field).stack().detach().clone().requires_grad_(True)
    mats = view.mesh.materials._replace(**{field: Vec3(x[:, 0], x[:, 1], x[:, 2])})
    mesh = view.mesh._replace(materials=mats)
    v = view._replace(mesh=mesh)
    if field == "emissive":
        v = v._replace(lights=MeshLightsView.build_on_device(mesh))
    loss = tpt.render_pass(v, opts, RES, RES, INSTANCE, SEED).composited.stack().mean()
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("name", list(GRADS))
def test_grad_matches_jax_golden(golden, gview, name):
    fields, leaf = GRADS[name]
    lv, g = _port_grad(gview, _opts(golden, **GRAD_BASE, **fields), leaf)
    want = golden[f"grad.{name}"]
    scale = np.abs(want).max()
    assert scale > 0.0
    assert np.abs(g - want).max() <= GRAD_RTOL * scale, (np.abs(g - want).max(), scale)
    assert abs(lv - float(golden[f"grad.{name}.loss"])) <= 1e-5 * abs(lv)


def test_detach_nee_cuts_its_gradient(golden, gview):
    """detach_nee takes the NEE terms' share out of d/d diffuse."""
    opts = _opts(golden, **GRAD_BASE)
    _, full = _port_grad(gview, opts, "diffuse")
    _, cut = _port_grad(gview, opts._replace(detach_nee=True), "diffuse")
    assert np.abs(full - cut).max() > 1e-3 * np.abs(full).max()


@pytest.mark.parametrize("option", list(PASSES) + ["detach_nee", "detach_emissive"])
def test_options_render_through_the_context(option):
    kw = PASSES.get(option, {option: True})
    ctx = RenderingContext.create(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(),
                                  8, 8, device="cpu", max_path_length=3, **kw)
    ctx.render(1)
    img = ctx.hdr_image()
    assert np.isfinite(img).all() and img.mean() > 0.0


def test_vpl_needs_the_views_vpl_set(gview):
    with pytest.raises(ValueError, match="VPL"):
        tpt.render_pass(gview._replace(vpls=None), tpt.PTOptions(nee="vpl"), 4, 4, 0)


def test_mega_refuses_ltc(gview):
    opts = tpt.PTOptions(tracer="mega", glossy_model="ltc", max_path_length=2)
    assert not pt_mega.mega_eligible(gview, opts)
    with pytest.raises(NotImplementedError, match="LTC"):
        tpt.render_pass(gview, opts, 4, 4, 0)


# ---- the VPL set ----

def _jax_vpls(storage, images):
    from fermat_tpu.scene.mesh_lights import build_vpls as jbuild
    from fermat_tpu.scene.mesh_lights import textured_tri_energies as jenergies

    mesh = storage.device_view()
    return jbuild(mesh, n_vpls=256, tri_energy=jenergies(mesh, images), images=images)


@pytest.mark.parametrize("textured", [False, True])
def test_vpls_bit_equal_to_jax(textured):
    """The VPL rows and norm of the port's build equal JAX's build_vpls bit
    for bit: the plain CornellBox, and with a seeded 8x8 emissive map on its
    light (nearest-texel lookups in the source image)."""
    from fermat_tpu.scene import procedural as jproc

    js, ts = jproc.cornell_box(glossy_boxes=True), tproc.cornell_box(glossy_boxes=True)
    images = []
    if textured:
        images = [np.random.default_rng(5).random((8, 8, 3)).astype(np.float32) * 2.0]
        for s in (js, ts):
            for m in s.materials:
                m.emissive_map = 0 if max(m.emissive) > 0 else -1
    want = _jax_vpls(js, images)
    mesh_np = host_arrays(ts.device_view(torch.device("cpu")))
    got = build_vpls(mesh_np, 256, textured_tri_energies(mesh_np, images), images, "cpu")
    assert got.rows.shape == (256, 11) and got.count == 256
    assert np.array_equal(got.rows.numpy().view(np.uint32), np.asarray(want.rows).view(np.uint32))
    assert np.float32(got.norm).view(np.uint32) == np.float32(want.norm).view(np.uint32)
    if textured:  # the map moved the light's Le
        plain = _jax_vpls(jproc.cornell_box(glossy_boxes=True), [])
        assert not np.array_equal(np.asarray(plain.rows)[:, 6:9], got.rows.numpy()[:, 6:9])


def test_vpl_view_sample_matches_jax(gview, golden):
    from fermat_tpu.scene.mesh_lights import VPLView as JVPL

    u = np.random.default_rng(3).random(4096).astype(np.float32)
    want = JVPL(rows=jnp.asarray(golden["view.vpls.rows"]),
                norm=jnp.asarray(golden["view.vpls.norm"]), count=256).sample(jnp.asarray(u))
    got = gview.vpls.sample(torch.from_numpy(u))
    for g, w in zip((*got[0], *got[1], *got[2], got[3], got[4]),
                    (*want[0], *want[1], *want[2], want[3], want[4])):
        assert np.array_equal(g.numpy(), np.asarray(w))


# ---- the LTC lobe ----

@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(11)
    n = 4096

    def unit():
        v = r.standard_normal((3, n)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    wi = unit()
    wi[2] = np.abs(wi[2])
    return (r.random(n).astype(np.float32), wi, unit(), r.random((2, n)).astype(np.float32))


def _close(got, want):
    """test_torch_bsdf.py's tolerance: rtol 1e-4 (atol 1e-6) on >= 99.5% of
    lanes, no mean offset beyond 1e-4 of the mean magnitude."""
    got, want = got.numpy().astype(np.float64), np.asarray(want).astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    near = np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-6
    assert near.mean() >= 0.995, (near.mean(), np.abs(got - want).max())
    assert abs((got - want)[near].mean()) <= 1e-4 * max(np.abs(want[near]).mean(), 1e-12)


def test_ltc_matches_jax(lanes):
    from fermat_tpu.bsdf import ltc as jltc

    rough, wi, wo, u = lanes
    tv = lambda a: Vec3(*map(torch.from_numpy, a))
    jv = lambda a: JV(*map(jnp.asarray, a))
    rj, rt = jnp.asarray(rough), torch.from_numpy(rough)
    _close(tltc.ltc_density(rt, tv(wi), tv(wo)), jltc.ltc_density(rj, jv(wi), jv(wo)))
    for g, w in zip(tltc.ltc_eval(rt, tv(wi), tv(wo)), jltc.ltc_eval(rj, jv(wi), jv(wo))):
        _close(g, w)
    got_wo, got_pdf = tltc.ltc_sample(rt, tv(wi), *map(torch.from_numpy, u))
    want_wo, want_pdf = jltc.ltc_sample(rj, jv(wi), *map(jnp.asarray, u))
    for g, w in zip((*got_wo, got_pdf), (*want_wo, want_pdf)):
        _close(g, w)
    for g, w in zip(tltc._fetch_params(rt, tv(wi).z), jltc._fetch_params(rj, jv(wi).z)):
        _close(g, w)


def test_port_reads_its_own_ltc_table():
    import fermat_tpu.bsdf.ltc as jltc

    assert os.path.dirname(tltc._NPZ) == os.path.join(ROOT, "fermat_tpu_torch", "data")
    with open(tltc._NPZ, "rb") as a, open(jltc._NPZ, "rb") as b:
        assert a.read() == b.read()


# ---- stream compaction ----

def test_compaction_primitives_match_jax():
    from fermat_tpu.ops import compact as jcomp

    r = np.random.default_rng(2)
    for p_live in (0.0, 0.3, 1.0):
        mask = r.random(64) < p_live
        want, got = jcomp.compact(jnp.asarray(mask)), tcomp.compact(torch.from_numpy(mask))
        for f in ("gather_idx", "scatter_idx", "count"):
            assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
        tree = (r.random(64).astype(np.float32), r.random((64, 3)).astype(np.float32))
        jt, tt = tuple(map(jnp.asarray, tree)), tuple(map(torch.from_numpy, tree))
        g_want, g_got = jcomp.gather_tree(want, jt), tcomp.gather_tree(got, tt)
        for a, b in zip(g_got, g_want):
            assert np.array_equal(a.numpy(), np.asarray(b))
        orig = tuple(x * 0 - 1 for x in tree)
        s_want = jcomp.scatter_tree(want, g_want, tuple(map(jnp.asarray, orig)))
        s_got = tcomp.scatter_tree(got, g_got, tuple(map(torch.from_numpy, orig)))
        for a, b in zip(s_got, s_want):
            assert np.array_equal(a.numpy(), np.asarray(b))
    img = r.random((16, 3)).astype(np.float32)
    pix = np.array([-1, 3, 3, 17, 0, -20, 15], np.int32)
    vals = r.random((7, 3)).astype(np.float32)
    en = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    for enabled in (None, en):
        want = jcomp.splat_add(jnp.asarray(img), jnp.asarray(pix), jnp.asarray(vals),
                               None if enabled is None else jnp.asarray(enabled))
        got = tcomp.splat_add(torch.from_numpy(img), torch.from_numpy(pix),
                              torch.from_numpy(vals),
                              None if enabled is None else torch.from_numpy(enabled))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


# ---- the golden ----

def write_golden() -> None:
    from fermat_tpu.bsdf.composite import scene_clearcoat, scene_lobes
    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.scene import procedural as jproc
    from fermat_tpu.scene.lights import MeshLightsView as JLights
    from fermat_tpu.scene.view import SceneView as JView

    storage = jproc.cornell_box(glossy_boxes=True, light_size=2.0)
    view = JView.build(storage, jproc.cornell_camera())
    lobes = tuple(bool(x) for x in scene_lobes(storage.materials))
    clearcoat = bool(scene_clearcoat(storage.materials))
    leaves, _ = jax.tree_util.tree_flatten_with_path(view)
    out = {f"view.{jax.tree_util.keystr(p).lstrip('.')}": np.asarray(a) for p, a in leaves}
    out = {k: v for k, v in out.items() if not k.startswith(("view.bvh", "view.clusters."))}
    out.update(res=RES, max_path_length=MPL, seed=SEED, instance=INSTANCE,
               lobes=np.asarray(lobes), clearcoat=clearcoat,
               scene="cornell_box(glossy_boxes=True, light_size=2.0)",
               # read by chip_smoke.py, which imports no test module
               passes=json.dumps(PASSES), grads=json.dumps(GRADS),
               grad_base=json.dumps(GRAD_BASE))
    for name, fields in PASSES.items():
        opts = PTOptions(max_path_length=MPL, lobes=lobes, clearcoat=clearcoat, **fields)
        o = jax.jit(lambda i: render_pass(view, opts, RES, RES, i, SEED))(jnp.uint32(INSTANCE))
        out.update({f"{name}.{c}": np.stack([np.asarray(x) for x in getattr(o, c)],
                                            -1).reshape(RES, RES, 3) for c in CHANNELS})
        out.update({f"{name}.tri": np.asarray(o.tri).reshape(RES, RES),
                    f"{name}.rays": float(o.rays)})
        print(f"{name}: rays {float(o.rays)}")
    for name, (fields, leaf) in GRADS.items():
        opts = PTOptions(lobes=lobes, clearcoat=clearcoat, **GRAD_BASE, **fields)

        def with_leaf(x, leaf=leaf):
            e = getattr(view.mesh.materials, leaf)
            mats = view.mesh.materials._replace(**{leaf: type(e)(x[:, 0], x[:, 1], x[:, 2])})
            mesh = view.mesh._replace(materials=mats)
            v = view._replace(mesh=mesh)
            return v._replace(lights=JLights.build(mesh)) if leaf == "emissive" else v

        e = getattr(view.mesh.materials, leaf)
        x0 = jnp.stack([e.x, e.y, e.z], axis=1)
        loss = lambda x, opts=opts, with_leaf=with_leaf: jnp.mean(render_pass(
            with_leaf(x), opts, RES, RES, jnp.uint32(INSTANCE), SEED).composited.stack())
        lv, g = jax.jit(jax.value_and_grad(loss))(x0)
        out[f"grad.{name}"], out[f"grad.{name}.loss"] = np.asarray(g), float(lv)
        print(f"grad {name} d/d {leaf}: loss {float(lv)}, max|g| {np.abs(np.asarray(g)).max()}")
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
