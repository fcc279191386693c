"""The bidirectional path tracer (integrators/bpt.py) and PSSMLT
(integrators/pssmlt.py) of fermat_tpu_torch against fermat_tpu.

JAX's BPT is compile-heavy on the CPU (about a minute a jitted pass), so the
passes are held to a stored golden, tests/golden/torch_port_bpt_24.npz,
written by `JAX_PLATFORMS=cpu python tests/test_torch_bpt.py` (about 7
minutes): JAX's bpt.render_pass (jitted, return_splat_list=True) at 24x24,
max_path_length=4, seed 0, instance 0, the scene's lobes, on
  A      cornell_box(glossy_boxes=True, light_size=2.0);
  A_nolt A with light_tracing=False;
  panel  cornell_box(light_scale=0.7, light_size=2.0) with a floor panel of
         tilted vertex normals (tests/test_bpt_extras.py), where the adjoint
         factor differs from 1;
  env    A under a seeded 32x16 environment map (escaped rays, the env tail);
  tex    A with scene.procedural.write_cornell_textures's seeded 16-texel
         maps (diffuse, specular and an emissive map on the light);
and big_room(400) at 16x16 (bench camera), JAX's CPU route walking its BVH
with real barycentrics, whose view's leaves are those of
tests/golden/torch_port_bigroom_24.npz. The port renders big_room through
tracer="auto" (the frontier tracer, (u, v) derived from the ray) and through
tracer="bvh" (JAX's BVH). For PSSMLT, on A at 16x16 with 256 chains,
max_path_length=4, n_seed_candidates=2, path_space "bpt" and "pt": JAX's
init_state, the first step's proposal (_mutate), new state and splat, run
op by op (jitted, XLA compiles the seed pass for over 15 minutes). The
golden also stores each view's leaves (the card replays them without JAX).

Tolerances, those of tests/test_torch_pt.py: `rays` within 0.5%; at least 99%
of pixels within atol 1e-4, rtol 1e-3 on every channel; channel means within
1e-3 relative. The splat list's pixels are equal on at least 99% of its
entries. _mutate within 2e-7 (exp and log round apart); a step from JAX's
stored state accepts the same proposal on at least 99% of chains.
No JAX BPT or PSSMLT pass runs here; the cheap pieces (_adjoint_corr,
MatrixSequence, _luminance, and MeshView.shade_fetch against JAX's
interpolate and _emissive_of) are held to JAX live.
"""
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import bpt as tbpt  # noqa: E402
from fermat_tpu_torch.integrators import pssmlt as tps  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_bpt_24.npz")
BIGROOM = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
RES, BIG_RES, MPL, SEED, INSTANCE = 24, 16, 4, 0, 0
ENV_W, ENV_H, TEX = 32, 16, 16
# name: (scene, BPTOptions fields beyond max_path_length and the lobes)
CASES = {
    "A": ("A", {}),
    "A_nolt": ("A", {"light_tracing": False}),
    "panel": ("panel", {}),
    "env": ("env", {}),
    "tex": ("tex", {}),
}
PS_RES, PS_CHAINS, PS_MPL, PS_SEEDS = 16, 256, 4, 2
PS_SPACES = ("bpt", "pt")


def env_image() -> np.ndarray:
    """The seeded 32x16 lat-long map of case `env` (float32 radiance)."""
    return (np.random.default_rng(21).random((ENV_H, ENV_W, 3)) * 1.5).astype(np.float32)


def build_scene(key: str, pkg: str, tmp: str):
    """(storage, camera, SceneView.build keywords) of scene `key` with the
    package `pkg` ("fermat_tpu" or "fermat_tpu_torch")."""
    import importlib

    proc = importlib.import_module(pkg + ".scene.procedural")
    if key == "panel":
        return panel_scene(pkg), proc.cornell_camera(), {}
    storage = proc.cornell_box(glossy_boxes=True, light_size=2.0)
    if key == "env":
        return storage, proc.cornell_camera(), {"env_map": env_image()}
    if key == "tex":
        names = tproc.write_cornell_textures(tmp, size=TEX)
        return tproc.set_texture_names(storage, names), proc.cornell_camera(), {
            "texture_dir": tmp}
    return storage, proc.cornell_camera(), {}


def panel_scene(pkg: str):
    """tests/test_bpt_extras.py's _smooth_normal_cornell: the CornellBox and a
    floor panel whose vertex normals are tilted ~25 degrees."""
    import importlib

    proc = importlib.import_module(pkg + ".scene.procedural")
    mats = importlib.import_module(pkg + ".scene.materials")
    mesh = importlib.import_module(pkg + ".scene.mesh")
    base = proc.cornell_box(light_scale=0.7, light_size=2.0)
    vs = np.array([[-0.8, 0.01, 0.2], [0.0, 0.01, 0.2], [0.0, 0.01, 0.9], [-0.8, 0.01, 0.9]],
                  np.float32)
    t = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.array([[0.4, 0.9, 0.1], [-0.4, 0.9, 0.1], [0.1, 0.9, -0.4], [-0.1, 0.9, 0.4]],
                   np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    m = mats.HostMaterial("panel")
    m.diffuse = (0.7, 0.6, 0.4)
    kw = {}
    if pkg == "fermat_tpu":
        kw = dict(group_names=["panel"], group_offsets=np.asarray([0, 2], np.int32))
    panel = mesh.MeshStorage(vertices=vs, triangles=t, normals=nrm, normal_indices=t.copy(),
                             uv_indices=np.full_like(t, -1), material_ids=np.zeros(2, np.int32),
                             materials=[m], **kw)
    return base.merge(panel)


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


def assert_rays_close(got: float, want: float) -> None:
    assert abs(got - want) <= 0.005 * want, (got, want)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def gviews(golden):
    cache = {}

    def get(key):
        if key not in cache:
            if key == "big_room":
                g = np.load(BIGROOM)
                arrays = {k[5:]: g[k] for k in g.files if k.startswith("view.")}
            else:
                p = f"{key}.view."
                arrays = {k[len(p):]: golden[k] for k in golden.files if k.startswith(p)}
            cache[key] = SceneView.from_numpy(arrays, "cpu")
        return cache[key]

    return get


def _bopts(golden, key, **kw):
    return tbpt.BPTOptions(max_path_length=MPL,
                           lobes=tuple(bool(x) for x in golden[f"{key}.lobes"]), **kw)


def assert_pass_matches(golden, name, out) -> None:
    rad, splat, rays, rays_lane, sp, sr = out
    assert_rays_close(float(rays), float(golden[f"{name}.rays"]))
    assert float(rays_lane.sum()) == float(rays)
    assert_image_close(rad.stack().numpy(), golden[f"{name}.rad"])
    if golden[f"{name}.splat"].any():
        assert_image_close(splat.numpy(), golden[f"{name}.splat"])
    else:
        assert not splat.any()
    want_sp, want_sr = golden[f"{name}.sp"], golden[f"{name}.sr"]
    assert sp.shape == want_sp.shape and sr.shape == want_sr.shape
    if want_sp.size:  # no light tracing: an (N, 0) list
        assert (sp.numpy() == want_sp).mean() >= 0.99
        # each splat entry's rgb (N * (L-1) rows) at the image tolerance
        assert_image_close(sr.reshape(-1, 3).numpy(), want_sr.reshape(-1, 3))


# ---- BPT passes against the golden ----

@pytest.mark.parametrize("name", list(CASES))
def test_bpt_matches_jax_golden(golden, gviews, name):
    key, fields = CASES[name]
    out = tbpt.render_pass(gviews(key), _bopts(golden, key, **fields), RES, RES, INSTANCE, SEED,
                           return_splat_list=True)
    assert_pass_matches(golden, name, out)


@pytest.mark.parametrize("tracer", ["auto", "bvh"])
def test_big_room_bpt_matches_jax_bvh_route(golden, gviews, tracer):
    """big_room(400) through the frontier tracer ((u, v) from the ray) and
    through the BVH walk, held to JAX's BVH route."""
    view = gviews("big_room")
    opts = _bopts(golden, "big_room", tracer=tracer)
    assert tpt._raw_tracers(view, tpt.PTOptions(tracer=tracer))[2] == (tracer == "auto")
    out = tbpt.render_pass(view, opts, BIG_RES, BIG_RES, INSTANCE, SEED, return_splat_list=True)
    assert_pass_matches(golden, "big_room", out)


def test_frontier_zero_uv_would_shade_at_the_first_vertex(golden, gviews, monkeypatch):
    """The frontier tracer returns u = v = 0: shading with them (what a
    literal port of JAX's BPT would do on that route) moves the image off
    JAX's; the ray-derived (u, v) match it (the test above)."""
    raw = tpt._raw_tracers
    monkeypatch.setattr(tpt, "_raw_tracers", lambda *a: (*raw(*a)[:2], False))
    rad = tbpt.render_pass(gviews("big_room"), _bopts(golden, "big_room"), BIG_RES, BIG_RES,
                           INSTANCE, SEED)[0].stack().numpy()
    want = golden["big_room.rad"]
    near = np.isclose(rad, want, atol=1e-4, rtol=1e-3).all(axis=1).mean()
    assert near < 0.9, near


def test_context_renders_bpt_as_the_golden(golden):
    """RenderingContext's "bpt" pass on the CPU: composited = eye radiance
    + the lane's light-tracing splat (bpt.py:612-650), the scene's lobes,
    no clearcoat option."""
    storage, cam, _ = build_scene("A", "fermat_tpu_torch", "")
    ctx = RenderingContext.create(storage, cam, RES, RES, renderer="bpt", device="cpu",
                                  max_path_length=MPL)
    assert "clearcoat" not in ctx.renderer_options
    assert tuple(ctx.renderer_options["lobes"]) == tuple(bool(x) for x in golden["A.lobes"])
    ctx.render(1)
    want = golden["A.rad"] + golden["A.splat"]
    assert_image_close(ctx.hdr_image().reshape(-1, 3), want)
    assert_rays_close(float(ctx.gbuffer["rays"]), float(golden["A.rays"]))
    with pytest.raises(TypeError):
        RenderingContext.create(storage, cam, 4, 4, renderer="bpt", device="cpu",
                                clearcoat=True).render(1)


def test_bpt_pix_lanes_follow_their_pixels(golden, gviews):
    """pix picks the lanes' pixels (duplicates allowed): each lane's eye
    radiance is its pixel's in the full-grid pass."""
    view, opts, res = gviews("A"), _bopts(golden, "A"), 8
    full = tbpt.render_pass(view, opts, res, res, INSTANCE, SEED)[0].stack()
    pix = torch.tensor([5, 5, 30, 0, res * res - 1])
    part = tbpt.render_pass(view, opts, res, res, INSTANCE, SEED, pix=pix)[0].stack()
    # 5 lanes take the CPU kernels' scalar tails, 64 their vector bodies
    torch.testing.assert_close(part, full[pix], rtol=1e-5, atol=1e-7)
    fb = tbpt.render_pass_fb(view, opts._replace(max_path_length=2), res, res, INSTANCE, SEED,
                             pix=pix)
    assert fb.composited.x.shape == (5,) and torch.equal(fb.tri, torch.full((5,), -1,
                                                                          dtype=torch.int32))


def test_bpt_refuses_the_megakernel(gviews):
    with pytest.raises(NotImplementedError, match="mega"):
        tbpt.render_pass(gviews("A"), tbpt.BPTOptions(tracer="mega"), 4, 4, 0)


# ---- PT with pix and sequence ----

def test_pt_pass_with_its_own_pix_and_sequence_is_unchanged(gviews):
    """pix=arange and the pass's own sequence give the default pass's bits."""
    from fermat_tpu_torch.core.rng import TiledSequence

    view, opts = gviews("A"), tpt.PTOptions(max_path_length=3)
    a = tpt.render_pass(view, opts, 8, 8, 3, SEED)
    b = tpt.render_pass(view, opts, 8, 8, 3, SEED, pix=torch.arange(64),
                        sequence=TiledSequence.create(SEED).set_instance(3))
    for f in ("composited", "direct", "diffuse", "specular", "normal"):
        assert torch.equal(getattr(a, f).stack(), getattr(b, f).stack()), f
    assert torch.equal(a.tri, b.tri) and float(a.rays) == float(b.rays)
    with pytest.raises(NotImplementedError, match="mega"):
        tpt.render_pass(view, opts._replace(tracer="mega"), 8, 8, 0, pix=torch.arange(64))


# ---- PSSMLT against the golden ----

def _ps_opts(space):
    return tps.PssmltOptions(max_path_length=PS_MPL, n_seed_candidates=PS_SEEDS,
                             path_space=space)


def _ps_state(golden, space, which):
    p = f"ps_{space}.{which}."
    return tps.PssmltState(
        u=torch.from_numpy(golden[p + "u"]), i_lum=torch.from_numpy(golden[p + "i_lum"]),
        contrib=torch.from_numpy(golden[p + "contrib"]),
        pixel=torch.from_numpy(golden[p + "pixel"]),
        brightness=torch.from_numpy(golden[p + "brightness"]), key=int(golden[p + "key"]))


@pytest.mark.parametrize("space", PS_SPACES)
def test_pssmlt_init_state_matches_jax(golden, gviews, space):
    got = tps.init_state(gviews("A"), _ps_opts(space), PS_RES, PS_RES, PS_CHAINS, SEED)
    want = _ps_state(golden, space, "init")
    assert got.u.shape == (PS_CHAINS, tps._dims(_ps_opts(space)))
    assert got.key == want.key
    same = (got.u == want.u).all(dim=1)
    assert float(same.float().mean()) >= 0.99
    np.testing.assert_allclose(float(got.brightness), float(want.brightness), rtol=1e-3)
    assert_image_close(got.contrib[same].reshape(-1, 3).numpy(),
                       want.contrib[same].reshape(-1, 3).numpy())
    assert float((got.pixel == want.pixel)[same].float().mean()) >= 0.99


@pytest.mark.parametrize("space", PS_SPACES)
def test_pssmlt_step_matches_jax(golden, gviews, space):
    """One step from JAX's stored state: the proposal (_mutate) within 2e-7,
    the same acceptance on >= 99% of chains, the splat image close."""
    s0 = _ps_state(golden, space, "init")
    opts = _ps_opts(space)
    u_prop = tps._mutate(s0.u, tps.hash_combine(s0.key, 0x1234567), opts)
    want_prop = torch.from_numpy(golden[f"ps_{space}.u_prop"])
    err = (u_prop - want_prop).abs()
    assert float(torch.minimum(err, 1.0 - err).max()) <= 2e-7
    s1, splat = tps.step(gviews("A"), opts, PS_RES, PS_RES, s0)
    want = _ps_state(golden, space, "step")
    took, want_took = (s1.u == u_prop).all(dim=1), (want.u == want_prop).all(dim=1)
    assert float((took == want_took).float().mean()) >= 0.99
    assert s1.key == want.key
    assert_image_close(splat.numpy(), golden[f"ps_{space}.splat"])


def test_pssmlt_context_carries_and_restarts_its_chains():
    storage, cam, _ = build_scene("A", "fermat_tpu_torch", "")
    ctx = RenderingContext.create(storage, cam, 8, 8, renderer="pssmlt", device="cpu",
                                  max_path_length=3, n_seed_candidates=1, path_space="pt")
    assert "lobes" not in ctx.renderer_options and "clearcoat" not in ctx.renderer_options
    ctx.render(1)
    s1 = ctx.renderer_state
    ctx.render_batch(1)
    s2 = ctx.renderer_state
    assert s2.key == tps.hash_combine(tps.hash_combine(s1.key, 0x1234567), 0xDEADBEEF)
    img = ctx.hdr_image()
    assert np.isfinite(img).all() and img.mean() > 0.0 and float(ctx.gbuffer["rays"]) == 0.0
    ctx.restart()
    assert ctx.renderer_state is None
    ctx.render(1)
    assert ctx.renderer_state.key == s1.key


def test_pssmlt_splats_the_empty_slots_on_the_last_pixel():
    """JAX wraps the -1 slots before its scatter drops out-of-range ones."""
    img = torch.zeros(6, 3)
    tps._splat(img, torch.tensor([[-1, 2], [5, -1]]),
               torch.tensor([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], [[7.0, 8.0, 9.0],
                                                                    [1.0, 1.0, 1.0]]]))
    assert img[5].tolist() == [9.0, 11.0, 13.0] and img[2].tolist() == [4.0, 5.0, 6.0]


# ---- the cheap pieces, live against JAX ----

def _lanes(n=512, seed=4):
    r = np.random.default_rng(seed)

    def unit():
        v = r.standard_normal((3, n)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    return r, unit


def test_adjoint_corr_matches_jax():
    import jax.numpy as jnp

    from fermat_tpu.core.math import Vec3 as JV
    from fermat_tpu.integrators.bpt import _adjoint_corr

    _, unit = _lanes()
    vs = [unit() for _ in range(4)]
    got = tbpt._adjoint_corr(*(Vec3(*map(torch.from_numpy, v)) for v in vs)).numpy()
    want = np.asarray(_adjoint_corr(*(JV(*map(jnp.asarray, v)) for v in vs)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got < 8.0).any() and (got == 8.0).any()


def test_matrix_sequence_luminance_and_dims_match_jax():
    import jax.numpy as jnp

    from fermat_tpu.integrators import pssmlt as jps

    r, _ = _lanes()
    u = r.random((64, 12)).astype(np.float32)
    js, ts = jps.MatrixSequence(jnp.asarray(u)), tps.MatrixSequence(torch.from_numpy(u))
    for dim in (0, 5, 10, 11, 40):
        for a, b in zip(ts.sample_3d(None, dim), js.sample_3d(None, jnp.uint32(dim))):
            assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(ts.sample_1d(None, dim).numpy(),
                              np.asarray(js.sample_1d(None, jnp.uint32(dim))))
    c = r.random((64, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(tps._luminance(torch.from_numpy(c)).numpy(),
                               np.asarray(jps._luminance(jnp.asarray(c))), rtol=1e-6)
    for space in PS_SPACES:
        for mpl in (4, 6):
            jo = jps.PssmltOptions(max_path_length=mpl, path_space=space)
            to = tps.PssmltOptions(max_path_length=mpl, path_space=space)
            assert tps._dims(to) == jps._dims(jo)
    assert tps._dims(tps.PssmltOptions()) == 352


def test_interpolate_and_emissive_match_jax(golden, gviews):
    """MeshView.shade_fetch (the pass's one fetch of the shade table) against
    JAX's interpolate and lights._emissive_of on the panel scene's view
    (tilted shading normals), at seeded (tri, u, v); shade_fetch_ray derives
    (u, v) from the ray."""
    import jax.numpy as jnp

    from fermat_tpu.scene.lights import _emissive_of as j_emissive
    from fermat_tpu_torch.core.math import ray_barycentrics

    jmesh = panel_scene("fermat_tpu").device_view()
    view = gviews("panel")
    table = view.mesh.shade_rows()
    r, _ = _lanes()
    n, t = 512, view.mesh.n_triangles
    tri = r.integers(0, t, n).astype(np.int32)
    u = r.random(n).astype(np.float32) * 0.5
    v = r.random(n).astype(np.float32) * 0.5
    tri_t = torch.from_numpy(tri)
    sh = view.mesh.shade_fetch(tri_t, torch.from_numpy(u), torch.from_numpy(v), table)
    want = jmesh.interpolate(jnp.asarray(tri), jnp.asarray(u), jnp.asarray(v))
    flat = lambda x: [x] if not isinstance(x, tuple) else list(x)
    for g, w in zip((sh.pos, sh.gn, sh.sn, sh.uv, sh.mat_id), want):
        for a, b in zip(flat(g), flat(w)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(sh.mats.emissive, j_emissive(jmesh, jnp.asarray(sh.mat_id.numpy()))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the ray-derived (u, v): a ray aimed at the lane's point finds it again
    o = Vec3(*(torch.full((n,), c) for c in (0.1, 1.0, 1.5)))
    pos = view.mesh.shade_fetch_ray(tri_t, o, sh.pos - o, table).pos
    np.testing.assert_allclose(pos.stack().numpy(), sh.pos.stack().numpy(), atol=2e-5)
    at = lambda f: Vec3(*(c[tri_t.long()] for c in f))
    ru, rv = ray_barycentrics(o, sh.pos - o, at(view.mesh.p0), at(view.mesh.e1), at(view.mesh.e2))
    np.testing.assert_allclose(ru.numpy(), u, atol=2e-5)


# ---- the golden ----

def write_golden() -> None:
    import time

    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.core.camera import Camera
    from fermat_tpu.core.rng import hash_combine
    from fermat_tpu.integrators import bpt as jbpt
    from fermat_tpu.integrators import pssmlt as jps
    from fermat_tpu.scene.procedural import big_room
    from fermat_tpu.scene.view import SceneView as JView

    def leaves(view, prefix):
        flat, _ = jax.tree_util.tree_flatten_with_path(view)
        out = {f"{prefix}.{jax.tree_util.keystr(p).lstrip('.')}": np.asarray(a) for p, a in flat}
        return {k: v for k, v in out.items()
                if not k.startswith((f"{prefix}.bvh", f"{prefix}.clusters.", f"{prefix}.vpls."))}

    def bpt_pass(view, opts, res):
        t0 = time.perf_counter()
        rad, splat, rays, sp, sr = jax.jit(lambda i: jbpt.render_pass(
            view, opts, res, res, i, SEED, return_splat_list=True))(jnp.uint32(INSTANCE))
        print(f"  {time.perf_counter() - t0:.1f} s")
        return dict(rad=np.stack([np.asarray(c) for c in rad], -1), splat=np.asarray(splat),
                    rays=float(rays), sp=np.asarray(sp), sr=np.asarray(sr))

    out = dict(res=RES, big_res=BIG_RES, max_path_length=MPL, seed=SEED, instance=INSTANCE,
               cases=json.dumps(CASES), ps_res=PS_RES, ps_chains=PS_CHAINS,
               ps_max_path_length=PS_MPL, ps_seed_candidates=PS_SEEDS)
    views = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (scene, fields) in CASES.items():
            if scene not in views:
                storage, cam, kw = build_scene(scene, "fermat_tpu", tmp)
                views[scene] = (JView.build(storage, cam, **kw),
                                tuple(bool(x) for x in scene_lobes(storage.materials)))
                out.update(leaves(views[scene][0], f"{scene}.view"))
                out[f"{scene}.lobes"] = np.asarray(views[scene][1])
            view, lobes = views[scene]
            print(f"bpt {name}")
            r = bpt_pass(view, jbpt.BPTOptions(max_path_length=MPL, lobes=lobes, **fields), RES)
            out.update({f"{name}.{k}": v for k, v in r.items()})
            print(f"{name}: rays {r['rays']}, mean {r['rad'].mean(0)}, splat {r['splat'].mean(0)}")

    # big_room(400): JAX's CPU route walks the BVH (real barycentrics); the
    # port reads the view of torch_port_bigroom_24.npz, which must be this one
    storage = big_room(400)
    view = JView.build(storage, Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0)))
    g = np.load(BIGROOM)
    for k, v in leaves(view, "view").items():
        if k in g.files:
            assert np.array_equal(g[k], v), k
    lobes = tuple(bool(x) for x in scene_lobes(storage.materials))
    print("bpt big_room")
    r = bpt_pass(view, jbpt.BPTOptions(max_path_length=MPL, lobes=lobes), BIG_RES)
    out.update({f"big_room.{k}": v for k, v in r.items()})
    out["big_room.lobes"] = np.asarray(lobes)
    print(f"big_room: rays {r['rays']}, mean {r['rad'].mean(0)}")

    # PSSMLT op by op: XLA:CPU compiles the jitted two-candidate seed pass
    # for more than 15 minutes, while it runs eagerly in about 40 s
    view = views["A"][0]
    for space in PS_SPACES:
        opts = jps.PssmltOptions(max_path_length=PS_MPL, n_seed_candidates=PS_SEEDS,
                                 path_space=space)
        t0 = time.perf_counter()
        st = jps.init_state(view, opts, PS_RES, PS_RES, PS_CHAINS, SEED)
        new, splat = jps.step(view, opts, PS_RES, PS_RES, st)
        u_prop = jps._mutate(st.u, hash_combine(st.key, jnp.uint32(0x1234567)), opts)
        print(f"pssmlt {space}: {time.perf_counter() - t0:.1f} s, brightness "
              f"{float(st.brightness)}, accepted "
              f"{float(np.mean(np.all(np.asarray(new.u) == np.asarray(u_prop), 1)))}")
        for pre, s in (("init", st), ("step", new)):
            for f in s._fields:
                out[f"ps_{space}.{pre}.{f}"] = np.asarray(getattr(s, f))
        out[f"ps_{space}.u_prop"] = np.asarray(u_prop)
        out[f"ps_{space}.splat"] = np.asarray(splat)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden()
