"""Path-space MLT (integrators/mlt.py), charted MLT (integrators/cmlt.py),
the BSDF inversions (bsdf/inversion.py) and pt.direct_env_image of
fermat_tpu_torch against fermat_tpu.

No JAX pass runs here. The passes are held to a stored golden,
tests/golden/torch_port_mlt_24.npz, written by
`JAX_PLATFORMS=cpu python tests/test_torch_mlt.py`: JAX run under
jax.disable_jit(), so that fori_loop runs as a Python loop, with
jax.lax.fori_loop wrapped at run time (here only) to record the chain state,
the splat and the rays of each step (the BVH walk alone jitted); seed 0,
instance 0, the scene's lobes, 24x24 unless said. Cases:
  M1     mlt on JAX's test scene, cornell_box(light_scale=0.5,
         light_size=2.0, glossy_boxes=True), max_path_length=4,
         steps_per_pass=8 (steps 3 and 7 are ST swaps);
  M_env  mlt on tests/test_envmap.py's env-lit floor (an 8x16 map of 0.8,
         camera (0, 2, 2) -> origin, fov 0.7), max_path_length=3;
  C1     cmlt on the test scene, max_path_length=4, n_seed_rounds=4:
         init_state and three steps (step 2 is a chart swap);
  C_env  cmlt on the floor, max_path_length=3, n_seed_rounds=2;
  B_mlt, B_cmlt  big_room(400) at 16x16 (bench camera), max_path_length=3
         (B_mlt steps_per_pass=4, B_cmlt n_seed_rounds=1), JAX's CPU route
         walking its BVH, on the view of tests/golden/torch_port_bigroom_24.npz;
         the port renders it through the frontier tracer ((u, v) from the ray).
The M cases' image is render_pass_fb's, the C cases' the first context
pass's (step 1 plus direct_env_image).

Tolerances: the seeded chains' integer fields equal on at least 99% of
chains, their floats within atol 1e-4, rtol 1e-3 on at least 99%; each step
from JAX's stored state k makes the same accept decision (the chain's state
moved or not) on at least 99% of chains, its state as the seeded one (but
for mlt's path values, which the splat holds: a path through M1's glossy
lobe is ill-conditioned), its splat within atol 1e-4, rtol 1e-3 on at least
99% of pixels with channel means within 1e-3 relative, its rays within
0.5%; a whole pass from a fresh
state through RenderingContext within 1e-2 of the channel means (a flipped
accept test sends a chain elsewhere). The small functions are held to JAX
live within 1e-5 (2e-7 where no transcendental is involved) on at least
99.9% of lanes.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.bsdf import inversion as tinv  # noqa: E402
from fermat_tpu_torch.bsdf.composite import BsdfParams  # noqa: E402
from fermat_tpu_torch.bsdf.composite import sample as tsample  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import cmlt as tcm  # noqa: E402
from fermat_tpu_torch.integrators import mlt as tmlt  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext, _RENDERER_REGISTRY  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_mlt_24.npz")
BIGROOM = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
RES, BIG_RES, SEED, INSTANCE = 24, 16, 0, 0
ENV_H, ENV_W, ENV_VALUE = 8, 16, 0.8
C_STEPS = 3
# name: (scene, renderer, options beyond the lobes)
CASES = {
    "M1": ("cornell", "mlt", {"max_path_length": 4, "steps_per_pass": 8}),
    "M_env": ("floor_env", "mlt", {"max_path_length": 3, "steps_per_pass": 8}),
    "C1": ("cornell", "cmlt", {"max_path_length": 4, "n_seed_rounds": 4}),
    "C_env": ("floor_env", "cmlt", {"max_path_length": 3, "n_seed_rounds": 2}),
    "B_mlt": ("big_room", "mlt", {"max_path_length": 3, "steps_per_pass": 4}),
    "B_cmlt": ("big_room", "cmlt", {"max_path_length": 3, "n_seed_rounds": 1}),
}
M_CASES = [n for n, c in CASES.items() if c[1] == "mlt"]
C_CASES = [n for n, c in CASES.items() if c[1] == "cmlt"]


def build_scene(key: str, pkg: str):
    """(storage, camera, SceneView.build keywords) of scene `key` with the
    package `pkg` ("fermat_tpu" or "fermat_tpu_torch")."""
    import importlib

    proc = importlib.import_module(pkg + ".scene.procedural")
    cam = importlib.import_module(pkg + ".core.camera")
    if key == "floor_env":
        return (proc.floor_quad(1.0, (0.6, 0.6, 0.6)),
                cam.Camera.create((0, 2.0, 2.0), (0, 0, 0), (0, 1, 0), 0.7),
                {"env_map": np.full((ENV_H, ENV_W, 3), ENV_VALUE, np.float32)})
    return (proc.cornell_box(light_scale=0.5, light_size=2.0, glossy_boxes=True),
            proc.cornell_camera(), {})


def _res(name: str) -> int:
    return BIG_RES if CASES[name][0] == "big_room" else RES


# ---- tolerances ----

def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


def assert_rays(got: float, want: float) -> None:
    assert abs(got - want) <= 0.005 * want, (got, want)


def _per_chain(a: np.ndarray) -> np.ndarray:
    return a.reshape(a.shape[0], -1)


def assert_state_close(got: tuple, golden, prefix: str, skip=()) -> None:
    """Integer and bool fields equal on >= 99% of chains, float fields within
    atol 1e-4, rtol 1e-3 on >= 99%; scalars equal (the keys and the step)
    or within 1e-5 (the brightness). Fields in `skip` are not compared."""
    for f in got._fields:
        if f in skip:
            continue
        a, b = getattr(got, f), golden[f"{prefix}.{f}"]
        if not isinstance(a, torch.Tensor):
            assert int(a) == int(b), (prefix, f, a, b)
            continue
        a = a.numpy()
        if a.ndim == 0:
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f"{prefix}.{f}")
        elif a.dtype.kind in "iub":
            same = (_per_chain(a) == _per_chain(b.astype(a.dtype))).all(axis=1).mean()
            assert same >= 0.99, f"{prefix}.{f}: equal on {same:.4f} of chains"
        else:
            near = np.isclose(_per_chain(a), _per_chain(b), atol=1e-4, rtol=1e-3).all(axis=1)
            assert near.mean() >= 0.99, f"{prefix}.{f}: close on {near.mean():.4f} of chains"


def _moved(new: tuple, old: tuple) -> np.ndarray:
    """(N,) whether a chain's state changed in a step (its accept decision)."""
    out = None
    for f in new._fields:
        a, b = getattr(new, f), getattr(old, f)
        if isinstance(a, torch.Tensor) and a.ndim:
            m = (_per_chain(a.numpy()) != _per_chain(b.numpy())).any(axis=1)
            out = m if out is None else out | m
    return out


def assert_same_decisions(new, old, want_new, want_old) -> None:
    same = (_moved(new, old) == _moved(want_new, want_old)).mean()
    assert same >= 0.99, f"the same accept decision on only {same:.4f} of chains"


# ---- the golden ----

@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def gview(golden):
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


def _opts(golden, name):
    scene, renderer, fields = CASES[name]
    lobes = tuple(bool(x) for x in golden[f"{scene}.lobes"])
    cls = tmlt.MLTOptions if renderer == "mlt" else tcm.CMLTOptions
    return cls(lobes=lobes, **fields)


def _mlt_state(golden, name, k) -> tmlt.ChainState:
    return tmlt.ChainState.from_numpy(
        {f: golden[f"{name}.{k}.{f}"] for f in tmlt.ChainState._fields}, "cpu")


def _cmlt_state(golden, name, k) -> tcm.CMLTState:
    return tcm.CMLTState.from_numpy(
        {f: golden[f"{name}.{k}.{f}"] for f in tcm.CMLTState._fields}, "cpu")


def test_golden_cases_are_the_documented_ones(golden):
    """The golden was written for CASES, and its env cases hold chains that
    end on the environment (MLT's s = -1 seeds, CMLT's (-1, t) charts)."""
    assert json.loads(str(golden["cases"])) == {k: list(v) for k, v in CASES.items()}
    assert (golden["M_env.0.env"]).any()
    assert (golden["C_env.0.s"] < 0).any()


@pytest.mark.parametrize("name", M_CASES)
def test_mlt_presample_matches_jax(golden, gview, name):
    """The seeded chains (phases 1 and 2) and the presample's rays."""
    view, res = gview(CASES[name][0]), _res(name)
    state, rays = tmlt.presample(view, _opts(golden, name), res, res, INSTANCE, SEED)
    assert_state_close(state, golden, f"{name}.0")
    assert_rays(float(rays), float(golden[f"{name}.0.rays"]))


@pytest.mark.parametrize("name", M_CASES)
def test_mlt_steps_match_jax(golden, gview, name):
    """Each step k from JAX's stored state k (perturbations and ST swaps):
    the accept decisions, the new state, the splat and the rays."""
    view, res = gview(CASES[name][0]), _res(name)
    opts = _opts(golden, name)
    swaps = 0
    for k in range(opts.steps_per_pass):
        old = _mlt_state(golden, name, k)
        new, splat, rays = tmlt.step(view, opts, res, res, INSTANCE, SEED, old, k)
        assert_same_decisions(new, old, _mlt_state(golden, name, k + 1), old)
        # a path's value through M1's 0.025-roughness lobe moves by up to
        # 2.5x when a stored barycentric moves by 1e-7 (measured on the
        # port), so the values are held through the splat, which divides
        # them by their luminance
        assert_state_close(new, golden, f"{name}.{k + 1}", skip=("val_x", "val_y", "val_z"))
        assert_image_close(splat.numpy(), golden[f"{name}.{k + 1}.splat"])
        want = float(golden[f"{name}.{k + 1}.rays"])
        if tmlt.is_swap_step(opts, k):
            swaps += 1
            assert float(rays) == want == 0.0
        else:
            assert_rays(float(rays), want)
    assert swaps == opts.steps_per_pass // opts.st_swap_frequency


@pytest.mark.parametrize("name", C_CASES)
def test_cmlt_init_state_matches_jax(golden, gview, name):
    view, res = gview(CASES[name][0]), _res(name)
    state = tcm.init_state(view, _opts(golden, name), res, res, res * res, SEED)
    assert_state_close(state, golden, f"{name}.0")


@pytest.mark.parametrize("name", C_CASES)
def test_cmlt_steps_match_jax(golden, gview, name):
    """Each step from JAX's stored state k (mutations and a chart swap)."""
    view, res = gview(CASES[name][0]), _res(name)
    opts = _opts(golden, name)
    for k in range(C_STEPS):
        old = _cmlt_state(golden, name, k)
        new, splat, rays = tcm.step(view, opts, res, res, old)
        assert_same_decisions(new, old, _cmlt_state(golden, name, k + 1), old)
        assert_state_close(new, golden, f"{name}.{k + 1}")
        assert_image_close(splat.numpy(), golden[f"{name}.{k + 1}.splat"])
        assert_rays(float(rays), float(golden[f"{name}.{k + 1}.rays"]))
    assert tcm.is_swap_step(opts, C_STEPS - 1)


@pytest.mark.parametrize("name", ["M1", "M_env", "C1", "C_env"])
def test_context_pass_matches_jax(golden, name):
    """One pass from a fresh state through RenderingContext: COMPOSITED
    (the chains' image plus the directly visible environment) within 1e-2
    of the golden pass's channel means, and its rays within 0.5%."""
    scene, renderer, fields = CASES[name]
    storage, cam, kw = build_scene(scene, "fermat_tpu_torch")
    ctx = RenderingContext.create(storage, cam, RES, RES, renderer=renderer, device="cpu",
                                  **kw, **fields)
    assert tuple(ctx.renderer_options["lobes"]) == _opts(golden, name).lobes
    ctx.render(1)
    got = ctx.hdr_image().reshape(-1, 3).mean(axis=0)
    want = golden[f"{name}.pass.img"].mean(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-2)
    assert_rays(float(ctx.gbuffer["rays"]), float(golden[f"{name}.pass.rays"]))


def test_cmlt_context_carries_its_chains_and_restart_drops_them():
    storage, cam, _ = build_scene("cornell", "fermat_tpu_torch")
    ctx = RenderingContext.create(storage, cam, 8, 8, renderer="cmlt", device="cpu",
                                  max_path_length=3, n_seed_rounds=1)
    ctx.render(2)
    first = ctx.renderer_state
    assert first.step_idx == 2 and first.u_e.shape == (64, tcm._dims_e(3))
    ctx.render_batch(1)
    assert ctx.renderer_state.step_idx == 3
    assert np.isfinite(ctx.hdr_image()).all() and ctx.hdr_image().mean() > 0.0
    ctx.restart()
    assert ctx.renderer_state is None and ctx.instance == 0
    ctx.render(1)
    assert ctx.renderer_state.step_idx == 1


def test_registry_lists_the_seven_ported_renderers():
    """JAX's eight renderers (rpt since the reuse tracer's slice; the test
    keeps its name); mlt's pass holds no state between passes (JAX's
    render_pass_fb), cmlt's carries its chains (context.py:65-101)."""
    assert sorted(_RENDERER_REGISTRY) == ["bpt", "cmlt", "mlt", "psfpt", "pssmlt", "pt", "ptrl",
                                         "rpt"]
    mlt_pass, mlt_opts = _RENDERER_REGISTRY["mlt"]()
    cmlt_pass, cmlt_opts = _RENDERER_REGISTRY["cmlt"](n_seed_rounds=2)
    assert mlt_pass is tmlt.render_pass_fb and mlt_opts == tmlt.MLTOptions()
    assert cmlt_pass.stateful and cmlt_opts == tcm.CMLTOptions(n_seed_rounds=2)


def test_mlt_and_cmlt_refuse_the_megakernel(gview):
    view = gview("cornell")
    with pytest.raises(NotImplementedError, match="MLT"):
        tmlt.render_pass(view, tmlt.MLTOptions(tracer="mega"), 4, 4, 0)
    with pytest.raises(NotImplementedError, match="CMLT"):
        tcm.init_state(view, tcm.CMLTOptions(tracer="mega", n_seed_rounds=1), 4, 4, 16)


# ---- the small functions, held to JAX live ----

def _lanes(n, seed):
    r = np.random.default_rng(seed)

    def unit(z_min=-1.0):
        v = r.standard_normal((3, n)).astype(np.float32)
        v[2] = np.maximum(v[2], z_min)
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    return r, unit


def _tv(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _jv(a):
    import jax.numpy as jnp

    from fermat_tpu.core.math import Vec3 as JV

    return JV(*(jnp.asarray(c) for c in a))


def _close(got, want, atol=1e-5, frac=0.999):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    near = np.isclose(got, want, atol=atol, rtol=atol) | ((got == want) | (
        np.isnan(got) & np.isnan(want)))
    assert near.mean() >= frac, f"{near.mean():.5f} of lanes within {atol}"


def _close3(got: Vec3, want, atol=1e-5):
    for a, b in zip(got, want):
        _close(a.numpy(), b, atol)


def test_perturbation_kernels_match_jax():
    """bounded_exp_map, exp_spherical_perturbation, h_perturbation (reflection
    and transmission, both sides) and h_perturbation_density on 4,096 lanes."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators import mlt as jm

    n = 4096
    r, unit = _lanes(n, 3)
    u = r.random(n).astype(np.float32)
    z0, z1 = r.random(n).astype(np.float32), r.random(n).astype(np.float32)
    _close(tmlt.bounded_exp_map(torch.from_numpy(u), 1e-4, 0.1).numpy(),
           jax.jit(lambda x: jm.bounded_exp_map(x, 1e-4, 0.1))(jnp.asarray(u)))
    d = unit()
    _close3(tmlt.exp_spherical_perturbation(_tv(d), torch.from_numpy(z0), torch.from_numpy(z1),
                                            0.1),
            jax.jit(lambda a, b, c: jm.exp_spherical_perturbation(a, b, c, 0.1))(
                _jv(d), jnp.asarray(z0), jnp.asarray(z1)))
    win, wout, nrm, new_in, new_n = unit(), unit(), unit(), unit(), unit()
    eta = np.where(r.random(n) < 0.5, 1.0 / 1.5, 1.5).astype(np.float32)
    eta2 = np.where(r.random(n) < 0.5, 1.0 / 1.3, 1.3).astype(np.float32)
    t = lambda a: torch.from_numpy(a)
    _close3(tmlt.h_perturbation(_tv(win), _tv(wout), _tv(nrm), t(eta), _tv(new_in), _tv(new_n),
                                t(eta2), t(z0), t(z1), 0.05),
            jax.jit(lambda *a: jm.h_perturbation(*a, 0.05))(
                _jv(win), _jv(wout), _jv(nrm), jnp.asarray(eta), _jv(new_in), _jv(new_n),
                jnp.asarray(eta2), jnp.asarray(z0), jnp.asarray(z1)))
    got = tmlt.h_perturbation_density(_tv(win), _tv(wout), _tv(nrm), t(eta)).numpy()
    want = np.asarray(jax.jit(jm.h_perturbation_density)(_jv(win), _jv(wout), _jv(nrm),
                                                          jnp.asarray(eta)))
    _close(got, want)
    assert (got > 0).all()


def test_rand_matches_jax_and_wraps_in_32_bits():
    """_Rand.u at steps whose step * 4096 + dim passes 2^32: equal bits."""
    import jax.numpy as jnp

    from fermat_tpu.integrators import mlt as jm

    n = 1000
    tr = tmlt._Rand.create(7, 3, n, "cpu")
    jr = jm._Rand.create(7, jnp.uint32(3), n)
    for step, dim in ((0, 0), (5, 999), (2 ** 20 + 3, 771), (2 ** 31 - 1, 4095)):
        assert np.array_equal(tr.u(step, dim).numpy(), np.asarray(jr.u(jnp.uint32(step), dim)))


def test_direct_env_image_matches_jax():
    """On the env-lit floor: the misses' radiance and n rays; on the
    CornellBox (no environment): zeros and no rays, without tracing."""
    from fermat_tpu.integrators import pt as jpt
    from fermat_tpu.scene.view import SceneView as JView

    import jax

    storage, cam, kw = build_scene("floor_env", "fermat_tpu")
    jview = JView.build(storage, cam, **kw)
    jimg, jrays = jax.jit(lambda: jpt.direct_env_image(jview, 16, 12, 5, 2))()
    storage, cam, kw = build_scene("floor_env", "fermat_tpu_torch")
    img, rays = tpt.direct_env_image(SceneView.build(storage, cam, "cpu", **kw), 16, 12, 5, 2)
    _close(img.numpy(), np.asarray(jimg), frac=1.0)
    assert float(rays) == float(jrays) == 192.0 and img.numpy().max() > 0.5
    # no environment: JAX returns zeros and no rays (pt.py:452-456); the
    # port decides it on the host, before any trace (a mesh-less view)
    storage, cam, _ = build_scene("cornell", "fermat_tpu_torch")
    view = SceneView.build(storage, cam, "cpu")._replace(mesh=None)
    img, rays = tpt.direct_env_image(view, 16, 12, 5, 2)
    assert not img.any() and img.shape == (192, 3) and float(rays) == 0.0


def _bsdf_params(n, r, torch_side: bool):
    """Seeded composite parameters: diffuse, glossy and glass-like lanes."""
    kind = r.integers(0, 3, n)
    diffuse = np.where(kind == 0, 0.7, np.where(kind == 1, 0.3, 0.0)).astype(np.float32)
    opacity = np.where(kind == 2, 0.0, 1.0).astype(np.float32)
    spec = np.full(n, 0.8, np.float32)
    rough = r.uniform(0.1, 0.8, n).astype(np.float32)
    ior = np.full(n, 1.5, np.float32)
    zero = np.zeros(n, np.float32)
    if torch_side:
        v = lambda a: Vec3(*(torch.from_numpy(a),) * 3)
        s = torch.from_numpy
        return BsdfParams(v(diffuse), v(zero), v(spec), s(rough), s(ior), s(opacity), v(zero))
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import BsdfParams as JP
    from fermat_tpu.core.math import Vec3 as JV

    v = lambda a: JV(*(jnp.asarray(a),) * 3)
    return JP(diffuse=v(diffuse), diffuse_trans=v(zero), specular=v(spec),
              roughness=jnp.asarray(rough), ior=jnp.asarray(ior), opacity=jnp.asarray(opacity))


def test_inversion_functions_match_jax():
    """Every map of bsdf/inversion.py on 4,096 lanes against JAX's:
    invert_cosine_hemisphere, invert_vndf, invert_ggx_reflect and _refract,
    classify_component (equal lobes) and invert (the attributed lobe equal,
    u0, u1, u2 and pdf within 1e-5, ok equal)."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf import inversion as jinv

    n = 4096
    r, unit = _lanes(n, 5)
    wo, wi, h = unit(), unit(0.05), unit(0.05)
    t = torch.from_numpy
    j = jnp.asarray
    for a, b in zip(tinv.invert_cosine_hemisphere(_tv(wo)),
                    jax.jit(jinv.invert_cosine_hemisphere)(_jv(wo))):
        _close(a.numpy(), b)
    alpha = r.uniform(0.01, 0.7, n).astype(np.float32)
    ior = np.full(n, 1.5, np.float32)
    for tf, jf, args in (
            (tinv.invert_vndf, jinv.invert_vndf, (wi, h)),
            (tinv.invert_ggx_reflect, jinv.invert_ggx_reflect, (wi, wo)),
            (lambda al, a, b: tinv.invert_ggx_refract(al, t(ior), a, b),
             lambda al, a, b: jinv.invert_ggx_refract(al, j(ior), a, b), (wi, wo))):
        got = tf(t(alpha), *map(_tv, args))
        want = jax.jit(jf)(j(alpha), *map(_jv, args))
        for a, b in zip(got, want):
            _close(a.numpy(), b)
    tp, jp = _bsdf_params(n, np.random.default_rng(6), True), _bsdf_params(
        n, np.random.default_rng(6), False)
    uc, us = r.random(n).astype(np.float32), r.random(n).astype(np.float32)
    comp = tinv.classify_component(tp, _tv(wi), _tv(wo), t(uc)).numpy()
    jcomp = np.asarray(jax.jit(jinv.classify_component)(jp, _jv(wi), _jv(wo), j(uc)))
    assert (comp == jcomp).mean() >= 0.999
    got = tinv.invert(tp, _tv(wi), _tv(wo), t(uc), t(us))
    want = jax.jit(jinv.invert)(jp, _jv(wi), _jv(wo), j(uc), j(us))
    same = got.component.numpy() == np.asarray(want.component)
    assert same.mean() >= 0.999
    assert (got.ok.numpy() == np.asarray(want.ok))[same].mean() >= 0.999
    for f in ("u0", "u1", "u2", "pdf"):
        _close(getattr(got, f).numpy()[same], np.asarray(getattr(want, f))[same])


@pytest.mark.parametrize("kind,rough", [
    ("cosine", None), ("vndf", 0.1), ("vndf", 0.35), ("vndf", 0.8), ("reflect", 0.15),
    ("reflect", 0.5), ("refract", 0.3), ("composite", 0.35), ("composite_pdf", 0.4)])
def test_inversion_round_trips(kind, rough):
    """tests/test_inversion.py's round trips and bounds on the port, its
    cases and thresholds: sample, invert, sample again gives the same
    sample coordinates, half vector or direction (and lobe); the inversion's
    pdf stays within the mixture's."""
    from fermat_tpu_torch.bsdf import ggx
    from fermat_tpu_torch.core.sampling import square_to_cosine_hemisphere

    n = 2048
    g = torch.Generator().manual_seed(17)
    rnd = lambda: torch.rand(n, generator=g)
    dot = lambda a, b: (a.x * b.x + a.y * b.y + a.z * b.z).numpy()
    wi = square_to_cosine_hemisphere(rnd(), rnd())
    u0, u1 = rnd(), rnd()
    if kind == "cosine":
        r0, r1, ok = tinv.invert_cosine_hemisphere(square_to_cosine_hemisphere(u0, u1))
        assert bool(ok.all())
        np.testing.assert_allclose(r0.numpy(), u0.numpy(), atol=2e-5)
        np.testing.assert_allclose(r1.numpy(), u1.numpy(), atol=2e-5)
        return
    alpha = torch.full((n,), rough * rough)
    if kind == "vndf":
        h = ggx.sample_vndf(alpha, wi, u0, u1)
        r0, r1, ok = tinv.invert_vndf(alpha, wi, h)
        okn = ok.numpy()
        assert okn.mean() > 0.99
        assert (1.0 - dot(h, ggx.sample_vndf(alpha, wi, r0, r1))[okn]).max() < 1e-4
    elif kind == "reflect":
        wo, pdf = ggx.reflect_sample(alpha, wi, u0, u1)
        r0, r1, ok = tinv.invert_ggx_reflect(alpha, wi, wo)
        m = (pdf > 0).numpy() & ok.numpy()
        assert m.mean() > 0.9
        assert (1.0 - dot(wo, ggx.reflect_sample(alpha, wi, r0, r1)[0])[m]).max() < 1e-4
    elif kind == "refract":
        ior = torch.full((n,), 1.5)
        wo, pdf = ggx.refract_sample(alpha, ior, wi, u0, u1)
        r0, r1, ok = tinv.invert_ggx_refract(alpha, ior, wi, wo)
        wo2, pdf2 = ggx.refract_sample(alpha, ior, wi, r0, r1)
        m = (pdf > 0).numpy() & ok.numpy() & (pdf2 > 0).numpy()
        assert m.mean() > 0.85
        assert (1.0 - dot(wo, wo2)[m]).max() < 1e-4
    else:
        c = lambda v: torch.full((n,), v)
        v3 = lambda v: Vec3(c(v), c(v), c(v))
        p = BsdfParams(v3(0.5), v3(0.0), v3(0.8), c(rough), c(1.5), c(1.0), v3(0.0))
        s = tsample(p, wi, u0, u1, rnd())
        inv = tinv.invert(p, wi, s.wo, rnd(), rnd())
        if kind == "composite":
            s2 = tsample(p, wi, inv.u0, inv.u1, inv.u2)
            m = (s.valid & inv.ok & s2.valid & (inv.component == s2.component)).numpy()
            assert m.mean() > 0.9
            assert (1.0 - dot(s.wo, s2.wo)[m]).max() < 5e-4
        else:
            mv = (s.valid & inv.ok).numpy()
            assert (inv.pdf.numpy()[mv] <= s.pdf.numpy()[mv] * (1 + 1e-3) + 1e-6).all()


def test_cmlt_mutate_and_dims_match_jax():
    """_dims_l / _dims_e for K = 3..8, and _mutate on (1,000, 14): equal
    large steps, the small steps within 2e-7 (exp and log round apart)."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators import cmlt as jc

    for K in range(3, 9):
        assert (tcm._dims_l(K), tcm._dims_e(K)) == (jc._dims_l(K), jc._dims_e(K))
        assert tcm.charts(K)[:3] == [(0, 2), (1, 2), (2, 2)]
    u = np.random.default_rng(9).random((1000, 14)).astype(np.float32)
    opts = tcm.CMLTOptions()
    for key in (0x1234, 0xDEADBEEF):
        got = tcm._mutate(torch.from_numpy(u), key, opts).numpy()
        want = np.asarray(jax.jit(lambda x, k: jc._mutate(x, k, jc.CMLTOptions()))(
            jnp.asarray(u), jnp.uint32(key)))
        _close(got, want, atol=2e-7, frac=1.0)
        assert ((got == u).all(axis=1) == (want == u).all(axis=1)).all()


# ---- the golden writer ----

def write_golden() -> None:
    import time

    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.core.camera import Camera
    from fermat_tpu.integrators import cmlt as jc
    from fermat_tpu.integrators import mlt as jm
    from fermat_tpu.integrators import pt as jpt
    from fermat_tpu.scene.procedural import big_room
    from fermat_tpu.scene.view import SceneView as JView

    def leaves(view, prefix):
        flat, _ = jax.tree_util.tree_flatten_with_path(view)
        out = {f"{prefix}.{jax.tree_util.keystr(p).lstrip('.')}": np.asarray(a) for p, a in flat}
        return {k: v for k, v in out.items()
                if not k.startswith((f"{prefix}.bvh", f"{prefix}.clusters.", f"{prefix}.vpls."))}

    def put_state(st, prefix):
        for f in st._fields:
            out[f"{prefix}.{f}"] = np.asarray(getattr(st, f))

    # MLT's chain steps: fori_loop as a Python loop that records each step's
    # state, splat and rays (the body adds into a zero splat and count, which
    # this loop sums as the pass's carry)
    orig = jax.lax.fori_loop
    record = []

    def fori(lo, hi, body, init):
        if not (isinstance(init, tuple) and len(init) == 3
                and isinstance(init[0], jm.ChainState)):
            return orig(lo, hi, body, init)
        record.append(init)
        carry = init
        for i in range(lo, hi):
            st, sp, nr = carry
            res = body(i, (st, jnp.zeros_like(sp), jnp.zeros_like(nr)))
            record.append(res)
            carry = (res[0], sp + res[1], nr + res[2])
        return carry

    # the BVH walk (big_room's route on the CPU) jitted even under
    # disable_jit: op by op a closest trace of 256 rays takes ~35 s
    def jitted(fn):
        fast = jax.jit(fn)

        def call(*args):
            with jax.disable_jit(False):
                return fast(*args)
        return call

    walks = {k: getattr(jpt, k) for k in ("trace_closest", "trace_any")}
    out = dict(res=RES, big_res=BIG_RES, seed=SEED, cases=json.dumps(CASES))
    views = {}
    jax.lax.fori_loop = fori
    for k, fn in walks.items():
        setattr(jpt, k, jitted(fn))
    try:
        for name, (scene, renderer, fields) in CASES.items():
            if scene not in views:
                if scene == "big_room":
                    storage = big_room(400)
                    view = JView.build(storage, Camera.create(eye=(0.0, 3.0, 10.0),
                                                              aim=(0.0, 1.5, 0.0)))
                    g = np.load(BIGROOM)
                    for k, v in leaves(view, "view").items():
                        if k in g.files:
                            assert np.array_equal(g[k], v), k
                else:
                    storage, cam, kw = build_scene(scene, "fermat_tpu")
                    view = JView.build(storage, cam, **kw)
                    out.update(leaves(view, f"{scene}.view"))
                lobes = tuple(bool(x) for x in scene_lobes(storage.materials))
                views[scene] = (view, lobes)
                out[f"{scene}.lobes"] = np.asarray(lobes)
            view, lobes = views[scene]
            res = BIG_RES if scene == "big_room" else RES
            t0 = time.perf_counter()
            with jax.disable_jit():
                if renderer == "mlt":
                    record.clear()
                    o = jm.render_pass_fb(view, jm.MLTOptions(lobes=lobes, **fields), res, res,
                                          jnp.uint32(INSTANCE), SEED)
                    put_state(record[0][0], f"{name}.0")
                    out[f"{name}.0.rays"] = float(record[0][2])
                    for k, (st, sp, nr) in enumerate(record[1:]):
                        put_state(st, f"{name}.{k + 1}")
                        out[f"{name}.{k + 1}.splat"] = np.asarray(sp)
                        out[f"{name}.{k + 1}.rays"] = float(nr)
                    out[f"{name}.pass.img"] = np.stack([np.asarray(c) for c in o.composited],
                                                       -1)
                    out[f"{name}.pass.rays"] = float(o.rays)
                else:
                    opts = jc.CMLTOptions(lobes=lobes, **fields)
                    st = jc.init_state(view, opts, res, res, res * res, SEED)
                    put_state(st, f"{name}.0")
                    for k in range(C_STEPS):
                        st, sp, nr = jc.step(view, opts, res, res, st)
                        put_state(st, f"{name}.{k + 1}")
                        out[f"{name}.{k + 1}.splat"] = np.asarray(sp)
                        out[f"{name}.{k + 1}.rays"] = float(nr)
                        if k == 0:  # the context's first pass (context.py:70-84)
                            env_img, env_rays = jpt.direct_env_image(view, res, res,
                                                                     jnp.uint32(INSTANCE), SEED)
                            out[f"{name}.pass.img"] = np.asarray(sp + env_img)
                            out[f"{name}.pass.rays"] = float(nr + env_rays)
            print(f"{name}: {time.perf_counter() - t0:.1f} s, pass mean "
                  f"{out[f'{name}.pass.img'].mean(0)}, rays {out[f'{name}.pass.rays']}")
    finally:
        jax.lax.fori_loop = orig
        for k, fn in walks.items():
            setattr(jpt, k, fn)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    t_all = time.perf_counter()
    write_golden()
    print(f"{time.perf_counter() - t_all:.1f} s")
