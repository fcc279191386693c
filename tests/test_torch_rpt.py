"""The reuse path tracer (integrators/rpt.py) of fermat_tpu_torch against
fermat_tpu.

JAX's rpt pass is held to a stored golden, tests/golden/torch_port_rpt_24.npz,
written by `JAX_PLATFORMS=cpu python tests/test_torch_rpt.py` (about a
minute): JAX's rpt.render_pass run op by op under jax.disable_jit() (the BVH
walk alone jitted: op by op a 256-ray walk takes ~35 s), seed 0, the scene's
lobes, 24x24 unless said. A trace function reads JAX's locals as the pass
runs: phase A's state where phase B starts (the vertices, the VPLs, alpha,
alpha2, x_valid, y_valid and the radiance), the tile offsets and each reuse
sample's k_pick. Cases:
  R1     cornell_box(light_scale=0.5, light_size=2.0, glossy_boxes=True),
         max_path_length=4, instances 0 and 3 (the roll offset changes);
  R_opts R1's scene with direct_lighting_nee=False, visible_lights=False,
         rr=False, 8x2 tiles, reuse_shadow_samples=3;
  R_env  tests/test_envmap.py's env-lit floor quad (an 8x16 map of 0.8,
         camera (0, 2, 2) -> origin, fov 0.7), max_path_length=2;
  B_rpt  big_room(400) at 16x16 (bench camera), max_path_length=3, JAX's
         CPU route walking its BVH, on the view of
         tests/golden/torch_port_bigroom_24.npz; the port renders it
         through the frontier tracer ((u, v) from the ray).
Tolerances: x_valid, y_valid and each sample's k_pick equal on at least 99%
of lanes; alpha, alpha2 and phase A's radiance within atol 1e-4, rtol 1e-3
on at least 99% of pixels, with channel means within 1e-3 relative; the
tile offsets equal; the rays within 0.5%. The reuse (rpt.reuse) run from
JAX's own phase-A state gives JAX's picks on at least 99% of lanes and its
image within the same tolerance as phase A's radiance. The whole pass's
image, its reuse run from the port's own phase A, is held to at least 98%
of pixels within atol 1e-4, rtol 1e-3 and channel means within 2e-3
relative. Phase A differs from JAX's by ulps from the first ray on (XLA's
CPU rsqrt is not correctly rounded, torch's is: the camera directions of R1
are bit-equal on 29-54% of lanes), and the pairwise terms are
ill-conditioned (a VPL beside its receiver, a near-mirror lobe at the VPL):
one-ulp differences move a few pixels past 1e-3, and JAX's own jitted pass
agrees with its op-by-op pass on 98.4% (instance 0) and 98.1% (instance 3)
of R1's pixels at that tolerance; one pick that flips at a CDF boundary
moves a channel mean of a 24x24 image by up to 1.3e-3 (R1, instance 3).
The small functions (_lum,
the tile offsets, the sequential sum and prefix sum) are held to JAX live,
bit for bit.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.bsdf.composite import BsdfParams, f_and_pdf, f_split  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import rpt as trpt  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_rpt_24.npz")
BIGROOM = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
RES, BIG_RES, SEED = 24, 16, 0
ENV_H, ENV_W, ENV_VALUE = 8, 16, 0.8
# name: (scene, RPTOptions fields beyond the lobes, instances)
CASES = {
    "R1": ("cornell", {"max_path_length": 4}, (0, 3)),
    "R_opts": ("cornell", {"max_path_length": 4, "direct_lighting_nee": False,
                           "visible_lights": False, "rr": False, "tile_w": 8, "tile_h": 2,
                           "reuse_shadow_samples": 3}, (0,)),
    "R_env": ("floor_env", {"max_path_length": 2}, (0,)),
    "B_rpt": ("big_room", {"max_path_length": 3}, (0,)),
}
RUNS = [(n, i) for n, c in CASES.items() for i in c[2]]
# phase A's state where phase B starts: JAX's local name, the PhaseA field
STATE_VEC = {"radiance": "radiance", "x_pos": "x_pos", "x_gn": "x_gn", "x_sn": "x_sn",
             "wi": "x_wi", "y_pos": "y_pos", "y_sn": "y_sn", "in_dir": "in_dir",
             "in_dir2": "in_dir2", "alpha": "alpha", "alpha2": "alpha2"}
PARAM_VEC = ("diffuse", "diffuse_trans", "specular")
PARAM_SCALAR = ("roughness", "ior", "opacity")


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


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


def assert_pass_image_close(got: np.ndarray, want: np.ndarray) -> None:
    """The whole pass's image (see the module docstring)."""
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.98, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=2e-3, atol=1e-7)


def assert_mostly_equal(got: np.ndarray, want: np.ndarray, what: str) -> None:
    same = (got == want).mean()
    assert same >= 0.99, f"{what}: equal on {same:.4f} of lanes"


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
    scene, fields, _ = CASES[name]
    return trpt.RPTOptions(lobes=tuple(bool(x) for x in golden[f"{scene}.lobes"]), **fields)


def _view_res(gview, name):
    scene = CASES[name][0]
    return gview(scene), (BIG_RES if scene == "big_room" else RES)


def _assert_picks(golden, p, name, picks_got):
    picks = golden[p + "k_pick"]
    assert len(picks_got) == picks.shape[0] == CASES[name][1].get("reuse_shadow_samples", 2)
    for s, kp in enumerate(picks_got):
        assert_mostly_equal(kp.numpy(), picks[s], f"k_pick sample {s}")


@pytest.mark.parametrize("name,instance", RUNS)
def test_rpt_pass_matches_jax_golden(golden, gview, name, instance):
    """Phase A's state, the tile offsets, every sample's pick, the image
    and the rays of one pass against JAX's."""
    view, res = _view_res(gview, name)
    rec = {}
    rad, rays, rays_lane = trpt.render_pass(view, _opts(golden, name), res, res, instance,
                                            SEED, record=rec)
    p = f"{name}.{instance}."
    a = rec["phase_a"]
    assert rec["offsets"] == tuple(int(x) for x in golden[p + "offsets"])
    for f in ("x_valid", "y_valid"):
        assert_mostly_equal(getattr(a, f).numpy(), golden[p + f], f)
    for f in ("alpha", "alpha2", "radiance"):
        assert_image_close(getattr(a, f).stack().numpy(), golden[p + f])
    _assert_picks(golden, p, name, rec["k_pick"])
    assert_pass_image_close(rad.stack().numpy(), golden[p + "img"])
    want = float(golden[p + "rays"])
    assert abs(float(rays) - want) <= 0.005 * want, (float(rays), want)
    assert float(rays_lane.sum()) == float(rays)


def _jax_phase_a(golden, p: str) -> "trpt.PhaseA":
    """JAX's phase-A state of run p as a PhaseA (no clearcoat)."""
    t = lambda k: torch.from_numpy(golden[p + k])
    v3 = lambda k: Vec3(*t(k).unbind(-1))

    def params(side):
        q = f"{side}_params."
        zero = torch.zeros_like(t(q + "roughness"))
        return BsdfParams(*(v3(q + f) for f in PARAM_VEC), *(t(q + f) for f in PARAM_SCALAR),
                          Vec3(zero, zero, zero))

    f = {field: v3(k) for k, field in STATE_VEC.items()}
    return trpt.PhaseA(x_params=params("x"), y_params=params("y"), x_valid=t("x_valid"),
                       y_valid=t("y_valid"), **f)


@pytest.mark.parametrize("name,instance", RUNS)
def test_reuse_from_jax_phase_a_matches_jax(golden, gview, name, instance):
    """rpt.reuse from JAX's phase-A state, traced with the port's tracers:
    JAX's picks and image."""
    view, res = _view_res(gview, name)
    opts = _opts(golden, name)
    p = f"{name}.{instance}."
    rec = {}
    seq = trpt.TiledSequence.create(SEED).set_instance(instance)
    rays = trpt._Rays(res * res, "cpu")
    rad = trpt.reuse(view, opts, trpt.pt_mod.view_tracers(view, opts.tracer, "RPT"), seq,
                     _jax_phase_a(golden, p), res, res, instance, SEED, rays, rec)
    _assert_picks(golden, p, name, rec["k_pick"])
    assert_image_close(rad.stack().numpy(), golden[p + "img"])


def test_context_renders_rpt_with_the_scene_lobes(golden):
    """RenderingContext(renderer="rpt") on the CPU: the scene's lobes, a
    pass equal to R1's at instance 0, the image accumulated."""
    storage, cam, _ = build_scene("cornell", "fermat_tpu_torch")
    ctx = RenderingContext.create(storage, cam, RES, RES, renderer="rpt", device="cpu",
                                  max_path_length=4)
    assert tuple(ctx.renderer_options["lobes"]) == tuple(bool(x) for x in golden["cornell.lobes"])
    ctx.render(1)
    assert_image_close(ctx.hdr_image().reshape(-1, 3), golden["R1.0.img"])
    assert abs(float(ctx.gbuffer["rays"]) - float(golden["R1.0.rays"])) <= 0.005 * float(
        golden["R1.0.rays"])


def test_untiled_resolution_and_mega_raise(gview):
    view = gview("cornell")
    with pytest.raises(ValueError, match="tiles evenly"):
        trpt.render_pass(view, trpt.RPTOptions(), 10, 8, 0)
    with pytest.raises(NotImplementedError, match="RPT"):
        trpt.render_pass(view, trpt.RPTOptions(tracer="mega"), 8, 8, 0)


# ---- the small functions, held to JAX live ----

def test_lum_and_tile_offsets_match_jax():
    import jax.numpy as jnp

    from fermat_tpu.core.math import Vec3 as JV
    from fermat_tpu.core.rng import _u32, hash_u32
    from fermat_tpu.integrators import rpt as jrpt

    r = np.random.default_rng(3)
    v = [r.standard_normal(1000).astype(np.float32) for _ in range(3)]
    got = trpt._lum(Vec3(*map(torch.from_numpy, v))).numpy()
    assert np.array_equal(got, np.asarray(jrpt._lum(JV(*map(jnp.asarray, v)))))
    insts = np.array([0, 1, 3, 7, 1000, 2 ** 31 + 5, 2 ** 32 - 1], np.uint64)
    for seed in (0, 1, 12345, 2 ** 31 - 2):  # JAX takes a seed as an int32
        for tw, th in ((4, 4), (8, 2), (3, 5)):
            ox = hash_u32(_u32(jnp.asarray(insts, jnp.uint32)) * _u32(7919) + _u32(seed)) % _u32(tw)
            oy = (hash_u32(_u32(jnp.asarray(insts, jnp.uint32)) * _u32(104729)
                           + _u32(seed + 1)) % _u32(th))
            for k, inst in enumerate(insts):
                assert trpt.tile_offsets(int(inst), seed, tw, th) == (int(ox[k]), int(oy[k]))


def test_sequential_sums_match_jax_bit_for_bit():
    """_cumsum_seq equals jnp.cumsum and _sum_seq jnp.sum on XLA's CPU, bit
    for bit, on 20,000 (16, 16) blocks of skewed values; torch.cumsum does
    not (it is why the pass adds in sequence)."""
    import jax.numpy as jnp

    a = (np.random.default_rng(4).random((20000, 16, 16)) ** 3).astype(np.float32)
    ta = torch.from_numpy(a)
    want_c = np.asarray(jnp.cumsum(jnp.asarray(a), axis=2))
    want_s = np.asarray(jnp.sum(jnp.asarray(a), axis=1, keepdims=True))
    assert np.array_equal(trpt._cumsum_seq(ta, 2).numpy(), want_c)
    assert np.array_equal(trpt._sum_seq(ta, 1).numpy(), want_s)
    assert not np.array_equal(torch.cumsum(ta, 2).numpy(), want_c)


def test_broadcast_bsdf_equals_flat_lanes():
    """The pairwise phase's BSDF over broadcast (T, P, 1) and (T, 1, P)
    operands equals JAX's form, the operands copied out to T*P*P flat
    lanes, bit for bit (f_split and f_and_pdf, all four lobes)."""
    r = np.random.default_rng(5)
    T, P = 64, 16
    u = lambda *s: torch.from_numpy(r.random(s).astype(np.float32))

    def unit(*s):
        v = torch.from_numpy(r.standard_normal((3, *s)).astype(np.float32))
        v = v / v.norm(dim=0)
        return Vec3(v[0], v[1], v[2])

    params = BsdfParams(Vec3(u(T, P, 1), u(T, P, 1), u(T, P, 1)),
                        Vec3(u(T, P, 1), u(T, P, 1), u(T, P, 1)) * 0.3,
                        Vec3(u(T, P, 1), u(T, P, 1), u(T, P, 1)) * 3.0,
                        u(T, P, 1), 1.0 + u(T, P, 1), u(T, P, 1).round(),
                        Vec3(*(torch.zeros(T, P, 1),) * 3))
    wi, wo = unit(T, P, 1), unit(T, P, P)
    lobes = (True, True, True, True)
    full = lambda t: t.expand(T, P, P).reshape(-1)
    fparams = BsdfParams(*(Vec3(*map(full, f)) if isinstance(f, Vec3) else full(f)
                           for f in params))
    flat = lambda v: Vec3(*(c.reshape(-1) for c in v))
    for fn in (f_split, f_and_pdf):
        got = fn(params, wi, wo, lobes)
        want = fn(fparams, Vec3(*map(full, wi)), flat(wo), lobes)
        for g, w in zip(got, want):
            for a, b in (zip(g, w) if isinstance(g, Vec3) else [(g, w)]):
                assert torch.equal(a.reshape(-1).view(torch.int32), b.view(torch.int32))


# ---- the golden ----

def write_golden() -> None:
    import time

    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.core.camera import Camera
    from fermat_tpu.integrators import pt as jpt
    from fermat_tpu.integrators import rpt as jrpt
    from fermat_tpu.scene.procedural import big_room
    from fermat_tpu.scene.view import SceneView as JView

    def leaves(view, prefix):
        flat, _ = jax.tree_util.tree_flatten_with_path(view)
        out = {f"{prefix}.{jax.tree_util.keystr(p).lstrip('.')}": np.asarray(a) for p, a in flat}
        return {k: v for k, v in out.items()
                if not k.startswith((f"{prefix}.bvh", f"{prefix}.clusters.", f"{prefix}.vpls."))}

    vec = lambda v: np.stack([np.asarray(c) for c in v], -1)
    src = open(jrpt.__file__).read().splitlines()
    line_of = lambda text: next(i + 1 for i, s in enumerate(src) if text in s)
    at_phase_b = line_of("P = opts.tile_w * opts.tile_h")
    after_pick = line_of("C_p = Vec3(pickk(C.x)")

    def capture(*args):
        """JAX's pass, its locals read by a trace function as it runs."""
        rec = {"k_pick": []}

        def local(frame, event, arg):
            if event == "line" and frame.f_lineno == at_phase_b:
                f = frame.f_locals
                for k in (*STATE_VEC, "x_valid", "y_valid", "x_params", "y_params"):
                    rec[k] = f[k]
            elif event == "line" and frame.f_lineno == after_pick:
                rec["k_pick"].append(np.asarray(frame.f_locals["k_pick"]))
            elif event == "return":
                f = frame.f_locals
                rec["off_x"], rec["off_y"] = f["off_x"], f["off_y"]
            return local

        def top(frame, event, arg):
            return local if event == "call" and frame.f_code is jrpt.render_pass.__code__ else None

        sys.settrace(top)
        try:
            out = jrpt.render_pass(*args)
        finally:
            sys.settrace(None)
        return out, rec

    def jitted(fn):
        fast = jax.jit(fn)

        def call(*args):
            with jax.disable_jit(False):
                return fast(*args)
        return call

    walks = {k: getattr(jpt, k) for k in ("trace_closest", "trace_any")}
    out = dict(res=RES, big_res=BIG_RES, seed=SEED, cases=json.dumps(CASES))
    views = {}
    for k, fn in walks.items():
        setattr(jpt, k, jitted(fn))
    try:
        for name, (scene, fields, instances) in CASES.items():
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
            opts = jrpt.RPTOptions(lobes=lobes, **fields)
            for inst in instances:
                t0 = time.perf_counter()
                with jax.disable_jit():
                    (rad, rays), rec = capture(view, opts, res, res, jnp.uint32(inst), SEED)
                p = f"{name}.{inst}."
                out[p + "img"], out[p + "rays"] = vec(rad), float(rays)
                for k in STATE_VEC:
                    out[p + k] = vec(rec[k])
                for k in ("x_valid", "y_valid"):
                    out[p + k] = np.asarray(rec[k])
                for side in ("x", "y"):
                    prm = rec[f"{side}_params"]
                    for k in PARAM_VEC:
                        out[f"{p}{side}_params.{k}"] = vec(getattr(prm, k))
                    for k in PARAM_SCALAR:
                        out[f"{p}{side}_params.{k}"] = np.asarray(getattr(prm, k))
                out[p + "offsets"] = np.asarray([int(rec["off_x"]), int(rec["off_y"])])
                out[p + "k_pick"] = np.stack(rec["k_pick"])
                print(f"{name} instance {inst}: {time.perf_counter() - t0:.1f} s, rays "
                      f"{float(rays)}, offsets {out[p + 'offsets']}, mean "
                      f"{out[p + 'img'].mean(0)}")
    finally:
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
