"""The path-space-filtering tracer (integrators/psfpt.py) and the
clustered-RL path tracer (integrators/ptrl.py) of fermat_tpu_torch, with
the spatial hash, the RL light clusters and the VTL cut, against fermat_tpu.

JAX compiles these passes too slowly on the CPU to run them live, so they
are held to a stored golden, tests/golden/torch_port_psf_24.npz, written by
`JAX_PLATFORMS=cpu python tests/test_torch_psf.py`: JAX's render_pass run
op by op (not jitted), seed 0, the scene's lobes, instance k-1 at pass k,
and the state after every pass. The ptrl passes follow JAX's context
factory (context.py:169-240): the clusters built at start, and every
adapt_every passes the host cut step, the reclustering and the Q remap
before the pass. Cases (24x24 unless said):
  P1       psfpt on cornell_box(), three passes, defaults;
  P2       psfpt with psf_depth=2, firefly_clamp=1.0, table_size=256 (so
           collisions and the ownership rule show), temporal_decay=0;
  P3       psfpt on tests/test_envmap.py's env-lit floor quad (an 8x16 map
           of 0.8, camera (0, 2, 2) -> origin, fov 0.7), psf_depth=0 (the
           floor's camera hits are the PSF vertices: a vertex at depth 1
           would look at the sky);
  R1       ptrl, sampler="vtl", adapt_every=2, four passes;
  R1_adapt R1 with adapt_every=1 and table_size=1024 from a seeded
           uneven Q (column 0 large), so that the cut adapts before each
           pass (at this size the learned Q stays too even for a step to
           pay);
  R2       ptrl, sampler="tri";
  B_psfpt, B_ptrl  big_room(400) at 16x16 (bench camera), JAX's CPU route
           walking its BVH, on the view of tests/golden/torch_port_bigroom_24.npz;
           the port renders it through the frontier tracer ((u, v) from the
           ray), and psfpt's first pass also through the BVH walk.
Each case checks pass 1 from a fresh state and pass k+1 from JAX's stored
state k. Tolerances, those of tests/test_torch_bpt.py: at least 99% of
pixels within atol 1e-4, rtol 1e-3; channel means within 1e-3; rays equal
(within 0.5% on big_room, where coplanar triangles tie). The state after a
pass (psfpt's cell sums and weights, ptrl's Q) within rtol 1e-4 on at least
99% of the entries that either side moved, the owner keys equal on at least
99.9% of slots, the VTL cut and its cluster tables equal. The small
functions are held to JAX live.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.core.math import Vec3, oct_encode  # noqa: E402
from fermat_tpu_torch.integrators import psfpt as tpsf  # noqa: E402
from fermat_tpu_torch.integrators import ptrl as tptrl  # noqa: E402
from fermat_tpu_torch.integrators import rl as trl  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext, _RENDERER_REGISTRY  # noqa: E402
from fermat_tpu_torch.scene import mesh_lights as tml  # noqa: E402
from fermat_tpu_torch.scene.spatial_hash import HashAccumulator, hash_shading_point  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_psf_24.npz")
BIGROOM = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
RES, BIG_RES, SEED = 24, 16, 0
ENV_H, ENV_W, ENV_VALUE = 8, 16, 0.8
# name: (scene, renderer, option fields beyond the lobes, passes)
CASES = {
    "P1": ("cornell", "psfpt", {}, 3),
    "P2": ("cornell", "psfpt", {"psf_depth": 2, "firefly_clamp": 1.0, "table_size": 256,
                                "temporal_decay": 0.0}, 2),
    "P3": ("floor_env", "psfpt", {"psf_depth": 0}, 2),
    "R1": ("cornell", "ptrl", {"sampler": "vtl", "adapt_every": 2}, 4),
    "R1_adapt": ("cornell", "ptrl", {"sampler": "vtl", "adapt_every": 1, "table_size": 1024},
                 2),
    "R2": ("cornell", "ptrl", {"sampler": "tri"}, 2),
    "B_psfpt": ("big_room", "psfpt", {}, 2),
    "B_ptrl": ("big_room", "ptrl", {}, 2),
}
CELL_FIELDS = ("sum_x", "sum_y", "sum_z", "weight", "key")


def uneven_q(table_size: int, n_clusters: int) -> np.ndarray:
    """R1_adapt's starting Q: seeded values in [0.5, 1.5), column 0 x 50."""
    q = np.random.default_rng(5).random((table_size, n_clusters)).astype(np.float32) + 0.5
    q[:, 0] *= 50.0
    return q


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
    return proc.cornell_box(), proc.cornell_camera(), {}


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


def assert_rays(got: float, want: float, big: bool) -> None:
    if big:
        assert abs(got - want) <= 0.005 * want, (got, want)
    else:
        assert got == want, (got, want)


def assert_moved_close(got: np.ndarray, want: np.ndarray, rest: float) -> None:
    """Within rtol 1e-4 on >= 99% of the entries either side moved from
    `rest` (the table's value where no lane wrote)."""
    moved = (got != rest) | (want != rest)
    assert moved.any()
    close = np.isclose(got[moved], want[moved], rtol=1e-4, atol=1e-7)
    assert close.mean() >= 0.99, f"{close.mean():.4f} of {moved.sum()} moved entries close"


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


def _lobes(golden, scene):
    return tuple(bool(x) for x in golden[f"{scene}.lobes"])


def _cells(golden, name, k) -> HashAccumulator:
    return HashAccumulator.from_numpy(*(golden[f"{name}.{k}.cells.{f}"] for f in CELL_FIELDS),
                                      "cpu")


def _assert_cells(golden, name, k, cells: HashAccumulator) -> None:
    keys = golden[f"{name}.{k}.cells.key"].astype(np.int64)
    assert (cells.key.numpy() == keys).mean() >= 0.999
    for f in CELL_FIELDS[:4]:
        assert_moved_close(getattr(cells, f).numpy(), golden[f"{name}.{k}.cells.{f}"], 0.0)


def _vtl(golden, name, k) -> tml.VTLView:
    p = f"{name}.{k}.vtl."
    return tml.VTLView.from_numpy({f: golden[p + f] for f in tml.VTLView._fields[:-1]},
                                  int(golden[f"{name}.n_clusters"]), "cpu")


def _assert_vtl_equal(golden, name, k, vtls: tml.VTLView) -> None:
    for f in tml.VTLView._fields[:-1]:
        assert np.array_equal(getattr(vtls, f).numpy(), golden[f"{name}.{k}.vtl.{f}"]), f


# ---- psfpt passes against the golden ----

# big_room's psfpt also through the BVH walk (JAX's route), there pass 1
# alone (the walk's plain version takes ~2 s a pass on the CPU)
PSF_CASES = [(n, t) for n, c in CASES.items() if c[1] == "psfpt"
             for t in (("auto", "bvh") if c[0] == "big_room" else ("auto",))]
RL_CASES = [(n, "auto") for n, c in CASES.items() if c[1] == "ptrl"]


def _passes(name: str, tracer: str) -> int:
    return 1 if tracer == "bvh" else CASES[name][3]


@pytest.mark.parametrize("name,tracer", PSF_CASES)
def test_psfpt_passes_match_jax_golden(golden, gview, name, tracer):
    """Pass 1 from fresh cells, and each pass k+1 from JAX's cells after
    pass k: the image, the rays and the cells after the pass."""
    scene, _, fields, _ = CASES[name]
    view, big = gview(scene), scene == "big_room"
    res = BIG_RES if big else RES
    opts = tpsf.PsfptOptions(lobes=_lobes(golden, scene), tracer=tracer, **fields)
    for k in range(_passes(name, tracer)):
        state = tpsf.init_state(view, opts) if k == 0 else tpsf.PsfptState(_cells(golden, name, k))
        out, state, rays, rays_lane = tpsf.render_pass(view, opts, res, res, k, state, SEED)
        assert_image_close(out.stack().numpy(), golden[f"{name}.{k + 1}.img"])
        assert_rays(float(rays), float(golden[f"{name}.{k + 1}.rays"]), big)
        assert float(rays_lane.sum()) == float(rays)
        _assert_cells(golden, name, k + 1, state.cells)


@pytest.mark.parametrize("name,tracer", RL_CASES)
def test_ptrl_passes_match_jax_golden(golden, gview, name, tracer):
    """The clusters built at start equal JAX's; pass 1 from a fresh (or
    R1_adapt's seeded) Q, and each pass k+1 from JAX's Q, clusters and cut
    after pass k, through ptrl.step (the adaptation on its cadence, then
    the pass): the cut and the clusters it leaves, the image, the rays
    and Q after the pass."""
    scene, _, fields, _ = CASES[name]
    view, big = gview(scene), scene == "big_room"
    res = BIG_RES if big else RES
    opts = tptrl.PtrlOptions(lobes=_lobes(golden, scene), tracer=tracer, **fields)
    vtl = opts.sampler == "vtl"
    fresh = tptrl.start(view, opts)
    if vtl:
        _assert_vtl_equal(golden, name, 0, fresh.clusters)
        assert fresh.cut.cut == list(golden[f"{name}.0.cut"])
    else:
        for f in trl.RLClusters._fields[:-1]:
            assert np.array_equal(getattr(fresh.clusters, f).numpy(), golden[f"{name}.rl.{f}"])
    for k in range(_passes(name, tracer)):
        run = fresh._replace(cut=copy.deepcopy(fresh.cut))
        if k:
            if run.cut is not None:
                run.cut.cut = list(golden[f"{name}.{k}.cut"])
            run = run._replace(state=tptrl.PtrlState(trl.RLState(torch.from_numpy(
                golden[f"{name}.{k}.q"]))), passes=k,
                clusters=_vtl(golden, name, k) if vtl else run.clusters)
        elif f"{name}.q0" in golden.files:
            run = run._replace(state=tptrl.PtrlState(trl.RLState(torch.from_numpy(
                golden[f"{name}.q0"]))))
        out, rays, rays_lane, run = tptrl.step(view, opts, run, res, res, k, SEED)
        if vtl:
            assert run.cut.cut == list(golden[f"{name}.{k + 1}.cut"])
            _assert_vtl_equal(golden, name, k + 1, run.clusters)
        assert_image_close(out.stack().numpy(), golden[f"{name}.{k + 1}.img"])
        assert_rays(float(rays), float(golden[f"{name}.{k + 1}.rays"]), big)
        assert float(rays_lane.sum()) == float(rays) and run.passes == k + 1
        assert_moved_close(run.state.qstate.q.numpy(), golden[f"{name}.{k + 1}.q"], 1.0)


def test_r1_adapt_golden_adapts(golden):
    """R1_adapt's cut moves at pass 1, R1's at no pass (its Q stays even)."""
    assert list(golden["R1_adapt.1.cut"]) != list(golden["R1_adapt.0.cut"])
    assert all(list(golden[f"R1.{k}.cut"]) == list(golden["R1.0.cut"]) for k in range(1, 5))


# ---- the context ----

@pytest.mark.parametrize("renderer,fields", [("psfpt", {}), ("ptrl", {"adapt_every": 2})])
def test_context_renders_the_golden_and_restart_drops_the_state(golden, renderer, fields):
    """RenderingContext on the CPU: the scene's lobes, COMPOSITED = the pass,
    the state carried from pass to pass and dropped by restart()."""
    storage, cam, _ = build_scene("cornell", "fermat_tpu_torch")
    name = {"psfpt": "P1", "ptrl": "R1"}[renderer]
    ctx = RenderingContext.create(storage, cam, RES, RES, renderer=renderer, device="cpu",
                                  **fields)
    assert tuple(ctx.renderer_options["lobes"]) == _lobes(golden, "cornell")
    ctx.render(1)
    assert_image_close(ctx.hdr_image().reshape(-1, 3), golden[f"{name}.1.img"])
    first = ctx.renderer_state
    ctx.render_batch(1)
    mean2 = (golden[f"{name}.1.img"] + golden[f"{name}.2.img"]) / 2
    assert_image_close(ctx.hdr_image().reshape(-1, 3), mean2)
    assert ctx.renderer_state is not first
    ctx.restart()
    assert ctx.renderer_state is None
    ctx.render(1)
    assert_image_close(ctx.hdr_image().reshape(-1, 3), golden[f"{name}.1.img"])
    if renderer == "ptrl":
        assert ctx.renderer_state.passes == 1


def test_registry_lists_the_ported_renderers():
    assert sorted(_RENDERER_REGISTRY) == ["bpt", "cmlt", "mlt", "psfpt", "pssmlt", "pt", "ptrl",
                                         "rpt"]
    view = SceneView.build(*build_scene("cornell", "fermat_tpu_torch")[:2], "cpu")
    with pytest.raises(NotImplementedError, match="PSFPT"):
        tpsf.render_pass(view, tpsf.PsfptOptions(tracer="mega"), 4, 4, 0,
                         tpsf.init_state(view, tpsf.PsfptOptions()))
    with pytest.raises(NotImplementedError, match="sampler"):
        tptrl.start(view, tptrl.PtrlOptions(sampler="cdf"))


# ---- the spatial hash ----

def _lanes(n, seed):
    r = np.random.default_rng(seed)

    def unit():
        v = r.standard_normal((3, n)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    return r, unit


def test_hash_shading_point_and_oct_encode_match_jax():
    """4,096 points at eye distances from 0.05 to 500 (lod -16..3), with
    jitter; oct_encode also on axis-aligned and lower-hemisphere normals.
    Keys on >= 99.9% of lanes (log2 and round may move a cell at an exact
    boundary), the slot the key's."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.core.math import Vec3 as JV
    from fermat_tpu.core.math import oct_encode as j_oct
    from fermat_tpu.scene.spatial_hash import hash_shading_point as j_hash

    n = 4096
    r, unit = _lanes(n, 11)
    nrm = unit()
    nrm[:, :6] = np.array([[1, -1, 0, 0, 0, 0], [0, 0, 1, -1, 0, 0], [0, 0, 0, 0, 1, -1]],
                          np.float32)
    pos = unit() * np.exp(r.uniform(np.log(0.05), np.log(500.0), n)).astype(np.float32)
    eye = np.array([0.3, 1.2, -0.7], np.float32)
    pos = (pos + eye[:, None]).astype(np.float32)
    jit = r.random(n).astype(np.float32)
    tv = lambda a: Vec3(*map(torch.from_numpy, a))
    jv = lambda a: JV(*map(jnp.asarray, a))
    for a, b in zip(oct_encode(tv(nrm)), j_oct(jv(nrm))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    teye = Vec3(*(torch.tensor(c) for c in eye))
    slot, key = hash_shading_point(tv(pos), tv(nrm), teye, 0.1, 1 << 14, torch.from_numpy(jit))
    js, jk = jax.jit(lambda p, q, e, j: j_hash(p, q, e, 0.1, 1 << 14, j))(
        jv(pos), jv(nrm), jv(eye), jnp.asarray(jit))
    same = key.numpy() == np.asarray(jk).astype(np.int64)
    assert same.mean() >= 0.999 and slot.dtype == torch.int32
    assert np.array_equal(slot.numpy()[same], np.asarray(js)[same])
    assert int(key.min()) >= 1 and len(np.unique(key.numpy())) > n // 8


def _serial_owners(old, slot, key, valid):
    """The ownership write done lane by lane, the last writer winning."""
    out = old.copy()
    for i in range(slot.shape[0]):
        s = slot[i] if valid[i] else 0
        out[s] = key[i] if valid[i] else old[s]
    return out


def test_deposit_and_lookup_match_jax_on_a_64_slot_table():
    """Duplicate slots, invalid lanes and valid lanes on slot 0: the owners
    equal JAX's and the serial last writer; JAX's slot-0 write-back (an
    invalid lane after a valid slot-0 lane takes slot 0 back); the sums,
    the weights and the lookup within 1e-6."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.scene.spatial_hash import HashAccumulator as JAcc

    r = np.random.default_rng(12)
    n, k = 1000, 64
    key = r.integers(1, 40, n).astype(np.uint32) * np.uint32(2654435761)
    key = np.maximum(key, 1)
    slot = (key % k).astype(np.int32)
    valid = r.random(n) < 0.7
    vals = [r.random(n).astype(np.float32) for _ in range(3)]
    old = (r.integers(0, 3, k) * r.integers(1, 2 ** 31, k)).astype(np.uint32)
    sums = [r.random(k).astype(np.float32) * (old > 0) for _ in range(4)]
    t = HashAccumulator.from_numpy(*sums, old, "cpu").decay(0.85)
    j = JAcc(*(jnp.asarray(s) for s in sums), jnp.asarray(old)).decay(0.85)
    ts = torch.from_numpy
    args_t = (ts(slot), ts(key.astype(np.int64)), *map(ts, vals), ts(valid))
    args_j = (jnp.asarray(slot), jnp.asarray(key), *map(jnp.asarray, vals), jnp.asarray(valid))
    t2, j2 = t.deposit(*args_t), jax.jit(lambda acc, *a: acc.deposit(*a))(j, *args_j)
    owners = t2.key.numpy()
    assert np.array_equal(owners, np.asarray(j2.key).astype(np.int64))
    assert np.array_equal(owners, _serial_owners(old.astype(np.int64), slot, key, valid))
    for f in ("sum_x", "sum_y", "sum_z", "weight"):
        np.testing.assert_allclose(getattr(t2, f).numpy(), np.asarray(getattr(j2, f)),
                                   rtol=1e-6, atol=1e-6)
    avg, ok = t2.lookup(ts(slot), ts(key.astype(np.int64)))
    javg, jok = jax.jit(lambda acc, *a: acc.lookup(*a))(j2, jnp.asarray(slot), jnp.asarray(key))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    for a, b in zip(avg, javg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # the write-back: lane 0 claims slot 0, an invalid lane after it writes
    # the old key back
    s0 = np.array([0, 5, 0], np.int32)
    k0 = np.array([64 * 7, 5, 64 * 9], np.int64)
    v0 = np.array([True, True, False])
    z = HashAccumulator.create(k, "cpu")
    got = z.deposit(ts(s0), ts(k0), *(torch.ones(3),) * 3, ts(v0))
    assert int(got.key[0]) == 0 and int(got.key[5]) == 5 and float(got.weight[0]) == 0.0
    got = z.deposit(ts(s0[:2]), ts(k0[:2]), *(torch.ones(2),) * 3, ts(v0[:2]))
    assert int(got.key[0]) == 64 * 7 and float(got.weight[0]) == 1.0


# ---- the RL clusters and the VTL set ----

def glowing_box(pkg: str):
    """cornell_box() with every material emissive (36 emissive triangles of
    six radiances), for cluster builds with more than one light."""
    import importlib

    storage = importlib.import_module(pkg + ".scene.procedural").cornell_box()
    for i, m in enumerate(storage.materials):
        m.emissive = (0.5 + 0.3 * i, 1.0 + 0.1 * i, 2.0 - 0.2 * i)
    return storage


@pytest.fixture(scope="module")
def views():
    """(JAX MeshView, port SceneView) of glowing_box and of cornell_box."""
    from fermat_tpu_torch.scene.procedural import cornell_camera

    scenes = {"glowing": glowing_box, "cornell": lambda p: build_scene("cornell", p)[0]}
    return {k: (f("fermat_tpu").device_view(),
                SceneView.build(f("fermat_tpu_torch"), cornell_camera(), "cpu"))
            for k, f in scenes.items()}


def _rl_inputs(n, n_cells, n_clusters, seed):
    r = np.random.default_rng(seed)
    q = (r.random((n_cells, n_clusters)) + 0.1).astype(np.float32)
    cell = r.integers(0, n_cells, n).astype(np.int32)
    u = [r.random(n).astype(np.float32) for _ in range(4)]
    return q, cell, u


def test_build_clusters_sample_and_pdf_match_jax(views):
    """build_clusters on 36 emissive triangles (and on the CornellBox's
    two): equal tables; rl.sample and pdf_area_of on 4,096 lanes from a
    seeded Q: the same triangle and cluster on every lane, the point, Le
    and pdf within 1e-6."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators import rl as jrl

    jview, view = views["glowing"]
    for jv, tv, c in ((jview, view, 16), (*views["cornell"], 4)):
        jc, tc = jrl.build_clusters(jv, c), trl.build_clusters(tv.mesh, c)
        for f in trl.RLClusters._fields[:-1]:
            assert np.array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f))), f
    q, cell, u = _rl_inputs(4096, 32, 16, 3)
    jst, tst = jrl.RLState(q=jnp.asarray(q)), trl.RLState(q=torch.from_numpy(q))
    jc, tc = jrl.build_clusters(jview, 16), trl.build_clusters(view.mesh, 16)
    got = trl.sample(tc, tst, view.lights.rows, torch.from_numpy(cell),
                     *map(torch.from_numpy, u))
    want = jax.jit(lambda c, *uu: jrl.sample(jc, jst, jview, c, *uu))(
        jnp.asarray(cell), *map(jnp.asarray, u))
    assert np.array_equal(got[4].numpy(), np.asarray(want[4]))
    assert np.array_equal(got[5].numpy(), np.asarray(want[5]))
    for a, b in zip((*got[0], *got[1], *got[2], got[3]), (*want[0], *want[1], *want[2], want[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    tri = np.random.default_rng(4).integers(-1, view.mesh.n_triangles, 4096).astype(np.int32)
    np.testing.assert_allclose(
        trl.pdf_area_of(tc, tst, torch.from_numpy(cell), torch.from_numpy(tri)).numpy(),
        np.asarray(jax.jit(lambda c, t: jrl.pdf_area_of(jc, jst, c, t))(jnp.asarray(cell),
                                                                        jnp.asarray(tri))),
        rtol=1e-6)


def test_locate_inverts_leaf_corners_as_jax():
    """locate against JAX's on points inside each leaf at depths 0-4 (the
    oracle of tests/test_mesh_lights.py), one lane set over all depths, and
    leaf_corners_np equal."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.scene import mesh_lights as jml

    r = np.random.default_rng(0)
    us, vs, ds, want_idx = [], [], [], []
    for d in range(5):
        c = tml.leaf_corners_np(d)
        assert np.array_equal(c, jml.leaf_corners_np(d))
        s, t = r.random((c.shape[0], 4)), r.random((c.shape[0], 4))
        flip = s + t > 1
        s, t = np.where(flip, 1 - s, s), np.where(flip, 1 - t, t)
        pts = (c[:, None, 0] + (c[:, 1] - c[:, 0])[:, None] * s[..., None]
               + (c[:, 2] - c[:, 0])[:, None] * t[..., None]).astype(np.float32)
        us.append(pts[..., 0].ravel())
        vs.append(pts[..., 1].ravel())
        ds.append(np.full(pts[..., 0].size, d, np.int32))
        want_idx.append(np.repeat(np.arange(c.shape[0]), 4))
    u, v, d = np.concatenate(us), np.concatenate(vs), np.concatenate(ds)
    got = tml.locate(*map(torch.from_numpy, (u, v, d))).numpy()
    want = np.asarray(jax.jit(jml.locate)(jnp.asarray(u), jnp.asarray(v), jnp.asarray(d)))
    assert np.array_equal(got, want)
    assert (got == np.concatenate(want_idx)).mean() > 0.99


def test_build_vtls_adapt_and_reclustered_match_jax(views):
    """build_vtls on 36 emissive triangles: every table of the view and the
    cut equal to JAX's; LightCutHost.adapt on a value with a strong cluster
    gives JAX's remap and cut, reclustered JAX's tables, ptrl.remap_q
    JAX's q @ m.T; the pdfs still normalize in each new cluster."""
    import jax.numpy as jnp

    from fermat_tpu.scene import mesh_lights as jml

    jview, view = views["glowing"]
    jv, jcut = jml.build_vtls(jview, target_clusters=8, n_target_vtls=256)
    tv, tcut = tml.build_vtls(view.mesh, target_clusters=8, n_target_vtls=256)
    for f in tml.VTLView._fields[:-1]:
        assert np.array_equal(getattr(tv, f).numpy(), np.asarray(getattr(jv, f))), f
    assert tcut.cut == jcut.cut and tcut.nodes == jcut.nodes and tv.n_clusters == jv.n_clusters
    assert np.array_equal(tcut.order, jcut.order)
    value = np.full(tcut.n_clusters, 0.01, np.float32)
    value[0] = 100.0
    tm, jm = tcut.adapt(value), jcut.adapt(value)
    assert tm is not None and np.array_equal(tm, jm) and tcut.cut == jcut.cut
    tv2, jv2 = tml.reclustered(tv, tcut), jml.reclustered(jv, jcut)
    for f in tml.VTLView._fields[:-1]:
        assert np.array_equal(getattr(tv2, f).numpy(), np.asarray(getattr(jv2, f))), f
    offs, pdf, area = (getattr(tv2, f).numpy() for f in ("cluster_offset", "pdf_area", "area"))
    for ci in range(tcut.n_clusters):
        if offs[ci + 1] > offs[ci]:
            np.testing.assert_allclose((pdf * area)[offs[ci]:offs[ci + 1]].sum(), 1.0, rtol=1e-4)
    q = np.random.default_rng(6).random((32, 12)).astype(np.float32)
    want = np.concatenate([np.asarray(jnp.asarray(q)[:, :8] @ jnp.asarray(jm).T), q[:, 8:]], 1)
    assert np.array_equal(tptrl.remap_q(torch.from_numpy(q), tm).numpy(), want)


def test_vtl_sample_and_pdf_match_jax(views):
    """sample_vtl and pdf_area_of_vtl on 4,096 lanes from a seeded Q (K2's
    16-column fetch on the CPU is the plain gather): the same VTL, cluster
    and triangle on every lane, point, Le and pdf within 1e-6; the pdf of a
    sampled point equals the sampled pdf."""
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators import rl as jrl
    from fermat_tpu.scene import mesh_lights as jml

    jview, view = views["glowing"]
    jv, _ = jml.build_vtls(jview, target_clusters=8, n_target_vtls=256)
    tv, _ = tml.build_vtls(view.mesh, target_clusters=8, n_target_vtls=256)
    q, cell, u = _rl_inputs(4096, 32, 8, 7)
    jst, tst = jrl.RLState(q=jnp.asarray(q)), trl.RLState(q=torch.from_numpy(q))
    got = trl.sample_vtl(tv, tst, torch.from_numpy(cell), *map(torch.from_numpy, u))
    want = jax.jit(lambda c, *uu: jrl.sample_vtl(jv, jst, c, *uu))(jnp.asarray(cell),
                                                                    *map(jnp.asarray, u))
    for i in (4, 5, 6):
        assert np.array_equal(got[i].numpy(), np.asarray(want[i]))
    for a, b in zip((*got[0], *got[1], *got[2], got[3]), (*want[0], *want[1], *want[2], want[3])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # barycentrics of the sampled points in their parent triangles
    r = np.random.default_rng(8)
    tri = got[4].numpy()
    su, sv = r.random(4096).astype(np.float32), r.random(4096).astype(np.float32)
    flip = su + sv > 1
    su, sv = np.where(flip, 1 - su, su), np.where(flip, 1 - sv, sv)
    tri[:8] = -1
    pdf_t = trl.pdf_area_of_vtl(tv, tst, torch.from_numpy(cell), torch.from_numpy(tri),
                                torch.from_numpy(su), torch.from_numpy(sv)).numpy()
    pdf_j = np.asarray(jax.jit(lambda *a: jrl.pdf_area_of_vtl(jv, jst, *a))(
        *map(jnp.asarray, (cell, tri, su, sv))))
    np.testing.assert_allclose(pdf_t, pdf_j, rtol=1e-6)
    assert (pdf_t > 0).all()  # tri -1 clamps to triangle 0, emissive here


# ---- the golden ----

def write_golden() -> None:
    import time

    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.core.camera import Camera
    from fermat_tpu.integrators import psfpt as jpsf
    from fermat_tpu.integrators import ptrl as jptrl
    from fermat_tpu.integrators import rl as jrl
    from fermat_tpu.scene.mesh_lights import build_vtls, reclustered
    from fermat_tpu.scene.procedural import big_room
    from fermat_tpu.scene.view import SceneView as JView

    def leaves(view, prefix):
        flat, _ = jax.tree_util.tree_flatten_with_path(view)
        out = {f"{prefix}.{jax.tree_util.keystr(p).lstrip('.')}": np.asarray(a) for p, a in flat}
        return {k: v for k, v in out.items()
                if not k.startswith((f"{prefix}.bvh", f"{prefix}.clusters.", f"{prefix}.vpls."))}

    img = lambda v: np.stack([np.asarray(c) for c in v], -1)
    out = dict(res=RES, big_res=BIG_RES, seed=SEED, cases=json.dumps(CASES))
    views = {}
    for name, (scene, renderer, fields, passes) in CASES.items():
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
        if renderer == "psfpt":
            opts = jpsf.PsfptOptions(lobes=lobes, **fields)
            state = jpsf.init_state(view, opts)
            for k in range(1, passes + 1):
                o, state, rays = jpsf.render_pass(view, opts, res, res, jnp.uint32(k - 1), state,
                                                  SEED)
                out[f"{name}.{k}.img"], out[f"{name}.{k}.rays"] = img(o), float(rays)
                for f in CELL_FIELDS:
                    out[f"{name}.{k}.cells.{f}"] = np.asarray(getattr(state.cells, f))
        else:
            # JAX's ptrl factory (context.py:169-240), run op by op
            opts = jptrl.PtrlOptions(lobes=lobes, **fields)
            out[f"{name}.n_clusters"] = opts.n_clusters
            if opts.sampler == "vtl":
                clusters, cut = build_vtls(view.mesh, target_clusters=opts.n_clusters,
                                           n_target_vtls=opts.n_vtls)
            else:
                clusters, cut = jrl.build_clusters(view.mesh, opts.n_clusters), None
                for f in jrl.RLClusters._fields[:-1]:
                    out[f"{name}.rl.{f}"] = np.asarray(getattr(clusters, f))
            state = jptrl.init_state(view, opts)
            if name == "R1_adapt":
                q0 = uneven_q(opts.table_size, opts.n_clusters)
                out[f"{name}.q0"] = q0
                state = jptrl.PtrlState(qstate=jrl.RLState(q=jnp.asarray(q0)))

            def record_clusters(k):
                if cut is not None:
                    out[f"{name}.{k}.cut"] = np.asarray(cut.cut, np.int64)
                    for f in clusters._fields[:-1]:
                        out[f"{name}.{k}.vtl.{f}"] = np.asarray(getattr(clusters, f))

            record_clusters(0)
            for k in range(1, passes + 1):
                if cut is not None and opts.adapt_every > 0 and k % opts.adapt_every == 0:
                    value = np.asarray(state.qstate.q.mean(axis=0))[: cut.n_clusters]
                    m = cut.adapt(value)
                    if m is not None:
                        clusters = reclustered(clusters, cut)
                        q_new = state.qstate.q[:, : m.shape[1]] @ jnp.asarray(m).T
                        pad = state.qstate.q.shape[1] - q_new.shape[1]
                        if pad > 0:
                            q_new = jnp.concatenate([q_new, state.qstate.q[:, q_new.shape[1]:]],
                                                    axis=1)
                        state = state._replace(qstate=jrl.RLState(q=q_new))
                o, state, rays = jptrl.render_pass(view, opts, clusters, res, res,
                                                   jnp.uint32(k - 1), state, SEED)
                out[f"{name}.{k}.img"], out[f"{name}.{k}.rays"] = img(o), float(rays)
                out[f"{name}.{k}.q"] = np.asarray(state.qstate.q)
                record_clusters(k)
        print(f"{name}: {passes} passes, {time.perf_counter() - t0:.1f} s, rays "
              f"{[out[f'{name}.{k}.rays'] for k in range(1, passes + 1)]}, mean "
              f"{out[f'{name}.{passes}.img'].mean(0)}")
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import time

    import jax

    jax.config.update("jax_platforms", "cpu")
    t_all = time.perf_counter()
    write_golden()
    print(f"{time.perf_counter() - t_all:.1f} s")
