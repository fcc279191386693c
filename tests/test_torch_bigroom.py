"""The large-scene slice end to end: fermat_tpu_torch's path tracer on
big_room(n_boxes=400) (4,836 triangles, so the view carries a cluster table
and the pass traces with the frontier tracer and picks lights from the
emissive subset) against fermat_tpu's render_pass(tracer="frontier").

The JAX pass runs the frontier kernels in Pallas interpret mode, far too slow
for a test, so its output is a stored golden, tests/golden/
torch_port_bigroom_24.npz: the bench camera (eye (0, 3, 10), aim (0, 1.5, 0)),
24x24, max_path_length=4, seed 0, instance 0, the scene's lobes; the four
channels, the first-hit triangle, `rays`, and the JAX scene view's leaves
(mesh, lights, camera, and the cluster table), so that the card can be held
to JAX without JAX. Written by `JAX_PLATFORMS=cpu python
tests/test_torch_bigroom.py`.

Tolerances, those of tests/test_torch_pt.py: `rays` within 0.5%; at least
99% of pixels within atol 1e-4, rtol 1e-3 on every channel; channel means
within 1e-3 relative. The first-hit triangle is compared on at least 99% of
pixels: the floor and the boxes' bottoms are coplanar at y = 0, and among
equal t the JAX kernel takes the first cluster it visits while the port
takes the smallest triangle id.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.accel.cluster import build_clusters  # noqa: E402
from fermat_tpu_torch.bsdf.composite import scene_lobes  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
N_BOXES, RES, MPL, SEED = 400, 24, 4, 0
CHANNELS = ("composited", "direct", "diffuse", "specular")


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def gview(golden):
    return SceneView.from_numpy(
        {k[5:]: golden[k] for k in golden.files if k.startswith("view.")}, "cpu")


def _opts(golden, **kw):
    return tpt.PTOptions(max_path_length=int(golden["max_path_length"]),
                         lobes=tuple(bool(x) for x in golden["lobes"]), **kw)


def test_big_room_mesh_matches_jax():
    from fermat_tpu.scene.procedural import big_room as jax_big_room

    a, b = jax_big_room(N_BOXES), tproc.big_room(N_BOXES)
    assert b.n_triangles == 4836
    for f in ("vertices", "triangles", "normal_indices", "uv_indices", "material_ids"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [m.diffuse for m in a.materials] == [m.diffuse for m in b.materials]


def test_shade_fetch_ray_matches_jax(gview):
    """Barycentrics from the ray and the fetched row (mesh.py:372-430): the
    same shading lanes as JAX's within 1e-5 (XLA:CPU contracts FMAs)."""
    import jax.numpy as jnp

    from fermat_tpu.core.math import Vec3 as JVec3
    from fermat_tpu.scene.procedural import big_room as jax_big_room

    rng = np.random.default_rng(7)
    tri = rng.integers(0, gview.mesh.n_triangles, 2048).astype(np.int32)
    o = (rng.random((2048, 3)) * 8.0 - 4.0).astype(np.float32)
    d = rng.standard_normal((2048, 3)).astype(np.float32)
    tv = lambda a: Vec3(*(torch.from_numpy(a[:, k].copy()) for k in range(3)))
    jv = lambda a: JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))
    got = gview.mesh.shade_fetch_ray(torch.from_numpy(tri), tv(o), tv(d), gview.mesh.shade_rows())
    pos, gn, sn, uv, mat_id = jax_big_room(N_BOXES).device_view().shade_fetch_ray(
        jnp.asarray(tri), jv(o), jv(d))[:5]
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                                    atol=1e-5)
    for a, b in ((got.pos, pos), (got.gn, gn), (got.sn, sn)):
        for k in range(3):
            close(a[k], b[k])
    close(got.uv, uv)
    np.testing.assert_array_equal(got.mat_id.numpy(), np.asarray(mat_id))


def test_view_takes_the_golden_cluster_table(golden, gview):
    """from_numpy takes the JAX cluster leaves; they equal the port's own
    build_clusters on the same mesh, bit for bit."""
    assert gview.clusters is not None and gview.lights.compact is not None
    own = build_clusters(gview.mesh)
    assert np.array_equal(own.tri, gview.clusters.tri)  # the host table
    for f in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z", "rows", "count",
              "node_box", "node_ref"):
        assert torch.equal(getattr(own, f), getattr(gview.clusters, f)), f
    assert gview.lights.compact[0].shape == (2, 23)  # the two ceiling-light triangles


def test_render_pass_matches_jax_golden(golden, gview):
    out = tpt.render_pass(gview, _opts(golden), RES, RES, int(golden["instance"]),
                          int(golden["seed"]))
    want_rays = float(golden["rays"])
    assert abs(float(out.rays) - want_rays) <= 0.005 * want_rays
    for c in CHANNELS:
        assert_image_close(getattr(out, c).stack().numpy(), golden[c].reshape(-1, 3))
    assert (out.tri.numpy() == golden["tri"].ravel()).mean() >= 0.99
    img = out.composited.stack()
    assert bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0


def test_narrow_pass_matches_render_pass(golden, gview):
    """NarrowPass compacts live lanes between bounces (min_width 16, so
    every bucket engages) and re-associates the same sum: images allclose,
    rays, per-lane rays and the G-buffer equal (tests/test_pt.py:172-200)."""
    opts = _opts(golden)
    ref = tpt.render_pass(gview, opts, RES, RES, 3, 0)
    drv = tpt.NarrowPass(gview, opts, RES, RES, 0, min_width=16)
    out = drv(3)
    widths = [w for _, _, w in drv.last_profile]
    assert widths and min(widths) < RES * RES, drv.last_profile
    for c in CHANNELS:
        np.testing.assert_allclose(getattr(out, c).stack().numpy(),
                                   getattr(ref, c).stack().numpy(), atol=2e-5, rtol=1e-5)
    assert float(out.rays) == float(ref.rays)
    assert torch.equal(out.rays_lane, ref.rays_lane)
    for f in ("tri", "material", "depth"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    once = tpt.render_pass_narrow(gview, opts, RES, RES, 3, 0, min_width=16)
    assert torch.equal(once.composited.stack(), out.composited.stack())


def test_context_narrow_option():
    """narrow=1 makes render() run NarrowPass; render_batch keeps the
    monolithic pass; both accumulate the same image."""
    storage = tproc.big_room(N_BOXES)
    make = lambda **kw: RenderingContext.create(storage, tproc.big_room_camera(), 12, 8,
                                                device="cpu", max_path_length=3, **kw)
    a, b, c = make(narrow=1), make(), make(narrow=1)
    a.render(1)
    b.render(1)
    c.render_batch(1)
    assert a.view.clusters is not None
    for ctx in (b, c):
        np.testing.assert_allclose(a.fb.composited.numpy(), ctx.fb.composited.numpy(),
                                   atol=2e-5, rtol=1e-5)
        assert float(a.gbuffer["rays"]) == float(ctx.gbuffer["rays"])


@pytest.mark.parametrize("n_tris,tracer,has_clusters,mode", [
    (36, "auto", False, "dense"), (4097, "auto", True, "frontier"),
    (36, "frontier", True, "frontier"), (36, "mega", False, "mega"),
    (36, "cluster", True, "cluster"), (4097, "binned", True, "binned"),
    # the BVH walk: asked for at any size, and "auto" above 4096 triangles
    # on a view without a cluster table (JAX's route off the TPU)
    (4097, "auto", False, "bvh"), (36, "bvh", False, "bvh"),
    # JAX's names of the dense tracer, at any size
    (36, "brute", False, "dense"), (4097, "pallas", True, "dense"),
])
def test_trace_mode_routes(n_tris, tracer, has_clusters, mode):
    assert tpt._trace_mode(n_tris, tpt.PTOptions(tracer=tracer), has_clusters) == mode


@pytest.mark.parametrize("n_tris,tracer", [(36, "frontier"), (36, "binned"), (36, "cluster")])
def test_trace_mode_refuses(n_tris, tracer):
    with pytest.raises(NotImplementedError):
        tpt._trace_mode(n_tris, tpt.PTOptions(tracer=tracer), False)


def write_golden() -> None:
    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes as jax_scene_lobes
    from fermat_tpu.core.camera import Camera
    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.scene.procedural import big_room
    from fermat_tpu.scene.view import SceneView as JaxView

    storage = big_room(N_BOXES)
    view = JaxView.build(storage, Camera.create(eye=(0.0, 3.0, 10.0), aim=(0.0, 1.5, 0.0)))
    lobes = tuple(bool(x) for x in jax_scene_lobes(storage.materials))
    assert lobes == tuple(scene_lobes(tproc.big_room(N_BOXES).materials))
    opts = PTOptions(max_path_length=MPL, lobes=lobes, tracer="frontier")
    out = jax.jit(lambda i: render_pass(view, opts, RES, RES, i, SEED))(jnp.uint32(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(view)
    arrays = {jax.tree_util.keystr(p).lstrip("."): np.asarray(a) for p, a in leaves}
    keep = {f"view.{k}": v for k, v in arrays.items()
            if not k.startswith(("bvh.", "vpls.", "clusters.p0", "clusters.e1", "clusters.e2"))}
    img = lambda v: np.stack([np.asarray(c) for c in v], -1).reshape(RES, RES, 3)
    np.savez_compressed(
        GOLDEN, res=RES, max_path_length=MPL, seed=SEED, instance=0, n_boxes=N_BOXES,
        lobes=np.asarray(lobes), scene=f"big_room(n_boxes={N_BOXES})",
        camera="eye (0, 3, 10), aim (0, 1.5, 0)", tracer="frontier",
        rays=float(out.rays), tri=np.asarray(out.tri).reshape(RES, RES),
        **{c: img(getattr(out, c)) for c in CHANNELS}, **keep)
    print(f"wrote {GOLDEN}: rays={float(out.rays)}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden()
