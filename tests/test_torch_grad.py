"""The port's differentiable pass (fermat_tpu_torch/integrators/pt.py under
torch.autograd, with K2's backward, ops/gather.py) against fermat_tpu's
jax.grad through render_pass.

jax.grad through the JAX pass compiles for tens of seconds (the JAX suite's
tests/test_gradients.py is marked heavy for that), so the tests hold the port
to a stored golden, tests/golden/torch_port_grad_16.npz, written by
`JAX_PLATFORMS=cpu python tests/test_torch_grad.py`. It holds, at 16x16,
seed 0, the gradient of the mean composited image (averaged over the
instances) with respect to:
  * "cornell": the full (M, 3) materials.diffuse of cornell_box(light_size=
    2.0), max_path_length=3, rr=False, the scene's lobes, instances 0 and 1
    (tests/test_gradients.py::test_fd_diffuse_albedo's configuration);
  * "rough": the full (M,) materials.roughness in the NEE-only direct-light
    configuration of tests/test_gradients.py::test_fd_ggx_roughness (glossy
    boxes of roughness 0.1, max_path_length=2, visible lights, BSDF-sampled
    and indirect lighting off), instances 0-2;
  * "bigroom": the (M, 3) diffuse of big_room(n_boxes=400) with
    tracer="frontier", max_path_length=4 with Russian roulette, the bench
    camera, instance 0; its scene view is the one stored in
    tests/golden/torch_port_bigroom_24.npz.
The views of "cornell" and "rough" are stored beside them, so the port reads
JAX's leaves.

The lit cases (test_lit_grad_matches_jax_golden) read their jax.grad from
tests/golden/torch_port_lights_24.npz, which tests/test_torch_lights.py
writes: the (M, 3) diffuse on its configurations B_nee and C and the (3,)
env scale on B_nee.

Tolerance: the port's gradient within 1e-5 of max|g| of JAX's (the same
estimator with the same detaches; it differs only by float rounding: XLA:CPU
contracts a*b+c into FMAs and sums in another order; measured at most
2.4e-07 of max|g| on the three cases). The other checks hold
the port to itself: the gradient is the same with every tracer (rtol 1e-5,
as tests/test_gradients.py::test_albedo_grad_identical_across_tracers), the
AD gradient equals the replay gradient of ops/pt_mega.py within 1e-5 of
max|g| on a view the replay takes, K2's plain backward equals index_select
under autograd, and a pass under grad computes the same image bit for bit as
one under torch.no_grad().
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.ops import gather  # noqa: E402
from fermat_tpu_torch.ops import pt_mega  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_grad_16.npz")
BIGROOM_VIEW = os.path.join(ROOT, "tests", "golden", "torch_port_bigroom_24.npz")
RES, SEED = 16, 0
CASES = {
    # name: (PTOptions fields beyond the lobes, instances, material field)
    "cornell": (dict(max_path_length=3, rr=False), (0, 1), "diffuse"),
    "rough": (dict(max_path_length=2, rr=False, visible_lights=False,
                   direct_lighting_bsdf=False, indirect_lighting_nee=False,
                   indirect_lighting_bsdf=False), (0, 1, 2), "roughness"),
    "bigroom": (dict(max_path_length=4, tracer="frontier"), (0,), "diffuse"),
}


def with_leaf(view, field: str, requires_grad: bool = True):
    """(view, leaf): the view with materials.<field> replaced by a leaf
    tensor (M, 3) for a Vec3 field, (M,) otherwise, as a caller fitting
    materials builds it."""
    m = view.mesh.materials
    cur = getattr(m, field)
    if isinstance(cur, Vec3):
        leaf = cur.stack().detach().clone().requires_grad_(requires_grad)
        val = Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2])
    else:
        leaf = cur.detach().clone().requires_grad_(requires_grad)
        val = leaf
    mats = m._replace(**{field: val})
    return view._replace(mesh=view.mesh._replace(materials=mats)), leaf


def mean_image_grad(view, opts, instances, field):
    """(loss, d loss / d materials.<field>) of the mean composited image
    averaged over the instances, through torch.autograd."""
    v, leaf = with_leaf(view, field)
    loss = sum(tpt.render_pass(v, opts, RES, RES, i, SEED).composited.stack().mean()
               for i in instances) / len(instances)
    loss.backward()
    return float(loss.detach()), leaf.grad


def _stored_view(z, prefix):
    return SceneView.from_numpy({k[len(prefix):]: z[k] for k in z.files
                                 if k.startswith(prefix)}, "cpu")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _case_view(golden, name):
    if name == "bigroom":
        return _stored_view(np.load(BIGROOM_VIEW), "view.")
    return _stored_view(golden, f"{name}.view.")


def _opts(golden, name):
    kw, _, _ = CASES[name]
    return tpt.PTOptions(lobes=tuple(bool(x) for x in golden[f"{name}.lobes"]), **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_grad_matches_jax_golden(golden, name):
    _, instances, field = CASES[name]
    loss, g = mean_image_grad(_case_view(golden, name), _opts(golden, name), instances, field)
    want = golden[f"{name}.grad"]
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(loss, float(golden[f"{name}.loss"]), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def cornell_built():
    """The port's own build of the golden's CornellBox: it carries the
    cluster table, which every cluster-table tracer needs."""
    return SceneView.build(tproc.cornell_box(light_size=2.0), tproc.cornell_camera(), "cpu")


@pytest.mark.parametrize("tracer", ["frontier", "cluster", "binned"])
def test_grad_identical_across_tracers(golden, cornell_built, tracer):
    opts = _opts(golden, "cornell")
    _, ref = mean_image_grad(cornell_built, opts, (0,), "diffuse")
    _, got = mean_image_grad(cornell_built, opts._replace(tracer=tracer), (0,), "diffuse")
    assert float(ref.abs().max()) > 0.0
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-9)


def test_ad_grad_matches_replay_grad():
    """On a view the megakernel's replay gradient takes, autograd through
    the dense pass and _mega_grad_plain give one gradient for one adjoint
    (an MSE against 0.2)."""
    res = 24
    view = SceneView.build(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(), "cpu")
    opts = tpt.PTOptions(max_path_length=4)
    assert pt_mega.mega_grad_eligible(view, opts)
    v, leaf = with_leaf(view, "diffuse")
    img = tpt.render_pass(v, opts, res, res, 1, SEED).composited.stack()
    adjoint = (2.0 * (img - 0.2) / img.numel()).detach()
    (img * adjoint).sum().backward()
    g_replay = pt_mega.render_grad_diffuse_mega(view, opts, res, res, 1, adjoint, SEED)
    scale = float(leaf.grad.abs().max())
    assert scale > 0.0
    np.testing.assert_allclose(g_replay.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("rows,cols", [(36, 52), (7, 3)])
def test_gather_bwd_plain_equals_index_select_autograd(rows, cols):
    """K2's plain backward against index_select under autograd, out-of-range
    indices included (they add nothing; their forward row is zero)."""
    rng = np.random.default_rng(rows)
    table = torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-3, rows + 3, 4096).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((4096, cols)).astype(np.float32))
    ok = (idx >= 0) & (idx < rows)

    t1 = table.clone().requires_grad_(True)
    out = gather.gather_rows(t1, idx)
    assert torch.equal(out, gather._gather_plain(table, idx))
    (out * g).sum().backward()

    t2 = table.clone().requires_grad_(True)
    ref = t2.index_select(0, idx.clamp(0, rows - 1).long()) * ok[:, None]
    (ref * g).sum().backward()
    np.testing.assert_allclose(t1.grad.numpy(), t2.grad.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(gather._gather_bwd_plain(g, idx, rows), t1.grad)


def test_forward_under_grad_bit_equal_to_no_grad(cornell_built):
    opts = tpt.PTOptions(max_path_length=3)
    v, leaf = with_leaf(cornell_built, "diffuse")
    on = tpt.render_pass(v, opts, RES, RES, 0, SEED)
    with torch.no_grad():
        off = tpt.render_pass(v, opts, RES, RES, 0, SEED)
    assert on.composited.x.requires_grad and not off.composited.x.requires_grad
    for c in ("composited", "direct", "diffuse", "specular", "diffuse_albedo", "normal"):
        a, b = getattr(on, c).stack().detach(), getattr(off, c).stack()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), c
    assert torch.equal(on.tri, off.tri) and float(on.rays) == float(off.rays)


def test_context_and_narrow_pass_record_no_graph(cornell_built):
    v, _ = with_leaf(cornell_built, "diffuse")
    ctx = RenderingContext.create(tproc.cornell_box(), tproc.cornell_camera(), 8, 8,
                                  device="cpu")
    ctx.view = v
    ctx.render(1)
    assert not ctx.fb.composited.requires_grad
    out = tpt.render_pass_narrow(v, tpt.PTOptions(max_path_length=3), 8, 8, 0, min_width=16)
    assert not out.composited.x.requires_grad


def test_emissive_gradient_is_refused(cornell_built):
    """An emissive leaf under a light table that does not follow it (built on
    the host, or on the device from other tensors) would get only the
    emissive-hit half of its gradient: refused, with how to rebuild. With the
    table built on the device from the same tensors
    (MeshLightsView.build_on_device) the pass renders the host table's image
    bit for bit and the leaf gets its gradient."""
    from fermat_tpu_torch.scene.lights import MeshLightsView

    opts = tpt.PTOptions(max_path_length=2)
    v, leaf = with_leaf(cornell_built, "emissive")
    with pytest.raises(NotImplementedError, match="build_on_device"):
        tpt.render_pass(v, opts, 4, 4, 0)
    with torch.no_grad():
        plain = tpt.render_pass(v, opts, 4, 4, 0)
    other = MeshLightsView.build_on_device(cornell_built.mesh)
    with pytest.raises(NotImplementedError, match="emissive"):
        tpt.render_pass(v._replace(lights=other), opts, 4, 4, 0)
    v = v._replace(lights=MeshLightsView.build_on_device(v.mesh))
    assert v.lights.follows(v.mesh.materials.emissive) and v.lights.rows.requires_grad
    out = tpt.render_pass(v, opts, 4, 4, 0)
    assert torch.equal(out.composited.stack().detach(), plain.composited.stack())
    out.composited.stack().mean().backward()
    assert leaf.grad is not None and float(leaf.grad.abs().max()) > 0.0


def test_mega_refuses_a_material_that_requires_grad(cornell_built):
    v, _ = with_leaf(cornell_built, "diffuse")
    opts = tpt.PTOptions(tracer="mega", max_path_length=2)
    with pytest.raises(NotImplementedError, match="mega"):
        tpt.render_pass(v, opts, 4, 4, 0)
    with torch.no_grad():  # no gradient asked for: the megakernel renders
        assert tpt.render_pass(v, opts, 4, 4, 0).composited.x.shape == (16,)


LIGHTS = os.path.join(ROOT, "tests", "golden", "torch_port_lights_24.npz")
# the lit gradient cases of tests/golden/torch_port_lights_24.npz (written by
# tests/test_torch_lights.py): configuration -> (its scene, PTOptions fields)
LIT_CASES = {"B_nee": ("B", dict(max_path_length=2)), "C": ("C", dict(max_path_length=4))}


@pytest.mark.parametrize("name,leaf", [("B_nee", "diffuse"), ("B_nee", "env"),
                                       ("C", "diffuse")])
def test_lit_grad_matches_jax_golden(name, leaf):
    """Through the light model's strategies: jax.grad of the mean composited
    image of one 24x24 pass with respect to the (M, 3) diffuse on the env-lit
    floor (B_nee) and the CornellBox with area, point and directional lights
    (C), and to the (3,) env scale on B_nee (both env strategies, the miss
    pickup and the env NEE, carry it), within 1e-5 of max|g|."""
    z = np.load(LIGHTS)
    scene, kw = LIT_CASES[name]
    view = _stored_view(z, f"{scene}.view.")
    opts = tpt.PTOptions(lobes=tuple(bool(x) for x in z[f"{name}.lobes"]),
                         clearcoat=bool(z[f"{name}.clearcoat"]), **kw)
    if leaf == "env":
        g_leaf = view.env.clone().requires_grad_(True)
        view = view._replace(env=g_leaf)
    else:
        view, g_leaf = with_leaf(view, leaf)
    loss = tpt.render_pass(view, opts, 24, 24, 0, SEED).composited.stack().mean()
    loss.backward()
    want = z[f"{name}.grad.{leaf}"]
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(float(loss.detach()), float(z[f"{name}.loss"]), rtol=1e-4)
    np.testing.assert_allclose(g_leaf.grad.numpy(), want, rtol=0, atol=1e-5 * scale)


def write_golden() -> None:
    import jax
    import jax.numpy as jnp

    from fermat_tpu.bsdf.composite import scene_lobes
    from fermat_tpu.core.camera import Camera
    from fermat_tpu.integrators.pt import PTOptions, render_pass
    from fermat_tpu.scene.procedural import big_room, cornell_box, cornell_camera
    from fermat_tpu.scene.view import SceneView as JaxView

    def leaves(view):
        flat, _ = jax.tree_util.tree_flatten_with_path(view)
        return {jax.tree_util.keystr(p).lstrip("."): np.asarray(a) for p, a in flat}

    rough = cornell_box(light_size=2.0, glossy_boxes=True)
    for m in rough.materials:  # tests/test_gradients.py::test_fd_ggx_roughness
        if m.name == "box":
            m.specular = (0.9, 0.9, 0.9)
            m.diffuse = (0.05, 0.05, 0.05)
            m.phong_exponent = 10.0
    scenes = {"cornell": (cornell_box(light_size=2.0), cornell_camera()),
              "rough": (rough, cornell_camera()),
              "bigroom": (big_room(400), Camera.create(eye=(0.0, 3.0, 10.0),
                                                       aim=(0.0, 1.5, 0.0)))}
    vg = np.load(BIGROOM_VIEW)
    out = {}
    for name, (storage, cam) in scenes.items():
        kw, instances, field = CASES[name]
        view = JaxView.build(storage, cam)
        lobes = tuple(bool(x) for x in scene_lobes(storage.materials))
        opts = PTOptions(lobes=lobes, **kw)
        m = view.mesh.materials
        cur = getattr(m, field)
        vec = hasattr(cur, "x")
        x0 = jnp.stack([cur.x, cur.y, cur.z], axis=1) if vec else cur

        def loss(x, view=view, opts=opts, field=field, vec=vec, instances=instances):
            val = type(getattr(view.mesh.materials, field))(x[:, 0], x[:, 1], x[:, 2]) \
                if vec else x
            v = view._replace(mesh=view.mesh._replace(
                materials=view.mesh.materials._replace(**{field: val})))
            return sum(jnp.mean(render_pass(v, opts, RES, RES, jnp.uint32(i), SEED)
                                .composited.stack()) for i in instances) / len(instances)

        lv, g = jax.jit(jax.value_and_grad(loss))(x0)
        out[f"{name}.grad"] = np.asarray(g)
        out[f"{name}.loss"] = float(lv)
        out[f"{name}.lobes"] = np.asarray(lobes)
        arrays = leaves(view)
        if name == "bigroom":  # the stored view is this view
            for k, a in arrays.items():
                if "view." + k in vg.files:
                    assert np.array_equal(a, vg["view." + k]), k
        else:
            out.update({f"{name}.view.{k}": a for k, a in arrays.items()
                        if not k.startswith(("bvh.", "clusters.", "vpls."))})
        print(f"{name}: loss {float(lv)}, max|g| {np.abs(np.asarray(g)).max()}")
    np.savez_compressed(GOLDEN, res=RES, seed=SEED, **out)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden()
