"""The megakernel path of the port (fermat_tpu_torch/ops/pt_mega.py) against
fermat_tpu's (ops/pallas_pt_mega.py) on the CPU.

The JAX megakernel takes ~30 s per call in Pallas interpret mode here (it
pads every launch to 1024-ray blocks and compiles the whole pass), so the
tests do not run it live: they hold the port's plain versions `_mega_plain`
and `_mega_grad_plain` to a stored JAX golden, and run live JAX only for the
cheap host code (tables, eligibility).

Writing the golden: `JAX_PLATFORMS=cpu python tests/test_torch_mega.py`
renders `render_pass_mega` and `render_grad_diffuse_mega` on the glossy
CornellBox at 32x32, seed 0, in interpret mode, and stores
tests/golden/torch_port_mega_32.npz (four forward configurations, their
options, and the adjoints and gradients of GRAD_CONFIGS). The scene view
of A-C is the one stored in tests/golden/torch_port_cornell_32.npz. The
CornellBox has no transmissive or coated material, so A-C pick no
transmission or coat lobe; D renders procedural.glass_cornell_box, whose
boxes are half transmissive and clearcoated, so that those code paths are
held to JAX too; its gradient is taken without the coat, which the replay
gradient gates out, so that K3b's per-vertex kd/f terms on transmissive
paths are held to JAX's.

Tolerances (those of tests/test_torch_pt.py, see there for why):
  * `rays` within 0.5%;
  * >= 99% of pixels within atol 1e-4 / rtol 1e-3 on every channel, each
    channel's mean within 1e-3 relative;
  * the G-buffer hit flag and `material` equal on >= 99.9% of pixels;
  * the (M, 3) diffuse gradient within rtol 1e-3 of max|g| (measured worst
    case on the CPU 7.0e-07 of max|g| for A and 2.4e-05 for D; the lanes are
    summed in another order than JAX's jnp.sum).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu.bsdf.composite import scene_lobes as jscene_lobes  # noqa: E402
from fermat_tpu.integrators.pt import PTOptions as JOpts  # noqa: E402
from fermat_tpu.ops import pallas_pt_mega as jmega  # noqa: E402
from fermat_tpu.scene import procedural as jproc  # noqa: E402
from fermat_tpu.scene.view import SceneView as JView  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.ops import pt_mega  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_mega_32.npz")
VIEW_GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_cornell_32.npz")
RES, SEED = 32, 0
CHANNELS = ("composited", "direct", "diffuse", "specular")
ALL = (True, True, True, True)
SCENE_LOBES = (True, False, True, False)  # scene_lobes of the glossy CornellBox
# name -> (PTOptions fields, instance)
CONFIGS = {
    "A": (dict(max_path_length=4, lobes=ALL, clearcoat=False), 3),
    "B": (dict(max_path_length=6, lobes=SCENE_LOBES, clearcoat=False), 0),
    "C": (dict(max_path_length=3, lobes=ALL, clearcoat=True), 1),
    "D": (dict(max_path_length=5, lobes=ALL, clearcoat=True), 2),  # glass_cornell
}
GRAD_TARGET = 0.2
# name -> overrides of CONFIGS[name] for the replay gradient (MSE vs GRAD_TARGET)
GRAD_CONFIGS = {"A": {}, "D": {"clearcoat": False}}


def grad_config(name):
    fields, inst = CONFIGS[name]
    return {**fields, **GRAD_CONFIGS[name]}, inst


def glass_cornell(proc):
    """glass_cornell_box of the port, or the same change to JAX's CornellBox."""
    if proc is tproc:
        return tproc.glass_cornell_box()
    storage = proc.cornell_box(glossy_boxes=True)
    for key, value in tproc.GLASS_BOX.items():
        setattr(storage.materials[4], key, value)
    return storage


def _jax_view():
    return JView.build(jproc.cornell_box(glossy_boxes=True), jproc.cornell_camera())


@pytest.fixture(scope="module")
def jview():
    return _jax_view()


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def view():
    """The port's view of the JAX scene view stored with the PT golden."""
    gz = np.load(VIEW_GOLDEN)
    return SceneView.from_numpy({k[5:]: gz[k] for k in gz.files if k.startswith("view.")},
                                "cpu")


def _close_frac(got, want, atol=1e-4, rtol=1e-3) -> float:
    return float(np.isclose(got, want, atol=atol, rtol=rtol).all(axis=1).mean())


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = _close_frac(got, want)
    assert near >= 0.99, f"only {near:.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


def test_e_pwl_coeffs_bit_equal_to_jax():
    rough = np.array([0.0, 0.02, 0.12, 0.37, 0.5, 0.83, 1.0, 1.3], np.float32)
    got = pt_mega._e_pwl_coeffs(rough)
    want = jmega._e_pwl_coeffs(rough)
    assert got.dtype == want.dtype == np.float32 and got.shape == (8, 33)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_tables_match_jax(jview, view):
    tb = pt_mega.build_mega_tables(view, RES, RES, 1e-4)
    jt = jmega.build_mega_tables(jview, RES, RES, 1e-4)
    assert (tb.n_tris, tb.n_mats, tb.n_lights) == (jt.n_tris, jt.n_mats, jt.n_lights)
    for name, cols in (("tri", 53), ("mat", 52), ("light", 17)):
        want = np.asarray(getattr(jt, name))[:, :, 0]
        got = getattr(tb, name).numpy()
        assert got.shape == (want.shape[0], cols)
        np.testing.assert_array_equal(got, want[:, :cols])
        assert not want[:, cols:].any()  # lane padding only
    np.testing.assert_allclose(tb.cam.numpy(), np.asarray(jt.cam)[0, :, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("scene", ["cornell", "soup200"])
@pytest.mark.parametrize("opts", [
    {}, {"clearcoat": True}, {"nee": "vpl"}, {"queue_compaction": True},
    {"debug_nee_no_shadow": True},
])
def test_eligibility_matches_jax(scene, opts):
    make = (lambda p: p.cornell_box(glossy_boxes=True)) if scene == "cornell" else (
        lambda p: p.random_soup(200))
    jv = JView.build(make(jproc), jproc.cornell_camera())
    tv = SceneView.build(make(tproc), tproc.cornell_camera(), "cpu")
    jo, to = JOpts(**opts), tpt.PTOptions(**opts)
    assert pt_mega.mega_eligible(tv, to) == jmega.mega_eligible(jv, jo)
    assert pt_mega.mega_grad_eligible(tv, to) == jmega.mega_grad_eligible(jv, jo)
    if scene == "cornell" and not opts:
        assert pt_mega.mega_grad_eligible(tv, to)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax_golden(golden, view, name):
    fields, inst = CONFIGS[name]
    assert int(golden[f"{name}.instance"]) == inst
    if name == "D":
        view = SceneView.build(glass_cornell(tproc), tproc.cornell_camera(), "cpu")
    opts = tpt.PTOptions(tracer="mega", **fields)
    out = tpt.render_pass(view, opts, RES, RES, inst, SEED)
    want_rays = float(golden[f"{name}.rays"])
    assert abs(float(out.rays) - want_rays) <= 0.005 * want_rays
    assert float(out.rays_lane.sum()) == float(out.rays)
    for c in CHANNELS:
        assert_image_close(getattr(out, c).stack().numpy(), golden[f"{name}.{c}"].reshape(-1, 3))
    for key, got in (("tri", out.tri), ("material", out.material)):
        eq = float((got.numpy() == golden[f"{name}.{key}"].ravel()).mean())
        assert eq >= 0.999, f"{key} equal on only {eq:.4f} of pixels"
    assert set(np.unique(out.tri.numpy())) <= {-1, 1}  # a hit flag, not an id
    hit = out.tri.numpy() > 0
    for key, got in (("depth", out.depth[None].T), ("normal", out.normal.stack()),
                     ("position", out.position.stack())):
        want = golden[f"{name}.{key}"].reshape(len(hit), -1)
        assert _close_frac(got.numpy()[hit], want[hit], atol=1e-5, rtol=1e-4) >= 0.999
    assert np.isinf(out.depth.numpy()[~hit]).all()


@pytest.mark.parametrize("name", sorted(GRAD_CONFIGS))
def test_grad_matches_jax_golden(golden, view, name):
    fields, inst = grad_config(name)
    assert bool(golden[f"grad.{name}.clearcoat"]) == fields["clearcoat"]
    if name == "D":
        view = SceneView.build(glass_cornell(tproc), tproc.cornell_camera(), "cpu")
    opts = tpt.PTOptions(tracer="mega", **fields)
    assert pt_mega.mega_grad_eligible(view, opts)
    adjoint = torch.from_numpy(golden[f"grad.{name}.adjoint"])
    g = pt_mega.render_grad_diffuse_mega(view, opts, RES, RES, inst, adjoint, SEED)
    want = golden[f"grad.{name}"]
    assert g.shape == want.shape == (5, 3)
    scale = float(np.abs(want).max())
    assert scale > 0.0
    np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=1e-3 * scale)


def test_mega_matches_port_dense_pass():
    """tests/test_pt_mega.py's check on the port: tracer="mega" against the
    port's own tracer="auto" pass, 24x24, 4 bounces, same tolerances."""
    res = 24
    v = SceneView.build(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(), "cpu")
    base = dict(max_path_length=4, rr=True)
    ref = tpt.render_pass(v, tpt.PTOptions(**base), res, res, 3)
    got = tpt.render_pass(v, tpt.PTOptions(tracer="mega", **base), res, res, 3)
    for c in CHANNELS:
        np.testing.assert_allclose(getattr(got, c).stack().numpy(),
                                   getattr(ref, c).stack().numpy(), rtol=2e-4, atol=1e-5)
    assert float(got.rays) == float(ref.rays)
    np.testing.assert_array_equal(got.tri.numpy() > 0, ref.tri.numpy() >= 0)
    np.testing.assert_array_equal(got.material.numpy(), ref.material.numpy())


@pytest.mark.parametrize("entry", ["forward", "grad"])
def test_ineligible_view_raises(entry):
    v = SceneView.build(tproc.random_soup(200), tproc.cornell_camera(), "cpu")
    opts = tpt.PTOptions(tracer="mega")
    with pytest.raises(NotImplementedError, match="mega"):
        if entry == "forward":
            tpt.render_pass(v, opts, 4, 4, 0)
        else:
            pt_mega.render_grad_diffuse_mega(v, opts, 4, 4, 0, torch.zeros(16, 3))


def test_render_pass_sees_in_place_material_change():
    """A bare render_pass builds the megakernel's tables from the view on
    every call, as JAX does, so an in-place change of the albedos shows in
    the next pass."""
    v = SceneView.build(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(), "cpu")
    opts = tpt.PTOptions(tracer="mega", max_path_length=2)
    before = tpt.render_pass(v, opts, 8, 8, 0).diffuse.stack()
    v.mesh.materials.diffuse.x.mul_(0.5)
    after = tpt.render_pass(v, opts, 8, 8, 0).diffuse.stack()
    assert float(after[:, 0].sum()) < 0.75 * float(before[:, 0].sum())


def test_context_drives_mega_and_gbuffer_miss(monkeypatch):
    builds = []
    build = pt_mega.build_mega_tables
    monkeypatch.setattr(pt_mega, "build_mega_tables", lambda *a: builds.append(a) or build(*a))
    ctx = RenderingContext.create(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(),
                                  12, 12, renderer="pt", max_path_length=3, tracer="mega",
                                  device="cpu")
    ctx.render(2)
    assert len(builds) == 1  # the context bakes the tables once ...
    ctx.restart()
    ctx.render(1)
    assert len(builds) == 2  # ... and again after restart()
    g = ctx.gbuffer
    assert torch.equal(g["miss"], torch.isinf(g["depth"]))
    assert not bool(g["miss"].any())  # the camera sees only the inside of the box
    assert set(torch.unique(g["tri"]).tolist()) == {1}
    img = ctx.hdr_image()
    assert np.isfinite(img).all() and img.mean() > 0.0


def test_mega_flops_counts_this_kernel_source():
    """chip_smoke.py's MEGA_FLOPS, K3's bound, is a hand count of mega.cu's
    device functions; it names the digest of the device code it was counted
    from, so an edit of that code fails here until the count is redone."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.mega_source_digest() == smoke.MEGA_FLOPS_SOURCE, (
        "mega.cu's device code changed since chip_smoke.MEGA_FLOPS was counted: recount "
        "it, then set MEGA_FLOPS_SOURCE")


def write_golden() -> None:
    jv = _jax_view()
    assert tuple(jscene_lobes(jproc.cornell_box(glossy_boxes=True).materials)) == SCENE_LOBES
    gz = np.load(VIEW_GOLDEN)
    for k in ("mesh.p0.x", "mesh.n0.z", "lights.cdf", "mesh.materials.diffuse.x"):
        kk = k.split(".")
        a = jv
        for part in kk:
            a = getattr(a, part)
        assert np.array_equal(np.asarray(a), gz["view." + k]), k
    tb = jmega.build_mega_tables(jv, RES, RES, 1e-4)
    out = {"res": RES, "seed": SEED, "scene": "cornell_box(glossy_boxes=True)"}
    jv_glass = JView.build(glass_cornell(jproc), jproc.cornell_camera())
    tb_glass = jmega.build_mega_tables(jv_glass, RES, RES, 1e-4)
    for name, (fields, inst) in CONFIGS.items():
        opts = JOpts(tracer="mega", **fields)
        o = jmega.render_pass_mega(jv_glass if name == "D" else jv, opts, RES, RES,
                                   jnp.uint32(inst), SEED, tables=tb_glass if name == "D" else tb)
        out[f"{name}.instance"] = inst
        out[f"{name}.max_path_length"] = fields["max_path_length"]
        out[f"{name}.lobes"] = np.asarray(fields["lobes"])
        out[f"{name}.clearcoat"] = fields["clearcoat"]
        for c in CHANNELS:
            out[f"{name}.{c}"] = np.asarray(getattr(o, c).stack()).reshape(RES, RES, 3)
        for key in ("normal", "position"):
            out[f"{name}.{key}"] = np.asarray(getattr(o, key).stack()).reshape(RES, RES, 3)
        for key in ("depth", "material", "tri"):
            out[f"{name}.{key}"] = np.asarray(getattr(o, key)).reshape(RES, RES)
        out[f"{name}.rays"] = float(o.rays)
        print(f"config {name}: rays {out[f'{name}.rays']}", flush=True)
    out["grad.target"] = GRAD_TARGET
    for name in GRAD_CONFIGS:  # the train step: a forward pass, its MSE adjoint, the replay
        fields, inst = grad_config(name)
        opts = JOpts(tracer="mega", **fields)
        v, t = (jv_glass, tb_glass) if name == "D" else (jv, tb)
        assert jmega.mega_grad_eligible(v, opts)
        img = jmega.render_pass_mega(v, opts, RES, RES, jnp.uint32(inst), SEED,
                                     tables=t).composited.stack()
        adjoint = 2.0 * (img - GRAD_TARGET) / (img.shape[0] * 3)
        g = jmega.render_grad_diffuse_mega(v, opts, RES, RES, jnp.uint32(inst), adjoint,
                                           SEED, tables=t)
        out[f"grad.{name}.adjoint"] = np.asarray(adjoint, np.float32)
        out[f"grad.{name}"] = np.asarray(g, np.float32)
        out[f"grad.{name}.clearcoat"] = fields["clearcoat"]
        print(f"gradient {name}: {out[f'grad.{name}'].tolist()}", flush=True)
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
