"""The slice end to end: fermat_tpu_torch's path tracer against fermat_tpu's
on the glossy CornellBox at 32x32, max_path_length=4, seed 0.

Tolerances (the same in chip_smoke.py's comparison with the golden):
  * `rays` (closest + shadow rays traced) within 0.5%. It has been equal on
    the CPU; a one-ulp difference in a Russian-roulette or BSDF decision
    (XLA:CPU fuses a*b+c into FMA and has its own rsqrt/sin/cos/log2) would
    move it by a ray or two, so equality is not demanded.
  * at least 99% of pixels within atol 1e-4, rtol 1e-3 on every channel;
  * each channel's image mean within 1e-3 relative.
Camera rays agree within 1e-6 (not bit-equal, for the same FMA/rsqrt
reason) and the first-hit triangle is equal on every pixel.

Writing the golden: `python tests/test_torch_pt.py` renders the JAX package's
pass on the CPU and stores tests/golden/torch_port_cornell_32.npz (four
channels, `rays`, the config and the JAX scene view's leaves, so that the
card can be held against JAX without JAX). The test below asserts that
JAX's output today still equals the stored file.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu.core.camera import generate_camera_rays as jgen  # noqa: E402
from fermat_tpu.core.rng import TiledSequence as JSeq  # noqa: E402
from fermat_tpu.render.context import RenderingContext as JCtx  # noqa: E402
from fermat_tpu.scene import procedural as jproc  # noqa: E402
from fermat_tpu_torch.core.camera import generate_camera_rays  # noqa: E402
from fermat_tpu_torch.core.rng import TiledSequence  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_cornell_32.npz")
RES, MPL, SEED = 32, 4, 0
CHANNELS = ("composited", "direct", "diffuse", "specular")


def jax_view_arrays(view) -> dict:
    """Leaves of a fermat_tpu SceneView as numpy, keyed by field path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(view)
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(a) for p, a in leaves}


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    """Satellite tolerance on (N, 3) images, see the module docstring."""
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    gm, wm = got.mean(axis=0), want.mean(axis=0)
    np.testing.assert_allclose(gm, wm, rtol=1e-3, atol=1e-7)


def _jax_reference():
    ctx = JCtx.create(jproc.cornell_box(glossy_boxes=True), jproc.cornell_camera(), RES, RES,
                      renderer="pt", seed=SEED, max_path_length=MPL)
    ctx.render(1)
    one = {c: np.asarray(getattr(ctx.fb, c)).reshape(-1, 3) for c in CHANNELS}
    one["tri"] = np.asarray(ctx.gbuffer["tri"]).ravel()
    one["rays"] = float(ctx.gbuffer["rays"])
    ctx.render(1)
    two = {c: np.asarray(getattr(ctx.fb, c)).reshape(-1, 3) for c in CHANNELS}
    return ctx, one, two


@pytest.fixture(scope="module")
def jax_ref():
    """One jitted JAX pass function (the context's), two passes."""
    return _jax_reference()


def test_jax_output_still_matches_golden(jax_ref):
    _, one, _ = jax_ref
    g = np.load(GOLDEN)
    assert float(g["rays"]) == one["rays"]
    for c in CHANNELS:
        np.testing.assert_allclose(g[c].reshape(-1, 3), one[c], rtol=1e-5, atol=1e-6)
    assert (int(g["res"]), int(g["max_path_length"]), int(g["seed"])) == (RES, MPL, SEED)


def test_render_pass_matches_jax(jax_ref):
    ctx, one, _ = jax_ref
    view = SceneView.from_numpy(jax_view_arrays(ctx.view), "cpu")
    opts = tpt.PTOptions(max_path_length=MPL, lobes=ctx.renderer_options["lobes"],
                         clearcoat=ctx.renderer_options["clearcoat"])
    out = tpt.render_pass(view, opts, RES, RES, 0, SEED)

    # camera rays
    pix = jnp.arange(RES * RES, dtype=jnp.uint32)
    seq = JSeq.create(SEED).set_instance(jnp.uint32(0))
    _, jd, _ = jax.jit(lambda p: jgen(ctx.view.camera, RES, RES,
                                      *seq.sample_2d(p, jnp.uint32(0)), p))(pix)
    tpix = torch.arange(RES * RES)
    jx, jy = TiledSequence.create(SEED, 0).sample_2d(tpix, 0)
    _, td, _ = generate_camera_rays(view.camera, RES, RES, jx, jy, tpix)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)

    np.testing.assert_array_equal(out.tri.numpy(), one["tri"])
    assert abs(float(out.rays) - one["rays"]) <= 0.005 * one["rays"]
    for c in CHANNELS:
        assert_image_close(getattr(out, c).stack().numpy(), one[c])
    assert out.rays_lane.shape == (RES * RES,)
    assert float(out.rays_lane.sum()) == float(out.rays)


def test_progressive_render_matches_jax(jax_ref):
    _, _, two = jax_ref
    ctx = RenderingContext.create(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(),
                                  RES, RES, renderer="pt", seed=SEED, max_path_length=MPL,
                                  device="cpu")
    ctx.render(2)
    for c in CHANNELS:
        assert_image_close(getattr(ctx.fb, c).reshape(-1, 3).numpy(), two[c])
    img = ctx.image()
    assert img.shape == (RES, RES, 3) and img.dtype == np.uint8 and img.max() > 0
    stats = ctx.dump_speed_stats()
    assert stats["passes"] == 2 and stats["rays_per_pass"] > RES * RES


def test_render_batch_equals_render():
    make = lambda: RenderingContext.create(tproc.cornell_box(), tproc.cornell_camera(), 8, 8,
                                           max_path_length=2, device="cpu")
    a, b = make(), make()
    a.render(2)
    b.render_batch(2)
    assert torch.equal(a.fb.composited, b.fb.composited) and a.instance == b.instance == 2


def test_port_imports_neither_jax_nor_fermat_tpu():
    code = (
        "import sys, pkgutil, importlib\n"
        "import fermat_tpu_torch\n"
        "for m in pkgutil.walk_packages(fermat_tpu_torch.__path__, 'fermat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fermat_tpu_torch.render.context import RenderingContext\n"
        "from fermat_tpu_torch.scene.procedural import (big_room, big_room_camera,\n"
        "                                               cornell_box, cornell_camera)\n"
        "ctx = RenderingContext.create(cornell_box(), cornell_camera(), 8, 8, device='cpu')\n"
        "ctx.render(1)\n"
        "big = RenderingContext.create(big_room(400), big_room_camera(), 8, 8, device='cpu',\n"
        "                              narrow=1, max_path_length=2)\n"
        "big.render(1)\n"
        "big.render_batch(1)\n"
        "assert big.view.clusters is not None and big.view.lights.compact is not None\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'fermat_tpu' or m.startswith('fermat_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', ctx.image().shape)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok (8, 8, 3)"


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the no-fallback check is for one without")
    with pytest.raises(RuntimeError, match="cuda"):
        RenderingContext.create(tproc.cornell_box(), tproc.cornell_camera(), 8, 8)


@pytest.mark.parametrize("option", [
    # every PTOptions field JAX's PT pass honours is ported (the BVH walk,
    # the VPL set, the LTC lobe, queue compaction, the detach and debug
    # switches: tests/test_torch_options.py, tests/test_torch_bvh.py), and so
    # are JAX's tracer names and the bpt, pssmlt, psfpt, ptrl, mlt, cmlt and
    # rpt renderers (tests/test_torch_bpt.py, tests/test_torch_psf.py,
    # tests/test_torch_mlt.py, tests/test_torch_rpt.py), but not on the
    # megakernel, which runs the PT pass only; the megakernel on a lit view
    # or with the LTC lobe (which JAX's megakernel cannot run) still raises
    {"renderer": "bpt", "tracer": "mega"}, {"renderer": "mlt", "tracer": "mega"},
    {"renderer": "cmlt", "tracer": "mega"},
    {"renderer": "rpt", "tracer": "mega"}, {"renderer": "pssmlt", "tracer": "mega"},
    {"renderer": "psfpt", "tracer": "mega"}, {"renderer": "ptrl", "tracer": "mega"},
    {"tracer": "mega", "glossy_model": "ltc"},
    {"tracer": "mega", "point_lights": [((0.0, 1.5, 0.0), (1.0, 1.0, 1.0))]},
])
def test_options_outside_the_slice_raise(option):
    with pytest.raises(NotImplementedError):
        ctx = RenderingContext.create(tproc.cornell_box(), tproc.cornell_camera(), 4, 4,
                                      device="cpu", **option)
        ctx.render(1)


@pytest.mark.parametrize("name", ["brute", "pallas"])
def test_jax_tracer_names_render_the_dense_pass(name):
    """JAX's tracer names: "brute" (its dense brute force) and "pallas"
    (K1) take the port's dense route at any scene size, so a pass is
    bit-equal to tracer="dense"."""
    assert tpt._trace_mode(5000, tpt.PTOptions(tracer=name), True) == "dense"
    imgs = []
    for tracer in (name, "dense"):
        ctx = RenderingContext.create(tproc.cornell_box(), tproc.cornell_camera(), 8, 8,
                                      device="cpu", tracer=tracer)
        ctx.render(1)
        imgs.append((ctx.hdr_image(), float(ctx.gbuffer["rays"])))
    assert np.array_equal(imgs[0][0], imgs[1][0]) and imgs[0][1] == imgs[1][1]


def test_scene_over_4096_triangles_raises():
    """Over 4096 triangles tracer="auto" takes the frontier tracer on a view
    with a cluster table and the BVH walk on one without (JAX's route off the
    TPU). The walk needs the view's BVH: without one the pass raises; with
    it (view.with_bvh()) every trace of the pass goes through the walk, and
    the pass finds the frontier pass's first hits and image."""
    view = SceneView.build(tproc.random_soup(4097), tproc.cornell_camera(), "cpu")
    assert view.clusters is not None and view.bvh is None
    bare = view._replace(clusters=None)
    opts = tpt.PTOptions(max_path_length=2)
    assert tpt._trace_mode(4097, opts, False) == "bvh"
    with pytest.raises(ValueError, match="BVH"):
        tpt.render_pass(bare, opts, 4, 4, 0)
    calls = []
    closest, anyhit = tpt.trace_closest_bvh, tpt.trace_any_bvh
    tpt.trace_closest_bvh = lambda *a: calls.append("closest") or closest(*a)
    tpt.trace_any_bvh = lambda *a: calls.append("any") or anyhit(*a)
    try:
        out = tpt.render_pass(bare.with_bvh(), opts, 4, 4, 0)
    finally:
        tpt.trace_closest_bvh, tpt.trace_any_bvh = closest, anyhit
    assert calls.count("closest") == 2 and calls.count("any") == 2
    ref = tpt.render_pass(view, opts, 4, 4, 0)
    assert torch.equal(out.tri, ref.tri) and float(out.rays) == float(ref.rays)
    np.testing.assert_allclose(out.composited.stack().numpy(), ref.composited.stack().numpy(),
                               rtol=1e-4, atol=1e-6)


def test_port_copy_alone_renders_with_its_own_data(tmp_path):
    """fermat_tpu_torch/ copied alone, with no fermat_tpu/ beside it, renders
    with the tables it reads from files: the blue-noise shifts, the LTC
    table, and the VPL set the view builds."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "fermat_tpu_torch"), tmp_path / "fermat_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import importlib.util, os, sys\n"
        "import fermat_tpu_torch\n"
        "assert os.path.dirname(fermat_tpu_torch.__file__).startswith(os.getcwd())\n"
        "assert importlib.util.find_spec('fermat_tpu') is None\n"
        "from fermat_tpu_torch.render.context import RenderingContext\n"
        "from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera\n"
        "ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), 8, 8,\n"
        "                              device='cpu', sampler='bluenoise', glossy_model='ltc',\n"
        "                              nee='vpl', max_path_length=3)\n"
        "ctx.render(1)\n"
        "assert ctx.view.vpls is not None and ctx.hdr_image().mean() > 0\n"
        "print('ok', ctx.image().shape)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok (8, 8, 3)"


def test_port_copy_alone_renders_bpt_and_pssmlt(tmp_path):
    """fermat_tpu_torch/ copied alone renders a BPT pass and a PSSMLT pass
    (its seed pass and one step) through RenderingContext."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "fermat_tpu_torch"), tmp_path / "fermat_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    code = (
        "import importlib.util, os\n"
        "import fermat_tpu_torch\n"
        "assert os.path.dirname(fermat_tpu_torch.__file__).startswith(os.getcwd())\n"
        "assert importlib.util.find_spec('fermat_tpu') is None\n"
        "from fermat_tpu_torch.render.context import RenderingContext\n"
        "from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera\n"
        "for r, kw in (('bpt', {}), ('pssmlt', {'n_seed_candidates': 1})):\n"
        "    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), 8,\n"
        "                                  8, renderer=r, device='cpu', max_path_length=3, **kw)\n"
        "    ctx.render(1)\n"
        "    assert ctx.hdr_image().mean() > 0, r\n"
        "print('ok', ctx.image().shape, ctx.renderer_state is not None)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok (8, 8, 3) True"


def write_golden() -> None:
    ctx, one, _ = _jax_reference()
    view = {f"view.{k}": v for k, v in jax_view_arrays(ctx.view).items()
            if not k.startswith(("bvh.", "clusters.", "vpls."))}
    np.savez_compressed(
        GOLDEN, res=RES, max_path_length=MPL, seed=SEED, instance=0,
        lobes=np.asarray(ctx.renderer_options["lobes"]),
        clearcoat=ctx.renderer_options["clearcoat"], scene="cornell_box(glossy_boxes=True)",
        rays=one["rays"], **{c: one[c].reshape(RES, RES, 3) for c in CHANNELS}, **view)
    print(f"wrote {GOLDEN}: rays={one['rays']}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_golden()
