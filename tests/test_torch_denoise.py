"""The port's denoisers (render/denoise.py), checkpoints (render/checkpoint.py)
and viewer (render/viewer.py) against fermat_tpu's, and the slice as a whole:
the command line on a run-time .glb with -view and a scripted key stream.

Tolerances. The denoisers are held to JAX's (its filters jitted, see the
`jax_denoise` fixture) at rtol 2e-5, atol 1e-6 on the same framebuffer and
G-buffer: XLA rounds `img / wgt`, the Gaussian weights' exp and its fused
sums apart from torch (ROADMAP Queue 3, "XLA:CPU rounding"); XBL's
per-pixel shifts are bit-equal. (On the card, chip_smoke.py phase 4o holds
XBL to the CPU at this tolerance on 99% of the pixels: its taps sit at
round(10 r cos(phi)), and the card's sin and cos can move one by an ulp.) The slice-wide test holds the CLI's TGA to
JAX's RenderingContext on the same scene, seed and options: every byte
within 1 and 99% of them equal (the PT passes agree to 1e-4 / 1e-3, which
crosses an 8-bit rounding step now and then), and filtered_image the same
way. A checkpoint restored after N passes and rendered M more equals, bit for
bit, the context rendered N + M passes, for pt and for every stateful
renderer. The viewer's AOV images equal JAX's aov_image applied to the same
context, its ANSI frames and decoded keys JAX's.
"""
import io
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from fermat_tpu_torch.render import denoise as tden  # noqa: E402
from fermat_tpu_torch.render.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.render.framebuffer import Framebuffer  # noqa: E402
from fermat_tpu_torch.render.viewer import SHADING_MODES, Viewer, aov_image, ansi_frame  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402

RES = 16
INSTANCE = 2  # phi_color = (instance^2 + 1) / 1e4
RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(scope="module")
def jax_denoise():
    """JAX's denoise, run as it is (eagerly) with its filters jitted: one EAW
    step compiled once for every step size, the variance prefilter and XBL
    (JAX's eager EAW takes ~16 s a call on this CPU, its whole denoise
    jitted ~20 s to compile)."""
    from fermat_tpu.render import denoise as jd

    step = jax.jit(jd.eaw_step, static_argnames=("params",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd, "eaw_step", lambda img, n, p, m, var, pr, params, s: step(
            img, n, p, m, var, pr, params, jnp.int32(s)))
        mp.setattr(jd, "filter_variance", jax.jit(jd.filter_variance, static_argnums=1))
        mp.setattr(jd, "xbl", jax.jit(jd.xbl, static_argnames=("params", "taps",
                                                               "filter_radius", "sigma")))
        yield jd.denoise


def _synthetic(seed=0):
    """A seeded framebuffer, G-buffer and the CornellBox camera."""
    r = np.random.default_rng(seed)
    f = lambda *s: r.random(s, dtype=np.float32)
    chans = [f(RES, RES, 3) * 2 for _ in range(6)] + [f(RES, RES, 4) * 0.1]
    n = r.normal(size=(RES, RES, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    pos = (f(RES, RES, 3) * 2 - 1).astype(np.float32)
    miss = r.random((RES, RES)) < 0.1
    return chans, n, pos, miss


def _jax_fb(chans):
    from fermat_tpu.render.framebuffer import Framebuffer as JFb

    return JFb(*(jnp.asarray(c) for c in chans))


def _jax_camera():
    from fermat_tpu.scene.procedural import cornell_camera

    return cornell_camera()


@pytest.mark.parametrize("method", ["eaw", "xbl"])
def test_denoise_matches_jax(method, jax_denoise):
    chans, n, pos, miss = _synthetic()
    fb = Framebuffer(*(torch.from_numpy(c) for c in chans))
    got = tden.denoise(fb, torch.from_numpy(n), torch.from_numpy(pos), torch.from_numpy(miss),
                       tproc.cornell_camera().to("cpu"), instance=INSTANCE, method=method)
    want = jax_denoise(_jax_fb(chans), jnp.asarray(n), jnp.asarray(pos), jnp.asarray(miss),
                       _jax_camera(), instance=INSTANCE, method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # miss pixels pass through: direct + demodulated input x albedo
    assert not np.array_equal(got.numpy()[~miss], chans[2][~miss])
    with pytest.raises(ValueError):
        tden.denoise(fb, torch.from_numpy(n), torch.from_numpy(pos), torch.from_numpy(miss),
                     tproc.cornell_camera().to("cpu"), method="nlm")


def test_variance_filter_and_xbl_shifts_match_jax():
    from fermat_tpu.core.rng import hash_combine, uniform_from_bits
    from fermat_tpu.render.denoise import filter_variance

    v = np.random.default_rng(5).random((RES, RES), dtype=np.float32)
    for fw in (1, 2):
        np.testing.assert_allclose(tden.filter_variance(torch.from_numpy(v), fw).numpy(),
                                   np.asarray(jax.jit(filter_variance, static_argnums=1)(
                                       jnp.asarray(v), fw)), rtol=1e-6, atol=0)
    pix = jnp.arange(RES * RES, dtype=jnp.uint32)
    want = np.stack([np.asarray(uniform_from_bits(hash_combine(pix, jnp.uint32(k)))).reshape(
        RES, RES) for k in (17, 37)], -1)
    assert np.array_equal(tden.xbl_shifts(RES, RES, "cpu").numpy(), want)


# ---- checkpoints ----

RENDERERS = {
    "pt": dict(max_path_length=2),
    "pssmlt": dict(max_path_length=3),
    "cmlt": dict(max_path_length=3),
    "psfpt": dict(max_path_length=3),
    "ptrl": dict(max_path_length=3),
}


def _ctx(renderer="pt", res=8, **kw):
    opts = dict(RENDERERS[renderer], **kw)
    return RenderingContext.create(tproc.cornell_box(), tproc.cornell_camera(), res, res,
                                   renderer=renderer, device="cpu", **opts)


@pytest.mark.parametrize("renderer", list(RENDERERS))
def test_checkpoint_resume_equals_the_uninterrupted_run(renderer, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    full = _ctx(renderer)
    full.render(2)
    save_checkpoint(path, full)
    full.render(2)
    resumed = _ctx(renderer)
    load_checkpoint(path, resumed)
    assert resumed.instance == 2
    assert (resumed.renderer_state is None) == (renderer == "pt")
    resumed.render(2)
    for k in Framebuffer._fields:
        assert torch.equal(getattr(resumed.fb, k), getattr(full.fb, k)), k
    if renderer != "pt":  # the state carried on equally
        mine, want = [], []
        from fermat_tpu_torch.render.checkpoint import _flatten

        _flatten(resumed.renderer_state, mine)
        _flatten(full.renderer_state, want)
        assert len(mine) == len(want) and all(np.array_equal(a, b) for a, b in zip(mine, want))


def test_checkpoint_mismatches_raise(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    ctx = _ctx("pt")
    ctx.render(1)
    save_checkpoint(path, ctx)
    with pytest.raises(ValueError, match="renderer"):
        load_checkpoint(path, _ctx("pssmlt"))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, _ctx("pt", res=4))  # another framebuffer size
    data = dict(np.load(path))
    data["structure"] = np.asarray(str(data["structure"]).replace(
        "fermat_tpu_torch.render.framebuffer", "os"))
    np.savez(str(tmp_path / "forged.npz"), **data)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "forged.npz"), _ctx("pt"))
    assert not any(k.endswith(".tmp.npz") for k in os.listdir(tmp_path))


# ---- the viewer ----

def test_aov_modes_ansi_frames_and_keys_match_jax():
    from fermat_tpu.render import viewer as jview

    assert SHADING_MODES == jview.SHADING_MODES
    ctx = _ctx("pt", res=RES)
    for mode in SHADING_MODES:  # before the first pass the G-buffer modes show the composite
        assert np.array_equal(aov_image(ctx, mode), jview.aov_image(ctx, mode)), mode
    ctx.render(2)
    for mode in SHADING_MODES:  # JAX's aov_image reads the port's tensors through numpy
        img = aov_image(ctx, mode)
        assert img.shape == (RES, RES, 3) and np.isfinite(img).all(), mode
        assert np.array_equal(img, jview.aov_image(ctx, mode)), mode
        assert ansi_frame(img, 12, 5) == jview.ansi_frame(img, 12, 5)
    stream = b"a\x1b[Aq\x1b[D\t5"
    assert Viewer.decode_keys(stream) == jview.Viewer.decode_keys(stream)


def test_viewer_keys_move_the_camera_and_restart():
    ctx = _ctx("pt", res=RES)
    ctx.render(2)
    v = Viewer(ctx, out=io.StringIO())
    cam = ctx.view.camera
    for key, want in (("w", cam.walk(0.12)), ("d", cam.walk(0.12).pan(0.12, 0.0)),
                      ("up", cam.walk(0.12).pan(0.12, 0.0).rotate(0.08, 0.0))):
        v.handle_key(key)
        assert ctx.instance == 0 and ctx.renderer_state is None
        for f in ("eye", "aim", "up"):
            assert torch.equal(getattr(ctx.view.camera, f).stack(), getattr(want, f).stack())
    v.handle_key("\t")
    v.handle_key("4")
    assert v.mode == SHADING_MODES[3]
    frames = Viewer(ctx, out=io.StringIO()).run(max_frames=5, input_stream=io.BytesIO(b"\tq"))
    assert frames == 1


# ---- the slice as a whole ----

class _Pipe(io.TextIOWrapper):
    """A stdin that is no terminal, its bytes scripted."""

    def isatty(self):
        return False


def test_cli_view_on_a_glb_matches_jax(tmp_path, monkeypatch, jax_denoise):
    """python -m fermat_tpu_torch -pt -i cornell.glb -view -cpu, fed one key
    chunk a frame through stdin: TAB x10 (to `filtered`), TAB (to
    `variance`), q. Three frames, three passes; the TGA equals the
    in-process context's, and it and filtered_image are held to JAX's."""
    from fermat_tpu.render.context import RenderingContext as JContext
    from fermat_tpu.scene.loaders.gltf import load_gltf as jload
    from fermat_tpu.core.camera import load_camera_file as jcam

    from fermat_tpu_torch.core.camera import load_camera_file
    from fermat_tpu_torch.scene.loaders.fa import load_mesh_any
    from fermat_tpu_torch.scene.loaders.gltf import save_gltf
    from fermat_tpu_torch.utils import cli
    from fermat_tpu_torch.utils.image import read_tga

    glb, cam, out = str(tmp_path / "cornell.glb"), tmp_path / "camera.txt", tmp_path / "v.tga"
    save_gltf(tproc.cornell_box(), glb)
    cam.write_text("0 1 3.5\n0 1 0\n0 1 0\n0.8\n")
    keys = b"".join(k.ljust(64) for k in (b"\t" * 10, b"\t", b"q"))
    monkeypatch.setattr(sys, "stdin", _Pipe(io.BytesIO(keys)))
    frames_out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", frames_out)
    assert cli.main(["-pt", "-i", glb, "-c", str(cam), "-r", str(RES), str(RES), "-passes", "5",
                     "-o", str(out), "-seed", "1", "-cpu", "-view",
                     "-opt", "max_path_length=2"]) == 0
    hud = frames_out.getvalue()
    assert hud.count("mode=") == 3 and "mode=filtered" in hud and "pass 3 mode=variance" in hud

    ctx = RenderingContext.create(load_mesh_any(glb), load_camera_file(str(cam)), RES, RES,
                                  seed=1, device="cpu", max_path_length=2)
    ctx.render(3)
    got = read_tga(str(out))
    assert np.array_equal(got, ctx.image()[..., :3])

    jctx = JContext.create(jload(glb), jcam(str(cam)), RES, RES, renderer="pt", seed=1,
                           max_path_length=2)
    jctx.render(3)

    def near(a, b):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())

    near(got, np.asarray(jctx.image())[..., :3])
    assert jax_denoise is not None  # JAX's filtered_image runs its jitted filters
    near(ctx.filtered_image(), np.asarray(jctx.filtered_image()))
