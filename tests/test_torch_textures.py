"""Textured surfaces and emitters, texel and emitter-radiance gradients, and
the remaining samplers and camera ops of fermat_tpu_torch against fermat_tpu.

The pieces are held to the JAX functions on numpy-seeded inputs: the atlas
build (its leaves exactly equal, for 8-bit, float and non-power-of-two
sources), the samplers of the atlas, the textured-emitter energies, image
I/O, the MTL loader, the bathroom stand-in, pcg_2d and the blue-noise and
white sequences (bit-identical), and the camera ops and CameraSampler.
Whole passes are held to a stored golden, tests/golden/torch_port_textures_24.npz,
written by `JAX_PLATFORMS=cpu python tests/test_torch_textures.py`: JAX's
render_pass on the CPU at 24x24, seed 0, instance 0, the scene's lobes, with
the four channels, the first-hit triangle, `rays` and each scene view's
leaves (the card replays them without JAX). Its configurations:
  T_A  cornell_box(glossy_boxes=True) with scene.procedural.write_cornell_textures's
       seeded 16-texel TGA maps (diffuse on the walls and floor, the white
       one non-power-of-two; specular on the boxes; emissive on the light),
       bilinear, max_path_length=3;
  T_B  the same view, texture_filter="trilinear";
  T_C  cornell_box() with a float PFM diffuse map on the white walls (so
       the atlas has no RGBA8 mirror) and a TGA emissive map on the light;
  T_D  bathroom_standin(n_boxes=200) (2,412 triangles: the dense route and
       the emissive subset of the light table) over write_standin_assets's
       seeded 8-texel material set with one emitter carrying Ke and map_Ke,
       so the subset's textured NEE runs;
  T_E  T_A's view with sampler="bluenoise".
It also holds jax.grad of the mean composited image with respect to the
texels of T_C and of "C2" (T_C's maps on cornell_box(light_size=2.0), the
textured view of tests/test_gradients.py's texel checks), and to the (M, 3)
emissive of the plain cornell_box() ("E", max_path_length=3, rr=False), the
light table rebuilt from it in the loss
(tests/test_gradients.py::test_fd_emitter_radiance), plus each pass's
first-hit uv.

T_C's texel gradient is held at JAX's own first-hit uv. The camera sees
T_C's light at a grazing angle, six pixels at 24x24, and those lanes weigh
most in the emissive map's gradient. There JAX's first-hit uv lies up to
1.3e-6 from the float64 Moller-Trumbore value of the same float32 rays and
triangles, with or without FMAs (an XLA build limited to SSE4.2 is as far
off); the port's lies 2.8e-7 from it. Times the map's width (8), the bilinear
weights move by 1e-5, and the port's own gradient sits 1.31e-05 of max|g|
from jax.grad. With JAX's first-hit uv put in for the port's at bounce 0
it sits 1.2e-7 from it. test_first_hit_uv_is_nearer_exact_than_jax holds the
float64 witness; C2 and E are held with the port's own uv.

Tolerances, those of tests/test_torch_pt.py: `rays` within 0.5%; at least 99%
of pixels within atol 1e-4, rtol 1e-3 on every channel; channel means within
1e-3 relative. The first-hit triangle is equal on T_A-T_C and T_E, and on at
least 99% of T_D's pixels (coplanar box bottoms on the floor). Gradients
within 1e-5 of max|g|. Only test_jax_output_still_matches_golden renders with
JAX (T_B, one jitted pass).
"""
import contextlib
import importlib
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.core import camera as tcam  # noqa: E402
from fermat_tpu_torch.core import rng as trng  # noqa: E402
from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.ops import pt_mega  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext  # noqa: E402
from fermat_tpu_torch.scene import mesh as mesh_mod  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.lights import MeshLightsView, host_arrays  # noqa: E402
from fermat_tpu_torch.scene.loaders.obj import load_mtl  # noqa: E402
from fermat_tpu_torch.scene.mesh_lights import textured_tri_energies  # noqa: E402
from fermat_tpu_torch.scene.textures import TextureAtlas  # noqa: E402
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402
from fermat_tpu_torch.utils import image as timg  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_textures_24.npz")
RES, SEED, INSTANCE = 24, 0, 0
TEX = 16  # the CornellBox maps' size (the card's phase 4h takes 1024)
CHANNELS = ("composited", "direct", "diffuse", "specular")
# name: (scene, PTOptions fields beyond the scene's lobes and clearcoat)
CONFIGS = {
    "T_A": ("A", dict(max_path_length=3)),
    "T_B": ("A", dict(max_path_length=3, texture_filter="trilinear")),
    "T_C": ("C", dict(max_path_length=3)),
    "T_D": ("D", dict(max_path_length=3)),
    "T_E": ("A", dict(max_path_length=3, sampler="bluenoise")),
    # gradient-only configurations
    "C2": ("C2", dict(max_path_length=3)),
    "E": ("E", dict(max_path_length=3, rr=False)),
}
# (configuration, leaf, held at JAX's first-hit uv; see the module docstring)
GRADS = (("T_C", "texels", True), ("C2", "texels", False), ("E", "emissive", False))
PASSES = [n for n in CONFIGS if n.startswith("T_")]


def pfm_map(h=8, w=8, seed=5):
    """tests/test_gradients.py::test_fd_texture_texels's image: float texels
    in [0.25, 1), not 8-bit exact."""
    return (0.25 + 0.75 * np.random.default_rng(seed).random((h, w, 3))).astype(np.float32)


def build_scene(key: str, pkg: str, tmp: str):
    """(storage, camera, SceneView.build keywords) of scene `key` with the
    package `pkg` ("fermat_tpu" or "fermat_tpu_torch"); its assets are
    written (seeded) into the directory `tmp`."""
    proc = importlib.import_module(pkg + ".scene.procedural")
    if key == "A":
        names = tproc.write_cornell_textures(tmp, size=TEX)
        storage = tproc.set_texture_names(proc.cornell_box(glossy_boxes=True), names)
        return storage, proc.cornell_camera(), dict(texture_dir=tmp)
    if key in ("C", "C2"):
        timg.write_pfm(os.path.join(tmp, "wall.pfm"), pfm_map())
        timg.write_tga(os.path.join(tmp, "glow.tga"), tproc._seeded_texture(
            np.random.default_rng(6), 8, 8, lo=64))
        box = proc.cornell_box(light_size=2.0 if key == "C2" else 1.0)
        storage = tproc.set_texture_names(box, {
            "white": {"diffuse_map_name": "wall.pfm"}, "light": {"emissive_map_name": "glow.tga"}})
        return storage, proc.cornell_camera(), dict(texture_dir=tmp)
    if key == "D":
        tproc.write_standin_assets(tmp, size=8, emitter=True)
        storage, cam, tex_dir = proc.bathroom_standin(200, 3, tmp)
        return storage, cam, dict(texture_dir=tex_dir)
    return proc.cornell_box(), proc.cornell_camera(), {}


def assert_image_close(got: np.ndarray, want: np.ndarray) -> None:
    near = np.isclose(got, want, atol=1e-4, rtol=1e-3).all(axis=1)
    assert near.mean() >= 0.99, f"only {near.mean():.4f} of pixels within tolerance"
    np.testing.assert_allclose(got.mean(axis=0), want.mean(axis=0), rtol=1e-3, atol=1e-7)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


_VIEWS = {}


def golden_view(golden, key: str) -> SceneView:
    if key not in _VIEWS:
        p = f"{key}.view."
        _VIEWS[key] = SceneView.from_numpy({k[len(p):]: golden[k] for k in golden.files
                                            if k.startswith(p)}, "cpu")
    return _VIEWS[key]


def golden_opts(golden, name: str, **kw) -> tpt.PTOptions:
    return tpt.PTOptions(lobes=tuple(bool(x) for x in golden[f"{name}.lobes"]),
                         clearcoat=bool(golden[f"{name}.clearcoat"]),
                         **{**CONFIGS[name][1], **kw})


def _tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the atlas ----

def _images(kind: str):
    rng = np.random.default_rng(5)
    if kind == "8bit":
        return [(rng.integers(0, 256, (8, 16, 4)) / 255.0).astype(np.float32),
                (rng.integers(0, 256, (32, 8, 3)) / 255.0).astype(np.float32)]
    if kind == "float":
        return [pfm_map(), rng.random((4, 4)).astype(np.float32)]
    # non-power-of-two 8-bit sources, padded to 64x32 and 8x8
    return [(rng.integers(0, 256, (23, 40, 3)) / 255.0).astype(np.float32),
            (rng.integers(0, 256, (5, 7, 3)) / 255.0).astype(np.float32)]


@pytest.mark.parametrize("kind", ["8bit", "float", "npot"])
def test_atlas_build_matches_jax(kind):
    """Every leaf of TextureAtlas.build exactly equal to JAX's, the RGBA8
    mirror bit for bit (held as int32 bits here), present iff 8-bit."""
    from fermat_tpu.scene.textures import TextureAtlas as JAtlas

    j = JAtlas.build(_images(kind))
    t = TextureAtlas.build(_images(kind), "cpu")
    for f in TextureAtlas._fields[:5]:
        a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (t.packed is None) == (j.packed is None) == (kind == "float")
    if kind != "float":
        for f in ("packed", "packed_q"):
            assert np.array_equal(getattr(t, f).numpy().view(np.uint32), np.asarray(getattr(j, f)))


def _lanes(n, n_tex, seed):
    rng = np.random.default_rng(seed)
    tex = rng.integers(-1, n_tex, n).astype(np.int32)
    u = (rng.random(n, np.float32) * 2.0 - 0.5).astype(np.float32)
    v = (rng.random(n, np.float32) * 2.0 - 0.5).astype(np.float32)
    return tex, u, v


@pytest.mark.parametrize("kind", ["8bit", "float"])
def test_atlas_samplers_match_jax(kind):
    """sample_bilinear0 and sample(lod=None) within 2e-6 of JAX's, each on its
    own branch (the mirror's quad, or four weighted taps; u, v in [-0.5, 1.5]
    wrap); trilinear sample(lod) within 2e-6 on at least 99.9% of lanes, room
    for a lane at an exact texel or level edge that other rounding tips to its
    neighbour. JAX runs op by op here and every lane agrees today."""
    import jax.numpy as jnp

    from fermat_tpu.scene.textures import TextureAtlas as JAtlas

    imgs = _images(kind)
    j, t = JAtlas.build(imgs), TextureAtlas.build(imgs, "cpu")
    tex, u, v = _lanes(4096, len(imgs), 7)
    lod = (np.random.default_rng(8).random(4096, np.float32) * 14.0 - 1.0).astype(np.float32)
    ja = lambda x: jnp.asarray(x)
    for got, want in ((t.sample_bilinear0(_tt(tex), _tt(u), _tt(v)),
                       j.sample_bilinear0(ja(tex), ja(u), ja(v))),
                      (t.sample(_tt(tex), _tt(u), _tt(v)), j.sample(ja(tex), ja(u), ja(v)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)
    got = t.sample(_tt(tex), _tt(u), _tt(v), _tt(lod)).numpy()
    want = np.asarray(j.sample(ja(tex), ja(u), ja(v), ja(lod)))
    near = np.isclose(got, want, rtol=2e-6, atol=2e-6).all(axis=1)
    assert near.mean() >= 0.999, near.mean()


def test_packed_quad_matches_the_taps():
    """tests/test_textures.py::test_bilinear0_fast_path_matches_generic on
    the port: the mirror's one-row quad within 2e-6 of the float taps."""
    imgs = _images("8bit")
    at = TextureAtlas.build(imgs, "cpu")
    tex, u, v = (_tt(a) for a in _lanes(512, 2, 5))
    generic = at._replace(packed=None, packed_q=None).sample_bilinear0(tex, u, v)
    torch.testing.assert_close(at.sample_bilinear0(tex, u, v), generic, rtol=2e-6, atol=2e-6)


def test_level0_offsets_stay_exact_above_2_24_texels():
    """sample_bilinear0's metadata row carries the level-0 offset exactly past
    2^24 texels, where JAX's one float32 column rounds 2^24 + 1 to 2^24 (a
    bathroom-class atlas of 16 maps of 1024^2 holds 22.4 M texels): the quad
    read is the one at the offset. The mirror here is a stride-0 view whose
    word is its own row index."""
    from fermat_tpu_torch.scene.textures import _unpack, level0_meta

    big = (1 << 24) + 1
    words = torch.arange(big + 8, dtype=torch.int32)
    ones = torch.ones((2, 12), dtype=torch.int32)
    offset = ones * torch.tensor([[0], [big]])
    at = TextureAtlas(texels=torch.zeros((1, 4)), offset=offset,
                      width=ones, height=ones, n_levels=torch.ones(2, dtype=torch.int32),
                      packed=words, packed_q=words[:, None].expand(big + 8, 4),
                      meta0=level0_meta(offset, ones, ones))
    half = torch.full((2,), 0.5)
    rgba = at.sample_bilinear0(torch.tensor([1, 0], dtype=torch.int32), half, half)
    assert torch.equal(rgba, _unpack(torch.tensor([big, 0], dtype=torch.int32)))
    assert int(np.float32(big)) != big


def test_replace_texels_drops_the_mirror():
    """tests/test_textures.py::test_replace_texels_drops_packed_mirror on the
    port, and a lone mirror half raises."""
    img = (np.arange(64 * 4).reshape(4, 4, 16)[:, :, :4] % 256 / 255.0).astype(np.float32)
    at = TextureAtlas.build([img], "cpu")
    up = at._replace(texels=at.texels * 0.5)
    assert at.packed is not None and up.packed is None and up.packed_q is None
    tex = torch.zeros(4, dtype=torch.int32)
    u = torch.tensor([0.1, 0.4, 0.6, 0.9])
    a, b = at.sample_bilinear0(tex, u, u), up.sample_bilinear0(tex, u, u)
    torch.testing.assert_close(b[:, :3], 0.5 * a[:, :3], rtol=1e-6, atol=1e-6)
    keep = at._replace(texels=at.texels, packed=at.packed, packed_q=at.packed_q)
    assert keep.packed is at.packed and keep.packed_q is at.packed_q
    with pytest.raises(ValueError, match="together"):
        at._replace(texels=at.texels, packed=at.packed)


# ---- host pieces: energies, image I/O, MTL, the stand-in ----

def test_textured_tri_energies_match_jax(tmp_path):
    """On scene C's view (an emissive map on the light) and D's (a mapped
    emitter material among the clutter): within 1e-6 relative of JAX's. A
    light table built on the device with these weights holds the host
    build's bits."""
    from fermat_tpu.scene.mesh_lights import textured_tri_energies as jenergies
    from fermat_tpu.utils.image import read_image as jread

    for key in ("C", "D"):
        d = str(tmp_path / key)
        os.makedirs(d)
        js, _, kw = build_scene(key, "fermat_tpu", d)
        ts, _, _ = build_scene(key, "fermat_tpu_torch", d)
        names = sorted({n for m in js.materials for n in (m.diffuse_map_name,
                                                           m.specular_map_name,
                                                           m.emissive_map_name) if n})
        path = lambda n: os.path.join(d, n)
        jimgs = [jread(path(n)) for n in names]
        timgs = [timg.read_image(path(n)) for n in names]
        for m in js.materials + ts.materials:
            m.emissive_map = names.index(m.emissive_map_name) if m.emissive_map_name else -1
        want = jenergies(js.device_view(), jimgs)
        mesh = ts.device_view("cpu")
        got = textured_tri_energies(host_arrays(mesh), timgs)
        assert (want > 0).sum() >= 2 and not np.allclose(
            got, textured_tri_energies(host_arrays(mesh), []))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        host, dev = (MeshLightsView.build(host_arrays(mesh), "cpu", got),
                     MeshLightsView.build_on_device(mesh, got))
        assert all(torch.equal(getattr(host, f), getattr(dev, f))
                   for f in ("cdf", "pdf_area", "rows"))


def test_image_io_round_trips_and_matches_jax(tmp_path):
    """The TGA writer's bytes equal JAX's; read_tga (top-left, bottom-left
    and RLE files, RGB and RGBA) and read_pfm (RGB and one channel) equal
    JAX's readers and give back what was written."""
    from fermat_tpu.utils import image as jimg

    rng = np.random.default_rng(9)
    rgba = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    for ch in (3, 4):
        a, b = str(tmp_path / f"t{ch}.tga"), str(tmp_path / f"j{ch}.tga")
        timg.write_tga(a, rgba[..., :ch])
        jimg.write_tga(b, rgba[..., :ch])
        assert open(a, "rb").read() == open(b, "rb").read()
        assert np.array_equal(timg.read_tga(a), rgba[..., :ch])
    # bottom-left origin and RLE, hand-made: 2x2 RGB, one run and one raw packet
    hdr = lambda kind, desc: bytes([0, 0, kind] + [0] * 9 + [2, 0, 2, 0, 24, desc])
    rle = hdr(10, 0) + bytes([0x81, 1, 2, 3, 0x01, 4, 5, 6, 7, 8, 9])
    flat = hdr(2, 0) + bytes(range(12))
    for name, data in (("rle.tga", rle), ("flat.tga", flat)):
        p = str(tmp_path / name)
        open(p, "wb").write(data)
        assert np.array_equal(timg.read_tga(p), jimg.read_tga(p)), name
    f3 = rng.random((6, 5, 3)).astype(np.float32)
    f1 = rng.random((6, 5)).astype(np.float32)
    for img in (f3, f1):
        p = str(tmp_path / f"x{img.ndim}.pfm")
        timg.write_pfm(p, img)
        assert np.array_equal(timg.read_pfm(p), img) and np.array_equal(jimg.read_pfm(p), img)
        assert np.array_equal(timg.read_image(p), jimg.read_image(p))
    assert np.array_equal(timg.read_image(a), jimg.read_image(a))
    with pytest.raises(ValueError, match=".png"):
        timg.read_image(str(tmp_path / "x.png"))


def test_load_mtl_and_the_standin_match_jax(tmp_path):
    """load_mtl on write_standin_assets's .mtl (backslash map paths) equals
    JAX's field for field, and bathroom_standin over it is JAX's mesh."""
    from fermat_tpu.scene.loaders.obj import load_mtl as jload
    from fermat_tpu.scene.procedural import bathroom_standin as jstandin

    tproc.write_standin_assets(str(tmp_path), size=4, emitter=True)
    assert "\\" in open(tmp_path / "bathroom.mtl").read()
    fields = ("name", "diffuse", "specular", "emissive", "phong_exponent", "diffuse_map_name",
              "specular_map_name", "emissive_map_name")
    a, b = load_mtl(str(tmp_path / "bathroom.mtl")), jload(str(tmp_path / "bathroom.mtl"))
    assert [[getattr(m, f) for f in fields] for m in a] == \
        [[getattr(m, f) for f in fields] for m in b]
    assert a[0].diffuse_map_name == "textures/kd_0.tga" and a[-1].emissive_map_name
    ts, tc, tdir = tproc.bathroom_standin(200, 3, str(tmp_path))
    js, jc, jdir = jstandin(200, 3, str(tmp_path))
    assert ts.n_triangles == 2412 and tdir == jdir
    for f in ("vertices", "triangles", "uvs", "uv_indices", "material_ids"):
        assert np.array_equal(getattr(ts, f), getattr(js, f)), f
    assert [m.name for m in ts.materials] == [m.name for m in js.materials]
    assert float(tc.fov) == float(jc.fov)


# ---- samplers and the camera ----

def test_pcg_and_sequences_bit_identical_to_jax():
    """pcg_2d, BlueNoiseSequence (sample_1d/2d/3d at several dimensions and
    instances) and WhiteSequence equal JAX's bit for bit
    (tests/test_bluenoise.py's sampler)."""
    import jax.numpy as jnp

    from fermat_tpu.core import rng as jrng

    r = np.random.default_rng(11)
    a = r.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    b = r.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    got = trng.pcg_2d(_tt(a.astype(np.int64)), _tt(b.astype(np.int64)))
    want = jrng.pcg_2d(jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32)))
    for x, y in zip(got, want):
        assert np.array_equal(x.numpy(), np.asarray(y).astype(np.int64))
    pix = np.arange(37 * 29, dtype=np.uint32)
    bits = lambda t: np.asarray(t, np.float32).view(np.int32)
    for seed, inst in ((0, 0), (7, 5)):
        for name, mk in (("bluenoise", lambda m: m.BlueNoiseSequence.create(seed, inst, 37)),
                         ("white", lambda m: m.WhiteSequence.create(seed, inst))):
            t, j = mk(trng), mk(jrng)
            for dim in (0, 3, 8, 21):
                for fn in ("sample_1d", "sample_2d", "sample_3d"):
                    x = getattr(t, fn)(_tt(pix.astype(np.int64)), dim)
                    y = getattr(j, fn)(jnp.asarray(pix), jnp.uint32(dim))
                    x, y = (x,) if fn == "sample_1d" else x, (y,) if fn == "sample_1d" else y
                    for p, q in zip(x, y):
                        assert np.array_equal(bits(p.numpy()), bits(q)), (name, dim, fn)


def _jcam(m):
    return m.Camera.create((0.3, 1.2, 2.5), (-0.1, 0.9, -0.2), (0.05, 1.0, 0.1), 0.9)


def test_camera_ops_and_sampler_match_jax():
    """walk, pan, zoom, rotate, square_screen_focal_length and CameraSampler
    (sample_direction, invert, pdf, w_e) within 1e-6 of JAX's
    (tests/test_core.py's camera)."""
    import jax.numpy as jnp

    from fermat_tpu.core import camera as jc
    from fermat_tpu.core.math import Vec3 as JVec3

    flat = lambda c: np.array([float(x) for v in (c.eye, c.aim, c.up) for x in v]
                              + [float(c.fov)])
    t0, j0 = _jcam(tcam), _jcam(jc)
    for op, args in (("walk", (0.3,)), ("pan", (0.2, -0.1)), ("zoom", (0.4,)), ("zoom", (9.0,)),
                     ("rotate", (0.3, -0.7))):
        np.testing.assert_allclose(flat(getattr(t0, op)(*args)), flat(getattr(j0, op)(*args)),
                                   rtol=1e-6, atol=1e-6, err_msg=op)
    np.testing.assert_allclose(float(t0.square_screen_focal_length()),
                               float(j0.square_screen_focal_length()), rtol=1e-6)
    ts, js = tcam.CameraSampler.create(t0, 1.5), jc.CameraSampler.create(j0, 1.5)
    r = np.random.default_rng(12)
    nx, ny = (r.random(2048, np.float32) * 1.4 - 0.2).astype(np.float32), \
        (r.random(2048, np.float32) * 1.4 - 0.2).astype(np.float32)
    dt, dj = ts.sample_direction(_tt(nx), _tt(ny)), js.sample_direction(jnp.asarray(nx),
                                                                        jnp.asarray(ny))
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                                    atol=1e-6)
    for a, b in zip(dt, dj):
        close(a, b)
    d = r.standard_normal((2048, 3)).astype(np.float32)
    d[:1024] = np.stack([np.asarray(c) for c in dj], 1)[:1024]  # half inside the frustum
    tv, jv = Vec3(*(_tt(d[:, k]) for k in range(3))), JVec3(*(jnp.asarray(d[:, k])
                                                              for k in range(3)))
    for a, b in zip(ts.invert(tv), js.invert(jv)):
        close(a, b)
    for proj in (False, True):
        np.testing.assert_allclose(ts.pdf(tv, proj).numpy(), np.asarray(js.pdf(jv, proj)),
                                   rtol=1e-5, atol=0)
    close(ts.w_e(tv), js.w_e(jv))
    assert (ts.pdf(tv).numpy()[:1024] > 0).mean() > 0.5


# ---- views and passes ----

def _named_leaves(view) -> dict:
    out = {}

    def walk(p, x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            out[p] = x.numpy() if isinstance(x, torch.Tensor) else x
        elif isinstance(x, tuple) and hasattr(x, "_fields"):
            for f in x._fields:
                walk(f"{p}.{f}" if p else f, getattr(x, f))
        elif isinstance(x, tuple):
            for i, y in enumerate(x):
                walk(f"{p}[{i}]", y)

    walk("", view)
    return out


@pytest.mark.parametrize("key", ["A", "C", "D"])
def test_port_build_equals_the_jax_view(golden, key, tmp_path, capsys):
    """SceneView.build(texture_dir=...) of the port's own scene holds the JAX
    view's leaves bit for bit: the mesh with its map slots, the light table
    weighted by the emissive maps (its CDF and pdf within 1e-6 relative: XLA's
    cumsum and sum against the port's numpy ones), and the atlas with its
    mirror (held as int32 bits here)."""
    storage, cam, kw = build_scene(key, "fermat_tpu_torch", str(tmp_path))
    own = _named_leaves(SceneView.build(storage, cam, "cpu", **kw))
    ref = _named_leaves(golden_view(golden, key))
    # the walk's BVH is built only on request (SceneView.with_bvh), and
    # tests/test_torch_bvh.py holds it to JAX's
    keys = [k for k in ref if "clusters." not in k and not k.startswith("bvh.")
            and ".bvh." not in k]
    assert "textures.texels" in keys and set(keys) <= set(own)
    for k in keys:
        if k.startswith("lights."):
            # XLA's cumsum and sum against numpy's: an ulp apart over many emitters
            np.testing.assert_allclose(own[k], ref[k], rtol=1e-6, atol=0)
        else:
            assert own[k].shape == ref[k].shape and own[k].tobytes() == ref[k].tobytes(), k
    assert "[textures]" not in capsys.readouterr().err


def check_against_golden(out, golden, name: str, tri_share: float = 1.0) -> None:
    want_rays = float(golden[f"{name}.rays"])
    assert abs(float(out.rays) - want_rays) <= 0.005 * want_rays, (float(out.rays), want_rays)
    same_tri = (out.tri.numpy() == golden[f"{name}.tri"]).mean()
    assert same_tri >= tri_share, same_tri
    for c in CHANNELS:
        assert_image_close(getattr(out, c).stack().numpy(), golden[f"{name}.{c}"].reshape(-1, 3))


@pytest.mark.parametrize("name", PASSES)
def test_pass_matches_jax_golden(golden, name):
    view = golden_view(golden, CONFIGS[name][0])
    assert view.has_textures and bool(view.textured_emitters)
    out = tpt.render_pass(view, golden_opts(golden, name), RES, RES, INSTANCE, SEED)
    check_against_golden(out, golden, name, 0.99 if name == "T_D" else 1.0)
    assert float(out.rays_lane.sum()) == float(out.rays)


def test_views_take_their_routes(golden):
    """T_C's atlas has no mirror (a float source); T_D's emissive subset
    serves its NEE; no textured view is the megakernel's."""
    assert golden_view(golden, "C").textures.packed is None
    assert golden_view(golden, "A").textures.packed_q is not None
    assert golden_view(golden, "D").lights.compact is not None
    for key in ("A", "C"):
        view = golden_view(golden, key)
        assert not pt_mega.mega_eligible(view, tpt.PTOptions())
        with pytest.raises(NotImplementedError, match="mega"):
            tpt.render_pass(view, tpt.PTOptions(tracer="mega", max_path_length=2), 4, 4, 0)


def test_trilinear_narrow_pass_equals_monolithic(golden):
    """The carry's cone_width goes through NarrowPass's compaction: with
    texture_filter="trilinear", narrow=1 is the monolithic pass."""
    view, opts = golden_view(golden, "A"), golden_opts(golden, "T_B")
    mono = tpt.render_pass(view, opts, RES, RES, INSTANCE, SEED)
    drv = tpt.NarrowPass(view, opts, RES, RES, SEED, min_width=64)
    narrow = drv(INSTANCE)
    assert any(w < RES * RES for _, _, w in drv.last_profile), drv.last_profile
    assert float(narrow.rays) == float(mono.rays) and torch.equal(narrow.tri, mono.tri)
    for c in CHANNELS:
        np.testing.assert_allclose(getattr(narrow, c).stack().numpy(),
                                   getattr(mono, c).stack().numpy(), rtol=1e-5, atol=1e-6)


@contextlib.contextmanager
def first_hit_uv(uv: torch.Tensor, hit: torch.Tensor):
    """Within the block, bounce 0's shading uv is `uv` (N, 2) on the lanes
    where `hit` (N,) is set: the first call of scene.mesh._shade in a pass
    shades the camera rays' hits."""
    orig, calls = mesh_mod._shade, []

    def shade(r, u, v):
        sh = orig(r, u, v)
        calls.append(r.shape[0])
        if len(calls) > 1:
            return sh
        assert r.shape[0] == uv.shape[0]
        return sh._replace(uv=torch.where(hit[:, None], uv, sh.uv))

    mesh_mod._shade = shade
    try:
        yield
    finally:
        mesh_mod._shade = orig


def port_grad(view, opts, leaf: str):
    """(loss, d loss / d leaf) of the port's pass: the texels through the
    atlas's _replace (the mirror dropped), the (M, 3) emissive with the light
    table rebuilt on the device from the same tensors."""
    if leaf == "texels":
        x = view.textures.texels.detach().clone().requires_grad_(True)
        v = view._replace(textures=view.textures._replace(texels=x))
    else:
        x = view.mesh.materials.emissive.stack().detach().clone().requires_grad_(True)
        mats = view.mesh.materials._replace(emissive=Vec3(x[:, 0], x[:, 1], x[:, 2]))
        mesh = view.mesh._replace(materials=mats)
        v = view._replace(mesh=mesh, lights=MeshLightsView.build_on_device(mesh))
    loss = tpt.render_pass(v, opts, RES, RES, INSTANCE, SEED).composited.stack().mean()
    loss.backward()
    return float(loss.detach()), x.grad.numpy()


@pytest.mark.parametrize("name,leaf,at_jax_uv", GRADS)
def test_grad_matches_jax_golden(golden, name, leaf, at_jax_uv):
    view, opts = golden_view(golden, CONFIGS[name][0]), golden_opts(golden, name)
    if at_jax_uv:
        with first_hit_uv(_tt(golden[f"{name}.uv"].reshape(-1, 2)),
                          _tt(golden[f"{name}.tri"] >= 0)):
            lv, g = port_grad(view, opts, leaf)
    else:
        lv, g = port_grad(view, opts, leaf)
    want = golden[f"{name}.grad.{leaf}"]
    scale = np.abs(want).max()
    assert scale > 0.0 and np.abs(g[want == 0]).max(initial=0.0) <= 1e-5 * scale
    np.testing.assert_allclose(g, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(lv, float(golden[f"{name}.loss"]), rtol=1e-5)


def test_first_hit_uv_is_nearer_exact_than_jax(golden):
    """The float64 witness of T_C's gradient: on the camera rays' hits the
    port's first-hit uv lies within 5e-7 of the float64 Moller-Trumbore uv
    of its own float32 rays and triangles (measured 2.8e-7 on the light,
    where the rays graze it), and JAX's stored uv lies farther from it
    (1.3e-6 there)."""
    view, opts = golden_view(golden, "C"), golden_opts(golden, "T_C")
    out = tpt.render_pass(view, opts, RES, RES, INSTANCE, SEED)
    tri = out.tri.numpy()
    assert np.array_equal(tri, golden["T_C.tri"])
    pix = torch.arange(RES * RES, dtype=torch.int64)
    jx, jy = trng.TiledSequence.create(SEED, INSTANCE).sample_2d(pix, 0)
    o, d, _ = tcam.generate_camera_rays(view.camera, RES, RES, jx, jy, pix)
    hit = tri >= 0
    t = tri[hit]
    col = lambda v: np.stack([c.numpy() for c in v], axis=1).astype(np.float64)
    m = view.mesh
    o, d = col(o)[hit], col(d)[hit]
    p0, e1, e2 = col(m.p0)[t], col(m.e1)[t], col(m.e2)[t]
    pv = np.cross(d, e2)
    inv_det = 1.0 / (e1 * pv).sum(1)
    tv = o - p0
    u = (tv * pv).sum(1) * inv_det
    v = (d * np.cross(tv, e1)).sum(1) * inv_det
    uv_c = lambda c: c.numpy().astype(np.float64)[t]
    exact = (uv_c(m.uv0) * (1.0 - u - v)[:, None] + uv_c(m.uv1) * u[:, None]
             + uv_c(m.uv2) * v[:, None])
    lit = m.materials.emissive_map.numpy()[m.material_id.numpy()[t]] >= 0
    assert lit.sum() > 0
    port = np.abs(out.uv.numpy()[hit] - exact).max(axis=1)
    jax_uv = np.abs(golden["T_C.uv"].reshape(-1, 2)[hit] - exact).max(axis=1)
    assert port.max() <= 5e-7, port.max()
    assert jax_uv[lit].max() > 2.0 * port[lit].max(), (jax_uv[lit].max(), port[lit].max())


def test_context_renders_textures_and_the_blue_noise_sampler(tmp_path):
    """RenderingContext.create(texture_dir=...) with both filters and
    sampler="bluenoise"; a texture found nowhere is map -1, as in JAX."""
    storage, cam, kw = build_scene("A", "fermat_tpu_torch", str(tmp_path))
    means = []
    for opt in ({}, {"texture_filter": "trilinear"}, {"sampler": "bluenoise"}):
        ctx = RenderingContext.create(storage, cam, 8, 8, device="cpu", max_path_length=2,
                                      **kw, **opt)
        ctx.render(1)
        assert ctx.view.has_textures and np.isfinite(ctx.hdr_image()).all()
        means.append(float(ctx.hdr_image().mean()))
    assert min(means) > 0.0 and len(set(means)) == 3
    storage.materials[0].diffuse_map_name = "absent.tga"
    view = SceneView.build(storage, cam, "cpu", texture_dir=str(tmp_path))
    assert storage.materials[0].diffuse_map == -1 and view.has_textures
    with pytest.raises(NotImplementedError, match="sampler"):
        tpt.render_pass(view, tpt.PTOptions(sampler="white"), 4, 4, 0)


# ---- the golden's writer and its live check ----

def _jax_leaves(view) -> dict:
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(view)
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(a) for p, a in flat}


def _jax_view(key, tmp):
    from fermat_tpu.bsdf.composite import scene_clearcoat, scene_lobes
    from fermat_tpu.scene.view import SceneView as JView

    s, c, kw = build_scene(key, "fermat_tpu", tmp)
    lobes = (tuple(bool(x) for x in scene_lobes(s.materials)),
             bool(scene_clearcoat(s.materials)))
    return JView.build(s, c, **kw), lobes


def _jax_opts(lobes, name):
    from fermat_tpu.integrators.pt import PTOptions

    return PTOptions(lobes=lobes[0], clearcoat=lobes[1], **CONFIGS[name][1])


def _jax_pass(view, lobes, name):
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import render_pass

    opts = _jax_opts(lobes, name)
    out = jax.jit(lambda i: render_pass(view, opts, RES, RES, i, SEED))(jnp.uint32(INSTANCE))
    res = {c: np.asarray(getattr(out, c).stack()) for c in CHANNELS}
    res.update(tri=np.asarray(out.tri), uv=np.asarray(out.uv), rays=float(out.rays))
    return res


def test_jax_output_still_matches_golden(golden, tmp_path):
    """JAX's pass today on T_B (one jitted pass) equals the stored golden."""
    view, lobes = _jax_view("A", str(tmp_path))
    got = _jax_pass(view, lobes, "T_B")
    assert got["rays"] == float(golden["T_B.rays"])
    assert np.array_equal(got["tri"], golden["T_B.tri"])
    for c in CHANNELS:
        np.testing.assert_allclose(golden[f"T_B.{c}"].reshape(-1, 3), got[c], rtol=1e-5,
                                   atol=1e-6)


def _jax_grad(view, opts, leaf: str):
    import jax
    import jax.numpy as jnp

    from fermat_tpu.integrators.pt import render_pass
    from fermat_tpu.scene.lights import MeshLightsView as JLights

    def with_leaf(x):
        if leaf == "texels":
            return view._replace(textures=view.textures._replace(texels=x))
        e = view.mesh.materials.emissive
        mats = view.mesh.materials._replace(emissive=type(e)(x[:, 0], x[:, 1], x[:, 2]))
        mesh = view.mesh._replace(materials=mats)
        return view._replace(mesh=mesh, lights=JLights.build(mesh))

    e = view.mesh.materials.emissive
    x0 = view.textures.texels if leaf == "texels" else jnp.stack([e.x, e.y, e.z], axis=1)
    loss = lambda x: jnp.mean(render_pass(with_leaf(x), opts, RES, RES, jnp.uint32(INSTANCE),
                                          SEED).composited.stack())
    lv, g = jax.jit(jax.value_and_grad(loss))(x0)
    return float(lv), np.asarray(g)


def write_golden() -> None:
    out = {"res": RES, "seed": SEED, "instance": INSTANCE,
           # read by chip_smoke.py, which imports no test module
           "configs": json.dumps(CONFIGS), "grads": json.dumps(GRADS)}
    views, lobes = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key in ("A", "C", "C2", "D", "E"):
            os.makedirs(os.path.join(tmp, key))
            views[key], lobes[key] = _jax_view(key, os.path.join(tmp, key))
            out.update({f"{key}.view.{n}": a for n, a in _jax_leaves(views[key]).items()
                        if not n.startswith(("bvh.", "vpls.", "clusters."))})
    for name, (key, _) in CONFIGS.items():
        out.update({f"{name}.lobes": np.asarray(lobes[key][0]),
                    f"{name}.clearcoat": lobes[key][1]})
        if name not in PASSES:
            continue
        got = _jax_pass(views[key], lobes[key], name)
        out.update({f"{name}.{c}": got[c].reshape(RES, RES, 3) for c in CHANNELS})
        out.update({f"{name}.tri": got["tri"], f"{name}.uv": got["uv"].reshape(RES, RES, 2),
                    f"{name}.rays": got["rays"]})
        print(f"{name}: rays {got['rays']}, mean {got['composited'].mean(0)}")
    for name, leaf, _ in GRADS:
        key = CONFIGS[name][0]
        lv, g = _jax_grad(views[key], _jax_opts(lobes[key], name), leaf)
        out[f"{name}.grad.{leaf}"], out[f"{name}.loss"] = g, lv
        print(f"{name} d/d {leaf}: loss {lv}, max|g| {np.abs(g).max()}")
    np.savez_compressed(GOLDEN, **out)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_golden()
