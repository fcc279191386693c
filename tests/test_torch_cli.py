"""The command line (utils/cli.py, `python -m fermat_tpu_torch`) and the
inputs it reads: the OBJ+MTL, PLY, STL, OFF, .fa and PBRT loaders, the
camera file and the .hdr writer, against fermat_tpu's.

Every scene and file is written to tmp_path at run time. Each loader is
held to JAX's live: the mesh arrays equal, every material's fields equal,
the groups, the camera, the lights and the film settings equal (a baked
checker texture compared by its TGA's bytes, the files living in two
temporary directories). The CLI renders with -cpu at 16x16 and its TGA
equals, byte for byte, the TGA of the port's RenderingContext on the same
loaded scene, seed and passes; -diff prints JAX's RMSE line and writes
JAX's _diff.tga bytes.
"""
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fermat_tpu_torch.core.camera import load_camera_file  # noqa: E402
from fermat_tpu_torch.render.context import RenderingContext, _RENDERER_REGISTRY  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.loaders import fa as tfa  # noqa: E402
from fermat_tpu_torch.scene.loaders import misc as tmisc  # noqa: E402
from fermat_tpu_torch.scene.loaders import obj as tobj  # noqa: E402
from fermat_tpu_torch.scene.loaders import pbrt as tpbrt  # noqa: E402
from fermat_tpu_torch.scene.loaders import ply as tply  # noqa: E402
from fermat_tpu_torch.utils import cli  # noqa: E402
from fermat_tpu_torch.utils import image as timage  # noqa: E402

MESH_ARRAYS = ("vertices", "triangles", "normals", "normal_indices", "uvs", "uv_indices",
               "material_ids", "group_offsets")
# a quad and a pentagon with v/vt/vn, negative (relative) indices, groups
# and objects, a material the MTL does not define
EXTRA_OBJ = """\
mtllib extra.mtl
o first
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl shiny
f 1/1/1 2/2/1 3/3/1 4/4/1
g second part
v 2 0 0
v 3 0 0.5
v 3 1 0
v 2.5 1.5 0
v 2 1 0
usemtl undefined
f -5 -4 -3 -2 -1
g
f -5//1 -4//1 -3//1
"""
EXTRA_MTL = """\
newmtl shiny
Kd 0.5 0.25 0.125
Ks 0.9 0.8 0.7
Ke 0 0 0
Ns 250
Ni 1.45
Tr 0.25
map_Kd tex\\wood.tga
bump bumps.tga
"""


def assert_same_material(a, b) -> None:
    assert vars(a) == vars(b), (vars(a), vars(b))


def assert_same_mesh(got, want) -> None:
    for f in MESH_ARRAYS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert got.group_names == want.group_names
    assert len(got.materials) == len(want.materials)
    for a, b in zip(got.materials, want.materials):
        assert_same_material(a, b)


def assert_same_camera(got, want) -> None:
    if want is None:
        assert got is None
        return
    t = lambda c: [float(x) for v in (c.eye, c.aim, c.up) for x in v] + [float(c.fov)]
    assert t(got) == t(want)


def write_cornell(tmp_path, name="cornell.obj") -> str:
    path = str(tmp_path / name)
    tobj.save_obj(tproc.cornell_box(glossy_boxes=True), path)
    return path


def write_ply(path: str, fmt: str) -> None:
    """A ply with normals, (s, t) and a quad and a triangle, in `fmt`."""
    v = np.array([[0, 0, 0, 0, 0, 1, 0, 0], [1, 0, 0, 0, 0, 1, 1, 0], [1, 1, 0, 0, 0, 1, 1, 1],
                  [0, 1, 0, 0, 0, 1, 0, 1], [0.5, 0.5, 1, 0, 1, 0, 0.5, 0.5]], np.float32)
    faces = [[0, 1, 2, 3], [0, 1, 4]]
    head = (f"ply\nformat {fmt} 1.0\ncomment written by the test\nelement vertex 5\n"
            + "".join(f"property float {n}\n" for n in ("x", "y", "z", "nx", "ny", "nz", "s",
                                                         "t"))
            + "element face 2\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(head.encode())
        if fmt == "ascii":
            for r in v:
                f.write((" ".join(repr(float(x)) for x in r) + "\n").encode())
            for fc in faces:
                f.write((f"{len(fc)} " + " ".join(map(str, fc)) + "\n").encode())
        else:
            e = "<" if fmt == "binary_little_endian" else ">"
            f.write(v.astype(e + "f4").tobytes())
            for fc in faces:
                f.write(struct.pack(e + "B" + "i" * len(fc), len(fc), *fc))


def write_stl_binary(path: str, tris: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", tris.shape[0]))
        for t in tris:
            f.write(b"\0" * 12)
            f.write(np.asarray(t, np.float32).tobytes())
            f.write(b"\0\0")


# ---- the loaders against JAX's ----

def test_obj_and_mtl_match_jax(tmp_path):
    from fermat_tpu.scene.loaders import obj as jobj

    (tmp_path / "extra.obj").write_text(EXTRA_OBJ)
    (tmp_path / "extra.mtl").write_text(EXTRA_MTL)
    for path in (write_cornell(tmp_path), str(tmp_path / "extra.obj")):
        got, want = tobj.load_obj(path), jobj.load_obj(path)
        assert_same_mesh(got, want)
    assert got.n_triangles == 6 and got.group_names == ["first", "second part", "group2"]
    # the CornellBox written by save_obj reads back to the procedural scene
    src = tproc.cornell_box(glossy_boxes=True)
    back = tobj.load_obj(str(tmp_path / "cornell.obj"))
    for f in ("vertices", "triangles", "uvs", "uv_indices", "material_ids"):
        assert np.array_equal(getattr(back, f), getattr(src, f)), f
    for a, b in zip(back.materials, src.materials):
        assert_same_material(a, b)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian", "binary_big_endian"])
def test_ply_matches_jax(tmp_path, fmt):
    from fermat_tpu.scene.loaders import ply as jply

    path = str(tmp_path / "m.ply")
    write_ply(path, fmt)
    got = tply.load_ply(path)
    assert_same_mesh(got, jply.load_ply(path))
    assert got.n_triangles == 3 and got.normals.shape == (5, 3) and got.uvs.shape == (5, 2)


def test_stl_and_off_match_jax(tmp_path):
    """tests/test_cugar_extras.py::TestMiscLoaders's files through both
    packages: a binary STL of the CornellBox's triangles, an ASCII STL, an
    OFF with a quad."""
    from fermat_tpu.scene.loaders import misc as jmisc

    cb = tproc.cornell_box()
    write_stl_binary(str(tmp_path / "m.stl"), cb.vertices[cb.triangles])
    (tmp_path / "a.stl").write_text("solid a\nfacet normal 0 0 1\nouter loop\nvertex 0 0 0\n"
                                    "vertex 1 0 0\nvertex 0 1 0\nendloop\nendfacet\nendsolid a\n")
    (tmp_path / "q.off").write_text("OFF\n4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    for name, fn, jfn, n in (("m.stl", tmisc.load_stl, jmisc.load_stl, cb.n_triangles),
                             ("a.stl", tmisc.load_stl, jmisc.load_stl, 1),
                             ("q.off", tmisc.load_off, jmisc.load_off, 2)):
        got = fn(str(tmp_path / name))
        assert_same_mesh(got, jfn(str(tmp_path / name)))
        assert got.n_triangles == n
        assert_same_mesh(tfa.load_mesh_any(str(tmp_path / name)), got)
    lo, hi = tfa.load_mesh_any(str(tmp_path / "m.stl")).bbox()
    np.testing.assert_allclose(lo, cb.vertices.min(0), atol=1e-5)
    np.testing.assert_allclose(hi, cb.vertices.max(0), atol=1e-5)


def test_fa_composing_two_meshes_matches_jax(tmp_path):
    """A .fa that loads the CornellBox OBJ and a binary PLY, each under its
    own transforms, with a camera and a directional light."""
    from fermat_tpu.scene.loaders import fa as jfa

    write_cornell(tmp_path)
    write_ply(str(tmp_path / "m.ply"), "binary_little_endian")
    (tmp_path / "scene.fa").write_text(textwrap.dedent("""\
        # two meshes
        Begin
          Translate 0.5 0 -1
          RotateY 30
          Scale 2 2 2
          LoadMesh cornell.obj
        End
        Begin
          Transform 1 0 0 0  0 1 0 3  0 0 1 0  0 0 0 1
          RotateX 90
          LoadMesh m.ply
        End
        LoadMesh missing.obj
        Camera persp eye 0 1 6 aim 0 1 0 up 0 1 0 fov 0.8
        DirectionalLight direction 0 -1 -0.5 color 2 2 1.5
        SetMaterial anything
        """))
    path = str(tmp_path / "scene.fa")
    with pytest.raises(FileNotFoundError):
        tfa.load_fa(path)
    got, want = tfa.load_fa(path, strict=False), jfa.load_fa(path, strict=False)
    assert_same_mesh(got.mesh, want.mesh)
    assert got.mesh.group_names == ["default", "ply"]
    assert_same_camera(got.camera, want.camera)
    assert [(d.direction, d.color) for d in got.dir_lights] == \
        [(d.direction, d.color) for d in want.dir_lights]


TRI = ('Shape "trianglemesh" "point P" [0 0 0  1 0 0  0 1 0] '
       '"integer indices" [0 1 2]\n')
# the inline scenes of tests/test_pbrt_loader.py, and one with a plymesh,
# an infinite light from a map, a uv'd mesh with normals and Film settings
PBRT_SCENES = {
    "lookat": "LookAt 1 2 3  1 2 7  0 1 0\n"
              'Camera "perspective" "float fov" [40]\nWorldBegin\n' + TRI,
    "trs": "WorldBegin\nTranslate 10 0 0\nRotate 90 0 0 1\nScale 2 2 2\n" + TRI,
    "attributes": 'WorldBegin\nMakeNamedMaterial "red" "string type" ["matte"] "rgb Kd" '
                  '[1 0 0]\nMakeNamedMaterial "blue" "string type" ["matte"] "rgb Kd" '
                  '[0 0 1]\nNamedMaterial "red"\nAttributeBegin\nNamedMaterial "blue"\n'
                  "Translate 5 0 0\n" + TRI + "AttributeEnd\n" + TRI,
    "film": 'Film "image" "integer xresolution" [64] "integer yresolution" [32] '
            '"float exposure" [2.5] "float gamma" [1.8]\nWorldBegin\n' + TRI,
    "include": 'WorldBegin\nInclude "geo.pbrt"\n',
    "sphere": 'WorldBegin\nTranslate 1 2 3\nShape "sphere" "float radius" [2]\n',
    "disk": 'WorldBegin\nShape "disk" "float radius" [3] "float height" [1]\n'
            'Shape "disk" "float radius" [2] "float innerradius" [1]\n',
    "instance": 'WorldBegin\nObjectBegin "gem"\n' + TRI + 'ObjectEnd\nTranslate 5 0 0\n'
                'ObjectInstance "gem"\nTranslate 0 5 0\nObjectInstance "gem"\n',
    "anonymous": 'WorldBegin\nMaterial "matte" "rgb Kd" [0.2 0.4 0.6]\n' + TRI,
    "arealight": 'WorldBegin\nMaterial "matte" "rgb Kd" [0.5 0.5 0.5]\nAttributeBegin\n'
                 'AreaLightSource "diffuse" "rgb L" [5 6 7]\n' + TRI + "AttributeEnd\n" + TRI,
    "lights": 'WorldBegin\nLightSource "distant" "point from" [0 10 0] "point to" [0 0 0] '
              '"rgb L" [2 2 2]\nLightSource "point" "point from" [1 2 3] "rgb I" [9 9 9]\n'
              + TRI,
    "checker": 'WorldBegin\nTexture "ch" "spectrum" "checkerboard" "rgb tex1" [0 0 0] '
               '"rgb tex2" [1 1 1] "float uscale" [4] "float vscale" [4]\n'
               'Material "matte" "texture Kd" ["ch"]\n' + TRI,
    "imagemap": 'WorldBegin\nTexture "wood" "spectrum" "imagemap" "string filename" '
                '["wood.tga"]\nMaterial "matte" "texture Kd" ["wood"]\n' + TRI,
    "materials": 'WorldBegin\nMaterial "metal"\n' + TRI + 'Material "mirror"\n' + TRI
                 + 'Material "substrate" "rgb Kd" [0.3 0.2 0.1]\n' + TRI
                 + 'Material "glass" "float index" [1.33]\n' + TRI
                 + 'Material "plastic" "rgb Kd" [0.1 0.2 0.3] "float roughness" [0.05]\n'
                 + TRI + 'Material "uber"\n' + TRI,
    "full": 'Film "image" "integer xresolution" [48] "integer yresolution" [40]\n'
            'LookAt 0 1 5  0 1 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'WorldBegin\nLightSource "infinite" "string mapname" ["sky.hdr"] '
            '"float scale" [0.5]\nAttributeBegin\nTranslate 0 0.5 0\n'
            'Shape "plymesh" "string filename" ["m.ply"]\nAttributeEnd\n'
            'Shape "trianglemesh" "point P" [0 0 0  1 0 0  0 1 0  1 1 0] '
            '"normal N" [0 0 1  0 0 1  0 0 1  0 0 1] "float uv" [0 0 1 0 0 1 1 1] '
            '"integer indices" [0 1 2  2 1 3]\n',
    "constant_env": 'WorldBegin\nLightSource "infinite" "rgb L" [0.2 0.3 0.4] '
                    '"float scale" [2]\n' + TRI,
}


@pytest.mark.parametrize("key", list(PBRT_SCENES))
def test_pbrt_matches_jax(tmp_path, key):
    from fermat_tpu.scene.loaders import pbrt as jpbrt
    from fermat_tpu.utils.image import write_tga as jwrite_tga

    (tmp_path / "geo.pbrt").write_text(TRI)
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4] = 0.25
    jwrite_tga(str(tmp_path / "wood.tga"), tex)
    write_ply(str(tmp_path / "m.ply"), "ascii")
    sky = np.random.default_rng(2).random((8, 16, 3)).astype(np.float32) * 2.0
    timage.write_hdr(str(tmp_path / "sky.hdr"), sky)
    (tmp_path / "s.pbrt").write_text(PBRT_SCENES[key])
    path = str(tmp_path / "s.pbrt")
    got, want = tpbrt.load_pbrt(path), jpbrt.load_pbrt(path)
    baked = {}
    for m in (*got.mesh.materials, *want.mesh.materials):
        if m.diffuse_map_name and m.diffuse_map_name != str(tmp_path / "wood.tga"):
            with open(m.diffuse_map_name, "rb") as f:
                baked.setdefault(m.name, []).append(f.read())
            m.diffuse_map_name = "<baked>"
    assert all(len(v) == 2 and v[0] == v[1] for v in baked.values())
    assert (key == "checker") == bool(baked)
    assert_same_mesh(got.mesh, want.mesh)
    assert_same_camera(got.camera, want.camera)
    assert (got.resolution, got.exposure, got.gamma, got.env_radiance) == \
        (want.resolution, want.exposure, want.gamma, want.env_radiance)
    assert (got.env_map is None) == (want.env_map is None)
    if got.env_map is not None:
        assert np.array_equal(got.env_map, want.env_map)
    assert got.point_lights == want.point_lights
    assert [(d.direction, d.color) for d in got.dir_lights] == \
        [(d.direction, d.color) for d in want.dir_lights]


def test_camera_file_and_write_hdr_match_jax(tmp_path):
    """load_camera_file on a 4-line file with commas; write_hdr's bytes
    equal JAX's, and both packages' read_hdr read it back alike."""
    from fermat_tpu.core.camera import load_camera_file as jload
    from fermat_tpu.utils import image as jimage

    p = tmp_path / "camera.txt"
    p.write_text("0.0, 1.0, 3.5\n0 1 0\n0, 1, 0\n0.7\n")
    assert_same_camera(load_camera_file(str(p)), jload(str(p)))
    (tmp_path / "short.txt").write_text("1 2 3\n")
    with pytest.raises(ValueError):
        load_camera_file(str(tmp_path / "short.txt"))
    img = np.random.default_rng(1).random((9, 13, 3)).astype(np.float32) * 4.0
    img[0, 0] = 0.0
    img[1, 1] = 1e-36
    timage.write_hdr(str(tmp_path / "a.hdr"), img)
    jimage.write_hdr(str(tmp_path / "b.hdr"), img)
    assert (tmp_path / "a.hdr").read_bytes() == (tmp_path / "b.hdr").read_bytes()
    got = timage.read_hdr(str(tmp_path / "a.hdr"))
    assert np.array_equal(got, jimage.read_hdr(str(tmp_path / "a.hdr")))
    # RGBE keeps 8 bits of each channel against the pixel's largest; it
    # writes a pixel below 1e-32 as 0
    assert (np.abs(got - img) <= img.max(-1, keepdims=True) / 128 + 1e-32).all()


@pytest.mark.parametrize("ext", [".gltf", ".glb", ".dae"])
def test_cli_renders_gltf_glb_and_dae(tmp_path, ext):
    """The CornellBox written as glTF (JSON with a data URI, or binary) and as
    COLLADA renders through -i at 16x16 on the CPU: the TGA's bytes equal a
    RenderingContext's on the mesh load_mesh_any reads (which is JAX's mesh,
    tests/test_torch_loaders_ext.py)."""
    from fermat_tpu_torch.scene.loaders.dae import save_dae
    from fermat_tpu_torch.scene.loaders.gltf import save_gltf
    from fermat_tpu_torch.utils.image import write_tga

    path = str(tmp_path / f"cornell{ext}")
    (save_dae if ext == ".dae" else save_gltf)(tproc.cornell_box(), path)
    cam, out = _camera(tmp_path), tmp_path / "out.tga"
    assert cli.main(["-i", path, "-c", cam, "-r", "16", "16", "-passes", "2", "-o", str(out),
                     "-cpu"]) == 0
    ctx = RenderingContext.create(tfa.load_mesh_any(path), load_camera_file(cam), 16, 16,
                                  device="cpu")
    ctx.render(2)
    write_tga(str(tmp_path / "want.tga"), ctx.image())
    assert out.read_bytes() == (tmp_path / "want.tga").read_bytes()


def test_cli_view_runs_from_a_scripted_stream(tmp_path):
    """-view as a process whose stdin is a pipe of scripted keys (one 64-byte
    read a frame): TAB to the uv mode, a step forward (the camera moves and
    the accumulation restarts), q. Its frames on stdout, its TGA the last
    image."""
    path = write_cornell(tmp_path)
    out = tmp_path / "view.tga"
    keys = b"".join(k.ljust(64) for k in (b"\t", b"w", b"q"))
    p = subprocess.run([sys.executable, "-m", "fermat_tpu_torch", "-i", path, "-c",
                        _camera(tmp_path), "-r", "8", "8", "-passes", "9", "-o", str(out),
                        "-cpu", "-view"], input=keys, capture_output=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr.decode()
    frames = p.stdout.decode()
    assert "pass 1 mode=shaded" in frames and "pass 2 mode=uv" in frames
    assert "pass 1 mode=uv" in frames.split("pass 2 mode=uv")[1]  # restarted by "w"
    assert "viewer: 3 frames" in p.stderr.decode()
    assert out.stat().st_size == 18 + 8 * 8 * 3  # an 8x8 RGB TGA


# ---- the command line ----

def _in_process(path, cam_path, res, passes, **kw):
    storage = tobj.load_obj(path)
    ctx = RenderingContext.create(storage, load_camera_file(cam_path), res, res, device="cpu",
                                  texture_dir=os.path.dirname(os.path.abspath(path)), **kw)
    ctx.render(passes)
    return ctx


@pytest.mark.parametrize("renderer,opts", [("pt", {}), ("rpt", {"max_path_length": 3})])
def test_cli_image_equals_the_context_image(tmp_path, renderer, opts):
    """-cpu at 16x16: the TGA's bytes equal those of a RenderingContext on
    the loaded scene with the same seed and passes; -benchmark's JSON."""
    import json

    from fermat_tpu_torch.utils.image import write_tga

    path = write_cornell(tmp_path)
    cam = tmp_path / "camera.txt"
    cam.write_text("0 1 3.5\n0 1 0\n0 1 0\n0.8\n")
    out, bench = tmp_path / "out.tga", tmp_path / "bench.json"
    argv = [f"-{renderer}", "-i", path, "-c", str(cam), "-r", "16", "16", "-passes", "2",
            "-o", str(out), "-benchmark", str(bench), "-seed", "3", "-cpu"]
    for k, v in opts.items():
        argv += ["-opt", f"{k}={v}"]
    assert cli.main(argv) == 0
    ctx = _in_process(path, str(cam), 16, 2, renderer=renderer, seed=3, **opts)
    write_tga(str(tmp_path / "want.tga"), ctx.image())
    assert out.read_bytes() == (tmp_path / "want.tga").read_bytes()
    stats = json.loads(bench.read_text())
    assert stats["device"] == "cpu" and stats["renderer"] == renderer
    assert stats["passes"] == 2 and stats["rays_per_s"] > 0 and stats["resolution"] == [16, 16]
    assert stats["launches"] == {}  # the CPU runs the plain versions


def test_cli_save_intermediate_and_ref(tmp_path, capsys):
    path = write_cornell(tmp_path)
    out = tmp_path / "o.tga"
    assert cli.main(["-i", path, "-r", "8", "8", "-passes", "3", "-o", str(out),
                     "-save-intermediate", "-cpu"]) == 0
    assert sorted(p.name for p in tmp_path.glob("o_*.tga")) == ["o_00001.tga", "o_00002.tga"]
    assert cli.main(["-i", path, "-r", "8", "8", "-passes", "1", "-o", str(tmp_path / "r.tga"),
                     "-ref", str(out), "-cpu"]) == 0
    assert "pass 1: RMSE" in capsys.readouterr().err


def test_cli_diff_matches_jax(tmp_path, capsys):
    from fermat_tpu.utils import cli as jcli
    from fermat_tpu.utils.image import write_tga

    r = np.random.default_rng(9)
    write_tga(str(tmp_path / "a.tga"), r.random((12, 10, 3)).astype(np.float32))
    write_tga(str(tmp_path / "b.tga"), r.random((12, 10, 3)).astype(np.float32))
    a, b = str(tmp_path / "a.tga"), str(tmp_path / "b.tga")
    assert cli.main(["-diff", a, b, "-o", str(tmp_path / "t.tga")]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["-diff", a, b, "-o", str(tmp_path / "j.tga")]) == 0
    want = capsys.readouterr().out
    assert got == want and got.startswith("RMSE: ")
    assert (tmp_path / "t_diff.tga").read_bytes() == (tmp_path / "j_diff.tga").read_bytes()


@pytest.mark.parametrize("argv", [["-i", "x.obj", "-nonsense"], ["-pt", "-passes", "2"]])
def test_cli_exit_code_2(argv, capsys):
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "unknown argument" in err or "missing -i" in err


def test_cli_plugin_registers_a_renderer(tmp_path, monkeypatch):
    (tmp_path / "torch_port_cli_plugin.py").write_text(textwrap.dedent("""\
        from fermat_tpu_torch.integrators import pt
        from fermat_tpu_torch.render.context import register_renderer
        CALLS = []

        def register_plugin():
            def factory(**kw):
                CALLS.append(kw)
                return pt.render_pass, pt.PTOptions(**kw)
            register_renderer("hellopt", factory)
        """))
    monkeypatch.syspath_prepend(str(tmp_path))
    path = write_cornell(tmp_path)
    try:
        assert cli.main(["-plugin", "torch_port_cli_plugin", "-hellopt", "-i", path, "-r", "8",
                         "8", "-o", str(tmp_path / "p.tga"), "-opt", "max_path_length=2",
                         "-cpu"]) == 0
        plugin = sys.modules["torch_port_cli_plugin"]
        assert plugin.CALLS and plugin.CALLS[0]["max_path_length"] == 2
        assert (tmp_path / "p.tga").exists()
    finally:
        _RENDERER_REGISTRY.pop("hellopt", None)
        sys.modules.pop("torch_port_cli_plugin", None)


def test_cli_without_cpu_and_no_card_raises(tmp_path):
    """Without -cpu the CLI asks for the card; with none it raises the
    context's error and renders nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    path = write_cornell(tmp_path)
    out = tmp_path / "never.tga"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-i", path, "-r", "8", "8", "-o", str(out)])
    assert not out.exists()


def test_python_dash_m_renders_a_pbrt_scene(tmp_path):
    """`python -m fermat_tpu_torch -cpu` on a .pbrt scene: its Film sets the
    resolution, the TGA is written."""
    (tmp_path / "s.pbrt").write_text(
        'Film "image" "integer xresolution" [8] "integer yresolution" [4]\n'
        'LookAt 0 0 3  0 0 0  0 1 0\nCamera "perspective" "float fov" [50]\nWorldBegin\n'
        'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [4 4 4]\nTranslate 0 0 -1\n'
        + TRI + "AttributeEnd\n" + 'Shape "trianglemesh" "point P" [-2 -2 -2  2 -2 -2  0 2 -2]'
        ' "integer indices" [0 1 2]\n')
    out = tmp_path / "m.tga"
    r = subprocess.run([sys.executable, "-m", "fermat_tpu_torch", "-i", str(tmp_path / "s.pbrt"),
                        "-o", str(out), "-cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert timage.read_tga(str(out)).shape == (4, 8, 3)


def test_dump_speed_stats_detailed_on_the_cpu(tmp_path):
    ctx = _in_process(write_cornell(tmp_path), _camera(tmp_path), 8, 2, renderer="rpt")
    stats = ctx.dump_speed_stats(detailed=True)
    assert {"rt_ms", "shadow_rt_ms", "shade_ms"} <= set(stats)
    assert stats["rt_ms"] > 0 and stats["shadow_rt_ms"] > 0
    assert stats["rt_ms"] + stats["shadow_rt_ms"] + stats["shade_ms"] > 0
    assert ctx.instance == 3  # the profiled pass is one more pass
    assert ctx.rmse_vs(ctx.hdr_image()) == 0.0


def test_capture_trace_and_op_breakdown(tmp_path):
    """capture_trace writes one Chrome trace of three calls after a warm-up;
    op_breakdown sums it by op name."""
    from fermat_tpu_torch.utils.profiling import capture_trace, op_breakdown

    a = torch.ones(64, 64)
    out = capture_trace(lambda: a @ a + 1.0, str(tmp_path / "trace"), n_runs=3)
    assert torch.equal(out, a @ a + 1.0)
    ops = {name: (ms, n) for name, ms, n in op_breakdown(str(tmp_path / "trace"), top=1000)}
    assert ops["aten::mm"][1] == 3 and ops["aten::add"][1] == 3
    assert all(ms >= 0.0 for ms, _ in ops.values())


@pytest.mark.parametrize("name,stage", [
    ("void (anonymous namespace)::closest_kernel<2>(Rays, int)", "rt_ms"),
    ("void (anonymous namespace)::any_kernel<1>(Rays, int)", "shadow_rt_ms"),
    ("void (anonymous namespace)::trace_kernel<true>(Ptrs, int)", "rt_ms"),
    ("void (anonymous namespace)::trace_kernel<false>(Ptrs, int)", "shadow_rt_ms"),
    ("void cluster_kernel<false>(RayPtrs, Table, int, Out)", "shadow_rt_ms"),
    ("void walk_kernel<false>(Walk)", "rt_ms"), ("void walk_kernel<true>(Walk)", "shadow_rt_ms"),
    ("void gather_rows_kernel(float const*, int)", "shade_ms"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "shade_ms")])
def test_kernel_stage_buckets_the_port_kernels(name, stage):
    from fermat_tpu_torch.utils.profiling import kernel_stage

    assert kernel_stage(name) == stage


def _camera(tmp_path) -> str:
    p = tmp_path / "camera.txt"
    p.write_text("0 1 3.5\n0 1 0\n0 1 0\n0.8\n")
    return str(p)
