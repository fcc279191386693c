"""The port's glTF and COLLADA loaders, its compressed attributes and its
binding of the native host runtime, against fermat_tpu's.

Every file is written at run time (the inline cases of
tests/test_gltf_loader.py and test_dae_loader.py, whose asset files are
absent). Where JAX's loader is right the port's mesh equals it, array for
array and material for material; where it is at fault (ROADMAP Queue 3) the
port's differs and the test pins the difference. The packed attribute words
equal JAX's bit for bit. The native library is built from
native/fermat_native.cpp into fermat_tpu_torch/_build/ and never touches
native/: its OBJ parse and its BVH equal JAX's, and a failed build raises.
"""
import base64
import hashlib
import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_dae_loader import _doc, _tri_geom  # noqa: E402
from test_gltf_loader import _quad_bin, _quad_gltf_dict, _write_glb  # noqa: E402

from fermat_tpu.scene.loaders.dae import load_dae as jload_dae  # noqa: E402
from fermat_tpu.scene.loaders.gltf import load_gltf as jload_gltf  # noqa: E402
from fermat_tpu_torch.scene import compression as tcomp  # noqa: E402
from fermat_tpu_torch.scene import procedural as tproc  # noqa: E402
from fermat_tpu_torch.scene.loaders import dae as tdae  # noqa: E402
from fermat_tpu_torch.scene.loaders import fa as tfa  # noqa: E402
from fermat_tpu_torch.scene.loaders import gltf as tgltf  # noqa: E402
from fermat_tpu_torch.utils import native as tnative  # noqa: E402

ARRAYS = ("vertices", "triangles", "normals", "normal_indices", "uvs", "uv_indices",
          "material_ids", "group_offsets")


def assert_same_mesh(a, b) -> None:
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    assert a.group_names == b.group_names
    assert [vars(m) for m in a.materials] == [vars(m) for m in b.materials]


# ---- compression ----

def test_packed_words_equal_jax_and_every_consumer_resolves_them(tmp_path):
    from fermat_tpu.scene import compression as jcomp
    from fermat_tpu.scene.procedural import cornell_box as jcornell

    r = np.random.default_rng(3)
    n = r.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]
    words = tcomp.compress_normals(n)
    assert words.dtype == np.uint32 and np.array_equal(words, jcomp.compress_normals(n))
    assert np.array_equal(tcomp.decompress_normals(words), jcomp.decompress_normals(words))
    uv = (r.random((4096, 2)) * 3 - 1).astype(np.float32)
    bias, scale = tcomp.uv_bias_scale(uv)
    jb, js = jcomp.uv_bias_scale(uv)
    assert np.array_equal(bias, jb) and np.array_equal(scale, js)
    pw = tcomp.compress_uv(uv, bias, scale)
    assert np.array_equal(pw, jcomp.compress_uv(uv, jb, js))
    assert np.array_equal(tcomp.decompress_uv(pw, bias, scale), jcomp.decompress_uv(pw, jb, js))

    mine = tproc.cornell_box()
    mine.normals, mine.normal_indices = n[:mine.n_vertices], mine.triangles.copy()
    ref = jcornell()
    ref.normals, ref.normal_indices = mine.normals.copy(), mine.triangles.copy()
    mine.compress_normals().compress_tex()
    ref.compress_normals().compress_tex()
    for k in ("normals_packed", "uvs_packed", "uv_bias", "uv_scale"):
        assert np.array_equal(getattr(mine, k), getattr(ref, k)), k
    assert mine.normals.shape[0] == 0 and mine.uvs.shape[0] == 0
    view, jview = mine.device_view("cpu"), ref.device_view()
    for k in ("n0", "n1", "n2"):
        np.testing.assert_array_equal(getattr(view, k).stack().numpy(),
                                      np.asarray(getattr(jview, k).stack()))
    for k in ("uv0", "uv1", "uv2", "lod_base"):
        np.testing.assert_array_equal(getattr(view, k).numpy(), np.asarray(getattr(jview, k)))
    # filtered, merge, transform and save_obj read the packed attributes
    keep = np.arange(mine.n_triangles) % 2 == 0
    f = mine.filtered(keep).device_view("cpu")
    np.testing.assert_array_equal(f.n1.stack().numpy(), view.n1.stack().numpy()[keep])
    both = tproc.cornell_box().merge(mine)
    np.testing.assert_array_equal(both.device_view("cpu").uv2.numpy()[36:], view.uv2.numpy())
    from fermat_tpu_torch.scene.loaders.obj import load_obj, save_obj

    save_obj(mine, str(tmp_path / "packed.obj"))
    back = load_obj(str(tmp_path / "packed.obj"))
    np.testing.assert_array_equal(back.normals, mine._resolved_normals())
    np.testing.assert_array_equal(back.uvs, mine._resolved_uvs())
    m = np.diag([2.0, 1.0, 1.0, 1.0])
    mine.transform(m)
    assert mine.normals_packed is not None and mine.normals.shape[0] == 0
    tn = mine._resolved_normals()
    np.testing.assert_allclose(tn, tcomp.decompress_normals(tcomp.compress_normals(
        back.normals @ np.linalg.inv(m[:3, :3]).T / np.linalg.norm(
            back.normals @ np.linalg.inv(m[:3, :3]).T, axis=1, keepdims=True))), atol=0)


# ---- glTF ----

def _gltf_case(name, tmp_path):
    """(path) of one of the oracle's inline glTF cases, written to tmp_path."""
    blob, _ = _quad_bin()
    g = _quad_gltf_dict(len(blob))
    p = tmp_path / f"{name}.glb"
    if name == "data_uri":
        g = _quad_gltf_dict(len(blob), uri="data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode())
        p = tmp_path / "quad.gltf"
        p.write_text(json.dumps(g))
        return p
    if name == "external_bin":
        (tmp_path / "quad.bin").write_bytes(blob)
        p = tmp_path / "ext.gltf"
        p.write_text(json.dumps(_quad_gltf_dict(len(blob), uri="quad.bin")))
        return p
    if name == "hierarchy":
        g["nodes"] = [{"children": [1, 2], "translation": [0, 0, 5]},
                      {"mesh": 0, "rotation": [0, 1, 0, 0]},
                      {"mesh": 0, "scale": [-1, 1, 1]},
                      {"mesh": 0, "matrix": [2, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 1, 2, 3, 1]}]
        g["scenes"] = [{"nodes": [0, 3]}]
    elif name in ("strip", "fan"):
        g["meshes"][0]["primitives"][0]["mode"] = 5 if name == "strip" else 6
        g["accessors"][3]["count"] = 4
        order = [0, 1, 3, 2] if name == "strip" else [0, 1, 2, 3]
        blob = blob[:112] + np.array(order, "<u2").tobytes() + blob[112 + 8:]
        g["bufferViews"][2]["byteLength"] = 8
    elif name == "no_indices":
        del g["meshes"][0]["primitives"][0]["indices"]
        g["accessors"][0]["count"] = g["accessors"][1]["count"] = 3
        g["accessors"][2]["count"] = 3
        del g["meshes"][0]["primitives"][0]["material"]
    _write_glb(p, g, blob)
    return p


@pytest.mark.parametrize("name", ["glb", "data_uri", "external_bin", "hierarchy", "strip",
                                  "fan", "no_indices"])
def test_gltf_matches_jax(name, tmp_path):
    p = str(_gltf_case(name, tmp_path))
    mine = tgltf.load_gltf(p)
    assert_same_mesh(mine, jload_gltf(p))
    assert_same_mesh(tfa.load_mesh_any(p), mine)


def test_gltf_faults_of_the_reference_are_not_carried(tmp_path):
    """No `scenes` key: JAX walks every node as a root, so a child's mesh
    lands twice (gltf.py:204); the port walks the roots. `scenes: []`: JAX
    raises IndexError; the port reads the roots."""
    blob, pos = _quad_bin()
    g = _quad_gltf_dict(len(blob))
    del g["scenes"], g["scene"]
    g["nodes"] = [{"children": [1], "translation": [0, 0, 5]}, {"mesh": 0}]
    p = tmp_path / "noscene.glb"
    _write_glb(p, g, blob)
    mine, ref = tgltf.load_gltf(str(p)), jload_gltf(str(p))
    assert mine.n_triangles == 2 and ref.n_triangles == 4
    np.testing.assert_allclose(mine.vertices, pos + [0, 0, 5])
    np.testing.assert_allclose(ref.vertices[4:], pos)  # the child again, as a root
    g["scenes"] = []
    _write_glb(p, g, blob)
    with pytest.raises(IndexError):
        jload_gltf(str(p))
    np.testing.assert_array_equal(tgltf.load_gltf(str(p)).vertices, mine.vertices)


# ---- COLLADA ----

_MATERIAL = """
  <library_images><image id="img0"><init_from>wood.png</init_from></image>
  </library_images>
  <library_effects><effect id="e0"><profile_COMMON>
    <newparam sid="surf"><surface type="2D"><init_from>img0</init_from>
    </surface></newparam>
    <newparam sid="samp"><sampler2D><source>surf</source></sampler2D>
    </newparam>
    <technique sid="common"><phong>
      <emission><color>0.1 0.2 0.3</color></emission>
      <diffuse><texture texture="samp" texcoord="uv0"/></diffuse>
      <specular><color>0.5 0.5 0.5</color></specular>
      <shininess><float>32</float></shininess>
    </phong></technique>
  </profile_COMMON></effect></library_effects>
  <library_materials><material id="mat0" name="wood">
    <instance_effect url="#e0"/></material></library_materials>
  <library_visual_scenes><visual_scene id="vs"><node>
    <instance_geometry url="#g0">
      <bind_material><technique_common>
        <instance_material symbol="m0" target="#mat0"/>
      </technique_common></bind_material>
    </instance_geometry>
  </node></visual_scene></library_visual_scenes>"""
_INSTANCES = """
  <library_visual_scenes><visual_scene id="vs">
    <node><translate>0 0 5</translate>
      <node><rotate>0 1 0 180</rotate><instance_geometry url="#g0"/></node>
      <node><scale>-1 1 1</scale><instance_geometry url="#g0"/></node>
      <node><matrix>1 0 0 1  0 2 0 0  0 0 1 0  0 0 0 1</matrix>
        <instance_geometry url="#g0"/></node>
    </node>
  </visual_scene></library_visual_scenes>"""
_POLYLIST = """
  <library_geometries><geometry id="q"><mesh>
    <source id="q-pos"><float_array id="q-pa" count="15">
      0 0 0  1 0 0  1 1 0  0 1 0  0.5 1.5 0</float_array>
      <technique_common><accessor source="#q-pa" count="5" stride="3"/>
      </technique_common></source>
    <vertices id="q-v"><input semantic="POSITION" source="#q-pos"/>
    </vertices>
    <polylist count="2" material="m">
      <input semantic="VERTEX" source="#q-v" offset="0"/>
      <vcount>4 3</vcount>
      <p>0 1 2 3  3 2 4</p>
    </polylist>
  </mesh></geometry></library_geometries>"""
DAE_CASES = {
    "split_streams_and_material": (_tri_geom() + _MATERIAL, "Y_UP"),
    "z_up": (_tri_geom() + _INSTANCES, "Z_UP"),
    "x_up": (_tri_geom(), "X_UP"),
    "instancing": (_tri_geom() + _INSTANCES, "Y_UP"),
    "polylist": (_POLYLIST, "Y_UP"),
}


@pytest.mark.parametrize("name", list(DAE_CASES))
def test_dae_matches_jax(name, tmp_path):
    body, up = DAE_CASES[name]
    p = tmp_path / f"{name}.dae"
    p.write_text(_doc(body, up=up))
    mine = tdae.load_dae(str(p))
    assert_same_mesh(mine, jload_dae(str(p)))
    assert_same_mesh(tfa.load_mesh_any(str(p)), mine)


def test_dae_faults_of_the_reference_are_not_carried(tmp_path):
    """An empty <p> of a polylist crashes JAX's loader (dae.py:226) and is an
    empty primitive here; <transparency>, which JAX never parses, sets the
    opacity (A_ONE: alpha x transparency; RGB_ZERO: 1 - luminance x it)."""
    empty = ('<geometry id="empty"><mesh><source id="e-pos"><float_array id="e-pa" '
             'count="3">0 0 0</float_array><technique_common><accessor source="#e-pa" '
             'count="1" stride="3"/></technique_common></source><vertices id="e-v">'
             '<input semantic="POSITION" source="#e-pos"/></vertices><polylist count="0" '
             'material="m"><input semantic="VERTEX" source="#e-v" offset="0"/><vcount>'
             '</vcount><p></p></polylist></mesh></geometry>')
    p = tmp_path / "empty.dae"
    p.write_text(_doc(_tri_geom().replace("</library_geometries>",
                                          empty + "</library_geometries>")))
    with pytest.raises((ValueError, IndexError)):
        jload_dae(str(p))
    mine = tdae.load_dae(str(p))
    assert mine.n_triangles == 1 and mine.group_offsets.tolist() == [0, 1, 1]
    for opaque, transparent, want in (("A_ONE", "1 1 1 0.5", 0.125), ("RGB_ZERO", "1 1 1 1", 0.75)):
        mat = _MATERIAL.replace(
            "<shininess>", f'<transparent opaque="{opaque}"><color>{transparent}</color>'
            '</transparent><transparency><float>0.25</float></transparency><shininess>')
        p = tmp_path / f"transparent_{opaque}.dae"
        p.write_text(_doc(_tri_geom() + mat))
        assert jload_dae(str(p)).materials[0].opacity == 1.0
        assert tdae.load_dae(str(p)).materials[0].opacity == pytest.approx(want)


# ---- the scene writers ----

@pytest.mark.parametrize("ext", [".gltf", ".glb", ".dae"])
def test_written_scenes_read_back_in_both_packages(ext, tmp_path):
    """save_gltf / save_dae (the port's writers) round-trip the CornellBox's
    triangles, corner uvs and materials; JAX's loader reads the same mesh."""
    box = tproc.cornell_box()
    p = str(tmp_path / f"cornell{ext}")
    (tdae.save_dae if ext == ".dae" else tgltf.save_gltf)(box, p)
    mine = tfa.load_mesh_any(p)
    assert_same_mesh(mine, (jload_dae if ext == ".dae" else jload_gltf)(p))
    a, b = box.device_view("cpu"), mine.device_view("cpu")
    for k in ("p0", "e1", "e2", "gn"):
        np.testing.assert_array_equal(getattr(a, k).stack().numpy(), getattr(b, k).stack().numpy())
    np.testing.assert_allclose(b.uv2.numpy(), a.uv2.numpy(), atol=1e-7)
    np.testing.assert_array_equal(a.material_id.numpy(), b.material_id.numpy())
    for x, y in zip(box.materials, mine.materials):
        assert np.allclose(x.diffuse, y.diffuse) and np.allclose(x.emissive, y.emissive)
        assert x.roughness == y.roughness and x.opacity == y.opacity


def test_load_mesh_any_dispatch(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        tfa.load_mesh_any(str(tmp_path / "model.fbx"))


# ---- the native runtime ----

def _native_dir_digest():
    h = hashlib.sha256()
    for f in sorted(os.listdir(os.path.join(ROOT, "native"))):
        with open(os.path.join(ROOT, "native", f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_native_obj_parse_equals_jaxs_on_a_large_file(tmp_path):
    """A file of at least 1 MB parses natively in both packages: the same
    MeshStorage; the library is the port's own build and native/ is left as
    it was."""
    from fermat_tpu.scene.loaders.obj import load_obj as jload_obj

    from fermat_tpu_torch.scene.loaders import obj as tobj

    before = _native_dir_digest()
    soup = tproc.random_soup(9000, seed=4)
    soup.normals = soup.vertices[:, ::-1].copy()
    soup.normal_indices = soup.triangles[:, ::-1].copy()
    path = str(tmp_path / "big.obj")
    tobj.save_obj(soup, path)
    assert os.path.getsize(path) >= tobj._NATIVE_MIN_BYTES
    mine = tobj.load_obj(path)
    assert_same_mesh(mine, jload_obj(path))
    assert mine.group_names == ["default"]
    py = tobj._load_obj_python(path)
    for k in ("vertices", "triangles", "normals", "normal_indices", "material_ids"):
        assert np.array_equal(getattr(py, k), getattr(mine, k)), k
    lib = tnative.library_path()
    assert lib.parent == tnative.BUILD_DIR and lib.exists()
    assert tnative.BUILD_DIR.parent.name == "fermat_tpu_torch"
    assert _native_dir_digest() == before


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int obj_load( {\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build_bvh_native(np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32),
                                 np.ones((4, 3), np.float32))
    monkeypatch.setattr(tnative, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(RuntimeError, match="missing"):
        tnative.build()
    # no fallback: the BVH route above 4096 triangles raises too
    from fermat_tpu_torch.accel.bvh import build_bvh_for_mesh

    with pytest.raises(RuntimeError):
        build_bvh_for_mesh(tproc.random_soup(4096, seed=1).device_view("cpu"))
    assert build_bvh_for_mesh(tproc.random_soup(4096, seed=1).device_view("cpu"),
                              use_native=False).n_nodes > 1
