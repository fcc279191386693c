"""SceneView.build of the port against fermat_tpu's on the CornellBox, and
SceneView.from_numpy, which carries fermat_tpu's scene state across.

The host-side tables are built in numpy by both packages, except where the
JAX package computes in XLA (triangle areas, the light CDF, the shade-row
join): those agree within 1e-6 relative.
"""
import jax
import numpy as np
import pytest
import torch

from fermat_tpu.scene import procedural as jproc
from fermat_tpu.scene.view import SceneView as JView
from fermat_tpu_torch.accel.bvh import BvhView
from fermat_tpu_torch.scene import procedural as tproc
from fermat_tpu_torch.scene.view import _BVH_LEAVES
from fermat_tpu_torch.scene.view import SceneView as TView


def jax_view_arrays(view) -> dict:
    """Leaves of a fermat_tpu SceneView as numpy, keyed by field path."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(view)
    return {jax.tree_util.keystr(p).lstrip("."): np.asarray(a) for p, a in leaves}


def port_view_arrays(obj, prefix="") -> dict:
    if obj is None:  # optional parts a view may not carry (clusters, lights.compact)
        return {}
    if isinstance(obj, torch.Tensor):
        return {prefix: obj.cpu().numpy()}
    if isinstance(obj, np.ndarray):  # the cluster table's host copy (ClusterView.tri)
        return {prefix: obj}
    if isinstance(obj, BvhView):  # JAX's BVH leaves are named by their flatten order
        return {f"{prefix}[<flat index {i}>]": getattr(obj, f).cpu().numpy()
                for i, f in enumerate(_BVH_LEAVES)}
    out = {}
    for name in obj._fields:
        out.update(port_view_arrays(getattr(obj, name), f"{prefix}.{name}" if prefix else name))
    return out


@pytest.fixture(scope="module")
def views():
    jv = JView.build(jproc.cornell_box(glossy_boxes=True), jproc.cornell_camera())
    tv = TView.build(tproc.cornell_box(glossy_boxes=True), tproc.cornell_camera(), "cpu")
    return jv, tv


def test_build_matches_jax_tables(views):
    jv, tv = views
    close = lambda got, want: np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                                         rtol=1e-6, atol=1e-7)
    close(tv.mesh.shade_rows(), jv.mesh.shade_rows())
    close(tv.lights.rows, jv.lights.rows)
    close(tv.lights.pdf_area, jv.lights.pdf_area)
    close(tv.lights.cdf, jv.lights.cdf)
    assert bool(tv.lights.has_lights) == bool(jv.lights.has_lights)
    close(tv.env, jv.env)
    # the per-triangle geometry is numpy on both sides: bit-equal
    got, want = port_view_arrays(tv), jax_view_arrays(jv)
    for k in got:
        if k.startswith(("mesh.", "camera.")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_from_numpy_round_trips_exactly(views):
    jv, _ = views
    arrays = jax_view_arrays(jv)
    tv = TView.from_numpy(arrays, "cpu")
    got = port_view_arrays(tv)
    assert got, "empty view"
    for k, a in got.items():
        assert a.dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(a, arrays[k], err_msg=k)


# leaves of light features the port takes across: an environment map's, a
# directional light's (keyed by the leaf that named the case when they were
# still refused)
_LIGHT_LEAVES = {
    "env_map.pdf": {"env_map.img": np.ones((4, 8, 3), np.float32),
                    "env_map.weight": np.ones(32, np.float32),
                    "env_map.cdf": np.arange(1, 33, dtype=np.float32),
                    "env_map.total": np.float32(32.0)},
    "dir_lights.dir_x": {f"dir_lights.{k}": np.ones(1, np.float32)
                         for k in ("dir_x", "dir_y", "dir_z", "col_x", "col_y", "col_z")},
    "textures.texels": {},
}


@pytest.mark.parametrize("extra", ["env_map.pdf", "dir_lights.dir_x", "textures.texels"])
def test_from_numpy_rejects_features_outside_the_slice(views, extra):
    """Textures were outside the slice until the atlas was ported: now an
    atlas with real texels comes across bit for bit (its RGBA8 mirror as
    int32 bits), also beside light leaves that the port takes across, and
    JAX's one-texel white atlas stands for no textures."""
    from fermat_tpu.scene.textures import TextureAtlas as JAtlas

    arrays = {**jax_view_arrays(views[0]), **_LIGHT_LEAVES[extra]}
    view = TView.from_numpy(arrays, "cpu")
    assert (view.env_map is not None) == (extra == "env_map.pdf")
    assert (view.dir_lights is not None) == (extra == "dir_lights.dir_x")
    assert view.textures is None and not view.has_textures
    img = (np.random.default_rng(1).integers(0, 256, (4, 8, 3)) / 255.0).astype(np.float32)
    atlas = JAtlas.build([img])
    arrays.update({f"textures.{k}": np.asarray(getattr(atlas, k)) for k in atlas._fields})
    view = TView.from_numpy(arrays, "cpu")
    assert view.has_textures and view.textures.count == 1
    assert np.array_equal(view.textures.texels.numpy(), np.asarray(atlas.texels))
    assert np.array_equal(view.textures.packed_q.numpy().view(np.uint32),
                          np.asarray(atlas.packed_q))


def test_build_rejects_textures(tmp_path, capsys):
    """SceneView.build no longer rejects textures: a texture found nowhere
    becomes map -1 with JAX's stderr line and no atlas, and a file found in
    texture_dir is loaded into the atlas, as JAX's build does."""
    from fermat_tpu_torch.utils.image import write_tga

    mesh = tproc.cornell_box()
    mesh.materials[0].diffuse_map_name = "wall.tga"
    view = TView.build(mesh, tproc.cornell_camera(), "cpu", texture_dir=str(tmp_path))
    assert "[textures] missing texture wall.tga" in capsys.readouterr().err
    assert mesh.materials[0].diffuse_map == -1 and not view.has_textures
    write_tga(str(tmp_path / "wall.tga"), np.full((2, 4, 3), 128, np.uint8))
    view = TView.build(mesh, tproc.cornell_camera(), "cpu", texture_dir=str(tmp_path))
    assert mesh.materials[0].diffuse_map == 0 and view.has_textures
    assert view.textures.width[0, 0] == 4 and view.textures.packed is not None
