"""SceneView — the plain view of a scene handed to the integrator
(fermat_tpu/scene/view.py).

The view holds the triangle soup, the mesh-light tables (with the emissive
subset of scenes over 2048 triangles), the camera, the environment radiance
and the cluster table of the cluster-table tracers (accel/cluster.py), which
`build` makes at every size, as the JAX package does (view.py:115-117):
tracer="auto" takes the dense tracer up to 4096 triangles, and "frontier",
"cluster" and "binned" serve any scene. The triangle BVH of the skip-link
walk (accel/bvh.py; tracer="bvh", and tracer="auto" above 4096 triangles
on a view without a cluster table) is built only when asked for, by
`with_bvh()` (`from_numpy` takes JAX's BVH leaves when they are there): its
host build, a Python recursion over nodes, takes seconds for big_room's
99,636 triangles, which no other route needs. `vpls` is the presampled VPL set of
nee="vpl" (scene/mesh_lights.py), built with the view as in JAX.

The light model beside the mesh emitters (view.py:65-181): directional and
point lights, analytic disk/rect area lights, a lat-long environment map
(then `env` is an RGB scale on the map's radiance), and the shadow sets:
for each shadow-ray mask bit that a material sets, the scene without that
material's triangles, with its own triangle soup and cluster table, built
once here. A field is None when the scene has no such light or set.

Textures (view.py:61-111): `build(texture_dir=...)` loads every texture a
material names into the packed mip atlas (scene/textures.py) and turns the
material's map slots into atlas indices; the light table's CDF is weighted
by the emissive maps' integrals (scene/mesh_lights.py). `textures` is None
when no texture was loaded.
"""
from __future__ import annotations

import os
import sys
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fermat_tpu_torch import resolve_device
from fermat_tpu_torch.accel.bvh import BvhView, build_bvh_for_mesh
from fermat_tpu_torch.accel.cluster import (DENSE_MAX_TRIANGLES, ClusterView, build_clusters,
                                            cluster_view)
from fermat_tpu_torch.core.camera import Camera
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.scene.analytic_lights import AreaLightsView, PointLightsView
from fermat_tpu_torch.scene.envmap import EnvMapView
from fermat_tpu_torch.scene.lights import DirectionalLightsView, MeshLightsView, host_arrays
from fermat_tpu_torch.scene.materials import (
    FLAG_SHADOW_DIRECT_IGNORE,
    FLAG_SHADOW_INDIRECT_IGNORE,
    MaterialTable,
)
from fermat_tpu_torch.scene.mesh import MeshStorage, MeshView
from fermat_tpu_torch.scene.mesh_lights import VPLView, build_vpls, textured_tri_energies
from fermat_tpu_torch.scene.textures import TextureAtlas
from fermat_tpu_torch.utils.image import read_image

Tensor = torch.Tensor

_AREA_COLUMNS = ("px", "py", "pz", "ux", "uy", "uz", "vx", "vy", "vz", "nx", "ny", "nz",
                 "cx", "cy", "cz")
_BOX_ROWS = ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y", "hi_z")
# the array leaves of JAX's BvhView in its flatten order (bvh.py:43-46); a
# JAX view's leaves name them "bvh[<flat index i>]"
_BVH_LEAVES = (*_BOX_ROWS, "skip", "prim_start", "is_leaf", "prims", "child")


def _resolve_textures(storage: MeshStorage, texture_dir: Optional[str]) -> list:
    """Load every texture a material names and set its map slots to atlas
    indices, in place (view.py:78-111, renderer.cu:784-882): the `.tga`
    sibling in texture_dir first, then the name in texture_dir, then the
    name itself; a texture found nowhere becomes slot -1, with JAX's line on
    stderr. Returns the images in slot order."""
    images, index = [], {}

    def tex_index(name: str) -> int:
        if not name:
            return -1
        if name in index:
            return index[name]
        candidates = [name]
        if texture_dir:
            candidates.insert(0, os.path.join(texture_dir, name))
            candidates.insert(0, os.path.join(texture_dir, os.path.splitext(name)[0] + ".tga"))
        for c in candidates:
            if os.path.exists(c):
                try:
                    images.append(read_image(c))
                    index[name] = len(images) - 1
                    return index[name]
                except Exception as e:  # noqa: BLE001 - JAX's build goes on likewise
                    print(f"[textures] failed {c}: {e}", file=sys.stderr)
        print(f"[textures] missing texture {name}", file=sys.stderr)
        index[name] = -1
        return -1

    for m in storage.materials:
        m.diffuse_map = tex_index(m.diffuse_map_name)
        m.specular_map = tex_index(m.specular_map_name)
        m.emissive_map = tex_index(m.emissive_map_name)
        m.bump_map = tex_index(m.bump_map_name)
    return images


def _textured_emitters(pdf_area: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """Whether any emitter carries an emissive map (pt.py:118-135,
    `_any_emissive_maps`): a 0-d bool on the host. JAX reads it from the
    device tables at every pass (and assumes yes under tracing); the answer
    is the same on either branch, so the port takes it once, when the view
    is made."""
    return np.asarray(bool((rows[pdf_area > 0.0, 22] >= 0.0).any()))


class ShadowSet(NamedTuple):
    """Occlusion-only geometry of one shadow-ray mask bit (view.py:29-35, the
    any-hit ignore set of optix_base_shadow_shaders.h:55-59): the scene
    without the triangles whose material sets the bit."""

    mesh: MeshView  # the kept triangles (vertices shared, MeshStorage.filtered)
    tris: Tensor  # (9, T') their soup, the dense any-hit tracer's and the walk's input
    clusters: ClusterView  # their cluster table, the cluster-table tracers' input
    bvh: Optional[BvhView] = None  # their BVH, the walk's input; SceneView.with_bvh


def _shadow_set(mesh: MeshView, clusters: Optional[ClusterView] = None,
                bvh: Optional[BvhView] = None) -> ShadowSet:
    return ShadowSet(mesh, mesh.tri_soup(), build_clusters(mesh) if clusters is None
                     else clusters, bvh)


def _build_shadow_sets(storage: MeshStorage, dev) -> Optional[Tuple]:
    """(direct, indirect) ShadowSet or None for the FLAG_SHADOW_DIRECT_IGNORE
    and FLAG_SHADOW_INDIRECT_IGNORE bits, or None when no material sets
    either (view.py:148-166). A set that would keep no triangle raises, as
    the JAX build does (its BVH build asserts on an empty mesh)."""
    if not storage.n_triangles:
        return None
    tri_flags = np.asarray([m.flags for m in storage.materials],
                           np.int32)[np.asarray(storage.material_ids)]

    def one(bit):
        drop = (tri_flags & bit) != 0
        if not drop.any():
            return None
        if drop.all():
            raise ValueError(f"shadow mask bit {bit}: every triangle's material ignores it, "
                             "so its shadow set is empty (the JAX build refuses it too)")
        mesh = storage.filtered(~drop).device_view(dev)
        return _shadow_set(mesh)

    sets = (one(FLAG_SHADOW_DIRECT_IGNORE), one(FLAG_SHADOW_INDIRECT_IGNORE))
    return None if all(x is None for x in sets) else sets


class SceneView(NamedTuple):
    mesh: MeshView
    lights: MeshLightsView
    camera: Camera
    env: Tensor  # (3,) environment radiance (0 = none); with env_map an RGB scale on it
    clusters: Optional[ClusterView] = None  # every built view; from_numpy: large ones
    dir_lights: Optional[DirectionalLightsView] = None
    point_lights: Optional[PointLightsView] = None
    shadow_sets: Optional[Tuple[Optional[ShadowSet], Optional[ShadowSet]]] = None
    env_map: Optional[EnvMapView] = None
    area_lights: Optional[AreaLightsView] = None
    textures: Optional[TextureAtlas] = None  # None: no texture loaded
    textured_emitters: Optional[np.ndarray] = None  # _textured_emitters, with textures
    vpls: Optional[VPLView] = None  # nee="vpl"'s VPL set; None when nothing emits
    bvh: Optional[BvhView] = None  # the walk's BVH; with_bvh builds it

    @property
    def device(self) -> torch.device:
        return self.env.device

    @property
    def has_textures(self) -> bool:
        return self.textures is not None

    @staticmethod
    def build(storage: MeshStorage, camera: Camera, device="cuda",
              env_radiance=(0.0, 0.0, 0.0), dir_light_defs=(), point_light_defs=(),
              env_map=None, area_light_defs=(), texture_dir=None,
              n_vpls: int = 256) -> "SceneView":
        """The view of a host mesh (view.py:65-181). dir_light_defs: records
        with `direction` and `color` (scene.lights.DirectionalLightDef);
        point_light_defs: (position, intensity) pairs; env_map: an (H, W, 3)
        float32 lat-long radiance image; area_light_defs: dicts of
        scene.analytic_lights.AreaLightsView.build; texture_dir: where the
        materials' texture names are looked up first; n_vpls: the size of
        the VPL set (0: none). The materials' map slots are set in place,
        as in JAX. The walk's BVH is not built here: with_bvh() adds it."""
        dev = resolve_device(device)
        images = _resolve_textures(storage, texture_dir)
        mesh = storage.device_view(dev)
        mesh_np = host_arrays(mesh)
        energies = textured_tri_energies(mesh_np, images)
        lights = MeshLightsView.build(mesh_np, dev, energies)
        # with a map, `env` scales its radiance: a zero default would black it out
        if env_map is not None and tuple(env_radiance) == (0.0, 0.0, 0.0):
            env_radiance = (1.0, 1.0, 1.0)
        dir_light_defs, point_light_defs = list(dir_light_defs), list(point_light_defs)
        return SceneView(
            mesh=mesh,
            lights=lights,
            camera=camera.to(dev),
            env=torch.tensor(env_radiance, dtype=torch.float32, device=dev),
            clusters=build_clusters(mesh),
            dir_lights=(DirectionalLightsView.build(dir_light_defs, dev) if dir_light_defs
                        else None),
            point_lights=(PointLightsView.build(point_light_defs, dev) if point_light_defs
                          else None),
            shadow_sets=_build_shadow_sets(storage, dev),
            env_map=None if env_map is None else EnvMapView.build(env_map, dev),
            area_lights=(AreaLightsView.build(list(area_light_defs), dev) if area_light_defs
                         else None),
            textures=TextureAtlas.build(images, dev) if images else None,
            textured_emitters=(_textured_emitters(lights.pdf_area.cpu().numpy(),
                                                  lights.rows.cpu().numpy())
                               if images else None),
            vpls=build_vpls(mesh_np, n_vpls, energies, images, dev) if n_vpls > 0 else None,
        )

    def with_bvh(self) -> "SceneView":
        """The view with the walk's BVH built for its mesh and for each
        shadow set that has none (on the host, then on the view's device)."""
        sets = self.shadow_sets
        if sets is not None:
            sets = tuple(ss if ss is None or ss.bvh is not None
                         else ss._replace(bvh=build_bvh_for_mesh(ss.mesh)) for ss in sets)
        return self._replace(bvh=self.bvh if self.bvh is not None
                             else build_bvh_for_mesh(self.mesh), shadow_sets=sets)

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], device) -> "SceneView":
        """The port's view from the leaves of a fermat_tpu SceneView, keyed by
        field path ("mesh.p0.x", "lights.cdf", "camera.eye.x", "env",
        "env_map.cdf", "shadow_sets[0].mesh.p0.x", ...).

        A scene over 4096 triangles takes its cluster table from the
        "clusters.*" leaves (tri and the six box rows) when they are there
        and builds it with accel/cluster.build_clusters otherwise; smaller
        scenes carry none, so that such a view holds exactly the JAX view's
        leaves (`build` makes the table at every size). A shadow set takes
        its mesh and its cluster table from its own leaves at any size. The
        light leaves come across as they are: the environment map's weights,
        CDF and total (not rebuilt), the analytic area lights, and the
        point and directional lights (None when the JAX view holds none).
        A texture atlas with real texels (more than JAX's one white texel)
        comes across bit for bit, its RGBA8 mirror included, and so does the
        VPL set of nee="vpl" ("vpls.rows", "vpls.norm"). The view and each
        shadow set take the walk's BVH from JAX's leaves ("bvh[<flat index
        i>]", BvhView's arrays in JAX's flatten order) when they are there;
        with_bvh() builds the ones that are missing.

        The view's tensors are plain copies of the arrays, none requiring
        grad. To differentiate a pass in material fields, replace them by
        leaf tensors, e.g. for the (M, 3) diffuse albedos:
            d = view.mesh.materials.diffuse.stack().clone().requires_grad_()
            mats = view.mesh.materials._replace(diffuse=Vec3(d[:, 0], d[:, 1], d[:, 2]))
            view = view._replace(mesh=view.mesh._replace(materials=mats))
        (roughness, an (M,) tensor, likewise; the environment scale `env` as
        view._replace(env=leaf)); render_pass under torch.enable_grad() then
        gives the leaf's .grad by backward(). For the texels, replace the
        atlas's: view._replace(textures=view.textures._replace(texels=leaf))
        (which drops the RGBA8 mirror, so that the fetches read the leaf). For
        the (M, 3) emissive, rebuild the light table from the same tensors:
        view._replace(mesh=mesh2, lights=MeshLightsView.build_on_device(mesh2)).
        """
        dev = resolve_device(device)

        def host(key):
            if key not in arrays:
                raise KeyError(f"SceneView.from_numpy: missing leaf {key!r}")
            return np.array(arrays[key])

        t = lambda key: torch.from_numpy(host(key)).to(dev)
        v3 = lambda p: Vec3(t(p + ".x"), t(p + ".y"), t(p + ".z"))

        def mesh_view(p):
            mt = p + "materials."
            materials = MaterialTable(
                diffuse=v3(mt + "diffuse"), specular=v3(mt + "specular"),
                emissive=v3(mt + "emissive"), diffuse_trans=v3(mt + "diffuse_trans"),
                reflectivity=v3(mt + "reflectivity"), roughness=t(mt + "roughness"),
                ior=t(mt + "ior"), opacity=t(mt + "opacity"), flags=t(mt + "flags"),
                diffuse_map=t(mt + "diffuse_map"), specular_map=t(mt + "specular_map"),
                emissive_map=t(mt + "emissive_map"), bump_map=t(mt + "bump_map"),
            )
            return MeshView(
                p0=v3(p + "p0"), e1=v3(p + "e1"), e2=v3(p + "e2"), gn=v3(p + "gn"),
                n0=v3(p + "n0"), n1=v3(p + "n1"), n2=v3(p + "n2"),
                uv0=t(p + "uv0"), uv1=t(p + "uv1"), uv2=t(p + "uv2"),
                material_id=t(p + "material_id"), lod_base=t(p + "lod_base"),
                materials=materials,
            )

        def bvh_of(p):
            key = lambda i: f"{p}bvh[<flat index {i}>]"
            if key(0) not in arrays:
                return None
            a = {f: host(key(i)) for i, f in enumerate(_BVH_LEAVES)}
            lo = np.stack([a["lo_x"], a["lo_y"], a["lo_z"]], 1)
            hi = np.stack([a["hi_x"], a["hi_y"], a["hi_z"]], 1)
            leaf_size = a["prims"].size // max(int(a["is_leaf"].sum()), 1)
            return BvhView.from_arrays(lo, hi, a["skip"], a["prim_start"], a["is_leaf"],
                                       a["prims"], a["child"], leaf_size, dev)

        def clusters_of(p, mesh):
            if p + "clusters.tri" not in arrays:
                return build_clusters(mesh)
            boxes = np.concatenate([host(f"{p}clusters.{k}").reshape(1, -1)
                                    for k in _BOX_ROWS])
            return cluster_view(host(p + "clusters.tri"), boxes, mesh)

        def soa(p, fields, cls):
            """A point or directional light view, None when it holds none."""
            if not np.size(arrays.get(p + fields[0], ())):
                return None
            return cls(*(t(p + f) for f in fields))

        mesh = mesh_view("mesh.")
        lights = MeshLightsView.from_arrays(
            *(host(f"lights.{k}") for k in ("cdf", "pdf_area", "has_lights", "rows")), dev)
        camera = Camera(v3("camera.eye"), v3("camera.aim"), v3("camera.up"),
                        t("camera.fov"))
        clusters = clusters_of("", mesh) if mesh.n_triangles > DENSE_MAX_TRIANGLES else None
        sets = []
        for k in range(2):
            p = f"shadow_sets[{k}]."
            if p + "mesh.p0.x" in arrays:
                smesh = mesh_view(p + "mesh.")
                sets.append(_shadow_set(smesh, clusters_of(p, smesh), bvh_of(p)))
            else:
                sets.append(None)
        env_map = None
        if "env_map.img" in arrays:
            env_map = EnvMapView.from_arrays(*(host(f"env_map.{k}") for k in
                                               ("img", "weight", "cdf", "total")), dev)
        area = None
        if np.size(arrays.get("area_lights.kind", ())):
            area = AreaLightsView.from_arrays(
                host("area_lights.kind"), [host(f"area_lights.{k}") for k in _AREA_COLUMNS],
                host("area_lights.ru"), host("area_lights.rv"), dev)
        textures = textured = None
        if np.shape(arrays.get("textures.texels", np.zeros((1, 4))))[0] > 1:
            textures = TextureAtlas.from_arrays(
                {k: arrays.get("textures." + k) for k in TextureAtlas._fields}, dev)
            textured = _textured_emitters(host("lights.pdf_area"), host("lights.rows"))
        vpls = None
        if "vpls.rows" in arrays:
            vpls = VPLView(rows=t("vpls.rows"), norm=t("vpls.norm"))
        return SceneView(
            mesh=mesh, lights=lights, camera=camera, env=t("env"), clusters=clusters,
            dir_lights=soa("dir_lights.", DirectionalLightsView._fields, DirectionalLightsView),
            point_lights=soa("point_lights.", PointLightsView._fields, PointLightsView),
            shadow_sets=None if all(x is None for x in sets) else tuple(sets),
            env_map=env_map, area_lights=area, textures=textures, textured_emitters=textured,
            vpls=vpls, bvh=bvh_of(""),
        )
