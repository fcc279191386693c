"""SceneView — the plain view of a scene handed to the integrator
(fermat_tpu/scene/view.py).

The view holds the triangle soup, the mesh-light tables (with the emissive
subset of scenes over 2048 triangles), the camera, a constant environment
radiance and the cluster table of the cluster-table tracers
(accel/cluster.py), which `build` makes at every size, as the JAX package
does (view.py:115-117): tracer="auto" takes the dense tracer up to 4096
triangles, and "frontier", "cluster" and "binned" serve any scene. There is
no triangle BVH. Textures, environment maps, analytic, point and
directional lights, and shadow sets raise NotImplementedError.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from fermat_tpu_torch import resolve_device
from fermat_tpu_torch.accel.cluster import (DENSE_MAX_TRIANGLES, ClusterView, build_clusters,
                                            cluster_view)
from fermat_tpu_torch.core.camera import Camera
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.scene.lights import MeshLightsView
from fermat_tpu_torch.scene.materials import (
    FLAG_SHADOW_DIRECT_IGNORE,
    FLAG_SHADOW_INDIRECT_IGNORE,
    MaterialTable,
)
from fermat_tpu_torch.scene.mesh import MeshStorage, MeshView

Tensor = torch.Tensor

# key prefixes of a flattened fermat_tpu SceneView whose presence means a
# feature outside this slice
_UNSUPPORTED = ("env_map.", "area_lights.", "shadow_sets.")


def _host_arrays(mesh: MeshView) -> dict:
    """The numpy arrays MeshLightsView.build reads, from a device view."""
    h = lambda t: t.detach().cpu().numpy()
    v3 = lambda v: np.stack([h(v.x), h(v.y), h(v.z)], axis=1)
    m = mesh.materials
    return dict(p0=v3(mesh.p0), e1=v3(mesh.e1), e2=v3(mesh.e2), gn=v3(mesh.gn),
                uv0=h(mesh.uv0), uv1=h(mesh.uv1), uv2=h(mesh.uv2),
                material_id=h(mesh.material_id), emissive=v3(m.emissive),
                emissive_map=h(m.emissive_map))


class SceneView(NamedTuple):
    mesh: MeshView
    lights: MeshLightsView
    camera: Camera
    env: Tensor  # (3,) constant environment radiance (0 = none)
    clusters: Optional[ClusterView] = None  # every built view; from_numpy: large ones

    @property
    def device(self) -> torch.device:
        return self.env.device

    @staticmethod
    def build(storage: MeshStorage, camera: Camera, device="cuda",
              env_radiance=(0.0, 0.0, 0.0)) -> "SceneView":
        dev = resolve_device(device)
        for m in storage.materials:
            if any((m.diffuse_map_name, m.specular_map_name, m.emissive_map_name,
                    m.bump_map_name)):
                raise NotImplementedError(
                    f"material {m.name!r} references a texture; textures are a later slice")
            if m.flags & (FLAG_SHADOW_DIRECT_IGNORE | FLAG_SHADOW_INDIRECT_IGNORE):
                raise NotImplementedError(
                    f"material {m.name!r} sets shadow-ignore flags; shadow sets are a later slice")
        mesh = storage.device_view(dev)
        return SceneView(
            mesh=mesh,
            lights=MeshLightsView.build(_host_arrays(mesh), dev),
            camera=camera.to(dev),
            env=torch.tensor(env_radiance, dtype=torch.float32, device=dev),
            clusters=build_clusters(mesh),
        )

    @staticmethod
    def from_numpy(arrays: Dict[str, np.ndarray], device) -> "SceneView":
        """The port's view from the leaves of a fermat_tpu SceneView, keyed by
        field path ("mesh.p0.x", "lights.cdf", "camera.eye.x", "env", ...).

        A scene over 4096 triangles takes its cluster table from the
        "clusters.*" leaves (tri and the six box rows) when they are there
        and builds it with accel/cluster.build_clusters otherwise; smaller
        scenes carry none, so that such a view holds exactly the JAX view's
        leaves (`build` makes the table at every size). Leaves this slice
        does not read (the BVH, the VPL set of nee="vpl", the cluster table
        of a small scene) are ignored; a texture atlas with real texels,
        environment maps, analytic/point/directional lights and shadow sets
        raise NotImplementedError.

        The view's tensors are plain copies of the arrays, none requiring
        grad. To differentiate a pass in material fields, replace them by
        leaf tensors, e.g. for the (M, 3) diffuse albedos:
            d = view.mesh.materials.diffuse.stack().clone().requires_grad_()
            mats = view.mesh.materials._replace(diffuse=Vec3(d[:, 0], d[:, 1], d[:, 2]))
            view = view._replace(mesh=view.mesh._replace(materials=mats))
        (roughness, an (M,) tensor, likewise); render_pass under
        torch.enable_grad() then gives d.grad by backward().
        """
        dev = resolve_device(device)
        for k, a in arrays.items():
            if k.startswith(_UNSUPPORTED):
                raise NotImplementedError(f"{k}: feature outside this slice")
            if k.startswith(("dir_lights.", "point_lights.")) and np.size(a):
                raise NotImplementedError(f"{k}: point/directional lights are a later slice")
        if np.shape(arrays.get("textures.texels", np.zeros((1, 4))))[0] > 1:
            raise NotImplementedError("textures are a later slice")

        def host(key):
            if key not in arrays:
                raise KeyError(f"SceneView.from_numpy: missing leaf {key!r}")
            return np.array(arrays[key])

        t = lambda key: torch.from_numpy(host(key)).to(dev)

        v3 = lambda p: Vec3(t(p + ".x"), t(p + ".y"), t(p + ".z"))
        mt = "mesh.materials."
        materials = MaterialTable(
            diffuse=v3(mt + "diffuse"), specular=v3(mt + "specular"),
            emissive=v3(mt + "emissive"), diffuse_trans=v3(mt + "diffuse_trans"),
            reflectivity=v3(mt + "reflectivity"), roughness=t(mt + "roughness"),
            ior=t(mt + "ior"), opacity=t(mt + "opacity"), flags=t(mt + "flags"),
            diffuse_map=t(mt + "diffuse_map"), specular_map=t(mt + "specular_map"),
            emissive_map=t(mt + "emissive_map"), bump_map=t(mt + "bump_map"),
        )
        mesh = MeshView(
            p0=v3("mesh.p0"), e1=v3("mesh.e1"), e2=v3("mesh.e2"), gn=v3("mesh.gn"),
            n0=v3("mesh.n0"), n1=v3("mesh.n1"), n2=v3("mesh.n2"),
            uv0=t("mesh.uv0"), uv1=t("mesh.uv1"), uv2=t("mesh.uv2"),
            material_id=t("mesh.material_id"), lod_base=t("mesh.lod_base"),
            materials=materials,
        )
        lights = MeshLightsView.from_arrays(
            *(host(f"lights.{k}") for k in ("cdf", "pdf_area", "has_lights", "rows")), dev)
        camera = Camera(v3("camera.eye"), v3("camera.aim"), v3("camera.up"),
                        t("camera.fov"))
        clusters = None
        if mesh.n_triangles > DENSE_MAX_TRIANGLES:
            if "clusters.tri" in arrays:
                boxes = np.concatenate([host(f"clusters.{k}").reshape(1, -1)
                                        for k in ("lo_x", "lo_y", "lo_z", "hi_x", "hi_y",
                                                  "hi_z")])
                clusters = cluster_view(host("clusters.tri"), boxes, mesh)
            else:
                clusters = build_clusters(mesh)
        return SceneView(mesh=mesh, lights=lights, camera=camera, env=t("env"),
                         clusters=clusters)

