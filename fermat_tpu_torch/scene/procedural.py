"""Procedural scenes (fermat_tpu/scene/procedural.py): the Cornell box built in
code, random triangle soups for tracer tests and the large "big room" scene.
Host data only (numpy)."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from fermat_tpu_torch.core.camera import Camera
from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage


def _quad(vs: List, tris: List, mats: List, a, b, c, d, mat_id: int,
          uvs: Optional[List] = None):
    i = len(vs)
    vs += [a, b, c, d]
    tris += [[i, i + 1, i + 2], [i, i + 2, i + 3]]
    mats += [mat_id, mat_id]
    if uvs is not None:
        # each quad spans the full [0,1]^2 uv square (vertex-parallel uvs)
        uvs += [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]


def _box(vs, tris, mats, lo, hi, mat_id, rot_y: float = 0.0, uvs: Optional[List] = None):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    corners = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1],
            [x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    if rot_y != 0.0:
        cx, cz = (x0 + x1) / 2, (z0 + z1) / 2
        c, s = np.cos(rot_y), np.sin(rot_y)
        x = corners[:, 0] - cx
        z = corners[:, 2] - cz
        corners[:, 0] = c * x + s * z + cx
        corners[:, 2] = -s * x + c * z + cz
    idx = [
        (0, 1, 5, 4), (2, 3, 7, 6), (1, 2, 6, 5), (3, 0, 4, 7), (4, 5, 6, 7), (3, 2, 1, 0),
    ]
    for q in idx:
        _quad(vs, tris, mats, *[corners[j] for j in q], mat_id, uvs=uvs)


def cornell_box(light_scale: float = 1.0, glossy_boxes: bool = False,
                light_size: float = 1.0) -> MeshStorage:
    """A Cornell box: red/green walls, white floor/ceiling/back, two boxes,
    area light in the ceiling (CornellBox-JP.mtl albedos); 36 triangles."""
    vs: List = []
    tris: List = []
    mats: List[int] = []
    uvs: List = []

    WHITE, RED, GREEN, LIGHT, BOX = 0, 1, 2, 3, 4
    _quad(vs, tris, mats, [-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1], WHITE, uvs=uvs)
    _quad(vs, tris, mats, [-1, 2, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1], WHITE, uvs=uvs)
    _quad(vs, tris, mats, [-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1], WHITE, uvs=uvs)
    _quad(vs, tris, mats, [-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1], RED, uvs=uvs)
    _quad(vs, tris, mats, [1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1], GREEN, uvs=uvs)
    # ceiling light (slightly below the ceiling, facing down), scaled about
    # its center by light_size
    lq = np.array(
        [[-0.24, 1.98, 0.22], [-0.24, 1.98, -0.16], [0.23, 1.98, -0.16], [0.23, 1.98, 0.22]],
        np.float32,
    )
    lc = lq.mean(0)
    lq[:, [0, 2]] = lc[[0, 2]] + (lq[:, [0, 2]] - lc[[0, 2]]) * min(light_size, 3.9)
    _quad(vs, tris, mats, lq[0], lq[1], lq[2], lq[3], LIGHT, uvs=uvs)
    _box(vs, tris, mats, (0.05, 0.0, 0.0), (0.65, 0.6, 0.55), BOX, rot_y=-0.29, uvs=uvs)
    _box(vs, tris, mats, (-0.65, 0.0, -0.65), (-0.05, 1.2, -0.05), BOX, rot_y=0.31, uvs=uvs)

    def mk(name, kd, ke=(0, 0, 0), ks=(0, 0, 0), ns=0.0):
        m = HostMaterial(name)
        m.diffuse = kd
        m.emissive = ke
        m.specular = ks
        m.phong_exponent = ns
        return m

    materials = [
        mk("white", (0.725, 0.71, 0.68)),
        mk("red", (0.63, 0.065, 0.05)),
        mk("green", (0.14, 0.45, 0.091)),
        mk("light", (0.78, 0.78, 0.78), ke=tuple(17.0 * light_scale for _ in range(3))),
        mk(
            "box",
            (0.725, 0.71, 0.68),
            ks=(0.5, 0.5, 0.5) if glossy_boxes else (0, 0, 0),
            ns=40.0 if glossy_boxes else 0.0,
        ),
    ]

    t = np.asarray(tris, np.int32)
    return MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uvs=np.asarray(uvs, np.float32),
        uv_indices=t.copy(),  # uvs are vertex-parallel
        material_ids=np.asarray(mats, np.int32),
        materials=materials,
    )


# the box material of glass_cornell_box
GLASS_BOX = dict(opacity=0.6, diffuse_trans=(0.2, 0.25, 0.3), reflectivity=(0.05, 0.04, 0.03),
                 ior=1.5)


def glass_cornell_box() -> MeshStorage:
    """The glossy Cornell box with half-transmissive, clearcoated boxes. Not a
    scene of the JAX package: its CornellBox has no transmissive or coated
    material, so this variant is what drives the transmission and clearcoat
    lobes in the parity checks."""
    storage = cornell_box(glossy_boxes=True)
    box = storage.materials[4]
    for key, value in GLASS_BOX.items():
        setattr(box, key, value)
    return storage


def cornell_camera() -> Camera:
    """models/CornellBox/camera-frontal.txt (a host camera; SceneView.build
    moves it to the scene's device)."""
    return Camera.create((0, 1.3, 1.5), (-0.01, 0.945, -0.025), (0, 1, 0), 1.81)


def random_soup(n_tris: int, seed: int = 0, extent: float = 10.0) -> MeshStorage:
    """Random triangle soup for tracer tests (lbvh_test.cu analog)."""
    r = np.random.default_rng(seed)
    centers = (r.random((n_tris, 3), dtype=np.float32) - 0.5) * extent
    offs = (r.random((n_tris, 2, 3), dtype=np.float32) - 0.5) * (
        extent * 2.0 / max(n_tris ** (1 / 3), 1.0)
    )
    verts = np.concatenate([centers, centers + offs[:, 0], centers + offs[:, 1]]).astype(np.float32)
    n = n_tris
    t = np.stack(
        [np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], axis=1
    ).astype(np.int32)
    m = HostMaterial("grey")
    m.diffuse = (0.5, 0.5, 0.5)
    return MeshStorage(
        vertices=verts,
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.zeros(n, np.int32),
        materials=[m],
    )


def big_room(n_boxes: int = 2000, seed: int = 3) -> MeshStorage:
    """A lit room filled with `n_boxes` rotated boxes (procedural.py:160-191):
    the CornellBox scaled by (8, 4, 8) plus 12 triangles per box, all boxes
    standing on the floor at y = 0. The numpy stream is the JAX package's,
    so the mesh is bit-equal to its big_room for the same arguments."""
    base = cornell_box()
    base.transform(np.diag(np.array([8, 4, 8, 1], np.float32)))
    vs: List = []
    tris: List = []
    mats: List[int] = []
    r = np.random.default_rng(seed)
    for _ in range(n_boxes):
        c = (r.random(3) - 0.5) * np.array([14, 0, 14])
        c[1] = 0.0
        s = 0.1 + r.random(3) * np.array([0.5, 1.6, 0.5])
        _box(vs, tris, mats, c - [s[0], 0, s[2]], c + [s[0], s[1] * 2, s[2]], 0,
             rot_y=float(r.random() * 3.14))
    m = HostMaterial("clutter")
    m.diffuse = tuple(0.2 + 0.6 * r.random(3))
    t = np.asarray(tris, np.int32)
    clutter = MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.asarray(mats, np.int32),
        materials=[m],
    )
    return base.merge(clutter)


def big_room_camera() -> Camera:
    """The camera of tools/bench_secondaries.py's big_room stage: eye
    (0, 3, 10), aim (0, 1.5, 0), up y and the default 60-degree fov."""
    return Camera.create((0.0, 3.0, 10.0), (0.0, 1.5, 0.0))


def floor_quad(half: float = 1.0, albedo=(0.6, 0.6, 0.6)) -> MeshStorage:
    """A single diffuse quad at y = 0 spanning [-half, half]^2
    (procedural.py:194-212): the subject of furnace and analytic-light
    checks. The JAX version's uv_indexed argument changes nothing there and
    is left out."""
    vs = [[-half, 0, half], [half, 0, half], [half, 0, -half], [-half, 0, -half]]
    m = HostMaterial("floor")
    m.diffuse = tuple(albedo)
    t = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        material_ids=np.zeros(2, np.int32),
        materials=[m],
    )
