"""Procedural scenes (fermat_tpu/scene/procedural.py): the Cornell box built in
code, random triangle soups for tracer tests, the large "big room" scene,
the textured bathroom-class stand-in and the water-caustic stand-in. Host
data only (numpy).

The stand-in reads a material set from disk (bathroom.mtl and its textures),
as JAX's does; `write_standin_assets` writes a seeded one, and
`write_cornell_textures` a seeded texture set for the CornellBox.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from fermat_tpu_torch.core.camera import Camera
from fermat_tpu_torch.scene.loaders.obj import load_mtl
from fermat_tpu_torch.scene.materials import HostMaterial
from fermat_tpu_torch.scene.mesh import MeshStorage
from fermat_tpu_torch.utils.image import write_tga


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


def bathroom_standin(n_boxes: int = 8300, seed: int = 3, assets: Optional[str] = None):
    """The bathroom2 stand-in (procedural.py:215-288): a room of n_boxes
    clutter boxes with per-face uv charts (12 n_boxes + 12 triangles;
    99,612 at the default), its materials parsed from assets/bathroom.mtl
    (map names relative to `assets`) plus an unmapped ceiling light appended
    last. The numpy stream is the JAX package's, so the mesh is bit-equal to
    its stand-in for the same arguments and materials. `assets` is a
    directory holding bathroom.mtl and its textures (write_standin_assets
    writes one). Returns (MeshStorage, Camera, texture_dir)."""
    if assets is None:
        raise ValueError("bathroom_standin needs an assets directory holding bathroom.mtl "
                         "(scene.procedural.write_standin_assets writes a seeded one)")
    mats = load_mtl(os.path.join(assets, "bathroom.mtl"))
    lm = HostMaterial("ceiling_light")
    lm.emissive = (14.0, 13.0, 12.0)
    materials = mats + [lm]
    n_mats = len(mats)
    vs: List = []
    tris: List = []
    midx: List[int] = []
    uvs: List = []
    r = np.random.default_rng(seed)
    w, h, d = 8.0, 4.0, 8.0
    shell = [int(r.integers(0, n_mats)) for _ in range(5)]
    _quad(vs, tris, midx, [-w, 0, d], [w, 0, d], [w, 0, -d], [-w, 0, -d], shell[0], uvs=uvs)
    _quad(vs, tris, midx, [-w, 2 * h, -d], [w, 2 * h, -d], [w, 2 * h, d], [-w, 2 * h, d],
          shell[1], uvs=uvs)
    _quad(vs, tris, midx, [-w, 0, -d], [w, 0, -d], [w, 2 * h, -d], [-w, 2 * h, -d], shell[2],
          uvs=uvs)
    _quad(vs, tris, midx, [-w, 0, d], [-w, 0, -d], [-w, 2 * h, -d], [-w, 2 * h, d], shell[3],
          uvs=uvs)
    _quad(vs, tris, midx, [w, 0, -d], [w, 0, d], [w, 2 * h, d], [w, 2 * h, -d], shell[4],
          uvs=uvs)
    # the ceiling light, wound to face down
    _quad(vs, tris, midx, [-2.0, 2 * h - 0.01, 2.0], [-2.0, 2 * h - 0.01, -2.0],
          [2.0, 2 * h - 0.01, -2.0], [2.0, 2 * h - 0.01, 2.0], n_mats, uvs=uvs)
    for _ in range(n_boxes):
        c = (r.random(3) - 0.5) * np.array([14, 0, 14])
        c[1] = 0.0
        s = 0.1 + r.random(3) * np.array([0.5, 1.6, 0.5])
        _box(vs, tris, midx, c - [s[0], 0, s[2]], c + [s[0], s[1] * 2, s[2]],
             int(r.integers(0, n_mats)), rot_y=float(r.random() * 3.14), uvs=uvs)
    t = np.asarray(tris, np.int32)
    mesh = MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uvs=np.asarray(uvs, np.float32),
        uv_indices=t.copy(),  # uvs are vertex-parallel
        material_ids=np.asarray(midx, np.int32),
        materials=materials,
    )
    # fov=60.0 is in radians, as JAX's stand-in passes it to Camera.create
    cam = Camera.create(eye=(0.0, 4.5, 7.2), aim=(0.0, 2.0, -2.0), fov=60.0)
    return mesh, cam, assets


def _seeded_texture(rng, h: int, w: int, lo: int = 16) -> np.ndarray:
    """An (h, w, 3) uint8 texture: a seeded colour per 8x8-texel checker cell
    with texel noise on top, so that the mip levels differ."""
    cells = rng.integers(lo, 256, ((h + 7) // 8, (w + 7) // 8, 3))
    img = np.repeat(np.repeat(cells, 8, axis=0), 8, axis=1)[:h, :w]
    img = img + rng.integers(-12, 13, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_standin_assets(path: str, size: int = 1024, emitter: bool = False) -> str:
    """A seeded material set for bathroom_standin: path/bathroom.mtl with 12
    materials (Kd, Ks, Ns; map_Kd on all, map_Ks on the first 4; map names
    written with backslashes, as bathroom2's are) and size x size 8-bit TGAs
    under path/textures. emitter=True makes the last material an emitter
    (Ke) with an emissive map (map_Ke). Returns path."""
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(path, "textures"), exist_ok=True)
    lines = []
    n_materials, n_specular = 12, 4
    for i in range(n_materials):
        kd = 0.3 + 0.6 * rng.random(3)
        lines += [f"newmtl mat_{i}", "Kd {:.4f} {:.4f} {:.4f}".format(*kd)]
        write_tga(os.path.join(path, "textures", f"kd_{i}.tga"),
                  _seeded_texture(rng, size, size))
        lines.append(f"map_Kd textures\\kd_{i}.tga")
        if i < n_specular:
            lines += ["Ks {:.4f} {:.4f} {:.4f}".format(*(0.1 + 0.4 * rng.random(3))),
                      f"Ns {float(rng.integers(20, 200))}", f"map_Ks textures\\ks_{i}.tga"]
            write_tga(os.path.join(path, "textures", f"ks_{i}.tga"),
                      _seeded_texture(rng, size, size))
        if emitter and i == n_materials - 1:
            lines += ["Ke 4.0 3.5 3.0", "map_Ke textures\\ke.tga"]
            write_tga(os.path.join(path, "textures", "ke.tga"),
                      _seeded_texture(rng, size, size, lo=64))
    with open(os.path.join(path, "bathroom.mtl"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_cornell_textures(path: str, size: int = 1024) -> Dict[str, dict]:
    """Seeded 8-bit TGA maps for cornell_box's materials, written to path:
    diffuse maps on the white, red and green walls and floor (the white one
    non-power-of-two, so the atlas resamples it), a specular map on the box
    material and an emissive map on the light. Returns {material name:
    {texture-name attribute: file name}}, to set on a storage's materials."""
    rng = np.random.default_rng(0)
    shapes = {"white.tga": (3 * size // 4 - 1, size - max(size // 40, 1)),
              "red.tga": (size, size), "green.tga": (size, size), "box_ks.tga": (size, size),
              "light_ke.tga": (size // 2, size // 2)}
    for name, (h, w) in shapes.items():
        write_tga(os.path.join(path, name),
                  _seeded_texture(rng, h, w, lo=96 if name == "light_ke.tga" else 16))
    return {"white": {"diffuse_map_name": "white.tga"}, "red": {"diffuse_map_name": "red.tga"},
            "green": {"diffuse_map_name": "green.tga"},
            "box": {"specular_map_name": "box_ks.tga"},
            "light": {"emissive_map_name": "light_ke.tga"}}


def set_texture_names(storage, names: Dict[str, dict]):
    """Set the texture-name attributes of `names` (write_cornell_textures)
    on the storage's materials, by material name; returns the storage."""
    for m in storage.materials:
        for attr, value in names.get(m.name, {}).items():
            setattr(m, attr, value)
    return storage


def caustic_standin():
    """The water_caustic stand-in (procedural.py:291-337): a refractive slab
    over a diffuse floor under a small area light, the SDS transport BPT is
    for; (MeshStorage, Camera). `fov=45.0` is passed in radians, as JAX
    passes it (the fault JAX's bathroom_standin shares, ROADMAP Queue 3)."""
    vs: List = []
    tris: List = []
    midx: List[int] = []

    floor = HostMaterial("floor")
    floor.diffuse = (0.75, 0.72, 0.65)
    glass = HostMaterial("glass")
    glass.diffuse = (0.0, 0.0, 0.0)
    glass.specular = (0.9, 0.9, 0.9)
    glass.ior = 1.33
    glass.opacity = 0.0  # pure refractor (glossy-trans lobe)
    glass.phong_exponent = 3000.0  # near-smooth water surface
    light = HostMaterial("light")
    light.emissive = (60.0, 58.0, 52.0)

    _quad(vs, tris, midx, [-3, 0, 3], [3, 0, 3], [3, 0, -3], [-3, 0, -3], 0)
    _box(vs, tris, midx, [-2.2, 0.8, -2.2], [2.2, 1.1, 2.2], 1)
    # the light faces down
    _quad(vs, tris, midx, [-0.5, 3.2, 0.5], [-0.5, 3.2, -0.5],
          [0.5, 3.2, -0.5], [0.5, 3.2, 0.5], 2)

    t = np.asarray(tris, np.int32)
    mesh = MeshStorage(
        vertices=np.asarray(vs, np.float32),
        triangles=t,
        normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1),
        material_ids=np.asarray(midx, np.int32),
        materials=[floor, glass, light],
        group_names=["caustic_standin"],
        group_offsets=np.asarray([0, t.shape[0]], np.int32),
    )
    return mesh, Camera.create(eye=(0.0, 2.6, 5.4), aim=(0.0, 0.6, 0.0), fov=45.0)
