"""Mesh lights, tier 2 (fermat_tpu/scene/mesh_lights.py, src/mesh_lights.cu):
textured-emitter energies, the VPL set, and the VTL set with its light-BVH
cluster cut.

`textured_tri_energies` gives the light table's CDF weights with the
emissive map's integral folded in, a Monte Carlo estimate over each
textured emitter. `build_vpls` presamples the M virtual point lights of
nee="vpl": stratified points from the triangle CDF, resampled in proportion
to their measured emission, so that a uniform pick of a row is an
emission-proportional light sample (VPLView.sample).

`build_vtls` splits every emissive triangle into a barycentric quadtree of
virtual triangle lights (VTLs) of about equal power, a uniform depth a
triangle, builds a median-split BVH over their centroids (`LightCutHost`)
and cuts it into clusters by surface-area priority; the clustered-RL
sampler (integrators/rl.py) learns over the clusters, and `adapt` refines
the cut between passes (`reclustered` rebuilds the cluster arrays). The
device view (`VTLView`) holds a 16-column row a VTL, so that a light sample
is one row fetch; `locate` maps a hit's (u, v) to its leaf in closed form.

Host numpy, at view build (the VTLs when the ptrl renderer starts), with
the JAX package's operations and `default_rng(1351)` streams, so the
weights, the VPL rows and their `norm`, and the VTL tables and the cut are
the JAX build's bit for bit. These tables are host constants: no gradient
flows into them, as in JAX.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops.gather import gather_rows

Tensor = torch.Tensor

_LUMA = np.array([0.2126, 0.7152, 0.0722])
_SAMPLES, _SEED = 10, 1351  # uniform points a textured emitter, and their stream


def _host_tex_lookup(images, tex_idx: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(N, 3) nearest-texel lookup in the source images; tex_idx < 0 is white."""
    out = np.ones((tex_idx.shape[0], 3), np.float64)
    for ti in np.unique(tex_idx):
        if ti < 0 or ti >= len(images):
            continue
        img = np.asarray(images[ti], np.float64)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        h, w = img.shape[:2]
        m = tex_idx == ti
        x = np.minimum((np.mod(u[m], 1.0) * w).astype(np.int64), w - 1)
        y = np.minimum((np.mod(v[m], 1.0) * h).astype(np.int64), h - 1)
        out[m] = img[y, x, :3]
    return out


def textured_tri_energies(mesh_np: dict, images) -> np.ndarray:
    """(T,) float64 emitted energy a triangle: luminance(Le) x area, with
    luminance(Le x the map's mean over _SAMPLES uniform points) on
    emitters that carry an emissive map. mesh_np: the host arrays of
    scene.lights.host_arrays."""
    mid = mesh_np["material_id"]
    e1, e2 = mesh_np["e1"], mesh_np["e2"]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    le = mesh_np["emissive"][mid]
    energy = (le @ _LUMA) * area
    tmap = mesh_np["emissive_map"][mid]
    tex_tris = np.nonzero((energy > 0) & (tmap >= 0))[0]
    if tex_tris.size == 0 or not images:
        return energy
    rng = np.random.default_rng(_SEED)
    k, t = _SAMPLES, tex_tris.size
    s = rng.random((t, k))
    r = rng.random((t, k))
    flip = s + r > 1
    s = np.where(flip, 1 - s, s)
    r = np.where(flip, 1 - r, r)
    w = 1.0 - s - r
    uv0, uv1, uv2 = (mesh_np[k_][tex_tris][:, None] for k_ in ("uv0", "uv1", "uv2"))
    uvs = uv0 * w[..., None] + uv1 * s[..., None] + uv2 * r[..., None]
    rgb = _host_tex_lookup(images, np.repeat(tmap[tex_tris], k), uvs[..., 0].ravel(),
                           uvs[..., 1].ravel())
    avg = rgb.reshape(t, k, 3).mean(1)
    energy[tex_tris] = ((le[tex_tris] * avg) @ _LUMA) * area[tex_tris]
    return energy


VPL_GATHER_MAX = 2048  # VPLView.sample fetches with K2 up to this many rows (mesh_lights.py:515)


class VPLView(NamedTuple):
    """The presampled VPL set (mesh_lights.py:492-519): rows (M, 11) float32
    with columns pos 0:3, n 3:6, Le 6:9, pdf_area 9, tri 10; norm, the
    estimate of the area integral of the emission's luminance (the density
    of a row is lum(Le) / norm)."""

    rows: Tensor  # (M, 11) float32
    norm: Tensor  # () float32

    @property
    def count(self) -> int:
        return self.rows.shape[0]

    def sample(self, u: Tensor) -> Tuple[Vec3, Vec3, Vec3, Tensor, Tensor]:
        """A uniform pick of a row by u -> (pos, n, Le, pdf_area, tri). The
        fetch is the row gather (K2) up to VPL_GATHER_MAX rows and plain
        indexing above, as in JAX."""
        m = self.rows.shape[0]
        k = torch.clamp_max((u * m).to(torch.int32), m - 1)
        r = gather_rows(self.rows, k) if m <= VPL_GATHER_MAX else self.rows[k.long()]
        vec = lambda c: Vec3(r[:, c], r[:, c + 1], r[:, c + 2])
        return vec(0), vec(3), vec(6), r[:, 9], r[:, 10].to(torch.int32)


def build_vpls(mesh_np: dict, n_vpls: int, tri_energy: np.ndarray, images,
               device) -> Optional[VPLView]:
    """Presample and resample n_vpls VPLs (mesh_lights.py:522-581) from the
    host arrays of scene.lights.host_arrays and the triangles' energies
    (textured_tri_energies); None when the scene emits nothing. Textured
    emitters scale Le by the nearest texel of their emissive map."""
    total = tri_energy.sum()
    if total <= 0:
        return None
    p0, e1, e2, gn = mesh_np["p0"], mesh_np["e1"], mesh_np["e2"], mesh_np["gn"]
    uv0, uv1, uv2 = mesh_np["uv0"], mesh_np["uv1"], mesh_np["uv2"]
    mid, em_np, emap = mesh_np["material_id"], mesh_np["emissive"], mesh_np["emissive_map"]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)

    rng = np.random.default_rng(_SEED)
    cdf = np.cumsum(tri_energy) / total
    # stratified presample from the triangle CDF (pdf in area measure)
    r = (np.arange(n_vpls) + rng.random(n_vpls)) / n_vpls
    tri = np.minimum(np.searchsorted(cdf, r), tri_energy.size - 1)
    u = rng.random(n_vpls)
    v = rng.random(n_vpls)
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pdf_area = (tri_energy[tri] / total) / np.maximum(area[tri], 1e-20)
    pos = p0[tri] + e1[tri] * u[:, None] + e2[tri] * v[:, None]
    uvs = uv0[tri] * (1 - u - v)[:, None] + uv1[tri] * u[:, None] + uv2[tri] * v[:, None]
    le = em_np[mid[tri]]
    if images:
        le = le * _host_tex_lookup(images, emap[mid[tri]], uvs[:, 0], uvs[:, 1])
    lum = le @ _LUMA
    e_over_pdf = lum / np.maximum(pdf_area, 1e-30)
    norm = e_over_pdf.mean()  # MC estimate of the emission's area integral
    if norm <= 0:
        return None
    # resample in proportion to the measured energy: a uniform pick is then
    # emission-proportional, and a VPL's density is lum / norm
    w = e_over_pdf / np.maximum(e_over_pdf.sum(), 1e-30)
    wcdf = np.cumsum(w)
    r2 = (np.arange(n_vpls) + rng.random(n_vpls)) / n_vpls
    pick = np.minimum(np.searchsorted(wcdf, r2), n_vpls - 1)
    rows = np.concatenate(
        [pos[pick], gn[tri[pick]], le[pick], (lum[pick] / norm)[:, None],
         tri[pick][:, None].astype(np.float64)], axis=1).astype(np.float32)
    return VPLView(rows=torch.from_numpy(rows).to(device),
                   norm=torch.tensor(np.float32(norm), device=device))


# ---------------------------------------------------------------------------
# Virtual triangle lights (mesh_lights.py:36-427, mesh_lights.cu:632-891)
# ---------------------------------------------------------------------------

D_MAX = 4  # the deepest quadtree of a triangle (4^4 = 256 VTLs)


def _children_np(c: np.ndarray) -> np.ndarray:
    """(N, 3, 2) corner triples -> (N, 4, 3, 2) midpoint-split children, with
    the reference's windings vtl0=(b0,m01,m02) vtl1=(b1,m12,m01)
    vtl2=(b2,m02,m12) vtl3=(m02,m01,m12) (mesh_lights.cu:677-690)."""
    b0, b1, b2 = c[:, 0], c[:, 1], c[:, 2]
    m01 = (b0 + b1) * 0.5
    m02 = (b0 + b2) * 0.5
    m12 = (b1 + b2) * 0.5
    return np.stack([np.stack([b0, m01, m02], 1), np.stack([b1, m12, m01], 1),
                     np.stack([b2, m02, m12], 1), np.stack([m02, m01, m12], 1)], axis=1)


def leaf_corners_np(depth: int) -> np.ndarray:
    """(4^depth, 3, 2) barycentric corners of all leaves, index-ordered."""
    c = np.array([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]], np.float64)
    for _ in range(depth):
        c = _children_np(c).reshape(-1, 3, 2)
    return c


def locate(u: Tensor, v: Tensor, depth: Tensor, d_max: int = D_MAX) -> Tensor:
    """The leaf index of barycentric (u, v) at each lane's `depth` (the
    inverse of leaf_corners_np's order): at each level the child region,
    and (u, v) re-expressed in that child's corner frame."""
    idx = torch.zeros_like(depth)
    uu, vv = u, v
    for lvl in range(d_max):
        live = lvl < depth
        in1 = uu >= 0.5
        in2 = vv >= 0.5
        in0 = (uu + vv) <= 0.5
        c = torch.where(in1, 1, torch.where(in2, 2, torch.where(in0, 0, 3))).to(idx.dtype)
        # child-local coordinates matching the corner windings above
        lu = torch.where(in1, 2.0 * vv, torch.where(
            in2, 2.0 - 2.0 * uu - 2.0 * vv, torch.where(in0, 2.0 * uu, 1.0 - 2.0 * vv)))
        lv = torch.where(in1, 2.0 - 2.0 * uu - 2.0 * vv, torch.where(
            in2, 2.0 * uu, torch.where(in0, 2.0 * vv, 2.0 * uu + 2.0 * vv - 1.0)))
        idx = torch.where(live, idx * 4 + c, idx)
        uu = torch.where(live, torch.clamp(lu, 0.0, 1.0), uu)
        vv = torch.where(live, torch.clamp(lv, 0.0, 1.0), vv)
    return idx


class VTLView(NamedTuple):
    """Device view of the VTL set (MeshVTLStorage analog).

    rows columns: q0 (0:3), d1 (3:6), d2 (6:9), n (9:12), Le (12:15),
    pdf_area (15); a sample point is q0 + d1 s + d2 t for uniform-triangle
    (s, t), and pdf_area is the area pdf GIVEN the VTL's cluster. VTLs are
    stored in light-BVH order, so each cluster is a contiguous range."""

    rows: Tensor  # (V, 16) float32
    power: Tensor  # (V,) float32 normalized emission power (sums to 1)
    area: Tensor  # (V,) float32
    tri: Tensor  # (V,) int32 parent triangle
    vtl_base: Tensor  # (T,) int32 first leaf of a triangle (-1 if not emissive)
    vtl_depth: Tensor  # (T,) int32 quadtree depth of a triangle
    leaf_slot: Tensor  # (V,) int32: vtl_base[tri] + local leaf -> storage slot
    cluster_of: Tensor  # (V,) int32
    cluster_offset: Tensor  # (C+1,) int32
    seg_cdf: Tensor  # (V,) float32 within-cluster power cdf (inclusive)
    pdf_area: Tensor  # (V,) float32 conditional area pdf given the cluster
    n_clusters: int

    @property
    def n_vtls(self) -> int:
        return self.rows.shape[0]

    @staticmethod
    def from_numpy(arrays: dict, n_clusters: int, device) -> "VTLView":
        """From JAX's VTLView arrays, by field name."""
        t = lambda k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
        return VTLView(*(t(k) for k in VTLView._fields[:-1]), n_clusters=int(n_clusters))


class LightCutHost:
    """Host-side light BVH and the current cluster cut (mesh_lights.py:131-241).

    The BVH is a median-split tree over VTL centroids; `cut` is a list of
    node ids whose VTL ranges partition [0, V). `adapt` refines the
    highest-value cut node and merges the lowest-value sibling pair, keeping
    the cluster count (the AdaptiveClusteredRLStorage analog)."""

    def __init__(self, centroids: np.ndarray, powers: np.ndarray, target_clusters: int,
                 leaf_size: int = 2):
        v = centroids.shape[0]
        self.order = np.arange(v, dtype=np.int64)
        # nodes: (start, end, left, right, parent, area)
        self.nodes: List[list] = []
        self._build(centroids, 0, v, -1, leaf_size)
        self.cut = self._initial_cut(target_clusters)
        self.powers = powers

    def _build(self, cent, start, end, parent, leaf_size) -> int:
        ids = self.order[start:end]
        lo = cent[ids].min(0)
        hi = cent[ids].max(0)
        ext = hi - lo
        area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
        me = len(self.nodes)
        self.nodes.append([start, end, -1, -1, parent, float(area)])
        if end - start > leaf_size:
            axis = int(np.argmax(ext))
            mid = (start + end) // 2
            sub = np.argsort(cent[ids][:, axis], kind="stable")
            self.order[start:end] = ids[sub]
            left = self._build(cent, start, mid, me, leaf_size)
            right = self._build(cent, mid, end, me, leaf_size)
            self.nodes[me][2] = left
            self.nodes[me][3] = right
        return me

    def _initial_cut(self, target: int) -> list:
        # split by surface-area priority (mesh_lights.cu:446-489)
        heap = [(-self.nodes[0][5], 0)]
        cut: List[int] = []
        while heap and len(heap) + len(cut) < target:
            _, n = heapq.heappop(heap)
            left, right = self.nodes[n][2], self.nodes[n][3]
            if left < 0:
                cut.append(n)
            else:
                heapq.heappush(heap, (-self.nodes[left][5], left))
                heapq.heappush(heap, (-self.nodes[right][5], right))
        cut.extend(n for _, n in heap)
        cut.sort(key=lambda n: self.nodes[n][0])
        return cut

    @property
    def n_clusters(self) -> int:
        return len(self.cut)

    def ranges(self) -> np.ndarray:
        """(C+1,) VTL offsets of the current cut (sorted by start)."""
        starts = [self.nodes[n][0] for n in self.cut]
        return np.asarray(starts + [self.nodes[0][1]], np.int64)

    def adapt(self, value: np.ndarray) -> Optional[np.ndarray]:
        """One refine-and-merge step driven by the learned value of each
        cluster: split the cut node of highest value (if it has children)
        and merge the sibling pair of lowest summed value. Returns the
        (C, C) Q remap M, q_new = q_old @ M.T, or None when no step pays."""
        c = len(self.cut)
        pos = {n: i for i, n in enumerate(self.cut)}
        # candidate merges: sibling pairs both in the cut
        merges = []
        for i, n in enumerate(self.cut):
            p = self.nodes[n][4]
            if p >= 0 and self.nodes[p][2] == n:  # n is a left child
                sib = self.nodes[p][3]
                if sib in pos:
                    merges.append((value[i] + value[pos[sib]], p, n, sib))
        splits = [(value[i], n) for i, n in enumerate(self.cut) if self.nodes[n][2] >= 0]
        if not merges or not splits:
            return None
        merges.sort(key=lambda t: t[0])
        splits.sort(key=lambda t: -t[0])
        mval, mparent, ml, mr = merges[0]
        sval, snode = splits[0]
        if snode in (ml, mr) or sval <= mval * 2.0:
            return None  # not profitable
        new_cut = [n for n in self.cut if n not in (ml, mr, snode)]
        new_cut.extend([mparent, self.nodes[snode][2], self.nodes[snode][3]])
        new_cut.sort(key=lambda n: self.nodes[n][0])
        # the split's children inherit its row; the merged node averages
        # its children's rows
        m = np.zeros((len(new_cut), c), np.float32)
        for j, n in enumerate(new_cut):
            if n == mparent:
                m[j, pos[ml]] = 0.5
                m[j, pos[mr]] = 0.5
            elif n in (self.nodes[snode][2], self.nodes[snode][3]):
                m[j, pos[snode]] = 1.0
            else:
                m[j, pos[n]] = 1.0
        self.cut = new_cut
        return m


def _cluster_arrays(ranges: np.ndarray, powers_s: np.ndarray, leaf_area_s: np.ndarray):
    """(cluster_of, seg_cdf, pdf_area) of VTLs in storage order under the
    cut's ranges (mesh_lights.py:356-365 and :403-412)."""
    v = powers_s.shape[0]
    cluster_of = np.zeros(v, np.int32)
    seg_cdf = np.zeros(v, np.float32)
    pdf_area = np.zeros(v, np.float32)
    for ci in range(ranges.shape[0] - 1):
        a, b = int(ranges[ci]), int(ranges[ci + 1])
        cluster_of[a:b] = ci
        w = powers_s[a:b]
        ws = max(w.sum(), 1e-30)
        seg_cdf[a:b] = np.cumsum(w) / ws
        pdf_area[a:b] = (w / ws) / np.maximum(leaf_area_s[a:b], 1e-20)
    return cluster_of, seg_cdf, pdf_area


def build_vtls(mesh_view, target_clusters: int = 64, n_target_vtls: int = 1024,
               tri_energy: Optional[np.ndarray] = None,
               leaf_energy: Optional[Callable] = None) -> tuple:
    """The VTL set and its light-BVH cluster cut (mesh_lights.py:243-392):
    (VTLView on the mesh's device, LightCutHost; None when nothing emits).

    tri_energy: optional (T,) emissive energies (texture-integrated); the
    default is material luminance x area. leaf_energy(tri_ids, corners)
    optionally gives each leaf's energy."""
    device = mesh_view.p0.x.device
    h = lambda t: t.detach().cpu().numpy()
    v3 = lambda v: np.stack([h(v.x), h(v.y), h(v.z)], 1)
    p0, e1, e2, gn = v3(mesh_view.p0), v3(mesh_view.e1), v3(mesh_view.e2), v3(mesh_view.gn)
    mid = h(mesh_view.material_id)
    le_tri = v3(mesh_view.materials.emissive)[mid]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    t = p0.shape[0]
    if tri_energy is None:
        tri_energy = (le_tri @ _LUMA) * area
    emissive = np.nonzero(tri_energy > 0)[0]

    vtl_base = np.full(t, -1, np.int32)
    vtl_depth = np.zeros(t, np.int32)
    dv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if emissive.size == 0:
        z, zi = np.zeros(0, np.float32), np.zeros(0, np.int32)
        return VTLView(rows=dv(np.zeros((0, 16), np.float32)), power=dv(z), area=dv(z),
                       tri=dv(zi), vtl_base=dv(vtl_base), vtl_depth=dv(vtl_depth),
                       leaf_slot=dv(zi), cluster_of=dv(zi),
                       cluster_offset=dv(np.zeros(target_clusters + 1, np.int32)),
                       seg_cdf=dv(z), pdf_area=dv(z), n_clusters=target_clusters), None

    # a triangle's quadtree depth: leaves about in proportion to energy
    e_tot = tri_energy[emissive].sum()
    e_target = e_tot / max(n_target_vtls, 1)
    with np.errstate(divide="ignore"):
        d = np.floor(np.log(np.maximum(tri_energy[emissive] / e_target, 1e-30))
                     / np.log(4.0) + 0.5)
    depth = np.clip(d, 0, D_MAX).astype(np.int32)
    vtl_depth[emissive] = depth

    # the leaves of each depth class
    tri_ids, corners = [], []
    for dv_ in range(D_MAX + 1):
        tris_d = emissive[depth == dv_]
        if tris_d.size == 0:
            continue
        lc = leaf_corners_np(dv_)  # (L, 3, 2)
        tri_ids.append(np.repeat(tris_d, lc.shape[0]))
        corners.append(np.tile(lc, (tris_d.size, 1, 1)))
    tri_ids = np.concatenate(tri_ids)
    corners = np.concatenate(corners).astype(np.float64)  # (V, 3, 2)
    v = tri_ids.size

    # leaves in (tri, local leaf) order; a triangle's base is its first leaf
    order0 = np.lexsort((np.arange(v), tri_ids))
    tri_ids = tri_ids[order0]
    corners = corners[order0]
    vtl_base[emissive] = np.searchsorted(tri_ids, emissive).astype(np.int32)

    # geometry in the parent triangle's frame: q0 = p0 + E c0, d1 = E (c1 - c0)
    def world(c):
        return p0[tri_ids] + e1[tri_ids] * c[:, :1] + e2[tri_ids] * c[:, 1:2]

    q0 = world(corners[:, 0])
    w1 = world(corners[:, 1])
    w2 = world(corners[:, 2])
    d1 = w1 - q0
    d2 = w2 - q0
    leaf_area = 0.5 * np.linalg.norm(np.cross(d1, d2), axis=1)

    if leaf_energy is not None:
        powers = np.asarray(leaf_energy(tri_ids, corners), np.float64)
    else:
        powers = (le_tri[tri_ids] @ _LUMA) * leaf_area
    powers = np.maximum(powers, 1e-30 * powers.max())
    powers = powers / powers.sum()

    # the light BVH over leaf centroids and its area-prioritized cut
    cut = LightCutHost((q0 + w1 + w2) / 3.0, powers, target_clusters)
    perm = cut.order  # VTLs in BVH order
    inv = np.empty(v, np.int64)
    inv[perm] = np.arange(v)
    tri_ids_s = tri_ids[perm]
    q0, d1, d2 = q0[perm], d1[perm], d2[perm]
    leaf_area_s = leaf_area[perm]
    powers_s = powers[perm]

    ranges = cut.ranges()
    cluster_of, seg_cdf, pdf_area = _cluster_arrays(ranges, powers_s, leaf_area_s)
    rows = np.concatenate([q0, d1, d2, gn[tri_ids_s], le_tri[tri_ids_s], pdf_area[:, None]],
                          axis=1).astype(np.float32)
    # cluster_offset padded to target_clusters + 1 (the cut may be smaller)
    offs = np.full(target_clusters + 1, int(ranges[-1]), np.int64)
    offs[: len(cut.cut) + 1] = ranges
    view = VTLView(rows=dv(rows), power=dv(powers_s.astype(np.float32)),
                   area=dv(leaf_area_s.astype(np.float32)), tri=dv(tri_ids_s.astype(np.int32)),
                   vtl_base=dv(vtl_base), vtl_depth=dv(vtl_depth),
                   leaf_slot=dv(inv.astype(np.int32)), cluster_of=dv(cluster_of),
                   cluster_offset=dv(offs.astype(np.int32)), seg_cdf=dv(seg_cdf),
                   pdf_area=dv(pdf_area), n_clusters=target_clusters)
    return view, cut


def reclustered(view: VTLView, cut: LightCutHost) -> VTLView:
    """The cluster arrays rebuilt after a cut adaptation (mesh_lights.py:394-427)."""
    v, device = view.n_vtls, view.rows.device
    ranges = cut.ranges()
    h = lambda t: t.detach().cpu().numpy()
    cluster_of, seg_cdf, pdf_area = _cluster_arrays(
        ranges, np.asarray(h(view.power), np.float64), np.asarray(h(view.area), np.float64))
    offs = np.full(view.n_clusters + 1, v, np.int64)
    offs[: len(cut.cut) + 1] = ranges
    rows = h(view.rows).copy()
    rows[:, 15] = pdf_area
    dv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return view._replace(rows=dv(rows), cluster_of=dv(cluster_of),
                         cluster_offset=dv(offs.astype(np.int32)), seg_cdf=dv(seg_cdf),
                         pdf_area=dv(pdf_area))
