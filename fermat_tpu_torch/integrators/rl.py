"""Clustered-RL (Q-learning) direct lighting (fermat_tpu/integrators/rl.py).

Tier 1: the emissive triangles, morton-sorted and cut into equal-power
chunks (`build_clusters`, host numpy at start); a per-cell Q table (K cells
x C clusters, `RLState`) is the renderer's state. `sample` picks a cluster
from the cell's bias-mixed Q row, a triangle in it by an 18-step binary
search of the cluster's power CDF, and a uniform point on it; `pdf_area_of`
is the matching MIS density of an emissive hit. Tier 2 samples the VTL set
of scene/mesh_lights.build_vtls instead (`sample_vtl`, `pdf_area_of_vtl`):
one 16-column row fetch a sample, K2 up to 2048 rows (`_fetch_vtl_rows`).

The bias floor keeps every light at a nonzero pdf, so the estimator stays
unbiased for any Q; learning moves only variance. Tier 1's light point
comes from the view's light table (one K2 fetch of the triangle's 23-column
row: the same p0, e1, e2, gn and Le as JAX's mesh.fetch and _emissive_of).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.core.morton import morton3d
from fermat_tpu_torch.core.sampling import square_to_uniform_triangle
from fermat_tpu_torch.ops.gather import gather_rows
from fermat_tpu_torch.scene.lights import row_sample
from fermat_tpu_torch.scene.mesh import MeshView
from fermat_tpu_torch.scene.mesh_lights import VTLView, locate

Tensor = torch.Tensor

SEARCH_STEPS = 18  # the segment search's fixed steps (rl.py:168, :265)
VTL_GATHER_MAX = 2048  # VTL rows fetched with K2 up to this many (rl.py:224-229)


class RLClusters(NamedTuple):
    """Static cluster tables (host-built at start)."""

    tri_cluster: Tensor  # (T,) int32, -1 = non-emissive
    sorted_tris: Tensor  # (E,) int32 emissive triangles grouped by cluster
    seg_cdf: Tensor  # (E,) float32 power cdf within each cluster (inclusive)
    cluster_offset: Tensor  # (C+1,) int32 into sorted_tris
    tri_pdf_area: Tensor  # (T,) float32 area pdf of the triangle GIVEN its cluster
    n_clusters: int

    @staticmethod
    def from_numpy(arrays: dict, n_clusters: int, device) -> "RLClusters":
        """From JAX's RLClusters arrays, by field name."""
        t = lambda k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
        return RLClusters(*(t(k) for k in RLClusters._fields[:-1]), n_clusters=int(n_clusters))


def build_clusters(mesh: MeshView, n_clusters: int = 16) -> RLClusters:
    """Morton-sort the emissive triangles and cut them into equal-power
    clusters (rl.py:45-111): JAX's numpy, on the same float32 inputs and
    uint32 codes, so np.argsort breaks ties in the codes as JAX's does."""
    dev = mesh.p0.x.device
    h = lambda t: t.detach().cpu().numpy()
    em = mesh.materials.emissive
    mid = h(mesh.material_id)
    lum = 0.2126 * h(em.x)[mid] + 0.7152 * h(em.y)[mid] + 0.0722 * h(em.z)[mid]
    area = h(mesh.triangle_areas())
    power = lum * area
    t = mid.shape[0]
    emissive = np.nonzero(power > 0)[0]
    dv = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if emissive.size == 0:
        return RLClusters(tri_cluster=dv(np.full(t, -1, np.int32)),
                          sorted_tris=dv(np.zeros(0, np.int32)),
                          seg_cdf=dv(np.zeros(0, np.float32)),
                          cluster_offset=dv(np.zeros(n_clusters + 1, np.int32)),
                          tri_pdf_area=dv(np.zeros(t, np.float32)), n_clusters=n_clusters)
    # morton order of the centroids
    cen = [h(p) + (h(a) + h(b)) / 3 for p, a, b in zip(mesh.p0, mesh.e1, mesh.e2)]
    c = np.stack([x[emissive] for x in cen], 1)
    lo, hi = c.min(0), c.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    codes = morton3d(*(torch.from_numpy((c[:, a] - lo[a]) / ext[a]) for a in range(3)))
    order = emissive[np.argsort(codes.numpy().astype(np.uint32))]
    # equal-power cut into n_clusters chunks
    p_sorted = power[order]
    cum = np.cumsum(p_sorted)
    total = cum[-1]
    cluster_of_sorted = np.minimum((cum / total * n_clusters - 1e-9).astype(np.int32),
                                   n_clusters - 1)
    tri_cluster = np.full(t, -1, np.int32)
    tri_cluster[order] = cluster_of_sorted
    offsets = np.zeros(n_clusters + 1, np.int64)
    for cl in range(n_clusters):
        offsets[cl + 1] = offsets[cl] + int((cluster_of_sorted == cl).sum())
    # the within-cluster power cdf and each triangle's conditional area pdf
    seg_cdf = np.zeros(order.size, np.float32)
    tri_pdf = np.zeros(t, np.float32)
    for cl in range(n_clusters):
        a, b = int(offsets[cl]), int(offsets[cl + 1])
        if b > a:
            w = p_sorted[a:b]
            wsum = w.sum()
            seg_cdf[a:b] = np.cumsum(w) / max(wsum, 1e-20)
            tris = order[a:b]
            tri_pdf[tris] = (w / max(wsum, 1e-20)) / np.maximum(area[tris], 1e-20)
    return RLClusters(tri_cluster=dv(tri_cluster), sorted_tris=dv(order.astype(np.int32)),
                      seg_cdf=dv(seg_cdf), cluster_offset=dv(offsets.astype(np.int32)),
                      tri_pdf_area=dv(tri_pdf), n_clusters=n_clusters)


class RLState(NamedTuple):
    """Per-cell Q values (the ClusteredRLStorage analog)."""

    q: Tensor  # (K, C) float32

    @staticmethod
    def create(table_size: int, n_clusters: int, device) -> "RLState":
        return RLState(q=torch.ones((table_size, n_clusters), dtype=torch.float32,
                                    device=device))


def cluster_probs(state: RLState, cell: Tensor, bias: float) -> Tensor:
    """(N, C) cluster selection probabilities: the cell's Q row normalized
    and mixed with a uniform floor."""
    row = state.q[cell.long()]
    s = torch.sum(row, dim=1, keepdim=True)
    c = row.shape[1]
    return (1.0 - bias) * row / torch.clamp_min(s, 1e-20) + bias / c


def _pick_cluster(probs: Tensor, u2: Tensor, n_clusters: int):
    """(cluster, its probability): count(cdf < u2), clipped."""
    cdf = torch.cumsum(probs, dim=1)
    cl = torch.clamp_max((cdf < u2[:, None]).to(torch.int32).sum(dim=1, dtype=torch.int32),
                         n_clusters - 1)
    return cl, torch.gather(probs, 1, cl.long()[:, None])[:, 0]


def _segment_search(seg_cdf: Tensor, lo: Tensor, hi: Tensor, u3: Tensor) -> Tensor:
    """The first index in [lo, hi) whose cdf is >= u3: SEARCH_STEPS fixed
    halvings of [lo, hi) (the cdf restarts in every cluster, so a global
    searchsorted is another function), clipped to the table."""
    e = seg_cdf.shape[0]
    for _ in range(SEARCH_STEPS):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        right = seg_cdf[torch.clamp(mid, 0, max(e - 1, 0)).long()] < u3
        lo, hi = torch.where(right, mid + 1, lo), torch.where(right, hi, mid)
    return torch.clamp(lo, 0, max(e - 1, 0))


def sample(clusters: RLClusters, state: RLState, light_rows: Tensor, cell: Tensor, u0: Tensor,
           u1: Tensor, u2: Tensor, u3: Tensor, bias: float = 0.25):
    """A light point: cluster by Q, triangle by the power CDF, point
    uniformly (rl.py:132-180). light_rows is the view's light table
    (MeshLightsView.rows). Returns (pos, normal, Le, pdf_area, tri, cluster)."""
    probs = cluster_probs(state, cell, bias)
    cl, p_cl = _pick_cluster(probs, u2, clusters.n_clusters)
    lo = clusters.cluster_offset[cl.long()]
    hi = clusters.cluster_offset[cl.long() + 1]
    if clusters.seg_cdf.shape[0] > 0:
        tri = clusters.sorted_tris[_segment_search(clusters.seg_cdf, lo, hi, u3).long()]
    else:
        tri = torch.zeros_like(cl)
    b0, b1 = square_to_uniform_triangle(u0, u1)
    pos, n, le, _ = row_sample(gather_rows(light_rows, tri), b0, b1)
    pdf_area = torch.where(hi <= lo, 0.0, p_cl * clusters.tri_pdf_area[tri.long()])
    return pos, n, le, pdf_area, tri, cl


def pdf_area_of(clusters: RLClusters, state: RLState, cell: Tensor, tri: Tensor,
                bias: float = 0.25) -> Tensor:
    """The area pdf the sampler gives an emissive hit on `tri` from `cell`
    (rl.py:183-194)."""
    tri_c = torch.clamp_min(tri, 0).long()
    cl = clusters.tri_cluster[tri_c]
    probs = cluster_probs(state, cell, bias)
    p_cl = torch.gather(probs, 1, torch.clamp_min(cl, 0).long()[:, None])[:, 0]
    return torch.where(cl >= 0, p_cl * clusters.tri_pdf_area[tri_c], 0.0)


def update(state: RLState, cell: Tensor, cluster: Tensor, reward: Tensor, valid: Tensor,
           lr: float = 0.15) -> RLState:
    """TD update toward the mean observed reward of each (cell, cluster)
    pair seen (rl.py:197-216)."""
    k, c = state.q.shape
    flat = torch.where(valid, cell * c + cluster, 0).long()
    f32 = dict(dtype=torch.float32, device=state.q.device)
    sums = torch.zeros(k * c, **f32).index_add_(0, flat, torch.where(valid, reward, 0.0))
    cnts = torch.zeros(k * c, **f32).index_add_(0, flat, valid.to(torch.float32))
    return td_update(state, sums, cnts, lr)


def td_update(state: RLState, sums: Tensor, cnts: Tensor, lr: float) -> RLState:
    """Q moved by lr toward sums / cnts where a (cell, cluster) pair was seen."""
    k, c = state.q.shape
    mean_r = sums / torch.clamp_min(cnts, 1.0)
    seen = (cnts > 0).reshape(k, c)
    return RLState(q=torch.where(seen, (1.0 - lr) * state.q + lr * mean_r.reshape(k, c),
                                 state.q))


# ---- tier 2: the VTL set's clusters (rl.py:219-311) ----

def _fetch_vtl_rows(vtls: VTLView, slot: Tensor) -> Tensor:
    if vtls.rows.shape[0] <= VTL_GATHER_MAX:
        return gather_rows(vtls.rows, slot)
    return vtls.rows[slot.long()]


def sample_vtl(vtls: VTLView, state: RLState, cell: Tensor, u0: Tensor, u1: Tensor,
               u2: Tensor, u3: Tensor, bias: float = 0.25):
    """A light point from the VTL set: cluster by Q, VTL by the power CDF,
    point uniformly in the sub-triangle, from one row fetch. Returns (pos,
    normal, Le, pdf_area, tri, cluster, slot)."""
    n, v, dev = cell.shape[0], vtls.rows.shape[0], cell.device
    if v == 0:
        z = torch.zeros(n, dtype=torch.float32, device=dev)
        zi = torch.zeros(n, dtype=torch.int32, device=dev)
        zv = Vec3(z, z, z)
        return zv, zv, zv, z, zi, zi, zi
    probs = cluster_probs(state, cell, bias)
    cl, p_cl = _pick_cluster(probs, u2, vtls.n_clusters)
    lo = vtls.cluster_offset[cl.long()]
    hi = vtls.cluster_offset[cl.long() + 1]
    slot = _segment_search(vtls.seg_cdf, lo, hi, u3)
    r = _fetch_vtl_rows(vtls, slot)
    vec = lambda c0: Vec3(r[:, c0], r[:, c0 + 1], r[:, c0 + 2])
    s, t = square_to_uniform_triangle(u0, u1)
    pos = vec(0) + vec(3) * s + vec(6) * t
    pdf_area = torch.where(hi <= lo, 0.0, p_cl * r[:, 15])
    return pos, vec(9), vec(12), pdf_area, vtls.tri[slot.long()], cl, slot


def pdf_area_of_vtl(vtls: VTLView, state: RLState, cell: Tensor, tri: Tensor, u: Tensor,
                    v: Tensor, bias: float = 0.25) -> Tensor:
    """The area pdf the VTL sampler gives the hit (tri, u, v): its VTL by
    the closed-form quadtree descent (mesh_lights.locate)."""
    nv = vtls.rows.shape[0]
    if nv == 0:
        return torch.zeros(tri.shape[0], dtype=torch.float32, device=tri.device)
    tri_c = torch.clamp_min(tri, 0).long()
    base = vtls.vtl_base[tri_c]
    local = locate(u, v, vtls.vtl_depth[tri_c])
    slot = vtls.leaf_slot[torch.clamp(base + local, 0, nv - 1).long()].long()
    cl = vtls.cluster_of[slot]
    probs = cluster_probs(state, cell, bias)
    p_cl = torch.gather(probs, 1, cl.long()[:, None])[:, 0]
    return torch.where(base >= 0, p_cl * vtls.pdf_area[slot], 0.0)
