"""The cluster table of the large-scene tracer (fermat_tpu/accel/cluster.py).

`build_clusters` partitions the triangles into clusters of at most 128
(binned-SAH leaves, merged greedily in DFS order while the union box stays
within 1.4x the summed areas) and lays them out exactly as the JAX package
does: a cluster-major (C_pad, 16, 128) float32 table, rows p0xyz e1xyz e2xyz
and the original triangle id in row 9 (-1 and degenerate zeros in padding
lanes), C_pad the cluster count rounded up to a group of 8, and per-cluster
boxes as (1, Cp) rows with Cp rounded up to 128 and inverted (+big, -big)
padding boxes. For the same mesh these are bit-equal to the JAX package's.
The table stays on the host; the device holds the row copy below.

`build_subclusters` makes the table of the subcluster tracer (K8,
ops/sub_trace.py) the same way at 32 triangles a leaf
(cluster.py:77-182): binned-SAH leaves of at most 32, no group padding,
per-subcluster boxes as (1, Cs) rows with Cs rounded up to 128, bit-equal
to the JAX package's leaves, slot order and boxes. The JAX package stores
every subcluster's tile at four lane phases ((Ns * 4, 16, 128)) because a
Mosaic lane tile is 128 wide; the port stores each once, as rows.

The port's tracers read more things built here, which the JAX package
does not have: the triangles of each cluster as (C_pad, 128, 12) rows (one
48-byte row per triangle) and the number of real triangles per cluster
(all of K5-K7), and, for the frontier kernel (ops/frontier_trace.py)
alone, a top-level BVH over the real clusters' boxes (accel/bvh.build_bvh
with one cluster per leaf) stored as one 64-byte record per inner node,
its depth, and the bounds its ray sort normalises origins by. The Pallas
kernel needs no such tree: it slab-tests every ray block against every
cluster box.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fermat_tpu_torch.accel.bvh import build_bvh
from fermat_tpu_torch.core.math import Vec3

Tensor = torch.Tensor

DENSE_MAX_TRIANGLES = 4096  # tracer="auto" traces larger scenes over the cluster table
CLUSTER = 128  # triangles per cluster
SUB = 32  # triangles per subcluster
GROUP = 8  # clusters per group (pads the cluster count)
SAH_MERGE = 1.4  # union-area gate of the DFS merge
MAX_DEPTH = 60  # the frontier kernel's stack holds up to 64 entries (csrc/frontier.cu)
_BIG = 3.0e38


class ClusterView(NamedTuple):
    tri: np.ndarray  # (C_pad, 16, 128) f32, the JAX package's table, on the host
    lo_x: Tensor  # (1, Cp) per-cluster boxes; padding boxes inverted
    lo_y: Tensor
    lo_z: Tensor
    hi_x: Tensor
    hi_y: Tensor
    hi_z: Tensor
    rows: Tensor  # (C_pad, 128, 12) f32: p0 e1 e2 xyz, original id, 0, 0
    count: Tensor  # (C_pad,) int32 real triangles per cluster (a prefix)
    node_box: Tensor  # (n_nodes, 6) f32 lo xyz, hi xyz of the top-level BVH
    node_ref: Tensor  # (n_nodes,) int32: inner -> right child, leaf -> ~cluster
    nodes: Tensor  # (n_inner, 16) f32: the tree as 64-byte records (_node_records)
    depth: np.ndarray  # 0-d int32 on the host: the stack entries the tree's walk needs
    key_norm: Tensor  # (6,) f32 lo xyz, 1 / extent xyz of the boxes (the ray sort's)
    p0: Vec3  # the original-order soup, for barycentrics from a winning id
    e1: Vec3
    e2: Vec3

    def boxes(self) -> Tensor:
        """(6, Cp) lo xyz, hi xyz rows."""
        return torch.cat([self.lo_x, self.lo_y, self.lo_z, self.hi_x, self.hi_y, self.hi_z])


class SubclusterView(NamedTuple):
    """The subcluster table (cluster.py:77-113): per-subcluster boxes, the
    triangles of each subcluster as (Ns, 32, 12) rows (p0 e1 e2 xyz,
    original id, 0, 0; padding slots zero with id -1), the number of real
    triangles per subcluster, and the original-order soup. The field names
    are ClusterView's, so the plain versions of ops/frontier_trace.py read
    either table."""

    lo_x: Tensor  # (1, Cs) per-subcluster boxes; padding boxes inverted
    lo_y: Tensor
    lo_z: Tensor
    hi_x: Tensor
    hi_y: Tensor
    hi_z: Tensor
    rows: Tensor  # (Ns, 32, 12) f32
    count: Tensor  # (Ns,) int32 real triangles per subcluster (a prefix)
    p0: Vec3
    e1: Vec3
    e2: Vec3

    @property
    def n_subclusters(self) -> int:
        return self.rows.shape[0]

    def boxes(self) -> Tensor:
        """(6, Cs) lo xyz, hi xyz rows."""
        return torch.cat([self.lo_x, self.lo_y, self.lo_z, self.hi_x, self.hi_y, self.hi_z])


def _sah_leaves(p0, e1, e2, cent, max_size: int = CLUSTER) -> list:
    """Binned-SAH leaves of at most `max_size` triangles, then the greedy
    DFS-order merge (cluster.py:185-240)."""
    v1 = p0 + e1
    v2 = p0 + e2
    lo = np.minimum(np.minimum(p0, v1), v2)
    hi = np.maximum(np.maximum(p0, v1), v2)
    _bvh, slots = build_bvh(cent, lo, hi, leaf_size=max_size)
    slots = slots.reshape(-1, max_size)  # DFS leaves, -1 padded
    leaves = [row[row >= 0].astype(np.int64) for row in slots]

    def box(ids):
        return lo[ids].min(0), hi[ids].max(0)

    def area(b):
        d = np.maximum(b[1] - b[0], 0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    merged = []
    cur = leaves[0]
    cb = box(cur)
    for nxt in leaves[1:]:
        if cur.size + nxt.size <= max_size:
            nb = box(nxt)
            ub = (np.minimum(cb[0], nb[0]), np.maximum(cb[1], nb[1]))
            if area(ub) <= SAH_MERGE * (area(cb) + area(nb)):
                cur = np.concatenate([cur, nxt])
                cb = ub
                continue
        merged.append(cur)
        cur, cb = nxt, box(nxt)
    merged.append(cur)
    return merged


def _median_leaves(cent: np.ndarray, max_size: int = CLUSTER) -> list:
    """Recursive longest-axis median split of the centroids (cluster.py:150)."""
    out = []
    stack = [np.arange(cent.shape[0], dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if ids.size <= max_size:
            out.append(ids)
            continue
        c = cent[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = ids[np.argsort(c[:, ax], kind="stable")]
        mid = ids.size // 2
        stack.append(srt[mid:])
        stack.append(srt[:mid])
    return out


def _morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    def expand(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(x) << 2) | (expand(y) << 1) | expand(z)


def _morton_leaves(cent: np.ndarray) -> list:
    lo, hi = cent.min(axis=0), cent.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((cent - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)
    order = np.argsort(_morton3d(q[:, 0], q[:, 1], q[:, 2]), kind="stable").astype(np.int64)
    return [order[s:s + CLUSTER] for s in range(0, cent.shape[0], CLUSTER)]


def _top_level(c_lo: np.ndarray, c_hi: np.ndarray):
    """BVH over the real clusters' boxes, one cluster per leaf: (node_box
    (n, 6), node_ref (n,), depth) with node_ref = right child or ~cluster
    and depth the deepest node's level (the root's is 0)."""
    cent = ((c_lo + c_hi) * np.float32(0.5)).astype(np.float32)
    bvh, _ = build_bvh(cent, c_lo, c_hi, leaf_size=1)
    n = bvh.n_nodes
    ref = np.empty(n, np.int32)
    depth = np.zeros(n, np.int64)
    for i in range(n):
        if bvh.is_leaf[i]:
            ref[i] = ~bvh.prims[bvh.prim_start[i]]
        else:
            ref[i] = bvh.skip[i + 1]  # the left child's skip is the right child
            depth[i + 1] = depth[ref[i]] = depth[i] + 1
    if depth.max() > MAX_DEPTH:
        raise ValueError(f"cluster BVH depth {depth.max()} exceeds the kernel's "
                         f"stack ({MAX_DEPTH})")
    return np.concatenate([bvh.lo, bvh.hi], axis=1).astype(np.float32), ref, int(depth.max())


def _node_records(node_box: np.ndarray, node_ref: np.ndarray) -> np.ndarray:
    """The tree as the frontier kernel reads it: one (16,) float32 record
    per inner node, in DFS order (record 0 the root), holding both
    children: left lo.x hi.x lo.y hi.y | right lo.x hi.x lo.y hi.y | left
    lo.z hi.z, right lo.z hi.z | left ref, right ref (int32 bits), 0, 0. A
    ref >= 0 is a record, a ref < 0 is ~cluster. The boxes are node_box's
    floats, unchanged. A tree whose root is a leaf (one cluster) becomes one
    record whose right child is an empty (inverted) box."""
    n = node_ref.shape[0]
    inner = np.nonzero(node_ref >= 0)[0]
    if inner.size == 0:
        box = np.concatenate([node_box, [[_BIG] * 3 + [-_BIG] * 3]]).astype(np.float32)
        left, right, refs = np.array([0]), np.array([1]), np.array([node_ref[0]] * 2)
    else:
        box = node_box
        left, right = inner + 1, node_ref[inner].astype(np.int64)
        rec_id = np.full(n, -1, np.int64)
        rec_id[inner] = np.arange(inner.size)
        refs = np.where(node_ref >= 0, rec_id, node_ref)
    rec = np.zeros((left.size, 16), np.float32)
    for k, (side, col) in enumerate(((left, 0), (left, 3), (left, 1), (left, 4),
                                     (right, 0), (right, 3), (right, 1), (right, 4),
                                     (left, 2), (left, 5), (right, 2), (right, 5))):
        rec[:, k] = box[side, col]
    rec[:, 12] = refs[left].astype(np.int32).view(np.float32)
    rec[:, 13] = refs[right].astype(np.int32).view(np.float32)
    return rec


def _key_norm(boxes: Tensor) -> Tensor:
    """(lo xyz, 1 / extent xyz) of the boxes, as pallas_frontier_trace.
    _sort_key (:70-74) normalises ray origins; the padding boxes are
    inverted, so they move neither bound."""
    lo, hi = boxes[:3].amin(dim=1), boxes[3:].amax(dim=1)
    return torch.cat([lo, 1.0 / torch.clamp_min(hi - lo, 1e-20)])


def _soup(mesh_view):
    """(p0, e1, e2, centroids) of the mesh as (T, 3) float32 host arrays."""
    h = lambda t: t.detach().cpu().numpy()
    v3 = lambda v: np.stack([h(v.x), h(v.y), h(v.z)], axis=1)
    p0, e1, e2 = v3(mesh_view.p0), v3(mesh_view.e1), v3(mesh_view.e2)
    return p0, e1, e2, (p0 + (p0 + e1) + (p0 + e2)) / 3.0


def _pack(leaves: list, n_rows: int, width: int, p0, e1, e2):
    """The leaves in slots of `width`, n_rows rows (the rows past the leaves
    empty): the ten component rows p0xyz e1xyz e2xyz id, each flat
    (n_rows * width,), and the (n_rows, 3) lo / hi boxes over each row's
    real triangles (+big / -big where it has none)."""
    slot = np.full((n_rows, width), -1, np.int64)
    for i, leaf in enumerate(leaves):
        slot[i, : leaf.size] = leaf
    flat = slot.reshape(-1)
    valid = flat >= 0
    take = np.where(valid, flat, 0)

    def comp(a):
        return np.where(valid, a[take], 0.0).astype(np.float32)

    comps = [comp(p0[:, 0]), comp(p0[:, 1]), comp(p0[:, 2]),
             comp(e1[:, 0]), comp(e1[:, 1]), comp(e1[:, 2]),
             comp(e2[:, 0]), comp(e2[:, 1]), comp(e2[:, 2]),
             np.where(valid, flat, -1).astype(np.float32)]
    p0p = np.stack(comps[0:3], 1)
    e1p = np.stack(comps[3:6], 1)
    e2p = np.stack(comps[6:9], 1)
    v1p = p0p + e1p
    v2p = p0p + e2p
    mins = np.where(valid[:, None], np.minimum(np.minimum(p0p, v1p), v2p), _BIG)
    maxs = np.where(valid[:, None], np.maximum(np.maximum(p0p, v1p), v2p), -_BIG)
    return (comps, mins.reshape(n_rows, width, 3).min(axis=1),
            maxs.reshape(n_rows, width, 3).max(axis=1))


def _box_rows(c_lo: np.ndarray, c_hi: np.ndarray) -> np.ndarray:
    """(6, C rounded up to 128) lo xyz, hi xyz rows, inverted padding."""
    n = c_lo.shape[0]
    cp = -(-n // 128) * 128
    c_lo = np.concatenate([c_lo, np.full((cp - n, 3), _BIG, np.float32)])
    c_hi = np.concatenate([c_hi, np.full((cp - n, 3), -_BIG, np.float32)])
    return np.concatenate([c_lo, c_hi], axis=1).T.astype(np.float32)


def build_subclusters(mesh_view) -> SubclusterView:
    """The subcluster table of the mesh (cluster.py:116-182): SAH leaves of
    at most 32 triangles, on the mesh view's device."""
    p0, e1, e2, cent = _soup(mesh_view)
    leaves = _sah_leaves(p0, e1, e2, cent, max_size=SUB)
    ns = len(leaves)
    comps, c_lo, c_hi = _pack(leaves, ns, SUB, p0, e1, e2)
    zero = np.zeros_like(comps[0])
    rows = np.stack(comps + [zero, zero], axis=1).reshape(ns, SUB, 12)
    boxes = _box_rows(c_lo, c_hi)
    dev = mesh_view.p0.x.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    row = lambda k: t(boxes[k].reshape(1, -1))
    return SubclusterView(
        lo_x=row(0), lo_y=row(1), lo_z=row(2), hi_x=row(3), hi_y=row(4), hi_z=row(5),
        rows=t(rows), count=t((rows[:, :, 9] >= 0.0).sum(axis=1).astype(np.int32)),
        p0=mesh_view.p0, e1=mesh_view.e1, e2=mesh_view.e2,
    )


def build_clusters(mesh_view, method: str = "sah") -> ClusterView:
    """Partition the mesh's triangles into clusters (cluster.py:243-371).

    method: "sah" (binned-SAH leaves + greedy DFS merge; the JAX package's
    default), "median" (longest-axis median split) or "morton" (128
    consecutive triangles of the morton order)."""
    p0, e1, e2, cent = _soup(mesh_view)
    if method == "sah":
        leaves = _sah_leaves(p0, e1, e2, cent)
    elif method == "median":
        leaves = _median_leaves(cent)
    elif method == "morton":
        leaves = _morton_leaves(cent)
    else:
        raise ValueError(f"cluster method {method!r}")

    c_pad = -(-len(leaves) // GROUP) * GROUP
    comps, c_lo, c_hi = _pack(leaves, c_pad, CLUSTER, p0, e1, e2)
    comps = comps + [np.zeros(c_pad * CLUSTER, np.float32)] * 6
    tri = np.stack([c.reshape(c_pad, CLUSTER) for c in comps], axis=1)
    return cluster_view(tri, _box_rows(c_lo, c_hi), mesh_view)


def cluster_view(tri: np.ndarray, boxes: np.ndarray, mesh_view) -> ClusterView:
    """The device view from the host table (C_pad, 16, 128) and the (6, Cp)
    boxes (lo xyz, hi xyz rows), with the kernel's rows, counts and
    top-level BVH derived from them; on the mesh view's device. The table
    itself stays on the host: the tracers read only its (C_pad, 128, 12)
    row copy."""
    tri = np.asarray(tri, np.float32)
    boxes = np.asarray(boxes, np.float32).reshape(6, -1)
    count = (tri[:, 9, :] >= 0.0).sum(axis=1).astype(np.int32)
    real = np.nonzero(count > 0)[0]  # padding clusters: no triangle, inverted box
    node_box, node_ref, depth = _top_level(boxes[:3, real].T, boxes[3:, real].T)
    leaf = node_ref < 0
    node_ref[leaf] = ~real[~node_ref[leaf]]
    # a leaf's box is its cluster's (a min and max over one box), so the
    # kernel takes a cluster's E' from the record's slab test of the leaf
    if not np.array_equal(node_box[leaf].view(np.int32),
                          boxes[:, ~node_ref[leaf]].T.view(np.int32)):
        raise ValueError("a leaf box of the cluster BVH differs from its cluster's box")
    dev = mesh_view.p0.x.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    row = lambda k: t(boxes[k].reshape(1, -1))
    return ClusterView(
        tri=tri,
        lo_x=row(0), lo_y=row(1), lo_z=row(2), hi_x=row(3), hi_y=row(4), hi_z=row(5),
        rows=t(tri[:, :12, :].transpose(0, 2, 1)),
        count=t(count), node_box=t(node_box), node_ref=t(node_ref),
        nodes=t(_node_records(node_box, node_ref)),
        depth=np.array(max(depth, 1), np.int32),
        key_norm=_key_norm(torch.from_numpy(np.ascontiguousarray(boxes))).to(dev),
        p0=mesh_view.p0, e1=mesh_view.e1, e2=mesh_view.e2,
    )
