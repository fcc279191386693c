"""Host binned-SAH BVH build (fermat_tpu/accel/bvh.py:81-221), numpy only,
and the device skip-link BVH of the walk (bvh.py:31-67, 224-255).

The port's own copy of the builder: the cluster table (accel/cluster.py)
takes its leaves as clusters, the frontier tracer's top level is a BVH over
the cluster boxes built by the same function, and `build_bvh_for_mesh`
builds the triangle BVH that the skip-link walk (accel/traverse.py,
ops/bvh_trace.py) traverses with tracer="bvh".

Nodes come out in DFS order with skip links: an inner node's left child is
the next node, its right child is the left child's `skip`, and `skip` of a
node is where a walk resumes after its subtree (-1 at the end). Leaves hold
`leaf_size` slots of `prims`, -1 padded.

`build_bvh_for_mesh` builds a mesh of `_NATIVE_MIN_TRIS` = 4096 triangles or
more with the native C++ builder (utils/native.py), as JAX does
(bvh.py:219-255), so above that size the tree is JAX's array for array;
`use_native=False` takes this Python builder at every size. A failed native
build raises.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Tuple

import numpy as np
import torch

SENTINEL = -1


class HostBvh(NamedTuple):
    lo: np.ndarray  # (n_nodes, 3) float32
    hi: np.ndarray  # (n_nodes, 3) float32
    skip: np.ndarray  # (n_nodes,) int32
    prim_start: np.ndarray  # (n_nodes,) int32, leaves only
    is_leaf: np.ndarray  # (n_nodes,) bool
    prims: np.ndarray  # (n_leaves * leaf_size,) int32, -1 padded
    leaf_size: int

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]


class _Node:
    __slots__ = ("lo", "hi", "left", "right", "prims")

    def __init__(self, lo, hi, left=None, right=None, prims=None):
        self.lo = lo
        self.hi = hi
        self.left = left
        self.right = right
        self.prims = prims


def build_bvh(centroids: np.ndarray, lo: np.ndarray, hi: np.ndarray,
              leaf_size: int = 4, n_bins: int = 16) -> Tuple[HostBvh, np.ndarray]:
    """Binned-SAH build over primitive boxes. centroids/lo/hi: (T, 3)
    float32. Returns (HostBvh, the prims array): `prims` indexes the
    ORIGINAL primitive array, in DFS leaf order."""
    n_prims = centroids.shape[0]
    assert n_prims > 0, "empty BVH"

    def recurse(ids) -> _Node:
        nlo, nhi = lo[ids].min(0), hi[ids].max(0)
        if len(ids) <= leaf_size:
            return _Node(nlo, nhi, prims=ids)
        c = centroids[ids]
        cl, ch = c.min(0), c.max(0)
        ext = ch - cl
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # degenerate spread: split in half by index
            mid = len(ids) // 2
            return _Node(nlo, nhi, recurse(ids[:mid]), recurse(ids[mid:]))
        rel = (c[:, axis] - cl[axis]) / ext[axis]
        bins = np.minimum((rel * n_bins).astype(np.int32), n_bins - 1)
        # each bin's box and count: the primitives sorted by bin, one
        # reduction a non-empty bin
        bin_n = np.bincount(bins, minlength=n_bins)
        full = bin_n > 0
        order = np.argsort(bins, kind="stable")
        first = (np.cumsum(bin_n) - bin_n)[full]
        bin_lo = np.full((n_bins, 3), np.inf)
        bin_hi = np.full((n_bins, 3), -np.inf)
        bin_lo[full] = np.minimum.reduceat(lo[ids[order]], first, axis=0)
        bin_hi[full] = np.maximum.reduceat(hi[ids[order]], first, axis=0)

        def area(blo, bhi):
            d = np.maximum(bhi - blo, 0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        # prefix / suffix sweeps over the bins: split s puts bins 0..s left
        left_n = np.cumsum(bin_n)[:-1]
        left_a = np.where(left_n > 0, area(np.minimum.accumulate(bin_lo, 0),
                                           np.maximum.accumulate(bin_hi, 0))[:-1], 0.0)
        right_n = np.cumsum(bin_n[::-1])[::-1][1:]
        right_a = np.where(right_n > 0, area(np.minimum.accumulate(bin_lo[::-1], 0)[::-1],
                                             np.maximum.accumulate(bin_hi[::-1], 0)[::-1])[1:],
                           0.0)
        costs = np.where((left_n > 0) & (right_n > 0), left_a * left_n + right_a * right_n,
                         np.inf)
        if not np.isfinite(costs).any():
            mid = len(ids) // 2
            order = np.argsort(c[:, axis], kind="stable")
            return _Node(nlo, nhi, recurse(ids[order[:mid]]), recurse(ids[order[mid:]]))
        split = int(np.argmin(costs))
        lmask = bins <= split
        lids, rids = ids[lmask], ids[~lmask]
        if len(lids) == 0 or len(rids) == 0:
            mid = len(ids) // 2
            order = np.argsort(c[:, axis], kind="stable")
            lids, rids = ids[order[:mid]], ids[order[mid:]]
        return _Node(nlo, nhi, recurse(lids), recurse(rids))

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = recurse(np.arange(n_prims, dtype=np.int32))
    finally:
        sys.setrecursionlimit(old_limit)

    nodes_lo, nodes_hi, skips, starts, leaf_flags = [], [], [], [], []
    prim_slots: list = []

    def flatten(n: _Node, skip_to: int):
        nodes_lo.append(n.lo)
        nodes_hi.append(n.hi)
        skips.append(skip_to)
        if n.prims is not None:
            starts.append(len(prim_slots))
            leaf_flags.append(True)
            prim_slots.extend(list(n.prims) + [-1] * (leaf_size - len(n.prims)))
        else:
            starts.append(0)
            leaf_flags.append(False)
            # the right child's index is known once the left subtree is out
            left_pos = len(nodes_lo)
            flatten(n.left, -2)
            right_pos = len(nodes_lo)
            for i in range(left_pos, right_pos):
                if skips[i] == -2:
                    skips[i] = right_pos
            flatten(n.right, skip_to)

    flatten(root, SENTINEL)
    prims = np.asarray(prim_slots, np.int32)
    bvh = HostBvh(
        lo=np.asarray(nodes_lo, np.float32), hi=np.asarray(nodes_hi, np.float32),
        skip=np.asarray(skips, np.int32), prim_start=np.asarray(starts, np.int32),
        is_leaf=np.asarray(leaf_flags, bool), prims=prims, leaf_size=leaf_size)
    return bvh, prims


class BvhView(NamedTuple):
    """The device skip-link BVH (bvh.py:31-67): per node the box, `skip`,
    `prim_start` (leaves), `is_leaf` and `child` (the DFS child, i + 1, as
    JAX stores it); `prims` holds leaf_size slots a leaf, -1 padded, of
    indices into the mesh's triangles. `nodes` packs each node into two
    float4 records for the walk's kernel (ops/bvh_trace.py): (lo xyz, skip
    as int bits), (hi xyz, child for an inner node or -1 - prim_start for a
    leaf, as int bits)."""

    lo_x: torch.Tensor
    lo_y: torch.Tensor
    lo_z: torch.Tensor
    hi_x: torch.Tensor
    hi_y: torch.Tensor
    hi_z: torch.Tensor
    skip: torch.Tensor  # (n_nodes,) int32
    prim_start: torch.Tensor  # (n_nodes,) int32
    is_leaf: torch.Tensor  # (n_nodes,) bool
    prims: torch.Tensor  # (n_leaves * leaf_size,) int32
    child: torch.Tensor  # (n_nodes,) int32
    leaf_size: int
    nodes: torch.Tensor  # (n_nodes, 8) float32 records

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]

    @staticmethod
    def from_arrays(lo: np.ndarray, hi: np.ndarray, skip: np.ndarray, prim_start: np.ndarray,
                    is_leaf: np.ndarray, prims: np.ndarray, child: np.ndarray, leaf_size: int,
                    device) -> "BvhView":
        """The device view of host arrays: lo, hi (n_nodes, 3) float32, the
        int32 links, the bool leaf flags."""
        lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
        skip, child = np.asarray(skip, np.int32), np.asarray(child, np.int32)
        prim_start, is_leaf = np.asarray(prim_start, np.int32), np.asarray(is_leaf, bool)
        prims = np.asarray(prims, np.int32)
        if prims.size % leaf_size or not (prim_start[is_leaf] + leaf_size <= prims.size).all():
            raise ValueError("BvhView: a leaf's prims run past the prims array")
        meta = np.where(is_leaf, -1 - prim_start, child).astype(np.int32)
        nodes = np.concatenate([lo, skip.view(np.float32)[:, None], hi,
                                meta.view(np.float32)[:, None]], axis=1)
        t = lambda a: torch.from_numpy(np.array(a)).to(device)  # a writable copy
        return BvhView(lo_x=t(lo[:, 0]), lo_y=t(lo[:, 1]), lo_z=t(lo[:, 2]),
                       hi_x=t(hi[:, 0]), hi_y=t(hi[:, 1]), hi_z=t(hi[:, 2]),
                       skip=t(skip), prim_start=t(prim_start), is_leaf=t(is_leaf),
                       prims=t(prims), child=t(child), leaf_size=int(leaf_size),
                       nodes=t(nodes))


_NATIVE_MIN_TRIS = 4096  # below this the Python build takes under a second


def build_bvh_for_mesh(mesh, leaf_size: int = 4, use_native: bool = True) -> BvhView:
    """The skip-link BVH of a MeshView's triangles (bvh.py:224-255), built
    on the host from the (p0, e1, e2) soup: boxes widened by 1e-7, centroids
    in float32, as JAX builds them; natively from _NATIVE_MIN_TRIS
    triangles unless use_native is False; on the mesh's device."""
    h = lambda v: np.stack([v.x.detach().cpu().numpy(), v.y.detach().cpu().numpy(),
                            v.z.detach().cpu().numpy()], 1)
    p0 = h(mesh.p0)
    p1 = p0 + h(mesh.e1)
    p2 = p0 + h(mesh.e2)
    lo = (np.minimum(np.minimum(p0, p1), p2) - 1e-7).astype(np.float32)
    hi = (np.maximum(np.maximum(p0, p1), p2) + 1e-7).astype(np.float32)
    centroids = ((p0 + p1 + p2) / 3.0).astype(np.float32)
    if use_native and centroids.shape[0] >= _NATIVE_MIN_TRIS:
        from fermat_tpu_torch.utils.native import build_bvh_native

        b = HostBvh(leaf_size=leaf_size, **build_bvh_native(centroids, lo, hi, leaf_size))
    else:
        b, _ = build_bvh(centroids, lo, hi, leaf_size)
    return BvhView.from_arrays(b.lo, b.hi, b.skip, b.prim_start, b.is_leaf, b.prims,
                               np.arange(1, b.n_nodes + 1, dtype=np.int32), leaf_size,
                               mesh.p0.x.device)
