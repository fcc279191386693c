"""Host binned-SAH BVH build (fermat_tpu/accel/bvh.py:81-221), numpy only.

The port's own copy of the builder: the cluster table (accel/cluster.py)
takes its leaves as clusters, and the frontier tracer's top level is a BVH
over the cluster boxes built by the same function. The device skip-link walk
of the JAX package (`trace_closest` / `trace_any` over a triangle BVH) is
not ported yet.

Nodes come out in DFS order with skip links: an inner node's left child is
the next node, its right child is the left child's `skip`, and `skip` of a
node is where a walk resumes after its subtree (-1 at the end). Leaves hold
`leaf_size` slots of `prims`, -1 padded.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Tuple

import numpy as np

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
        bin_lo = np.full((n_bins, 3), np.inf, np.float32)
        bin_hi = np.full((n_bins, 3), -np.inf, np.float32)
        bin_n = np.zeros(n_bins, np.int64)
        for b in range(n_bins):
            m = bins == b
            if m.any():
                bin_lo[b] = lo[ids[m]].min(0)
                bin_hi[b] = hi[ids[m]].max(0)
                bin_n[b] = m.sum()

        def area(blo, bhi):
            d = np.maximum(bhi - blo, 0)
            return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

        # prefix / suffix sweeps over the bins
        costs = np.full(n_bins - 1, np.inf)
        acc_lo, acc_hi, acc_n = np.full(3, np.inf), np.full(3, -np.inf), 0
        left_a = np.zeros(n_bins - 1)
        left_n = np.zeros(n_bins - 1, np.int64)
        for b in range(n_bins - 1):
            acc_lo = np.minimum(acc_lo, bin_lo[b])
            acc_hi = np.maximum(acc_hi, bin_hi[b])
            acc_n += bin_n[b]
            left_a[b] = area(acc_lo, acc_hi) if acc_n else 0.0
            left_n[b] = acc_n
        acc_lo, acc_hi, acc_n = np.full(3, np.inf), np.full(3, -np.inf), 0
        for b in range(n_bins - 1, 0, -1):
            acc_lo = np.minimum(acc_lo, bin_lo[b])
            acc_hi = np.maximum(acc_hi, bin_hi[b])
            acc_n += bin_n[b]
            right_a = area(acc_lo, acc_hi) if acc_n else 0.0
            if left_n[b - 1] > 0 and acc_n > 0:
                costs[b - 1] = left_a[b - 1] * left_n[b - 1] + right_a * acc_n
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
