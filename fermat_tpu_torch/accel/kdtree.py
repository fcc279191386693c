"""k-d tree k-nearest-neighbor queries (fermat_tpu/accel/kdtree.py; cugar/kd
analog).

Reference analog: cugar/kd/* (the GPU k-d builder + kNN lookups used by
photon-style estimators). The renderers' own density estimators (PSFPT,
RPT) use stochastic spatial hashing instead; this module is library code
for exact kNN.

The build is host numpy (median splits into flat skip-link arrays), as
JAX's, moved to the caller's device. `knn` walks the tree with every query
lane in step, a masked tensor loop in place of JAX's `lax.while_loop`
(kdtree.py:120-179), carrying a sorted k-best list per lane and pruning a
subtree whose box is farther than the current k-th best; a leaf's points
are tested together and merged into the list by one stable sort, and the
lanes that finished leave the walk every 16 steps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fermat_tpu_torch import resolve_device

Tensor = torch.Tensor

_LEAF = 8
_BIG = 3.0e38
_SYNC_EVERY = 16


class KdTreeView(NamedTuple):
    """Flat skip-link k-d tree over points (device)."""

    lo: Tensor  # (M, 3) node bounds
    hi: Tensor  # (M, 3)
    skip: Tensor  # (M,) next node if subtree skipped (-1 done)
    start: Tensor  # (M,) leaf slot start (-1 inner)
    count: Tensor  # (M,) leaf point count
    pts: Tensor  # (P, 3) points in leaf order
    ids: Tensor  # (P,) original point ids in leaf order


def build_kdtree(points: np.ndarray, device="cuda") -> KdTreeView:
    """Host median-split build over (N, 3) points, moved to `device`."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    order = np.arange(n)
    nodes: list = []
    slots: list = []

    def rec(start, end):
        ids = order[start:end]
        lo = points[ids].min(0) if ids.size else np.zeros(3)
        hi = points[ids].max(0) if ids.size else np.zeros(3)
        me = len(nodes)
        nodes.append([*lo, *hi, -1, -1, 0])
        if end - start <= _LEAF:
            nodes[me][7] = len(slots)
            nodes[me][8] = end - start
            slots.extend(ids.tolist())
        else:
            axis = int(np.argmax(hi - lo))
            mid = (start + end) // 2
            sub = np.argsort(points[ids][:, axis], kind="stable")
            order[start:end] = ids[sub]
            rec(start, mid)
            rec(mid, end)
        return me

    if n:
        rec(0, n)
    else:
        nodes.append([0, 0, 0, 0, 0, 0, -1, 0, 0])

    m = len(nodes)
    arr = np.asarray(nodes, np.float64)
    sizes = np.zeros(m, np.int64)
    skips = np.full(m, -1, np.int64)

    def subtree(i):
        if arr[i, 8] > 0 or n == 0:
            sizes[i] = 1
            return 1
        sl = subtree(i + 1)
        sr = subtree(i + 1 + sl)
        sizes[i] = 1 + sl + sr
        return sizes[i]

    subtree(0)

    def fix(i, skip):
        skips[i] = skip
        if arr[i, 8] > 0 or n == 0:
            return
        l = i + 1
        r = l + sizes[l]
        fix(l, r)
        fix(r, skip)

    fix(0, -1)

    dev = resolve_device(device)
    j = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return KdTreeView(
        lo=j(arr[:, 0:3].astype(np.float32)),
        hi=j(arr[:, 3:6].astype(np.float32)),
        skip=j(skips.astype(np.int32)),
        start=j(arr[:, 7].astype(np.int32)),
        count=j(arr[:, 8].astype(np.int32)),
        pts=j(points[np.asarray(slots + [0], np.int64)[: max(len(slots), 1)]]
              .astype(np.float32)),
        ids=j(np.asarray(slots + [0], np.int64)[: max(len(slots), 1)]
              .astype(np.int32)),
    )


def _box_dist2(lo, hi, qx, qy, qz):
    dx = torch.clamp_min(torch.maximum(lo[:, 0] - qx, qx - hi[:, 0]), 0.0)
    dy = torch.clamp_min(torch.maximum(lo[:, 1] - qy, qy - hi[:, 1]), 0.0)
    dz = torch.clamp_min(torch.maximum(lo[:, 2] - qz, qz - hi[:, 2]), 0.0)
    return dx * dx + dy * dy + dz * dz


def _merge(best_d: Tensor, best_i: Tensor, cand_d: Tensor, cand_i: Tensor):
    """The k nearest of each lane's k-best list and a leaf's candidates
    (_BIG where a slot is no candidate), ascending. A stable sort of the
    list followed by the candidates in slot order keeps the order that
    JAX's unrolled insertion gives (kdtree.py:132-151): a candidate goes
    after the entries of equal distance before it, and one of _BIG never
    enters."""
    k = best_d.shape[1]
    d, order = torch.sort(torch.cat([best_d, cand_d], dim=1), dim=1, stable=True)
    return d[:, :k], torch.gather(torch.cat([best_i, cand_i], dim=1), 1, order[:, :k])


def knn(tree: KdTreeView, qx: Tensor, qy: Tensor, qz: Tensor, k: int = 4):
    """k nearest points for each query lane: (dist2 (N, k) ascending,
    ids (N, k)); empty slots carry 3e38 / -1."""
    n = qx.shape[0]
    dev = qx.device
    out_d = torch.full((n, k), _BIG, dtype=torch.float32, device=dev)
    out_i = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    best_d, best_i = out_d.clone(), out_i.clone()
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    lane = torch.arange(n, device=dev)
    last = tree.pts.shape[0] - 1
    slots = torch.arange(_LEAF, device=dev)
    step = 0
    while True:
        if step % _SYNC_EVERY == 0:
            # every _SYNC_EVERY steps the finished lanes (cursor -1) are
            # written out and the walk goes on with the live ones only
            live = node >= 0
            n_live = int(live.sum())
            if n_live < lane.shape[0]:
                done = ~live
                out_d[lane[done]], out_i[lane[done]] = best_d[done], best_i[done]
                keep = torch.nonzero(live).squeeze(1)
                lane, node, best_d, best_i = lane[keep], node[keep], best_d[keep], best_i[keep]
                qx, qy, qz = qx[keep], qy[keep], qz[keep]
            if n_live == 0:
                return out_d, out_i
        step += 1
        nc = torch.clamp_min(node, 0).long()
        live = node >= 0
        near = _box_dist2(tree.lo[nc], tree.hi[nc], qx, qy, qz)
        enter = live & (near < best_d[:, k - 1])
        count = tree.count[nc]
        is_leaf = count > 0
        slot = torch.clamp(tree.start[nc][:, None] + slots, 0, last).long()  # (N, _LEAF)
        p = tree.pts[slot]
        ok = (enter & is_leaf)[:, None] & (slots < count[:, None])
        d2 = ((qx[:, None] - p[..., 0]) ** 2 + (qy[:, None] - p[..., 1]) ** 2
              + (qz[:, None] - p[..., 2]) ** 2)
        best_d, best_i = _merge(best_d, best_i, torch.where(ok, d2, _BIG), tree.ids[slot])
        node = torch.where(enter & ~is_leaf, node + 1, torch.where(live, tree.skip[nc], node))
