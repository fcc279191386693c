"""Device-side LBVH build: morton sort + Karras radix tree
(fermat_tpu/accel/lbvh.py).

Reference: cugar/bvh/cuda/lbvh_builder.h:60-166 (morton + radix tree build),
cugar/radixtree/cuda/radixtree.h (Karras 2012 topology), cugar/tree/reduce.h
(bottom-up bbox reduction), validated the same way lbvh_test.cu:59-240 does —
against the host builder via traversal equivalence.

Tensor code on the primitives' device with JAX's fixed passes
(lbvh.py:92-183), so the tree is JAX's array for array:
  * morton codes in the normalized scene box + a stable argsort;
  * per internal node: direction, range and split by common-prefix
    searches (31 doubling passes, 32 halving passes, 32 split passes; ties
    broken by index bits, the standard Karras augmentation);
  * parent pointers, then 64 bottom-up box-reduction passes;
  * skip links by 64 passes of skip(x) = sibling if x is a left child else
    skip(parent), and first-child links: the stackless contract of BvhView,
    which the port's walk (accel/traverse.walk_closest, ops/bvh_trace)
    traverses.

Node indexing: internal nodes 0..N-2, leaves N-1..2N-2 (leaf i holds sorted
primitive i; leaf_size == 1). A uint32 code lives in an int64 tensor, as in
core/morton.py.
"""
from __future__ import annotations

from typing import Tuple

import torch

from fermat_tpu_torch.accel.bvh import BvhView
from fermat_tpu_torch.core.morton import morton3d

Tensor = torch.Tensor


def _clz32(x: Tensor) -> Tensor:
    """Leading zeros of uint32 values held in int64 (bit smear + popcount)."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return 32 - (((x * 0x01010101) & 0xFFFFFFFF) >> 24)


def _nodes(lo: Tensor, hi: Tensor, skip: Tensor, child: Tensor, is_leaf: Tensor,
           prim_start: Tensor) -> Tensor:
    """BvhView.nodes (the walk kernel's two float4 records a node) on device."""
    meta = torch.where(is_leaf, -1 - prim_start, child).to(torch.int32)
    return torch.cat([lo, skip.to(torch.int32).view(torch.float32)[:, None], hi,
                      meta.view(torch.float32)[:, None]], dim=1).contiguous()


def _view(lo: Tensor, hi: Tensor, skip: Tensor, prim_start: Tensor, is_leaf: Tensor,
          prims: Tensor, child: Tensor) -> BvhView:
    return BvhView(lo_x=lo[:, 0].contiguous(), lo_y=lo[:, 1].contiguous(),
                   lo_z=lo[:, 2].contiguous(), hi_x=hi[:, 0].contiguous(),
                   hi_y=hi[:, 1].contiguous(), hi_z=hi[:, 2].contiguous(),
                   skip=skip, prim_start=prim_start, is_leaf=is_leaf, prims=prims,
                   child=child, leaf_size=1,
                   nodes=_nodes(lo, hi, skip, child, is_leaf, prim_start))


def build_lbvh(cx: Tensor, cy: Tensor, cz: Tensor, lo_x: Tensor, lo_y: Tensor, lo_z: Tensor,
               hi_x: Tensor, hi_y: Tensor, hi_z: Tensor) -> Tuple[BvhView, Tensor]:
    """Build from per-primitive centroids and boxes (all (T,) tensors):
    (BvhView with leaf_size 1, the sorted primitive order, int32)."""
    n = cx.shape[0]
    dev = cx.device
    i32 = dict(dtype=torch.int32, device=dev)
    lo = torch.stack([lo_x, lo_y, lo_z], dim=1)
    hi = torch.stack([hi_x, hi_y, hi_z], dim=1)
    if n == 1:  # a single-leaf tree
        zero = torch.zeros(1, **i32)
        return _view(lo, hi, torch.full((1,), -1, **i32), zero,
                     torch.ones(1, dtype=torch.bool, device=dev), zero, zero), zero
    # scene box normalization
    smin = lo.amin(dim=0)
    smax = hi.amax(dim=0)
    inv = 1.0 / torch.clamp_min(smax - smin, 1e-12)
    codes = morton3d((cx - smin[0]) * inv[0], (cy - smin[1]) * inv[1],
                     (cz - smin[2]) * inv[2])
    order = torch.argsort(codes, stable=True)
    scodes = codes[order]

    def delta(i: Tensor, j: Tensor) -> Tensor:
        """Common-prefix length of sorted codes i, j; -1 outside the range.
        Equal codes fall through to the index bits (62-bit keys)."""
        valid = (j >= 0) & (j < n)
        jc = torch.clamp(j, 0, n - 1)
        x = scodes[i] ^ scodes[jc]
        d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
        return torch.where(valid, d, -1)

    # ---- Karras internal-node topology (radixtree.h) ----
    i = torch.arange(n - 1, dtype=torch.int64, device=dev)
    d_dir = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d_dir = torch.where(d_dir == 0, 1, d_dir)
    delta_min = delta(i, i - d_dir)
    lmax = torch.full_like(i, 2)
    for _ in range(31):  # exponential upper bound on the range length
        lmax = torch.where(delta(i, i + lmax * d_dir) > delta_min, lmax * 2, lmax)
    l = torch.zeros_like(i)
    t = torch.clamp_min(lmax, 1)
    for _ in range(32):  # binary search of the range's other end
        t = torch.clamp_min(t // 2, 1)
        l = torch.where(delta(i, i + (l + t) * d_dir) > delta_min, l + t, l)
    j = i + l * d_dir
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    rem = l
    for _ in range(32):  # binary search of the split
        t = (rem + 1) // 2
        s = torch.where(delta(i, i + (s + t) * d_dir) > delta_node, s + t, s)
        rem = torch.where(rem > 1, t, 0)
    gamma = i + s * d_dir + torch.clamp_max(d_dir, 0)

    # a child is a leaf when its range collapses; leaves live at n-1+k
    left = torch.where(torch.minimum(i, j) == gamma, (n - 1) + gamma, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, (n - 1) + gamma + 1, gamma + 1)
    n_nodes = 2 * n - 1
    parent = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    sibling = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    is_left = torch.zeros(n_nodes, dtype=torch.bool, device=dev)
    parent[left] = i
    parent[right] = i
    sibling[left] = right
    sibling[right] = left
    is_left[left] = True

    # ---- bottom-up bbox reduction (tree/reduce.h), 64 passes ----
    blo = torch.zeros((n_nodes, 3), dtype=torch.float32, device=dev)
    bhi = torch.zeros((n_nodes, 3), dtype=torch.float32, device=dev)
    blo[n - 1:] = lo[order]
    bhi[n - 1:] = hi[order]
    for _ in range(64):
        new_lo = torch.minimum(blo[left], blo[right])
        new_hi = torch.maximum(bhi[left], bhi[right])
        blo[i] = new_lo
        bhi[i] = new_hi

    # ---- skip links: skip(x) = sibling if left child else skip(parent) ----
    skip = torch.full((n_nodes,), -1, dtype=torch.int64, device=dev)
    has_parent = parent >= 0
    for _ in range(64):
        par_skip = torch.where(has_parent, skip[torch.clamp_min(parent, 0)], -1)
        skip = torch.where(has_parent, torch.where(is_left, sibling, par_skip), -1)

    first_child = torch.zeros(n_nodes, dtype=torch.int64, device=dev)
    first_child[i] = left
    node_ids = torch.arange(n_nodes, dtype=torch.int64, device=dev)
    is_leaf = node_ids >= (n - 1)
    prim_start = torch.where(is_leaf, node_ids - (n - 1), 0)
    order = order.to(torch.int32)
    return _view(blo, bhi, skip.to(torch.int32), prim_start.to(torch.int32), is_leaf, order,
                 first_child.to(torch.int32)), order


def build_lbvh_for_mesh(mesh_view) -> BvhView:
    """LBVH over a MeshView's triangles, on the mesh's device (lbvh.py:217-234):
    boxes widened by 1e-7 and centroids as JAX computes them."""
    p0, e1, e2 = mesh_view.p0, mesh_view.e1, mesh_view.e2
    p1x, p1y, p1z = p0.x + e1.x, p0.y + e1.y, p0.z + e1.z
    p2x, p2y, p2z = p0.x + e2.x, p0.y + e2.y, p0.z + e2.z
    lo = [torch.minimum(torch.minimum(a, b), c) - 1e-7
          for a, b, c in ((p0.x, p1x, p2x), (p0.y, p1y, p2y), (p0.z, p1z, p2z))]
    hi = [torch.maximum(torch.maximum(a, b), c) + 1e-7
          for a, b, c in ((p0.x, p1x, p2x), (p0.y, p1y, p2y), (p0.z, p1z, p2z))]
    # a device tensor as the divisor: a Python scalar would make the card
    # multiply by its reciprocal, which rounds apart from the CPU's division
    three = torch.full((), 3.0, dtype=torch.float32, device=p0.x.device)
    cx, cy, cz = ((a + b + c) / three
                  for a, b, c in ((p0.x, p1x, p2x), (p0.y, p1y, p2y), (p0.z, p1z, p2z)))
    view, _ = build_lbvh(cx, cy, cz, *lo, *hi)
    return view
