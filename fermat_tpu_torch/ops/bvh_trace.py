"""The skip-link BVH walk on the card: closest hit and occlusion over a
triangle BVH (fermat_tpu/accel/traverse.py:140 trace_closest, :196
trace_any), one thread a ray (csrc/bvh.cu).

JAX's walk is an XLA while_loop, not a Pallas kernel. In eager PyTorch the
lockstep loop would read a flag back to the host every few steps, thousands
of steps a trace on a large scene, so on a CUDA tensor the wrappers launch
the hand-written kernel; on a CPU tensor they run the plain lockstep walk of
accel/traverse.py (walk_closest / walk_any), which takes the same steps a
ray, so the two agree bit for bit on the card. No fallback: a build or
launch failure on a CUDA tensor raises.

`bvh` is an accel/bvh.BvhView, `tris` the (9, T) soup of
MeshView.tri_soup() whose triangles its prims index. The PT pass routes
tracer="bvh", and tracer="auto" above 4096 triangles on a view without a
cluster table, here (integrators/pt.py).
"""
from __future__ import annotations

import torch

from fermat_tpu_torch.accel.traverse import Hit, walk_any, walk_closest
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel, check_cuda_tensor
from fermat_tpu_torch.ops.trace import _lane_args

Tensor = torch.Tensor

CLOSEST = CudaKernel(
    "trace_closest_bvh", "bvh.cu", "fermat_bvh_closest",
    [P] * 12 + [I, I, I] + [P] * 4,
    replaces="fermat_tpu/accel/traverse.py:140 (trace_closest, an XLA while_loop; not a "
             "Pallas kernel)",
)
ANY = CudaKernel(
    "trace_any_bvh", "bvh.cu", "fermat_bvh_any",
    [P] * 12 + [I, I, I, P],
    replaces="fermat_tpu/accel/traverse.py:196 (trace_any, an XLA while_loop; not a "
             "Pallas kernel)",
)


def _kernel_args(bvh, tris: Tensor, o: Vec3, d: Vec3, tmin: Tensor, tmax: Tensor,
                 active: Tensor) -> list:
    """Checked launch inputs as contiguous tensors; the caller holds them
    until the launch is enqueued."""
    dev = o.x.device
    rays = [c.contiguous() for c in (*o, *d)]
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz"), rays):
        check_cuda_tensor(t, name, torch.float32, 1, dev)
    check_cuda_tensor(active, "active", torch.bool, 1, dev)
    check_cuda_tensor(tris, "tris", torch.float32, 2, dev)
    check_cuda_tensor(bvh.nodes, "bvh.nodes", torch.float32, 2, dev)
    check_cuda_tensor(bvh.prims, "bvh.prims", torch.int32, 1, dev)
    if tris.shape[0] != 9:
        raise ValueError(f"tris must be (9, T), got {tuple(tris.shape)}")
    if bvh.nodes.shape[1] != 8:
        raise ValueError(f"bvh.nodes must be (n_nodes, 8), got {tuple(bvh.nodes.shape)}")
    return [bvh.nodes, bvh.prims, tris, *rays, tmin, tmax, active]


def trace_closest_bvh(bvh, tris: Tensor, o: Vec3, d: Vec3, tmin, tmax,
                      active: Tensor = None) -> Hit:
    """Closest hit over the BVH; t = tmax and tri = -1 on a miss and on an
    inactive lane."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return walk_closest(bvh, tris, o, d, tmin, tmax, active)
    n, dev = o.x.shape[0], o.x.device
    args = _kernel_args(bvh, tris, o, d, tmin, tmax, active)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    CLOSEST.launch(dev, *(a.data_ptr() for a in args), bvh.leaf_size, tris.shape[1], n,
                   t.data_ptr(), tri.data_ptr(), u.data_ptr(), v.data_ptr())
    return Hit(t=t, tri=tri, u=u, v=v)


def trace_any_bvh(bvh, tris: Tensor, o: Vec3, d: Vec3, tmin, tmax,
                  active: Tensor = None) -> Tensor:
    """Occlusion flag per ray inside (tmin, tmax), masked by `active`."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return walk_any(bvh, tris, o, d, tmin, tmax, active)
    n, dev = o.x.shape[0], o.x.device
    args = _kernel_args(bvh, tris, o, d, tmin, tmax, active)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    ANY.launch(dev, *(a.data_ptr() for a in args), bvh.leaf_size, tris.shape[1], n,
               occ.data_ptr())
    return occ
