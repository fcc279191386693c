"""Multi-device rendering: pixel lanes split over the ranks of a
torch.distributed process group (fermat_tpu/parallel/mesh.py).

No reference analog: the reference is single-GPU (renderer.cu:600-603). As
in JAX's design the scene is replicated (every rank builds the same view)
and rays never migrate, so the only collectives are small:
  * each rank renders its contiguous slice of the pixel ids through the
    `pix=` argument of the PT and BPT passes;
  * the ray counts are all_reduce'd;
  * BPT's light-tracing splat image (every rank splats into the full
    image) is all_reduce'd, the multi-device form of the reference's
    atomic splat sink (bpt_impl.h:143-155);
  * the train step all_reduces the diffuse gradient before the SGD update.

The caller starts the process group (`torch.distributed.init_process_group`
with its backend, init method, world size and rank) and names the backend:
`gloo` with device "cpu", `nccl` with a CUDA device. `make_mesh` refuses
any other pairing; nothing falls back from one backend to the other. A
rank's pass gives each lane the result the whole pass gives it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.integrators import bpt as bpt_mod
from fermat_tpu_torch.integrators import pt as pt_mod
from fermat_tpu_torch.scene.view import SceneView

Tensor = torch.Tensor

AXIS = "tiles"
_BACKEND_DEVICE = {"gloo": "cpu", "nccl": "cuda"}


class Mesh(NamedTuple):
    """The 1-D device mesh (JAX's Mesh over axis "tiles"): this process's
    rank, the world size, its device and the process group."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None


def make_mesh(device=None, group=None) -> Mesh:
    """The mesh of an initialized process group; `device` defaults to the
    backend's own (the CPU for gloo, cuda:<rank mod cards> for nccl)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed.init_process_group first")
    backend = dist.get_backend(group)
    if backend not in _BACKEND_DEVICE:
        raise NotImplementedError(f"backend {backend!r}: gloo (CPU) or nccl (CUDA)")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if device is None:
        device = ("cpu" if backend == "gloo"
                  else f"cuda:{rank % max(torch.cuda.device_count(), 1)}")
    device = torch.device(device)
    if device.type != _BACKEND_DEVICE[backend]:
        raise ValueError(f"backend {backend!r} runs on {_BACKEND_DEVICE[backend]}, not on "
                         f"{device}")
    return Mesh(rank, size, device, group)


def shard_pixels(n: int, mesh: Mesh) -> Tensor:
    """This rank's contiguous slice of the n pixel ids (n must divide)."""
    if n % mesh.size:
        raise ValueError(f"{n} pixels not divisible by {mesh.size} ranks")
    chunk = n // mesh.size
    return torch.arange(mesh.rank * chunk, (mesh.rank + 1) * chunk, dtype=torch.int64,
                        device=mesh.device)


def _all_reduce(t: Tensor, mesh: Mesh) -> Tensor:
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def render_pass_sharded(view: SceneView, opts: pt_mod.PTOptions, res_x: int, res_y: int,
                        instance: int, mesh: Mesh, seed: int = 0) -> "pt_mod._PassOutput":
    """One progressive PT pass over this rank's pixel slice: its lanes'
    outputs and the all_reduce'd ray count of the whole pass."""
    pix = shard_pixels(res_x * res_y, mesh)
    out = pt_mod.render_pass(view, opts, res_x, res_y, instance, seed, pix=pix)
    return out._replace(rays=_all_reduce(out.rays, mesh))


def render_pass_gspmd(view: SceneView, opts: pt_mod.PTOptions, res_x: int, res_y: int,
                      instance: int, mesh: Mesh, seed: int = 0) -> "pt_mod._PassOutput":
    """JAX's GSPMD-partitioned PT pass (mesh.py:156-186). PyTorch has no
    GSPMD; this is the same computation as render_pass_sharded, which it
    runs: the pixel slices split over the ranks, the ray count all_reduce'd."""
    return render_pass_sharded(view, opts, res_x, res_y, instance, mesh, seed)


def render_bpt_pass_sharded(view: SceneView, opts: bpt_mod.BPTOptions, res_x: int,
                            res_y: int, instance: int, mesh: Mesh, seed: int = 0):
    """One BPT pass over this rank's pixel slice (eye subpaths and their
    paired light subpaths): (this rank's radiance Vec3, the all_reduce'd
    (H*W, 3) light-tracing splat image, the all_reduce'd ray count)."""
    pix = shard_pixels(res_x * res_y, mesh)
    rad, splat, rays, _ = bpt_mod.render_pass(view, opts, res_x, res_y, instance, seed, pix=pix)
    return rad, _all_reduce(splat, mesh), _all_reduce(rays, mesh)


def _all_gather_rows(local: Tensor, mesh: Mesh) -> Tensor:
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)


def render_image_sharded(view: SceneView, opts: pt_mod.PTOptions, res_x: int, res_y: int,
                         n_passes: int, mesh: Mesh, seed: int = 0) -> Tensor:
    """The (H, W, 3) composited image averaged over n_passes sharded passes,
    gathered on every rank."""
    acc = None
    for i in range(n_passes):
        img = render_pass_sharded(view, opts, res_x, res_y, i, mesh, seed).composited.stack()
        acc = img if acc is None else acc + img
    return (_all_gather_rows(acc, mesh) / n_passes).reshape(res_y, res_x, 3)


def train_step_sharded(view: SceneView, target: Tensor, opts: pt_mod.PTOptions, res_x: int,
                       res_y: int, instance: int, mesh: Mesh, lr: float = 0.05,
                       seed: int = 0):
    """One inverse-rendering step (mesh.py:202-234): render this rank's
    slice, MSE against the flat (N, 3) target, d loss / d diffuse albedo
    (M, 3) through autograd, the gradient and loss all_reduce'd, then the
    SGD update clamped to [0, 1]. Each rank's loss is its slice's mean times
    its share of the pixels, so the sum is the image's mean (at one rank the
    factor is 1.0, the unsharded step). Returns (updated view, loss)."""
    n = res_x * res_y
    pix = shard_pixels(n, mesh)
    mats = view.mesh.materials
    with torch.enable_grad():
        leaf = mats.diffuse.stack().detach().clone().requires_grad_(True)
        v = view._replace(mesh=view.mesh._replace(materials=mats._replace(
            diffuse=Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]))))
        out = pt_mod.render_pass(v, opts, res_x, res_y, instance, seed, pix=pix)
        d = out.composited.stack() - target[pix]
        loss = torch.mean(d * d) * (pix.shape[0] / n)
        loss.backward()
    grad = _all_reduce(leaf.grad, mesh)
    loss = _all_reduce(loss.detach(), mesh)
    new = torch.clamp(leaf.detach() - lr * grad, 0.0, 1.0)
    mats = mats._replace(diffuse=Vec3(new[:, 0].contiguous(), new[:, 1].contiguous(),
                                      new[:, 2].contiguous()))
    return view._replace(mesh=view.mesh._replace(materials=mats)), loss
