"""Stream compaction and splat primitives (fermat_tpu/ops/compact.py:30-89).

The reference appends surviving rays to dense queues with warp-aggregated
atomics (PTRayQueue::warp_append, pathtracer_queues.h:69-93) and splats
into the framebuffer with atomic adds. Here, as in JAX:
  * `compact`      — exclusive scan + scatter: a mask -> a gather map onto
                     the dense prefix of its set lanes, and the live count;
  * `gather_tree` / `scatter_tree` — apply the map to every leaf of a tuple
                     or NamedTuple of (n, ...) tensors, and write compacted
                     results back to their source lanes;
  * `splat_add`    — scatter-add by target pixel (index_add_), lanes whose
                     pixel lies outside the image dropped, as JAX's
                     mode="drop" drops them.
Queues keep a fixed capacity: the map spans all n lanes, and downstream
stages mask slots >= count. Plain PyTorch, on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Compaction(NamedTuple):
    """compact()'s result. gather_idx[i] is the source lane of slot i (0 for
    the unused slots i >= count, as JAX's max-scatter leaves them);
    scatter_idx[j] is the slot of source lane j."""

    gather_idx: Tensor  # (n,) int32
    scatter_idx: Tensor  # (n,) int32
    count: Tensor  # () int32
    mask: Tensor  # (n,) bool, the original mask


def compact(mask: Tensor) -> Compaction:
    """Dense-prefix compaction of the set lanes (warp_append analog)."""
    n = mask.shape[0]
    m = mask.to(torch.int32)
    scatter_idx = torch.cumsum(m, 0, dtype=torch.int32) - m  # exclusive scan
    count = m.sum(dtype=torch.int32)
    src = torch.arange(n, dtype=torch.int32, device=mask.device)
    # dead lanes write 0 into the last slot, which a max leaves as it is
    gather_idx = torch.zeros(n, dtype=torch.int32, device=mask.device).scatter_reduce(
        0, torch.where(mask, scatter_idx, n - 1).long(), torch.where(mask, src, 0), "amax")
    return Compaction(gather_idx=gather_idx, scatter_idx=scatter_idx, count=count, mask=mask)


def _map_tree(fn, *trees):
    """fn over the leaves of matching tuples / NamedTuples of tensors."""
    head = trees[0]
    if isinstance(head, tuple):
        out = [_map_tree(fn, *leaves) for leaves in zip(*trees)]
        return type(head)(*out) if hasattr(head, "_fields") else type(head)(out)
    return fn(*trees)


def gather_tree(c: Compaction, tree):
    """Every (n, ...) leaf of `tree` in compacted slot order."""
    idx = c.gather_idx.long()
    return _map_tree(lambda a: a.index_select(0, idx), tree)


def scatter_tree(c: Compaction, compacted_tree, original_tree):
    """Compacted results back to their source lanes; dead lanes keep their
    original values."""
    idx = c.scatter_idx.long()

    def put(comp: Tensor, orig: Tensor) -> Tensor:
        vals = comp.index_select(0, idx)
        return torch.where(c.mask.reshape(c.mask.shape + (1,) * (orig.dim() - 1)), vals, orig)

    return _map_tree(put, compacted_tree, original_tree)


def splat_add(image: Tensor, pixel: Tensor, values: Tensor, enabled: Tensor = None) -> Tensor:
    """image (P, C) plus each lane's values (n, C) at its pixel (n,); a new
    tensor. Disabled lanes add zeros to pixel 0; a pixel in [-P, 0) counts
    from the end and one outside [-P, P) is dropped, as JAX's
    `.at[].add(mode="drop")` does."""
    if enabled is not None:
        values = torch.where(enabled[:, None], values, 0.0)
        pixel = torch.where(enabled, pixel, 0)
    p = image.shape[0]
    pixel = torch.where(pixel < 0, pixel + p, pixel)  # numpy-style negative indices
    keep = (pixel >= 0) & (pixel < p)
    return image.index_add(0, torch.where(keep, pixel, 0).long(),
                           torch.where(keep[:, None], values, 0.0))
