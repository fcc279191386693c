"""The per-ray hit record (fermat_tpu/accel/traverse.py:36-46).

The tracers that fill it are in fermat_tpu_torch/ops: the dense ones and
their plain brute-force versions in trace.py, the ones over the cluster
table in frontier_trace.py, cluster_trace.py and binned_trace.py. They follow the Pallas kernels'
semantics rather than fermat_tpu's brute twin, which leaves a stale `t` on
inactive lanes (traverse.py:319-321) where the kernels return `tmax`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Hit(NamedTuple):
    """Per-ray hit record (src/ray.h Hit analog)."""

    t: Tensor
    tri: Tensor  # int32, -1 = miss
    u: Tensor
    v: Tensor

    @property
    def hit_mask(self) -> Tensor:
        return self.tri >= 0
