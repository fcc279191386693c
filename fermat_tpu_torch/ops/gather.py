"""K2 — row gather `table[idx]` (fermat_tpu/ops/gather.py:50-116).

On a CUDA tensor `gather_rows` launches the hand-written kernel in
csrc/gather.cu; on a CPU tensor it runs `_gather_plain`. Forward only: the
custom VJP of the JAX version (`_pog_bwd`, gather.py:84) belongs to the
differentiable slice.
"""
from __future__ import annotations

import torch

from fermat_tpu_torch.ops._cuda import I, P, CudaKernel, check_cuda_tensor

Tensor = torch.Tensor

GATHER = CudaKernel(
    "gather_rows", "gather.cu", "fermat_gather_rows",
    [P, P, I, I, I, P],
    replaces="fermat_tpu/ops/gather.py:50 (_pallas_onehot_gather, kernel _onehot_kernel :41)",
)


def _gather_plain(table: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch version: rows by index, zero rows outside [0, R)."""
    r = table.shape[0]
    ok = (idx >= 0) & (idx < r)
    rows = table.index_select(0, idx.clamp(0, r - 1).long())
    return torch.where(ok[:, None], rows, 0.0)


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """(R, K) float32 rows by (N,) int32 indices -> (N, K), exact."""
    if table.device.type == "cpu":
        return _gather_plain(table, idx)
    dev = table.device
    check_cuda_tensor(table, "table", torch.float32, 2, dev)
    check_cuda_tensor(idx, "idx", torch.int32, 1, dev)
    n = idx.shape[0]
    r, k = table.shape
    if n * k >= 2 ** 31:
        raise ValueError(f"gather_rows: {n} x {k} outputs exceed the kernel's int32 range")
    out = torch.empty((n, k), dtype=torch.float32, device=dev)
    GATHER.launch(dev, table.data_ptr(), idx.data_ptr(), r, k, n, out.data_ptr())
    return out
