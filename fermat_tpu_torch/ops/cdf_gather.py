"""K4 — fused CDF pick and row fetch (fermat_tpu/ops/pallas_cdf_gather.py).

`cdf_pick_rows(rows, cdf, u)` returns rows[min(upper_bound(cdf, u), L-1)]:
the light pick of every NEE sample over the emissive subset of a scene with
more than 2048 triangles (integrators/pt.py:_sample_lights_compact). On a
CUDA tensor it launches the hand-written kernel of csrc/cdf_gather.cu; on a
CPU tensor it runs `_pick_plain`. A NaN u picks row 0, as the JAX package's
count `sum(cdf <= u)` does (torch.searchsorted would give L).
"""
from __future__ import annotations

import torch

from fermat_tpu_torch.ops._cuda import I, P, CudaKernel, check_cuda_tensor

Tensor = torch.Tensor

PICK = CudaKernel(
    "cdf_pick_rows", "cdf_gather.cu", "fermat_cdf_pick_rows",
    [P, P, P, I, I, I, P],
    replaces="fermat_tpu/ops/pallas_cdf_gather.py:59 (cdf_pick_rows, kernel "
             "_pick_fetch_kernel :39, pallas_call :83)",
)


def pick_index(cdf: Tensor, u: Tensor) -> Tensor:
    """(N,) int64 min(upper_bound(cdf, u), L-1); NaN u -> 0."""
    idx = torch.searchsorted(cdf, u, right=True)
    idx = torch.where(torch.isnan(u), 0, idx)
    return torch.clamp(idx, max=cdf.shape[0] - 1)


def _pick_plain(rows: Tensor, cdf: Tensor, u: Tensor) -> Tensor:
    """Plain PyTorch version: searchsorted, the clamp, a row gather."""
    return rows.index_select(0, pick_index(cdf, u))


def cdf_pick_rows(rows: Tensor, cdf: Tensor, u: Tensor) -> Tensor:
    """rows (L, C) f32, cdf (L,) inclusive and non-decreasing, u (N,) f32 ->
    (N, C) exact copies of the picked rows."""
    if u.device.type == "cpu":
        return _pick_plain(rows, cdf, u)
    dev = u.device
    check_cuda_tensor(rows, "rows", torch.float32, 2, dev)
    check_cuda_tensor(cdf, "cdf", torch.float32, 1, dev)
    check_cuda_tensor(u, "u", torch.float32, 1, dev)
    n_rows, cols = rows.shape
    n = u.shape[0]
    if cdf.shape[0] != n_rows or n_rows == 0:
        raise ValueError(f"cdf_pick_rows: cdf has {cdf.shape[0]} entries for {n_rows} rows")
    if n * cols >= 2 ** 31:
        raise ValueError(f"cdf_pick_rows: {n} x {cols} outputs exceed the kernel's int32 range")
    out = torch.empty((n, cols), dtype=torch.float32, device=dev)
    PICK.launch(dev, rows.data_ptr(), cdf.data_ptr(), u.data_ptr(), n_rows, cols, n,
                out.data_ptr())
    return out
