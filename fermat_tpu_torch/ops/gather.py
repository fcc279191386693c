"""K2 — row gather `table[idx]` and its backward (fermat_tpu/ops/gather.py:50-116).

`gather_rows` is a torch.autograd.Function. Forward: on a CUDA tensor it
launches the hand-written kernel in csrc/gather.cu, on a CPU tensor it runs
`_gather_plain`. Backward (the custom VJP `_pog_bwd`, gather.py:84-103):
d_table[r, :] is the sum of the cotangent rows g[n, :] over the lanes n with
idx[n] == r; lanes whose index lies outside [0, R) add nothing (their
forward row is zero), and idx gets no gradient. On a CUDA tensor the
backward launches `fermat_gather_rows_bwd` (csrc/gather.cu), on a CPU
tensor it runs `_gather_bwd_plain`; a CUDA cotangent never takes the plain
backward. JAX's `one_hot_matmul_gather` (gather.py:19-33, the XLA one-hot
matmul of small tables, ONE_HOT_MAX_ROWS) computes the same rows: its
counterpart here is the plain version, `_gather_plain`.
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
GATHER_BWD = CudaKernel(
    "gather_rows_bwd", "gather.cu", "fermat_gather_rows_bwd",
    [P, P, I, I, I, P, P, I],
    replaces="fermat_tpu/ops/gather.py:84 (_pog_bwd, the custom VJP of "
             "_pallas_onehot_gather_diff :78; an XLA transposed one-hot matmul)",
)

# csrc/gather.cu's shared-memory backward: the most threads and shared
# memory a CTA takes, the most CTAs an SM in its grid (one partial each in
# the scratch), and the most table rows it serves: at 52 columns the atomic
# mode is as fast at 160 rows and faster above (tools/torch_k1b_k2b_steps.py
# --cut)
BWD_THREADS = 256
BWD_SMEM = 232_448
BWD_PER_SM = 2
BWD_ROWS = 160
# K2b against its plain version: both sum each d_table element in float32,
# in orders that differ (the plain version's index_add_ is atomic on a
# card), so per element |K2b - plain| <= BWD_RTOL * (sum of |g| over the
# lanes summed): ~1,700 float32 roundings, room for the sqrt(m) growth of
# the rounding of a sum of m ~ 10^5 terms
BWD_RTOL = 1e-4


def _gather_plain(table: Tensor, idx: Tensor) -> Tensor:
    """Plain PyTorch version: rows by index, zero rows outside [0, R)."""
    r = table.shape[0]
    ok = (idx >= 0) & (idx < r)
    rows = table.index_select(0, idx.clamp(0, r - 1).long())
    return torch.where(ok[:, None], rows, 0.0)


def _gather_bwd_plain(g: Tensor, idx: Tensor, rows: int) -> Tensor:
    """Plain PyTorch version of the backward: (N, K) cotangent -> (R, K)
    d(table), the in-range lanes' rows summed by index."""
    ok = (idx >= 0) & (idx < rows)
    out = torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return out.index_add_(0, idx[ok].long(), g[ok])


def bwd_slices(rows: int, cols: int) -> int:
    """Lane slices a CTA of the shared-memory backward keeps a private
    (R, K) partial for (the `slices` argument of csrc/gather.cu, for a
    16-byte aligned cotangent); 0 selects the global atomic mode. A slice is
    read by q threads, q = K / 4 float4 columns when K % 4 == 0, else K
    floats; a CTA takes at most BWD_THREADS threads and BWD_SMEM bytes of
    partials. The shared mode serves tables of at most BWD_ROWS rows."""
    q = cols // 4 if cols % 4 == 0 else cols
    if rows > BWD_ROWS or q > BWD_THREADS:
        return 0
    return min(BWD_THREADS // q, BWD_SMEM // (4 * rows * cols))


def _gather_fwd(table: Tensor, idx: Tensor) -> Tensor:
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


def gather_rows_bwd(g: Tensor, idx: Tensor, rows: int) -> Tensor:
    """d(table) (rows, K) from the (N, K) cotangent of gather_rows."""
    if g.device.type == "cpu":
        return _gather_bwd_plain(g, idx, rows)
    dev = g.device
    g = g.contiguous()
    check_cuda_tensor(g, "g", torch.float32, 2, dev)
    check_cuda_tensor(idx, "idx", torch.int32, 1, dev)
    n, k = g.shape
    if n * k >= 2 ** 31 or rows * k >= 2 ** 31:
        raise ValueError(f"gather_rows_bwd: {n} x {k} cotangent or {rows} x {k} table exceeds "
                         "the kernel's int32 range")
    if k % 4 == 0 and g.data_ptr() % 16:
        g = g.clone()  # 16-byte aligned, for the float4 loads bwd_slices counts on
    s = bwd_slices(rows, k)
    # one (R, K) partial a CTA of the shared mode's grid; the atomic mode reads none
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    scratch = torch.empty(sms * BWD_PER_SM * rows * k if s else 1, dtype=torch.float32,
                          device=dev)
    out = torch.empty((rows, k), dtype=torch.float32, device=dev)
    GATHER_BWD.launch(dev, g.data_ptr(), idx.data_ptr(), rows, k, n, scratch.data_ptr(),
                      out.data_ptr(), s)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: Tensor, idx: Tensor) -> Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return _gather_fwd(table, idx)

    @staticmethod
    def backward(ctx, g: Tensor):
        (idx,) = ctx.saved_tensors
        return gather_rows_bwd(g, idx, ctx.rows), None


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """(R, K) float32 rows by (N,) int32 indices -> (N, K), exact;
    differentiable in `table`."""
    return _GatherRows.apply(table, idx)
