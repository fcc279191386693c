"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  * gather.py — K2, row gather (replaces ops/gather.py:_pallas_onehot_gather),
    and its backward K2b (replaces the custom VJP _pog_bwd)
  * trace.py  — K1a/K1b, dense closest / any hit (replaces ops/pallas_trace.py)
  * pt_mega.py — K3a/K3b, the whole-pass PT megakernel and its replay
    gradient (replaces ops/pallas_pt_mega.py)
  * cdf_gather.py — K4, fused CDF pick and row fetch (replaces
    ops/pallas_cdf_gather.py)
  * frontier_trace.py — K5a/K5b, closest / any hit over the cluster table
    (replaces ops/pallas_frontier_trace.py); the plain versions of the
    function K5-K7 share
  * cluster_trace.py — K6a/K6b, the same function visited near to far per
    block of rays (replaces ops/pallas_cluster_trace.py)
  * binned_trace.py — K7a/K7b, the same function as rounds of per-ray
    visits binned by cluster (replaces ops/pallas_binned_trace.py)
  * sub_trace.py — K8a/K8b, the same function over 32-triangle leaves,
    four staged together per step (replaces ops/pallas_sub_trace.py)
  * bvh_trace.py — the skip-link BVH walk, closest / any hit, one thread a
    ray (replaces accel/traverse.py's XLA while_loop, not a Pallas kernel)
  * compact.py — stream compaction and splats (ops/compact.py), plain
    PyTorch
  * _cuda.py  — builds csrc/*.cu with nvcc on first use and binds them (ctypes)
"""
