"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

  * gather.py — K2, row gather (replaces ops/gather.py:_pallas_onehot_gather)
  * trace.py  — K1a/K1b, dense closest / any hit (replaces ops/pallas_trace.py)
  * pt_mega.py — K3a/K3b, the whole-pass PT megakernel and its replay
    gradient (replaces ops/pallas_pt_mega.py)
  * _cuda.py  — builds csrc/*.cu with nvcc on first use and binds them (ctypes)
"""
