"""Acceleration structures and the hit record.

Slice 1 traces every scene with the dense tracer (ops/trace.py); the BVH and
cluster tracers of fermat_tpu/accel are later slices.
"""
