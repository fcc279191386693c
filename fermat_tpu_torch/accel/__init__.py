"""Acceleration structures and the hit record.

Scenes of at most 4096 triangles trace with the dense tracer (ops/trace.py)
and need no structure. Larger ones carry the cluster table of cluster.py,
whose leaves come from the host binned-SAH builder of bvh.py and whose
top-level tree the frontier tracer walks (ops/frontier_trace.py), and
cluster.build_subclusters makes the 32-triangle leaf table of the
subcluster tracer (ops/sub_trace.py). The device skip-link BVH walk of
fermat_tpu/accel/bvh.py is not ported.
"""
