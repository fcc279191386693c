"""Acceleration structures and the hit record.

Scenes of at most 4096 triangles trace with the dense tracer (ops/trace.py)
and need no structure. Larger ones carry the cluster table of cluster.py,
whose leaves come from the host binned-SAH builder of bvh.py and whose
top-level tree the frontier tracer walks (ops/frontier_trace.py), and
cluster.build_subclusters makes the 32-triangle leaf table of the
subcluster tracer (ops/sub_trace.py). bvh.build_bvh_for_mesh builds the
triangle BVH (bvh.BvhView) of the skip-link walk: its plain lockstep
version is traverse.walk_closest / walk_any, its kernel ops/bvh_trace.py
(tracer="bvh", and tracer="auto" above 4096 triangles without a cluster
table); from 4096 triangles it builds through the native C++ builder
(utils/native.py), as JAX does. lbvh.py builds a Karras LBVH of the same
layout on the device, kdtree.py a k-d tree for exact kNN queries.
"""
