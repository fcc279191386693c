"""Integrators. Slice 1 ports the wavefront path tracer (pt.py)."""
