"""BSDF: Fresnel, GGX-Smith, and the layered composite model."""
