"""Core numerics: SoA vector math, counter RNG and QMC, sampling warps, camera."""
