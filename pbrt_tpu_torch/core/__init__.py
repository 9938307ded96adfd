"""Core math: counter-based RNG, vector math, sampling warps, transforms."""
