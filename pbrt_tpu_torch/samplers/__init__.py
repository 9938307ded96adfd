"""Samplers (port of pbrt_tpu/samplers/__init__.py:437-440).

Only the independent sampler is ported: it is the counter-based
``core.rng.uniform`` itself. The stratified, Halton, Sobol', (0,2) and
max-min-distance samplers come with the rest of the scene zoo.
"""

from __future__ import annotations

from typing import Callable

from pbrt_tpu_torch.core import rng as rng_mod


def make_sampler(name: str, spp: int = 16, resolution=None) -> Callable:
    """Return sample(pixel_id, sample_idx, dim, seed) → float32 in [0,1)."""
    if name.lower() in ("independent", "random"):
        def sample(pixel_id, sample_idx, dim, seed=0):
            return rng_mod.uniform(pixel_id, sample_idx, dim, seed)
        return sample
    raise NotImplementedError(
        f"sampler {name!r}: ROADMAP queue 1 item 8 (only 'independent' "
        "is ported)")
