"""The import guard: the benchmark measures pbrt_tpu_torch and nothing of
the JAX package it was ported from.

Module names are compared by their top-level name, the part before the
first dot, as a whole: ``pbrt_tpu_torch`` passes, ``pbrt_tpu`` and
``pbrt_tpu.ops`` do not.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pbrt_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded), sorted."""
    names = sys.modules if names is None else names
    return sorted({top_level(n) for n in names} & FORBIDDEN)
