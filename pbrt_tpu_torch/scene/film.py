"""Reconstruction filter (port of the box branch of pbrt_tpu/scene/film.py).

pbrt_tpu importance-samples the filter: each (pixel, sample) draws its
film offset from |f| and carries the weight f/p. For the box filter the
inverse CDF is closed-form (offset = (2u−1)·r, weight 1). The tabulated
filters (triangle, gaussian, mitchell, sinc) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

_DEFAULT_RADIUS = {"box": 0.5}


@dataclasses.dataclass
class Filter:
    radius: torch.Tensor   # (2,) xwidth, ywidth
    is_box: bool = True


def make_filter(name: str = "box", xwidth: float | None = None,
                ywidth: float | None = None, device="cpu") -> Filter:
    if name != "box":
        raise NotImplementedError(
            f"filter {name!r}: tabulated filters are ROADMAP queue 1 item 7")
    rx = float(xwidth) if xwidth is not None else _DEFAULT_RADIUS[name]
    ry = float(ywidth) if ywidth is not None else _DEFAULT_RADIUS[name]
    return Filter(radius=torch.tensor([rx, ry], dtype=torch.float32,
                                      device=device))


def sample_filter_offset(filt: Filter, u: torch.Tensor):
    """u: (R,2) uniforms → (offset (R,2) in pixels, weight (R,))."""
    if not filt.is_box:
        raise NotImplementedError("tabulated filters: ROADMAP queue 1 item 7")
    off = (2.0 * u - 1.0) * filt.radius
    return off, torch.ones(u.shape[:-1], dtype=u.dtype, device=u.device)
