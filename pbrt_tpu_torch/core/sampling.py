"""Sampling warps (port of pbrt_tpu/core/sampling.py:178-196)."""

from __future__ import annotations

import math

import torch

PI_OVER_2 = math.pi / 2
PI_OVER_4 = math.pi / 4
INV_PI = 1.0 / math.pi


def concentric_sample_disk(u: torch.Tensor) -> torch.Tensor:
    """Branchless Shirley–Chiu concentric disk mapping (sampling.cpp:113)."""
    uo = 2.0 * u - 1.0
    x, y = uo[..., 0], uo[..., 1]
    zero = (x == 0.0) & (y == 0.0)
    use_x = x.abs() > y.abs()
    r = torch.where(use_x, x, y)
    one = torch.ones_like(x)
    theta = torch.where(
        use_x, PI_OVER_4 * (y / torch.where(x == 0.0, one, x)),
        PI_OVER_2 - PI_OVER_4 * (x / torch.where(y == 0.0, one, y)))
    r = torch.where(zero, torch.zeros_like(r), r)
    theta = torch.where(zero, torch.zeros_like(theta), theta)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def cosine_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    d = concentric_sample_disk(u)
    z = torch.sqrt(torch.clamp_min(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2,
                                   0.0))
    return torch.cat([d, z[..., None]], dim=-1)
