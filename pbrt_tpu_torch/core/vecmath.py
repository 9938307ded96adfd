"""Vector math over batched ``(..., 3)`` tensors (port of the subset of
pbrt_tpu/core/vecmath.py that the fused path slice uses)."""

from __future__ import annotations

import dataclasses

import torch

SHADOW_EPS = 1e-3  # conservative ray-offset epsilon (vecmath.SHADOW_EPS)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp_min(torch.sum(v * v, dim=-1),
                                           1e-30))[..., None]


def face_forward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flip n into the hemisphere of v (geometry.h Faceforward)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def offset_ray_origin(p: torch.Tensor, n: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Scaled-normal shadow-ray origin offset (OffsetRayOrigin role)."""
    nf = face_forward(n, w)
    scale = SHADOW_EPS * torch.clamp_min(p.abs().amax(dim=-1), 1.0)
    return p + scale[..., None] * nf


@dataclasses.dataclass
class Ray:
    """A batch of rays: origins and directions, (R, 3) each. (pbrt_tpu's
    tmax and hero-wavelength fields come with the integrators that read
    them.)"""
    o: torch.Tensor
    d: torch.Tensor


def make_ray(o: torch.Tensor, d: torch.Tensor) -> Ray:
    return Ray(o=o, d=d)
