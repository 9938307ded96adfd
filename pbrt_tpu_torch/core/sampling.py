"""Sampling utilities (port of the parts of pbrt_tpu/core/sampling.py that
the ported integrators use): the discrete Distribution1D, the warps and
the power heuristic."""

from __future__ import annotations

import dataclasses
import math

import torch

PI = math.pi
PI_OVER_2 = math.pi / 2
PI_OVER_4 = math.pi / 4
INV_PI = 1.0 / math.pi
INV_4PI = 0.25 / math.pi


@dataclasses.dataclass
class Distribution1D:
    """Piecewise-constant 1D distribution (sampling.h:55-107): func (N,),
    cdf (N+1,), func_int () the integral of func over [0,1]."""
    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @property
    def n(self) -> int:
        return self.func.shape[-1]


def make_distribution_1d(f: torch.Tensor) -> Distribution1D:
    """CDF table of a 1D function; an all-zero function falls back to the
    uniform distribution (sampling.cpp)."""
    n = f.shape[-1]
    cdf = torch.cumsum(f, dim=-1) / n
    func_int = cdf[..., -1]
    zero = func_int == 0.0
    ramp = torch.arange(1, n + 1, dtype=f.dtype, device=f.device) / n
    cdf = torch.where(zero[..., None], ramp,
                      cdf / torch.where(zero, 1.0, func_int)[..., None])
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    return Distribution1D(func=f, cdf=cdf, func_int=func_int)


def sample_distribution_1d_discrete(d: Distribution1D, u: torch.Tensor):
    """SampleDiscrete (sampling.h:89-99) of a single shared distribution:
    returns (index, pmf)."""
    off = torch.searchsorted(d.cdf, u.contiguous(), right=True) - 1
    off = torch.clamp(off, 0, d.n - 1)
    func_int = torch.where(d.func_int > 0, d.func_int, 1.0)
    pmf = d.func[off] / (func_int * d.n)
    pmf = torch.where(d.func_int > 0, pmf, 1.0 / d.n)
    return off, pmf


def uniform_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    z = u[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_cone_pdf(cos_theta_max: torch.Tensor) -> torch.Tensor:
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def uniform_sample_cone(u: torch.Tensor,
                        cos_theta_max: torch.Tensor) -> torch.Tensor:
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    phi = u[..., 1] * 2.0 * PI
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def uniform_sample_triangle(u: torch.Tensor) -> torch.Tensor:
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return torch.where(f_pdf > 0,
                       (f * f) / torch.clamp_min(f * f + g * g, 1e-20), 0.0)


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
