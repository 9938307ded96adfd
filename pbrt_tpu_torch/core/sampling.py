"""Sampling utilities (port of pbrt_tpu/core/sampling.py):
Distribution1D (discrete and continuous, one shared or one per row),
Distribution2D for the environment map, the warps and their pdfs, and
the balance and power heuristics."""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_tpu_torch.core import vecmath

PI = math.pi
PI_OVER_2 = math.pi / 2
PI_OVER_4 = math.pi / 4
INV_PI = 1.0 / math.pi
INV_2PI = 0.5 / math.pi
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


def _find_interval(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Index i with cdf[i] <= u < cdf[i+1], clipped into [0, n-1]: at a
    tie of the CDF the last such bin, as pbrt_tpu's searchsorted(side=
    "right") - 1. ``cdf`` is one shared (n+1,) table or one row per lane,
    (..., n+1) with u (...)."""
    n = cdf.shape[-1] - 1
    if cdf.ndim == 1:
        idx = torch.searchsorted(cdf, u.contiguous(), right=True)
    else:
        idx = torch.searchsorted(cdf.contiguous(), u[..., None].contiguous(),
                                 right=True)[..., 0]
    return torch.clamp(idx - 1, 0, n - 1)


def _take(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """tab[idx] for a shared table, or per row for a batched one."""
    if tab.ndim == 1:
        return tab[idx]
    return torch.gather(tab, -1, idx[..., None])[..., 0]


def sample_distribution_1d_continuous(d: Distribution1D, u: torch.Tensor):
    """SampleContinuous (sampling.h:65-87): returns (x in [0,1), pdf,
    offset)."""
    off = _find_interval(d.cdf, u)
    c_lo = _take(d.cdf, off)
    c_hi = _take(d.cdf, off + 1)
    du = u - c_lo
    denom = torch.where(c_hi - c_lo > 0, c_hi - c_lo, 1.0)
    du = du / denom
    func_int = torch.where(d.func_int > 0, d.func_int, 1.0)
    pdf = _take(d.func, off) / func_int
    x = (off.to(u.dtype) + du) / d.n
    return x, pdf, off


def sample_distribution_1d_discrete(d: Distribution1D, u: torch.Tensor):
    """SampleDiscrete (sampling.h:89-99): returns (index, pmf)."""
    off = _find_interval(d.cdf, u)
    func_int = torch.where(d.func_int > 0, d.func_int, 1.0)
    pmf = _take(d.func, off) / (func_int * d.n)
    pmf = torch.where(d.func_int > 0, pmf, 1.0 / d.n)
    return off, pmf


def distribution_1d_discrete_pdf(d: Distribution1D, idx: torch.Tensor
                                 ) -> torch.Tensor:
    """DiscretePDF (sampling.h:101-104): the pmf of index idx (uniform
    for a zero-integral distribution)."""
    func_int = torch.where(d.func_int > 0, d.func_int, 1.0)
    return torch.where(d.func_int > 0, _take(d.func, idx) / (func_int * d.n),
                       1.0 / d.n)


@dataclasses.dataclass
class Distribution2D:
    """Piecewise-constant 2D distribution (sampling.h:124-132): one
    conditional Distribution1D per row, (H, W), and the marginal over
    rows, (H,)."""
    cond: Distribution1D
    marginal: Distribution1D


def make_distribution_2d(f: torch.Tensor) -> Distribution2D:
    cond = make_distribution_1d(f)
    return Distribution2D(cond=cond,
                          marginal=make_distribution_1d(cond.func_int))


def sample_distribution_2d(d: Distribution2D, u: torch.Tensor):
    """u: (..., 2) → ((u, v) in [0,1)², pdf): the marginal picks a row,
    that row's conditional the column."""
    v, pdf_m, row = sample_distribution_1d_continuous(d.marginal, u[..., 1])
    rd = Distribution1D(func=d.cond.func[row], cdf=d.cond.cdf[row],
                        func_int=d.cond.func_int[row])
    x, pdf_c, _ = sample_distribution_1d_continuous(rd, u[..., 0])
    return torch.stack([x, v], dim=-1), pdf_m * pdf_c


def distribution_2d_pdf(d: Distribution2D, uv: torch.Tensor) -> torch.Tensor:
    h, w = d.cond.func.shape
    iu = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    iv = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    func_int = torch.where(d.marginal.func_int > 0, d.marginal.func_int, 1.0)
    return d.cond.func[iv, iu] / func_int


def uniform_sample_hemisphere(u: torch.Tensor) -> torch.Tensor:
    z = u[..., 0]
    r = vecmath.safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_sample_sphere(u: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = vecmath.safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_cone_pdf(cos_theta_max: torch.Tensor) -> torch.Tensor:
    return 1.0 / (2.0 * PI * (1.0 - cos_theta_max))


def uniform_sample_cone(u: torch.Tensor,
                        cos_theta_max: torch.Tensor) -> torch.Tensor:
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = vecmath.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = u[..., 1] * 2.0 * PI
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def uniform_sample_triangle(u: torch.Tensor) -> torch.Tensor:
    su0 = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - su0, u[..., 1] * su0], dim=-1)


def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / torch.clamp_min(nf * f_pdf + ng * g_pdf, 1e-20)


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
    z = vecmath.safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.cat([d, z[..., None]], dim=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI
