"""Reconstruction filters (port of pbrt_tpu/scene/film.py: box, triangle,
gaussian, mitchell and sinc; src/filters/).

pbrt splats each sample into every pixel within the filter radius and
divides by the summed weights. pbrt_tpu, and this port, importance-sample
the filter instead: each (pixel, sample) draws its film offset from the
normalized |f| and carries the weight f/p, so the pixel estimate is the
mean of w·L, with the same expectation and no scatter; the sign of f
carries the negative lobes of mitchell and sinc. The box filter's inverse
CDF is closed-form (offset = (2u−1)·r, weight 1). The other filters are
separable tables of 256 inverse-CDF offsets and weights per axis, built on
the host in float64 exactly as pbrt_tpu builds them and rounded to
float32, so both packages draw the same offsets and weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.ops import fastgather

BOX = 0
TRIANGLE = 1
GAUSSIAN = 2
MITCHELL = 3
SINC = 4

_FILTER_NAMES = {"box": BOX, "triangle": TRIANGLE, "gaussian": GAUSSIAN,
                 "mitchell": MITCHELL, "sinc": SINC}
_DEFAULT_RADIUS = {BOX: 0.5, TRIANGLE: 2.0, GAUSSIAN: 2.0, MITCHELL: 2.0,
                   SINC: 4.0}
_N_TAB = 256


def _filter_1d(ftype: int, x: np.ndarray, radius: float, extra: float
               ) -> np.ndarray:
    """The 1D factor of the separable filter at offsets x (float64)."""
    ax = np.abs(x)
    if ftype == BOX:
        return (ax <= radius).astype(np.float64)
    if ftype == TRIANGLE:
        return np.maximum(0.0, radius - ax)
    if ftype == GAUSSIAN:
        alpha = extra  # filters/gaussian.h: default 2
        return np.maximum(
            0.0, np.exp(-alpha * x * x) - np.exp(-alpha * radius * radius))
    if ftype == MITCHELL:
        b = c = 1.0 / 3.0
        t = np.abs(2.0 * x / radius)
        f = np.where(
            t > 1,
            ((-b - 6 * c) * t ** 3 + (6 * b + 30 * c) * t ** 2
             + (-12 * b - 48 * c) * t + (8 * b + 24 * c)) / 6.0,
            ((12 - 9 * b - 6 * c) * t ** 3 + (-18 + 12 * b + 6 * c) * t ** 2
             + (6 - 2 * b)) / 6.0)
        return np.where(t <= 2.0, f, 0.0)
    if ftype == SINC:
        tau = extra if extra > 0 else 3.0

        def sinc(v):
            return np.where(np.abs(v) < 1e-5, 1.0,
                            np.sin(np.pi * v) / (np.pi * v))
        return np.where(ax <= radius, sinc(x) * sinc(x / tau), 0.0)
    raise ValueError(ftype)


def _table(ftype: int, r: float, extra: float):
    """Inverse-CDF offsets of |f| at the 256 stratum centres and their
    weights f / (pdf · ∫f), float64 rounded to float32."""
    xs = np.linspace(-r, r, 4096)
    f = _filter_1d(ftype, xs, r, extra)
    p = np.abs(f)
    cdf = np.concatenate([[0.0], np.cumsum(p)])
    cdf /= cdf[-1]
    u = (np.arange(_N_TAB) + 0.5) / _N_TAB
    idx = np.clip(np.searchsorted(cdf, u) - 1, 0, len(xs) - 1)
    dx = xs[1] - xs[0]
    pdf = p[idx] / (p.sum() * dx)
    # E[w] then equals pbrt's Σ f·L / Σ f
    w = f[idx] / np.maximum(pdf * (f.sum() * dx), 1e-12)
    return xs[idx].astype(np.float32), w.astype(np.float32)


@dataclasses.dataclass
class Filter:
    radius: torch.Tensor         # (2,) xwidth, ywidth
    is_box: bool = True
    # tabulated filters: (256,) offsets and weights per axis (None: box)
    inv_cdf: torch.Tensor | None = None
    inv_cdf_y: torch.Tensor | None = None
    w_x: torch.Tensor | None = None
    w_y: torch.Tensor | None = None


def make_filter(name: str = "box", xwidth: float | None = None,
                ywidth: float | None = None, alpha: float = 2.0,
                tau: float = 3.0, device="cpu") -> Filter:
    if name not in _FILTER_NAMES:
        raise ValueError(f"unknown filter {name!r}")
    ftype = _FILTER_NAMES[name]
    rx = float(xwidth) if xwidth is not None else _DEFAULT_RADIUS[ftype]
    ry = float(ywidth) if ywidth is not None else _DEFAULT_RADIUS[ftype]
    radius = torch.tensor([rx, ry], dtype=torch.float32, device=device)
    if ftype == BOX:
        return Filter(radius=radius)
    extra = alpha if ftype == GAUSSIAN else tau
    (ix, wx), (iy, wy) = _table(ftype, rx, extra), _table(ftype, ry, extra)

    def t(a):
        return torch.as_tensor(a, device=device)

    return Filter(radius=radius, is_box=False, inv_cdf=t(ix),
                  inv_cdf_y=t(iy), w_x=t(wx), w_y=t(wy))


def sample_filter_offset(filt: Filter, u: torch.Tensor):
    """u: (R,2) uniforms → (offset (R,2) in pixels, weight (R,))."""
    if filt.is_box:
        off = (2.0 * u - 1.0) * filt.radius
        return off, torch.ones(u.shape[:-1], dtype=u.dtype, device=u.device)
    ix = (u[..., 0] * _N_TAB).to(torch.int32).clamp(0, _N_TAB - 1).long()
    iy = (u[..., 1] * _N_TAB).to(torch.int32).clamp(0, _N_TAB - 1).long()
    gx = fastgather.make_row_gather(_N_TAB, ix)
    gy = fastgather.make_row_gather(_N_TAB, iy)
    off = torch.stack([gx(filt.inv_cdf), gy(filt.inv_cdf_y)], dim=-1)
    return off, gx(filt.w_x) * gy(filt.w_y)


def splat(image: torch.Tensor, p_raster: torch.Tensor, value: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    """Film::AddSplat analogue (film.h:83-87): scatter-add ``value``
    (R, C) at the raster positions ``p_raster`` (R, 2) into a copy of
    ``image`` (H, W, C); lanes where ``valid`` is false add zero.

    One ``index_add_`` over the flattened pixels. On the card it sums
    with atomics in no fixed order, so two runs may differ in the last
    bits of a pixel that several lanes hit; sorting the lanes by pixel
    first would fix the order at the price of a sort of every pass's 2^21
    lanes, five times a chunk. The tests compare each lane's contribution
    exactly and the summed film within a stated tolerance."""
    h, w = image.shape[0], image.shape[1]
    xi = p_raster[..., 0].to(torch.int32).clamp(0, w - 1).long()
    yi = p_raster[..., 1].to(torch.int32).clamp(0, h - 1).long()
    value = torch.where(valid[..., None], value, 0.0)
    flat = image.reshape(h * w, -1).clone()
    flat.index_add_(0, yi * w + xi, value)
    return flat.reshape(image.shape)
