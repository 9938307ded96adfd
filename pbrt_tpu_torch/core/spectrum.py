"""Spectra: RGB (3 channels) and sampled (60 bins over 400–700 nm), port
of pbrt_tpu/core/spectrum.py.

The channel count is data, as in pbrt_tpu: a spectrum is an array whose
last axis has 3 or 60 entries, and a ``SpectrumConfig`` names the mode.
The parser turns every spectrum-typed parameter ("rgb", "spectrum" pairs
or an on-disk SPD, "blackbody", "xyz") into linear RGB, host side in
numpy, and the scene builder lifts RGB to 60 bins with ``from_rgb`` for a
sampled scene. Tables: the 60 bin centres, the Wyman–Sloan–Shirley
Gaussian fits of the CIE matching functions, the sRGB (D65) matrix, the
(3,60) spectrum → RGB matrix and the smooth RGB → spectrum basis, built
in float64 and rounded to float32 where pbrt_tpu rounds them.

The hero-wavelength half (the fork's HWSS): ``index_from_wavelength``,
``zero_all_bins_but``, the spectral distribution and its wavelength
sampling (distr.h:85-112), and West et al.'s ``rotate_sample``, in torch.
The 60-term products (``spectrum_to_rgb``, ``spectrum_to_xyz``) sum as
pbrt_tpu's XLA CPU dot does, with no matmul, so a card's TF32 matmul
never touches them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from pbrt_tpu_torch.core.sampling import (Distribution1D, _take,
                                          make_distribution_1d,
                                          sample_distribution_1d_continuous)

# spectrum.h:48-51
LAMBDA_START = 400.0
LAMBDA_END = 700.0
LAMBDA_RANGE = LAMBDA_END - LAMBDA_START
N_SPECTRAL_SAMPLES = 60

# CIE Y integral over the visible range (radiometric → photometric)
CIE_Y_INTEGRAL = 106.856895


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    mode: str = "rgb"            # "rgb" | "sampled"

    @property
    def n_channels(self) -> int:
        return 3 if self.mode == "rgb" else N_SPECTRAL_SAMPLES


RGB = SpectrumConfig("rgb")
SAMPLED = SpectrumConfig("sampled")


def bin_centers() -> np.ndarray:
    i = np.arange(N_SPECTRAL_SAMPLES)
    return LAMBDA_START + (i + 0.5) * (LAMBDA_RANGE / N_SPECTRAL_SAMPLES)


def _pw_gauss(x, alpha, mu, s1, s2):
    """Piecewise Gaussian: sigma = s1 left of mu, s2 right of mu; in
    float64 numpy, or in the dtype of a torch tensor."""
    if isinstance(x, torch.Tensor):
        t = (x - mu) * torch.where(x < mu, 1.0 / s1, 1.0 / s2)
        return alpha * torch.exp(-0.5 * t * t)
    x = np.asarray(x, np.float64)
    t = (x - mu) * np.where(x < mu, 1.0 / s1, 1.0 / s2)
    return alpha * np.exp(-0.5 * t * t)


def cie_x(lam):
    return (_pw_gauss(lam, 1.056, 599.8, 37.9, 31.0)
            + _pw_gauss(lam, 0.362, 442.0, 16.0, 26.7)
            + _pw_gauss(lam, -0.065, 501.1, 20.4, 26.2))


def cie_y(lam):
    return (_pw_gauss(lam, 0.821, 568.8, 46.9, 40.5)
            + _pw_gauss(lam, 0.286, 530.9, 16.3, 31.1))


def cie_z(lam):
    return (_pw_gauss(lam, 1.217, 437.0, 11.8, 36.0)
            + _pw_gauss(lam, 0.681, 459.0, 26.0, 13.8))


def cie_xyz(lam):
    """(...,) wavelengths → (..., 3) CIE matching values (numpy or
    torch, as given)."""
    if isinstance(lam, torch.Tensor):
        return torch.stack([cie_x(lam), cie_y(lam), cie_z(lam)], dim=-1)
    return np.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)


# sRGB / Rec.709 primaries, D65 white (spectrum.cpp XYZToRGB)
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float64)
_RGB_TO_XYZ = np.linalg.inv(_XYZ_TO_RGB)


def xyz_to_rgb(xyz) -> np.ndarray:
    """(..., 3) XYZ → linear RGB, in float32 as pbrt_tpu computes it."""
    return (np.asarray(xyz, np.float32)
            @ _XYZ_TO_RGB.T.astype(np.float32))


def rgb_to_xyz(rgb):
    """(..., 3) linear RGB → XYZ in float32, summed term by term as
    pbrt_tpu's product (``_dot``, no matmul); numpy or torch, as given."""
    return _dot(rgb, _RGB_TO_XYZ.T.astype(np.float32), lanes=1)


@functools.lru_cache()
def _tables():
    """(bin centres (60,), spectrum → RGB (3,60), RGB → spectrum basis B
    (60,3)) in float32, built in float64 as pbrt_tpu builds them. B is
    the smoothest spectrum of each primary: it minimises the squared first
    differences subject to spectrum_to_rgb(B) = I (an exact round trip)."""
    lam = bin_centers()
    xyz = np.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)  # (60,3)
    dlam = LAMBDA_RANGE / N_SPECTRAL_SAMPLES
    spec_to_xyz = xyz.T * dlam / CIE_Y_INTEGRAL                    # (3,60)
    spec_to_rgb = _XYZ_TO_RGB @ spec_to_xyz                        # (3,60)
    n = N_SPECTRAL_SAMPLES
    D = (np.eye(n) - np.eye(n, k=1))[:-1]          # first differences
    K = np.linalg.inv(D.T @ D + 1e-4 * np.eye(n))  # smoothness kernel
    M = spec_to_rgb
    B = K @ M.T @ np.linalg.inv(M @ K @ M.T)       # (60,3), M @ B = I3
    return (lam.astype(np.float32), spec_to_rgb.astype(np.float32),
            B.astype(np.float32))


@functools.lru_cache()
def _xyz_table() -> np.ndarray:
    """(60,3) CIE matching values at the float32 bin centres, in float32
    arithmetic as pbrt_tpu evaluates them at run time."""
    lam = torch.as_tensor(_tables()[0])
    return torch.stack([cie_x(lam), cie_y(lam), cie_z(lam)], dim=-1).numpy()


def _dot(x, table: np.ndarray, lanes: int):
    """x (..., n) @ table (n, k) in float32, summed as XLA's CPU dot sums
    a product of this shape: ``lanes`` strided partial sums, each a chain
    of fused multiply-adds (emulated in float64, where the product of two
    float32 is exact), added pairwise at the end: 4 lanes for the 60-term
    products, 1 for the 3-term one. Bit-equal to pbrt_tpu's products on
    the CPU, and free of any matmul, so a card's TF32 never applies.
    numpy in, numpy out; torch in, torch out."""
    if isinstance(x, torch.Tensor):
        x64 = x.to(torch.float64)
        t64 = torch.as_tensor(table, dtype=torch.float64, device=x.device)
        acc = [torch.zeros(x.shape[:-1] + t64.shape[-1:], device=x.device)
               for _ in range(lanes)]
        for i in range(t64.shape[0]):
            acc[i % lanes] = (x64[..., i:i + 1] * t64[i] + acc[
                i % lanes].to(torch.float64)).to(torch.float32)
    else:
        x64 = np.asarray(x, np.float32).astype(np.float64)
        t64 = np.asarray(table, np.float64)
        acc = [np.zeros(x64.shape[:-1] + t64.shape[-1:], np.float32)
               for _ in range(lanes)]
        for i in range(t64.shape[0]):
            acc[i % lanes] = (x64[..., i:i + 1] * t64[i]
                              + acc[i % lanes]).astype(np.float32)
    while len(acc) > 1:
        acc = [acc[j] + acc[j + 1] for j in range(0, len(acc), 2)]
    return acc[0]


def spectrum_to_rgb(spec):
    """(..., 60) sampled spectrum → (..., 3) linear RGB in float32."""
    return _dot(spec, _tables()[1].T, lanes=4)


def spectrum_to_xyz(spec):
    """(..., 60) → (..., 3) CIE XYZ in float32."""
    return _dot(spec, _xyz_table(), lanes=4) * (
        (LAMBDA_RANGE / N_SPECTRAL_SAMPLES) / CIE_Y_INTEGRAL)


def rgb_to_spectrum(rgb):
    """(..., 3) linear RGB → (..., 60) smooth spectrum (an exact round
    trip), in float32 as pbrt_tpu computes it."""
    return _dot(rgb, _tables()[2].T, lanes=1)


def to_rgb(spec, cfg: SpectrumConfig):
    return spec if cfg.mode == "rgb" else spectrum_to_rgb(spec)


def from_rgb(rgb, cfg: SpectrumConfig):
    return rgb if cfg.mode == "rgb" else rgb_to_spectrum(rgb)


def luminance(spec, cfg: SpectrumConfig = RGB):
    """Spectrum::y() (photometric luminance) of torch spectra."""
    if cfg.mode == "rgb":
        w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=spec.dtype,
                         device=spec.device)
        return spec @ w
    return spectrum_to_xyz(spec)[..., 1]


def spd_from_pairs(lambdas, values, cfg: SpectrumConfig = RGB) -> np.ndarray:
    """Piecewise-linear SPD given as (λ, v) pairs → the spectrum of cfg's
    shape: the 60 bins sampled at their centres, or linear RGB (float64
    integration over the 60 bins, rounded to float32 at the end)."""
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    lam = bin_centers()
    samp = np.interp(lam, lambdas, values)
    if cfg.mode == "sampled":
        return samp.astype(np.float32)
    xyz = np.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)
    dlam = LAMBDA_RANGE / N_SPECTRAL_SAMPLES
    XYZ = (samp[:, None] * xyz).sum(0) * dlam / CIE_Y_INTEGRAL
    return (_XYZ_TO_RGB @ XYZ).astype(np.float32)


def blackbody(lambda_nm, temperature):
    """Planck's law, W/(m^2 sr nm) up to scale (spectrum.cpp Blackbody),
    in float64."""
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    l_m = np.asarray(lambda_nm, np.float64) * 1e-9
    return (2.0 * h * c * c) / (
        l_m ** 5 * (np.exp(h * c / (l_m * kb * temperature)) - 1.0))


def blackbody_normalized(lambda_nm, temperature):
    l_max = 2.8977721e-3 / temperature * 1e9
    return blackbody(lambda_nm, temperature) / blackbody(l_max, temperature)


# ---------------------------------------------------------------------------
# HWSS support (the fork): bin indexing, wavelength sampling
# (spectrum.h:282-294, distr.h:85-112, hero.cpp:46-48)
# ---------------------------------------------------------------------------

def index_from_wavelength(wvl: torch.Tensor) -> torch.Tensor:
    """spectrum.h:291-294 indexFromWavelength: the float32 bin position,
    truncated toward zero, clipped into [0, 59]."""
    idx = ((wvl - LAMBDA_START)
           * (N_SPECTRAL_SAMPLES / LAMBDA_RANGE)).to(torch.int32)
    return torch.clamp(idx, 0, N_SPECTRAL_SAMPLES - 1)


def zero_all_bins_but(spec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """spectrum.h:287-289 zeroAllBinsBut, batched over leading dims."""
    chan = torch.arange(spec.shape[-1], device=spec.device)
    return torch.where(chan == idx[..., None], spec, 0.0)


def make_spectral_distribution(spec: torch.Tensor) -> Distribution1D:
    """distr.h SpectralDistribution: the CDF over the 60 bins of spec."""
    return make_distribution_1d(torch.clamp_min(spec, 0.0))


def spectral_distribution_pmf(d: Distribution1D, idx: torch.Tensor
                              ) -> torch.Tensor:
    """The discrete probability of bin idx, func[idx] / (func_int · n);
    uniform, 1/n, when the function integrates to 0."""
    func_int = torch.where(d.func_int > 0, d.func_int, 1.0)
    pmf = _take(d.func, idx) / (func_int * d.n)
    return torch.where(d.func_int > 0, pmf, 1.0 / d.n)


def sample_wavelength(d: Distribution1D, u: torch.Tensor):
    """distr.h:91-112 sampleWavelength: (λ in nm, the bin's discrete pdf)
    — the reference's Pdf is the bin probability (hero_path_mis.cpp uses
    spectralDistribution.Pdf(idx))."""
    x, _, off = sample_distribution_1d_continuous(d, u)
    return (LAMBDA_START + LAMBDA_RANGE * x,
            spectral_distribution_pmf(d, off))


def rotate_sample(u: torch.Tensor, i: int, n: int = 4) -> torch.Tensor:
    """West et al.'s rotation (hero.cpp:46-48): (u + i/n) mod 1 in float32;
    a sum that rounds to 1.0 wraps to 0."""
    return torch.remainder(u + i / n, 1.0)
