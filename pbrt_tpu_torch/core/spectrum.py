"""Spectra for the scene parser: the RGB mode of pbrt_tpu/core/spectrum.py,
host side, in numpy.

The parser turns every spectrum-typed parameter ("rgb", "spectrum" pairs
or an on-disk SPD, "blackbody", "xyz") into linear RGB through these
helpers: the 60 bin centres over 400–700 nm, the Wyman–Sloan–Shirley
Gaussian fits of the CIE matching functions and the sRGB (D65) matrix.
Tables are built in float64 and rounded to float32 where pbrt_tpu rounds
them. The 60-bin sampled mode (hero-wavelength rendering) is not ported.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

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


def require_rgb(cfg: SpectrumConfig) -> None:
    if cfg.mode != "rgb":
        raise NotImplementedError(
            "spectral rendering (60-bin sampled spectra): ROADMAP queue 1 "
            "item 9")


def bin_centers() -> np.ndarray:
    i = np.arange(N_SPECTRAL_SAMPLES)
    return LAMBDA_START + (i + 0.5) * (LAMBDA_RANGE / N_SPECTRAL_SAMPLES)


def _pw_gauss(x, alpha, mu, s1, s2):
    """Piecewise Gaussian: sigma = s1 left of mu, s2 right of mu."""
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


# sRGB / Rec.709 primaries, D65 white (spectrum.cpp XYZToRGB)
_XYZ_TO_RGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], np.float64)


def xyz_to_rgb(xyz) -> np.ndarray:
    """(..., 3) XYZ → linear RGB, in float32 as pbrt_tpu computes it."""
    return (np.asarray(xyz, np.float32)
            @ _XYZ_TO_RGB.T.astype(np.float32))


@functools.lru_cache()
def _spec_to_rgb() -> np.ndarray:
    lam = bin_centers()
    xyz = np.stack([cie_x(lam), cie_y(lam), cie_z(lam)], axis=-1)  # (60,3)
    dlam = LAMBDA_RANGE / N_SPECTRAL_SAMPLES
    return (_XYZ_TO_RGB @ (xyz.T * dlam / CIE_Y_INTEGRAL)).astype(
        np.float32)                                                # (3,60)


def spectrum_to_rgb(spec) -> np.ndarray:
    """(..., 60) sampled spectrum → (..., 3) linear RGB, in float32 (the
    float32 table pbrt_tpu uses)."""
    return np.asarray(spec, np.float32) @ _spec_to_rgb().T


def spd_from_pairs(lambdas, values, cfg: SpectrumConfig = RGB) -> np.ndarray:
    """Piecewise-linear SPD given as (λ, v) pairs → linear RGB (float64
    integration over the 60 bins, rounded to float32 at the end)."""
    require_rgb(cfg)
    lambdas = np.asarray(lambdas, np.float64)
    values = np.asarray(values, np.float64)
    order = np.argsort(lambdas)
    lambdas, values = lambdas[order], values[order]
    lam = bin_centers()
    samp = np.interp(lam, lambdas, values)
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
