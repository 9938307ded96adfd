"""Hošek–Wilkie analytic spectral sky-dome + solar radiance model.

Port of pbrt_tpu/tools/hosek.py (numpy, with its own copy of
hosek_data.npz): a numpy re-implementation of the reference's
ext/ArHosekSkyModel.c evaluation path as used by `imgtool makesky`
(tools/imgtool.cpp:87-186): state cooking (quintic Bézier over cube-rooted solar elevation, linear
blends over turbidity and albedo — ArHosekSkyModel_CookConfiguration /
CookRadianceConfiguration, ArHosekSkyModel.c:147-290), the 9-coefficient
sky radiance formula (GetRadianceInternal, :291-305), and the direct
solar radiance with piecewise-polynomial elevation fits + 5th-order limb
darkening (arhosekskymodel_solar_radiance*, :658-760). Dataset in
hosek_data.npz (published Hošek–Wilkie 2012 supplementary constants;
written by pbrt_tpu/tools/gen_hosek_data.py from the reference's header).

Cold-path tool code: vectorized over direction arrays, double precision.
"""

from __future__ import annotations

import os

import numpy as np

_PIECES = 45
_ORDER = 4
_SOLAR_RADIUS = np.radians(0.51) / 2.0   # terrestrial sun


def _data():
    global _NPZ
    try:
        return _NPZ
    except NameError:
        _NPZ = np.load(os.path.join(os.path.dirname(__file__),
                                    "hosek_data.npz"))
        return _NPZ


def _bezier5(ctrl, x):
    """Quintic Bézier with 6 control points; ctrl (..., 6, 9|1)."""
    c = [ctrl[..., i, :] for i in range(6)]
    return ((1 - x) ** 5 * c[0]
            + 5 * (1 - x) ** 4 * x * c[1]
            + 10 * (1 - x) ** 3 * x ** 2 * c[2]
            + 10 * (1 - x) ** 2 * x ** 3 * c[3]
            + 5 * (1 - x) * x ** 4 * c[4]
            + x ** 5 * c[5])


def _cook(dataset_flat, n_coef, turbidity, albedo, elevation):
    """CookConfiguration / CookRadianceConfiguration for one band.
    dataset_flat: (2 * 10 * 6 * n_coef,)."""
    d = dataset_flat.reshape(2, 10, 6, n_coef)
    it = int(turbidity)
    tr = turbidity - it
    x = (elevation / (np.pi / 2.0)) ** (1.0 / 3.0)
    cfg = ((1 - albedo) * (1 - tr) * _bezier5(d[0, it - 1], x)
           + albedo * (1 - tr) * _bezier5(d[1, it - 1], x))
    if it < 10:
        cfg = cfg + ((1 - albedo) * tr * _bezier5(d[0, it], x)
                     + albedo * tr * _bezier5(d[1, it], x))
    return cfg


class HosekSkyModel:
    """Per-band cooked state (arhosekskymodelstate_alloc_init)."""

    def __init__(self, elevation: float, turbidity: float, albedo: float):
        dd = _data()
        self.elevation = float(elevation)
        self.turbidity = float(turbidity)
        self.albedo = float(albedo)
        self.configs = np.stack([
            _cook(dd["datasets"][wl], 9, turbidity, albedo, elevation)
            for wl in range(11)])                          # (11, 9)
        self.radiances = np.asarray([
            _cook(dd["datasets_rad"][wl], 1, turbidity, albedo,
                  elevation)[0] for wl in range(11)])       # (11,)
        self.solar = dd["solar_datasets"].reshape(11, 10, _PIECES, _ORDER)
        self.limb = dd["limb_darkening"]                    # (11, 6)

    def _radiance_internal(self, wl: int, theta, gamma):
        """GetRadianceInternal (ArHosekSkyModel.c:291-305)."""
        c = self.configs[wl]
        exp_m = np.exp(c[4] * gamma)
        cg = np.cos(gamma)
        ray_m = cg * cg
        mie_m = (1.0 + cg * cg) / np.power(
            1.0 + c[8] * c[8] - 2.0 * c[8] * cg, 1.5)
        zenith = np.sqrt(np.maximum(np.cos(theta), 0.0))
        return ((1.0 + c[0] * np.exp(c[1] / (np.cos(theta) + 0.01)))
                * (c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m
                   + c[7] * zenith))

    def _sky_band(self, wl: int, theta, gamma):
        return self._radiance_internal(wl, theta, gamma) \
            * self.radiances[wl]

    def _sr_internal(self, turb_i: int, wl: int, elevation):
        """Piecewise polynomial direct solar radiance
        (arhosekskymodel_sr_internal, :658-688)."""
        pos = np.minimum((np.cbrt(2.0 * elevation / np.pi)
                          * _PIECES).astype(int), 44)
        break_x = (pos / _PIECES) ** 3 * (np.pi * 0.5)
        x = elevation - break_x
        # coefs walked backwards from order*(pos+1)-1: res = sum x^i *
        # coefs[order*pos + (order-1-i)]
        coefs = self.solar[wl, turb_i]                       # (45, 4)
        c = coefs[pos]                                       # (..., 4)
        res = np.zeros_like(x, dtype=np.float64)
        x_exp = np.ones_like(x, dtype=np.float64)
        for i in range(_ORDER):
            res = res + x_exp * c[..., _ORDER - 1 - i]
            x_exp = x_exp * x
        return res

    def _solar_direct(self, wavelength: float, elevation, gamma):
        """solar_radiance_internal2 (:690-760): turbidity+wavelength
        bilinear of the elevation fit, times limb darkening."""
        sol_rad_sin = np.sin(_SOLAR_RADIUS)
        ar2 = 1.0 / (sol_rad_sin * sol_rad_sin)
        sin_g = np.sin(gamma)
        sc2 = np.maximum(1.0 - ar2 * sin_g * sin_g, 0.0)
        sample_cos = np.sqrt(sc2)
        on_disc = sample_cos > 0.0

        turb_low = int(self.turbidity) - 1
        turb_frac = self.turbidity - (turb_low + 1)
        if turb_low == 9:
            turb_low, turb_frac = 8, 1.0
        wl_low = int((wavelength - 320.0) / 40.0)
        wl_frac = np.fmod(wavelength, 40.0) / 40.0
        if wl_low == 10:
            wl_low, wl_frac = 9, 1.0

        def sr(t, w):
            return self._sr_internal(t, w, elevation)

        direct = ((1 - turb_frac) * ((1 - wl_frac) * sr(turb_low, wl_low)
                                     + wl_frac * sr(turb_low, wl_low + 1))
                  + turb_frac * ((1 - wl_frac) * sr(turb_low + 1, wl_low)
                                 + wl_frac * sr(turb_low + 1,
                                                wl_low + 1)))
        ld = ((1 - wl_frac) * self.limb[wl_low]
              + wl_frac * self.limb[min(wl_low + 1, 10)])
        dark = sum(ld[i] * sample_cos ** i for i in range(6))
        return np.where(on_disc, direct * dark, 0.0)

    def sky_radiance(self, theta, gamma, wavelength: float):
        """arhosekskymodel_radiance (:522-565): wavelength-lerped sky."""
        wl_low = int((wavelength - 320.0) / 40.0)
        if wl_low < 0 or wl_low >= 11:
            return np.zeros_like(np.asarray(theta, np.float64))
        interp = np.fmod((wavelength - 320.0) / 40.0, 1.0)
        val = (1.0 - interp) * self._sky_band(wl_low, theta, gamma)
        if interp >= 1e-6 and wl_low + 1 < 11:
            val = val + interp * self._sky_band(wl_low + 1, theta, gamma)
        return val

    def solar_radiance(self, theta, gamma, wavelength: float):
        """arhosekskymodel_solar_radiance: direct solar disc + in-
        scattered sky."""
        return (self._solar_direct(wavelength, np.pi / 2.0 - theta, gamma)
                + self.sky_radiance(theta, gamma, wavelength))


def makesky_image(elevation_rad: float, turbidity: float, albedo: float,
                  resolution: int) -> np.ndarray:
    """The reference's `imgtool makesky` dome (tools/imgtool.cpp:142-186):
    lat-long (res, 2*res, 3) RGB image, three wavelengths averaged per
    channel, rows past the horizon black."""
    lam = [630.0, 680.0, 710.0, 500.0, 530.0, 560.0, 460.0, 480.0, 490.0]
    states = [HosekSkyModel(elevation_rad, turbidity, albedo)
              for _ in range(9)]
    n_theta, n_phi = resolution, 2 * resolution
    img = np.zeros((n_theta, n_phi, 3), np.float64)
    sun = np.array([0.0, np.sin(elevation_rad), np.cos(elevation_rad)])
    t_idx = np.arange(n_theta)
    theta = (t_idx + 0.5) / n_theta * np.pi
    valid = theta <= np.pi / 2.0
    phi = (np.arange(n_phi) + 0.5) / n_phi * 2.0 * np.pi
    th, ph = np.meshgrid(theta[valid], phi, indexing="ij")
    v = np.stack([np.cos(ph) * np.sin(th), np.cos(th),
                  np.sin(ph) * np.sin(th)], axis=-1)
    gamma = np.arccos(np.clip(v @ sun, -1.0, 1.0))
    for c in range(9):
        val = states[c].solar_radiance(th, gamma, lam[c])
        img[valid, :, c // 3] += val / 3.0
    return img.astype(np.float32)
