"""Tabulated BSSRDF tables and the device-side profile sampling (port of
pbrt_tpu/scene/bssrdf.py).

Counterpart of pbrt's BSSRDF machinery (core/bssrdf.{h,cpp}):

- **Host side, numpy** (a copy of pbrt_tpu's, so the tables are its bit
  for bit): the photon-beam-diffusion table ``compute_table``
  (ComputeBeamDiffusionBSSRDF, bssrdf.cpp:145-172) with its
  ``beam_diffusion_ms`` / ``beam_diffusion_ss`` integrands (:68-144), the
  Catmull–Rom helpers (interpolation.cpp:61-103, 260-330),
  ``subsurface_from_diffuse`` (kdsubsurface's inversion, :174-184),
  ``material_profiles`` (the ρ-axis interpolation of TabulatedBSSRDF,
  folded at build time into one radial profile and CDF per (material,
  channel)), ``disney_profiles`` (Burley's normalized diffusion in the
  same radial form) and ``build_scene_tables``.
- **Device side, torch**: ``sample_sr`` (Sample_Sr by inversion of the
  integrated spline, SampleCatmullRom2D's radius step, with pbrt_tpu's
  linear first guess and 8 Newton–bisection steps) and
  ``eval_profile_multi`` / ``eval_profile`` (the spline value at an
  optical radius, Sr / Pdf_Sr's inner sum). A lane's table row is read
  with an index gather; pbrt_tpu's one-hot products give the same
  values, and no matmul is involved (no TF32 on the card).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_tpu_torch.ops import fastgather
from pbrt_tpu_torch.scene import materials as mat_mod

N_RHO = 100        # BSSRDFTable(100, 64): materials/subsurface.cpp:137
N_RADIUS = 64


# ---------------------------------------------------------------------------
# host-side table build (numpy)
# ---------------------------------------------------------------------------

def fresnel_moment1(eta: float) -> float:
    """First Fresnel reflectance moment fit (bssrdf.cpp:43-53)."""
    e = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = e * e, e**3, e**4, e**5
    lo = (0.45966 - 1.73965 * e + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * e - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return float(np.where(e < 1, lo, hi))


def fresnel_moment2(eta: float) -> float:
    """Second Fresnel reflectance moment fit (bssrdf.cpp:54-66)."""
    e = np.asarray(eta, np.float64)
    e2, e3, e4, e5 = e * e, e**3, e**4, e**5
    lo = (0.27614 - 0.87350 * e + 1.12077 * e2 - 0.65095 * e3
          + 0.07883 * e4 + 0.04860 * e5)
    r = 1.0 / np.maximum(e, 1e-9)
    r2, r3 = r * r, r**3
    hi = (-547.033 + 45.3087 * r3 - 218.725 * r2 + 458.843 * r
          + 404.557 * e - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
          + 0.63942 * e5)
    return float(np.where(e < 1, lo, hi))


def _fr_dielectric_np(cos_i, eta_i, eta_t):
    """Host FrDielectric (core/reflection.cpp:47-64)."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    swap = cos_i <= 0
    ei = np.where(swap, eta_t, eta_i)
    et = np.where(swap, eta_i, eta_t)
    ci = np.abs(cos_i)
    s_i = np.sqrt(np.maximum(0.0, 1.0 - ci * ci))
    s_t = ei / et * s_i
    tir = s_t >= 1
    ct = np.sqrt(np.maximum(0.0, 1.0 - s_t * s_t))
    r_par = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
    r_per = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
    fr = 0.5 * (r_par * r_par + r_per * r_per)
    return np.where(tir, 1.0, fr)


def beam_diffusion_ms(rho, sigma_a_unit, g, eta, r):
    """Multiple-scattering beam-diffusion term Ed(r) (bssrdf.cpp:68-121):
    the classical dipole with Grosjean's diffusion coefficient and the
    extrapolated boundary, over 100 depth samples. rho / sigma_a_unit are
    unit-density coefficients (sigma_t = 1), broadcast with r."""
    n = 100
    rho = np.asarray(rho, np.float64)
    r = np.asarray(r, np.float64)
    sigma_s = rho
    sigma_a = sigma_a_unit
    sigmap_s = sigma_s * (1 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / np.maximum(sigmap_t, 1e-12)
    d_g = (2 * sigma_a + sigmap_s) / (3 * sigmap_t * sigmap_t)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1, fm2 = fresnel_moment1(eta), fresnel_moment2(eta)
    ze = -2 * d_g * (1 + 3 * fm2) / (1 - 2 * fm1)
    c_phi = 0.25 * (1 - 2 * fm1)
    c_e = 0.5 * (1 - 3 * fm2)
    i = (np.arange(n) + 0.5) / n
    # depth samples, exponential in sigmap_t (importance samples the beam)
    zr = -np.log(1 - i)[..., :] / sigmap_t[..., None]
    rr = r[..., None]
    zv = -zr + 2 * ze[..., None]
    dr = np.sqrt(rr * rr + zr * zr)
    dv = np.sqrt(rr * rr + zv * zv)
    st = sigma_tr[..., None]
    inv4pi = 1.0 / (4 * np.pi)
    phi_d = inv4pi / d_g[..., None] * (np.exp(-st * dr) / dr
                                       - np.exp(-st * dv) / dv)
    edn = inv4pi * (zr * (1 + st * dr) * np.exp(-st * dr) / dr**3
                    - zv * (1 + st * dv) * np.exp(-st * dv) / dv**3)
    e = phi_d * c_phi + edn * c_e
    kappa = 1 - np.exp(-2 * sigmap_t[..., None] * (dr + zr))
    return (kappa * (rhop * rhop)[..., None] * e).mean(-1)


def beam_diffusion_ss(rho, sigma_a_unit, g, eta, r):
    """Single-scattering term Ess(r) (bssrdf.cpp:122-144)."""
    n = 100
    rho = np.asarray(rho, np.float64)
    r = np.asarray(r, np.float64)
    sigma_t = np.asarray(rho + sigma_a_unit)  # = 1 by construction
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    i = (np.arange(n) + 0.5) / n
    ti = t_crit[..., None] - np.log(1 - i) / sigma_t[..., None]
    rr = r[..., None]
    d = np.sqrt(rr * rr + ti * ti)
    cos_o = ti / d
    # Henyey–Greenstein phase (core/medium.h PhaseHG)
    denom = 1 + g * g + 2 * g * cos_o
    phase = (1 - g * g) / (4 * np.pi * denom * np.sqrt(
        np.maximum(denom, 1e-12)))
    fr = _fr_dielectric_np(-cos_o, 1.0, eta)
    ess = (rho[..., None] * np.exp(-sigma_t[..., None]
                                   * (d + t_crit[..., None]))
           / (d * d) * phase * (1 - fr) * np.abs(cos_o))
    return ess.mean(-1)


def _cr_weights_np(nodes, x):
    """CatmullRomWeights (interpolation.cpp:61-103), scalar host form.
    Returns (ok, offset, w[4])."""
    n = len(nodes)
    if not (nodes[0] <= x <= nodes[n - 1]):
        return False, 0, np.zeros(4)
    idx = int(np.searchsorted(nodes, x, side="right") - 1)
    idx = min(max(idx, 0), n - 2)
    x0, x1 = nodes[idx], nodes[idx + 1]
    t = (x - x0) / (x1 - x0)
    t2, t3 = t * t, t * t * t
    w = np.zeros(4)
    w[1] = 2 * t3 - 3 * t2 + 1
    w[2] = -2 * t3 + 3 * t2
    if idx > 0:
        w0 = (t3 - 2 * t2 + t) * (x1 - x0) / (x1 - nodes[idx - 1])
        w[0] = -w0
        w[2] += w0
    else:
        w0 = t3 - 2 * t2 + t
        w[1] -= w0
        w[2] += w0
    if idx + 2 < n:
        w3 = (t3 - t2) * (x1 - x0) / (nodes[idx + 2] - x0)
        w[1] -= w3
        w[3] = w3
    else:
        w3 = t3 - t2
        w[1] -= w3
        w[2] += w3
    return True, idx - 1, w


def integrate_catmull_rom(x, values):
    """IntegrateCatmullRom (interpolation.cpp:260-287): the spline's
    integral and running CDF, over the leading dims of ``values``
    (..., n)."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    n = x.shape[-1]
    cdf = np.zeros(v.shape, np.float64)
    s = 0.0
    for i in range(n - 1):
        x0, x1 = x[i], x[i + 1]
        f0, f1 = v[..., i], v[..., i + 1]
        width = x1 - x0
        if i > 0:
            d0 = width * (f1 - v[..., i - 1]) / (x1 - x[i - 1])
        else:
            d0 = f1 - f0
        if i + 2 < n:
            d1 = width * (v[..., i + 2] - f0) / (x[i + 2] - x0)
        else:
            d1 = f1 - f0
        s = s + ((d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
        cdf[..., i + 1] = s
    return cdf[..., -1], cdf


def invert_catmull_rom(x, values, u):
    """InvertCatmullRom (interpolation.cpp:288-330): the t with
    values(t) = u on the monotone spline, scalar host form."""
    x = np.asarray(x, np.float64)
    v = np.asarray(values, np.float64)
    n = len(x)
    if not u > v[0]:
        return float(x[0])
    if not u < v[n - 1]:
        return float(x[n - 1])
    i = int(np.searchsorted(v, u, side="right") - 1)
    i = min(max(i, 0), n - 2)
    x0, x1 = x[i], x[i + 1]
    f0, f1 = v[i], v[i + 1]
    width = x1 - x0
    d0 = width * (f1 - v[i - 1]) / (x1 - x[i - 1]) if i > 0 else f1 - f0
    d1 = width * (v[i + 2] - f0) / (x[i + 2] - x0) if i + 2 < n else f1 - f0
    a, b, t = 0.0, 1.0, 0.5
    for _ in range(32):
        if not (a < t < b):
            t = 0.5 * (a + b)
        t2, t3 = t * t, t * t * t
        fhat = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
                + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
        dfhat = ((6 * t2 - 6 * t) * f0 + (-6 * t2 + 6 * t) * f1
                 + (3 * t2 - 4 * t + 1) * d0 + (3 * t2 - 2 * t) * d1)
        if abs(fhat - u) < 1e-6 * max(abs(u), 1e-6) or b - a < 1e-6:
            break
        if fhat - u < 0:
            a = t
        else:
            b = t
        t -= (fhat - u) / dfhat if dfhat != 0 else 0.0
    return float(x0 + width * t)


_TABLE_CACHE: dict = {}


def _radius_grid():
    """The 64-sample geometric optical-radius grid shared by every
    tabulated profile (bssrdf.cpp:152-155)."""
    radius = np.zeros(N_RADIUS)
    radius[1] = 2.5e-3
    for i in range(2, N_RADIUS):
        radius[i] = radius[i - 1] * 1.2
    return radius


def compute_table(g: float, eta: float):
    """ComputeBeamDiffusionBSSRDF (bssrdf.cpp:145-172): a dict of rho
    (100,), radius (64,), profile (100,64), cdf (100,64) and rho_eff
    (100,), float64, cached by (g, eta)."""
    key = (round(float(g), 6), round(float(eta), 6))
    if key in _TABLE_CACHE:
        return _TABLE_CACHE[key]
    radius = _radius_grid()
    rho = (1 - np.exp(-8 * np.arange(N_RHO) / (N_RHO - 1))) \
        / (1 - np.exp(-8))
    rg = rho[:, None] * np.ones(N_RADIUS)[None, :]
    rr = np.ones(N_RHO)[:, None] * radius[None, :]
    prof = 2 * np.pi * rr * (
        beam_diffusion_ss(rg, 1 - rg, g, eta, rr)
        + beam_diffusion_ms(rg, 1 - rg, g, eta, rr))
    rho_eff, cdf = integrate_catmull_rom(radius, prof)
    out = dict(rho=rho, radius=radius, profile=prof, cdf=cdf,
               rho_eff=rho_eff)
    _TABLE_CACHE[key] = out
    return out


def subsurface_from_diffuse(kd, mfp, g: float, eta: float):
    """SubsurfaceFromDiffuse (bssrdf.cpp:174-184): per-channel
    (sigma_a, sigma_s) whose effective albedo is kd."""
    t = compute_table(g, eta)
    kd = np.atleast_1d(np.asarray(kd, np.float64))
    mfp = np.broadcast_to(np.atleast_1d(np.asarray(mfp, np.float64)),
                          kd.shape)
    sigma_s = np.zeros_like(kd)
    sigma_a = np.zeros_like(kd)
    for c in range(kd.shape[0]):
        rho = invert_catmull_rom(t["rho"], t["rho_eff"], kd[c])
        sigma_s[c] = rho / mfp[c]
        sigma_a[c] = (1 - rho) / mfp[c]
    return sigma_a, sigma_s


def material_profiles(sigma_a, sigma_s, g: float, eta: float):
    """The ρ-axis Catmull–Rom interpolation of TabulatedBSSRDF
    (bssrdf.cpp:198-231 'rhoWeights') folded into per-channel radial
    tables: profile (C, 64), cdf (C, 64) (unnormalized, cdf[..., -1] =
    rho_eff), rho_eff (C,), sigma_t (C,) and r_max (C,), the world radius
    of Sample_Sr(ch, 0.999) (bssrdf.cpp:373-378 rMax)."""
    t = compute_table(g, eta)
    sigma_a = np.atleast_1d(np.asarray(sigma_a, np.float64))
    sigma_s = np.atleast_1d(np.asarray(sigma_s, np.float64))
    sigma_t = sigma_a + sigma_s
    rho = np.where(sigma_t > 0, sigma_s / np.maximum(sigma_t, 1e-12), 0.0)
    C = rho.shape[0]
    prof = np.zeros((C, N_RADIUS))
    cdf = np.zeros((C, N_RADIUS))
    rho_eff = np.zeros(C)
    rmax = np.zeros(C)
    for c in range(C):
        ok, off, w = _cr_weights_np(t["rho"], rho[c])
        if not ok:
            continue
        for i in range(4):
            if w[i] == 0:
                continue
            j = min(max(off + i, 0), N_RHO - 1)
            prof[c] += w[i] * t["profile"][j]
            cdf[c] += w[i] * t["cdf"][j]
            rho_eff[c] += w[i] * t["rho_eff"][j]
        # a negative overshoot of the spline would break the CDF's
        # monotonicity
        prof[c] = np.maximum(prof[c], 0.0)
        if cdf[c, -1] > 0 and sigma_t[c] > 0:
            r_opt = invert_catmull_rom(t["radius"], cdf[c],
                                       0.999 * cdf[c, -1])
            rmax[c] = r_opt / sigma_t[c]
    return dict(profile=prof, cdf=cdf, rho_eff=rho_eff,
                sigma_t=sigma_t, r_max=rmax, radius=t["radius"])


def disney_profiles(sd):
    """DisneyBSSRDF radial tables (materials/disney.cpp:365-470).

    Burley's normalized diffusion Sr(r) = R·(e^{-r/d} + e^{-r/(3d)}) /
    (8π d r), d = 0.2·scatterdistance, is R times a normalized polar pdf.
    In optical units x = r/d the tabulated integrand 2π·r·Sr/R is
    (e^{-x} + e^{-x/3})/4, whose integral is 1, so these rows use the
    tabulated machinery (``sample_sr`` / ``eval_profile``) with rho_eff
    ≈ 1, and R = diffuseWeight·color multiplies in the subsurface
    transport. A channel of scatterdistance 0 gets sigma_t 0 (never
    sampled, no contribution)."""
    sd = np.atleast_1d(np.asarray(sd, np.float64))
    C = sd.shape[0]
    radius = _radius_grid()
    prof = np.zeros((C, N_RADIUS))
    cdf = np.zeros((C, N_RADIUS))
    rho_eff = np.zeros(C)
    sigma_t = np.zeros(C)
    rmax = np.zeros(C)
    shape = (np.exp(-radius) + np.exp(-radius / 3.0)) / 4.0
    total, cdf_row = integrate_catmull_rom(radius, shape[None, :])
    r_opt_999 = invert_catmull_rom(radius, cdf_row[0], 0.999 * total[0])
    for c in range(C):
        d = 0.2 * sd[c]
        if d <= 0:
            continue
        sigma_t[c] = 1.0 / d
        prof[c] = shape
        cdf[c] = cdf_row[0]
        rho_eff[c] = total[0]
        rmax[c] = r_opt_999 * d
    return dict(profile=prof, cdf=cdf, rho_eff=rho_eff,
                sigma_t=sigma_t, r_max=rmax, radius=radius)


# ---------------------------------------------------------------------------
# the scene's tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SSSTables:
    """Per-(material, channel) radial tables, flattened to rows
    mat·C + ch. Kept out of the MaterialTable, so gathering a lane's
    material never moves (R, C, 64) blocks."""
    radius: torch.Tensor      # (64,) the shared optical-radius grid
    profile: torch.Tensor     # (M*C, 64)
    cdf: torch.Tensor         # (M*C, 64) unnormalized; [..., -1] = rho_eff
    rho_eff: torch.Tensor     # (M*C,)
    sigma_t: torch.Tensor     # (M*C,)
    r_max: torch.Tensor       # (M*C,) world 0.999-quantile radius


def row_is_disney_sss(r: dict) -> bool:
    """A row that builds a DisneyBSSRDF: Disney, non-black
    scatterdistance, not thin (disney.cpp:506-527 takes the thin branch
    before the BSSRDF one)."""
    return (r.get("type") == mat_mod.DISNEY
            and float(np.max(np.asarray(r.get("scatter_d", 0.0)))) > 0
            and not r.get("thin", 0.0))


def row_has_sss(r: dict) -> bool:
    """A subsurface or kdsubsurface row, or a DisneyBSSRDF row."""
    return r.get("type") == mat_mod.SUBSURFACE or row_is_disney_sss(r)


def build_scene_tables(rows, n_channels: int, device="cpu"
                       ) -> SSSTables | None:
    """The scene's SSSTables from the builder's material rows (None when
    no row scatters below its surface): TabulatedBSSRDF rows (the
    SUBSURFACE type) and DisneyBSSRDF rows."""
    if not any(row_has_sss(r) for r in rows):
        return None
    m = len(rows)
    C = n_channels
    prof = np.zeros((m, C, N_RADIUS), np.float32)
    cdf = np.zeros((m, C, N_RADIUS), np.float32)
    rho_eff = np.zeros((m, C), np.float32)
    sigma_t = np.zeros((m, C), np.float32)
    r_max = np.zeros((m, C), np.float32)
    radius = _radius_grid()
    for i, r in enumerate(rows):
        if row_is_disney_sss(r):
            sd = np.broadcast_to(np.asarray(r.get("scatter_d", 0.0),
                                            np.float64), (C,))
            p = disney_profiles(sd)
        elif r.get("type") == mat_mod.SUBSURFACE:
            sa = np.broadcast_to(np.asarray(r.get("sss_sigma_a", 0.01),
                                            np.float64), (C,))
            ss = np.broadcast_to(np.asarray(r.get("sss_sigma_s", 1.0),
                                            np.float64), (C,))
            p = material_profiles(sa, ss, float(r.get("sss_g", 0.0)),
                                  float(r.get("eta", 1.33)))
        else:
            continue
        prof[i] = p["profile"]
        cdf[i] = p["cdf"]
        rho_eff[i] = p["rho_eff"]
        sigma_t[i] = p["sigma_t"]
        r_max[i] = p["r_max"]
        radius = p["radius"]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SSSTables(
        radius=t(radius), profile=t(prof.reshape(m * C, N_RADIUS)),
        cdf=t(cdf.reshape(m * C, N_RADIUS)), rho_eff=t(rho_eff.reshape(-1)),
        sigma_t=t(sigma_t.reshape(-1)), r_max=t(r_max.reshape(-1)))


# ---------------------------------------------------------------------------
# device side, over lanes
# ---------------------------------------------------------------------------

def _rows(tables: SSSTables, row_id):
    """A lane's row index into the flattened tables, clipped into range
    as pbrt_tpu's row gathers clip it."""
    return row_id.long().clamp(0, tables.profile.shape[0] - 1)


def _segment_lookup(cdf_rows, u_abs):
    """FindInterval over the radius axis: the largest i with
    cdf[i] <= u, clamped to [0, n-2]."""
    n = cdf_rows.shape[-1]
    idx = (cdf_rows <= u_abs[:, None]).sum(-1) - 1
    return idx.clamp(0, n - 2)


def _row_taps(table, rid):
    """tap(idx) = table[rid, idx] per lane (pbrt_tpu's select_along_last
    of the lane's row), read from the flat table without gathering whole
    rows."""
    n = table.shape[-1]
    flat = table.reshape(-1)
    base = rid * n
    return lambda idx: fastgather.gather_rows(flat, base + idx)


def _spline_coeffs(x_grid, tap, idx):
    """The segment's endpoints and finite-difference derivatives of the
    Catmull–Rom interpolant (the d0 / d1 scheme of
    interpolation.cpp:105-170); ``tap(i)`` reads a lane's row at i."""
    n = x_grid.shape[-1]
    i1 = (idx + 1).clamp_max(n - 1)
    im1 = (idx - 1).clamp_min(0)
    ip2 = (idx + 2).clamp_max(n - 1)
    x0, x1 = x_grid[idx], x_grid[i1]
    xm1, xp2 = x_grid[im1], x_grid[ip2]
    f0, f1 = tap(idx), tap(i1)
    fm1, fp2 = tap(im1), tap(ip2)
    width = x1 - x0
    d0 = torch.where(idx > 0,
                     width * (f1 - fm1) / torch.clamp_min(x1 - xm1, 1e-20),
                     f1 - f0)
    d1 = torch.where(idx + 2 < n,
                     width * (fp2 - f0) / torch.clamp_min(xp2 - x0, 1e-20),
                     f1 - f0)
    return x0, x1, width, f0, f1, d0, d1


def sample_sr(tables: SSSTables, row_id, u):
    """TabulatedBSSRDF::Sample_Sr (bssrdf.cpp:355-362 →
    SampleCatmullRom2D, interpolation.cpp:172-258) over lanes: returns
    (r_world, valid), r_world −1 where not valid. ``row_id`` = mat·C +
    ch into the flattened tables."""
    rid = _rows(tables, row_id)
    g_row = fastgather.make_row_gather(tables.profile.shape[0], rid)
    cdf = g_row(tables.cdf)                          # (R, 64)
    s_t = g_row(tables.sigma_t)
    total = cdf[:, -1]
    valid = (s_t > 0) & (total > 0)
    u_abs = u * total
    idx = _segment_lookup(cdf, u_abs)
    x0, x1, width, f0, f1, d0, d1 = _spline_coeffs(
        tables.radius, _row_taps(tables.profile, rid), idx)
    cdf0 = fastgather.select_along_last(cdf, idx)
    up = (u_abs - cdf0) / torch.clamp_min(width, 1e-20)
    # the linear interpolant's inverse as the first guess, then 8 fixed
    # Newton–bisection steps (pbrt iterates to 1e-6; 8 reach it on this
    # smooth monotone integrand)
    disc = torch.clamp_min(f0 * f0 + 2.0 * up * (f1 - f0), 0.0)
    t = torch.where((f0 - f1).abs() > 1e-20,
                    (f0 - torch.sqrt(disc)) / (f0 - f1),
                    up / torch.clamp_min(f0, 1e-20))
    a = torch.zeros_like(t)
    b = torch.ones_like(t)
    for _ in range(8):
        t = torch.where((t >= a) & (t <= b), t, 0.5 * (a + b))
        fhat_i = t * (f0 + t * (0.5 * d0 + t * (
            (1.0 / 3.0) * (-2 * d0 - d1) + f1 - f0
            + t * (0.25 * (d0 + d1) + 0.5 * (f0 - f1)))))
        fhat = f0 + t * (d0 + t * (-2 * d0 - d1 + 3 * (f1 - f0)
                                   + t * (d0 + d1 + 2 * (f0 - f1))))
        below = fhat_i - up < 0
        a = torch.where(below, t, a)
        b = torch.where(below, b, t)
        t = t - (fhat_i - up) / torch.where(fhat.abs() > 1e-20, fhat, 1.0)
    t = t.clamp(0.0, 1.0)
    r_opt = x0 + width * t
    r_world = r_opt / torch.clamp_min(s_t, 1e-20)
    return torch.where(valid, r_world, -1.0), valid


def _profile_at(tables: SSSTables, tap, s_t, r_world):
    """sr_hat = profile(r_opt) / (2π r_opt) · sigma_t², ≥ 0, at the world
    radius r_world of each lane's row (``tap`` reads the row)."""
    r_opt = r_world * s_t
    grid = tables.radius
    n = grid.shape[-1]
    # the grid points ≤ r_opt (the grid increases strictly), none for NaN
    count = torch.searchsorted(grid, r_opt.contiguous(), right=True)
    count = torch.where(torch.isnan(r_opt), 0, count)
    idx = (count - 1).clamp(0, n - 2)
    x0, x1, width, f0, f1, d0, d1 = _spline_coeffs(grid, tap, idx)
    t = ((r_opt - x0) / torch.clamp_min(width, 1e-20)).clamp(0.0, 1.0)
    t2 = t * t
    t3 = t2 * t
    val = ((2 * t3 - 3 * t2 + 1) * f0 + (-2 * t3 + 3 * t2) * f1
           + (t3 - 2 * t2 + t) * d0 + (t3 - t2) * d1)
    in_range = (r_opt >= grid[0]) & (r_opt <= grid[-1])
    val = torch.where(in_range, torch.clamp_min(val, 0.0), 0.0)
    return val / torch.clamp_min(2.0 * math.pi * r_opt, 1e-12) * s_t * s_t


def eval_profile_multi(tables: SSSTables, row_id, radii):
    """``eval_profile`` at several world radii of one row per lane.
    Returns (list of sr_hat per radius, sigma_t, rho_eff)."""
    rid = _rows(tables, row_id)
    tap = _row_taps(tables.profile, rid)
    g_row = fastgather.make_row_gather(tables.profile.shape[0], rid)
    s_t = g_row(tables.sigma_t)
    return ([_profile_at(tables, tap, s_t, r) for r in radii], s_t,
            g_row(tables.rho_eff))


def eval_profile(tables: SSSTables, row_id, r_world):
    """The Catmull–Rom profile at a world radius (the inner sum of
    TabulatedBSSRDF::Sr / Pdf_Sr, bssrdf.cpp:198-231, 364-392) with the
    row's (sigma_t, rho_eff): (sr_hat, sigma_t, rho_eff), sr_hat =
    profile(r_opt) / (2π r_opt) · sigma_t² ≥ 0."""
    (sr,), s_t, rho_eff = eval_profile_multi(tables, row_id, [r_world])
    return sr, s_t, rho_eff
