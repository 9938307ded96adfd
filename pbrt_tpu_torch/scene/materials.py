"""Material table and BSDF evaluation (port of pbrt_tpu/scene/materials.py).

Rows of an SoA table, gathered per shading point; ``bsdf_f``,
``bsdf_pdf`` and ``bsdf_sample`` evaluate every family present in the
table on the gathered rows and select by type, in the local shading frame
(z = shading normal), with pbrt_tpu's lobe flags and estimator
convention: a delta lobe returns ``f`` already divided by ``|cos|`` with
``pdf`` its discrete probability, so the caller always computes
``beta *= f·|cos|/pdf``.

Types (MakeMaterial, core/api.cpp:497-583): MATTE (Lambert / Oren–Nayar),
MIRROR, GLASS (smooth, or rough when ``roughness > 1e-3``), PLASTIC, METAL,
DISPERSIVE_GLASS (smooth glass at eta = B + C/λ²: the hero integrators
pass eta at their hero wavelength, ``cauchy_eta``; the others render it
at eta(0.55 µm)), UBER (plastic's
lobes), SUBSTRATE (FresnelBlend), TRANSLUCENT, DISNEY (thin and solid,
with transmission), HAIR (scene/hair.py; its absorption in
``sss_sigma_a``, the fiber offset ``h`` from the caller) and FOURIER
(a measured table of the scene's, ``fourier_id``, scene/fourier.py,
sampled by a two-sided cosine lobe; black where the caller passes no
tables). Microfacet rows take Trowbridge–Reitz or, with
``ndf`` 1, Beckmann–Spizzichino. The BSSRDF families: a SUBSURFACE row
(subsurface, kdsubsurface) and a solid Disney row with scatterdistance
(whose diffuse lobe becomes the BSSRDF's entry) are turned by
integrators/common.py::subsurface_transport into MIRROR (the interface's
reflection) or SSS_EXIT (the exit lobe, SeparableBSSRDF's Sw) for the
bounce; the radial profiles live in scene/bssrdf.py. Textured sigma or
bump raise in ``check_row`` with their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec_mod
from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (INV_PI, concentric_sample_disk,
                                          cosine_sample_hemisphere)

# material type tags (pbrt_tpu's)
MATTE = 0
MIRROR = 1
GLASS = 2
PLASTIC = 3
METAL = 4
DISPERSIVE_GLASS = 5
UBER = 6
SUBSTRATE = 7
TRANSLUCENT = 8
NONE = 9
DISNEY = 10
SUBSURFACE = 11
HAIR = 12
FOURIER = 13
SSS_EXIT = 14

NDF_TR = 0
NDF_BECKMANN = 1

# lobe flags returned by bsdf_sample
FLAG_SPECULAR = 1
FLAG_TRANSMISSION = 2

# row keys and pbrt_tpu's defaults, as (default, per channel)
_DEFAULTS = {
    "kd": (0.5, True), "ks": (0.25, True), "kr": (1.0, True),
    "kt": (1.0, True), "eta": (1.5, False), "metal_eta": (0.2, True),
    "metal_k": (3.9, True), "roughness": (0.0, False),
    "sigma": (0.0, False), "cauchy_b": (1.5, False),
    "cauchy_c": (0.0, False), "metallic": (0.0, False),
    "spec_tint": (0.0, False), "sheen": (0.0, False),
    "sheen_tint": (0.5, False), "clearcoat": (0.0, False),
    "clearcoat_gloss": (1.0, False), "anisotropic": (0.0, False),
    "spec_trans": (0.0, False), "diff_trans": (1.0, False),
    "flatness": (0.0, False), "thin": (0.0, False),
    "sss_sigma_a": (0.01, True), "sss_sigma_s": (1.0, True),
    "scatter_d": (0.0, True), "beta_m": (0.3, False),
    "beta_n": (0.3, False), "hair_alpha": (2.0, False)}
# sss_g (the subsurface rows' HG asymmetry) is read by the BSSRDF table
# build (scene/bssrdf.py) and not carried in the table, as in pbrt_tpu
ROW_KEYS = frozenset(_DEFAULTS) | {"type", "ndf", "kd_tex", "sss_g",
                                   "fourier_id"}
_UNPORTED_KEYS = {"sigma_tex": 8, "bump_tex": 8}


@dataclasses.dataclass
class MaterialTable:
    """(M, ...) rows; C = spectrum channels. The static flags let the
    BSDF functions skip whole families, as pbrt_tpu skips tracing them."""
    mtype: torch.Tensor            # (M,) int32
    kd: torch.Tensor               # (M,C) diffuse reflectance
    ks: torch.Tensor               # (M,C) glossy reflectance
    kr: torch.Tensor               # (M,C) specular reflection scale
    kt: torch.Tensor               # (M,C) specular transmission scale
    eta: torch.Tensor              # (M,) dielectric IOR
    metal_eta: torch.Tensor        # (M,C) conductor eta
    metal_k: torch.Tensor          # (M,C) conductor absorption
    roughness: torch.Tensor        # (M,) microfacet roughness
    ndf: torch.Tensor              # (M,) int32: 0 TR, 1 Beckmann
    sigma: torch.Tensor            # (M,) Oren–Nayar sigma (degrees)
    cauchy_b: torch.Tensor         # (M,) dispersive glass B
    cauchy_c: torch.Tensor         # (M,) dispersive glass C (µm²)
    metallic: torch.Tensor         # (M,) the Disney parameters
    spec_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    anisotropic: torch.Tensor
    spec_trans: torch.Tensor
    diff_trans: torch.Tensor       # raw difftrans (halved at evaluation)
    flatness: torch.Tensor
    thin: torch.Tensor             # (M,) 0/1
    sss_sigma_a: torch.Tensor      # (M,C) subsurface absorption
    sss_sigma_s: torch.Tensor      # (M,C) subsurface scattering
    scatter_d: torch.Tensor        # (M,C) Disney scatterdistance
    beta_m: torch.Tensor           # (M,) hair: longitudinal roughness
    beta_n: torch.Tensor           # (M,) hair: azimuthal roughness
    hair_alpha: torch.Tensor       # (M,) hair: scale tilt (degrees)
    fourier_id: torch.Tensor       # (M,) int32 the scene's table (−1 none)
    kd_tex: torch.Tensor           # (M,) int32 texture row of kd (−1 none)
    has_beckmann: bool = False     # any Beckmann row?
    has_disney_trans: bool = False  # any Disney row with spectrans or thin?
    # any solid Disney row with non-black scatterdistance (the
    # DisneyBSSRDF's entry lobe and the subsurface transport)?
    has_disney_sss: bool = False
    has_hair: bool = False         # any HAIR row?
    has_fourier: bool = False      # any FOURIER row?
    present: tuple = ()            # sorted types present (empty: all)


def tensor_fields():
    """The table's per-row tensor fields (the rest are static flags)."""
    return [f.name for f in dataclasses.fields(MaterialTable)
            if f.type == "torch.Tensor"]


def check_row(row: dict) -> None:
    """Raise, naming the ROADMAP item, on what the port cannot build."""
    for k in sorted(set(row) - ROW_KEYS):
        raise NotImplementedError(
            f"material parameter {k!r}: ROADMAP queue 1 item "
            f"{_UNPORTED_KEYS.get(k, 8)}")


def make_material_table(rows: list[dict], n_channels: int,
                        device="cpu") -> MaterialTable:
    """Host-side builder from parameter dicts (pbrt_tpu's defaults)."""
    from pbrt_tpu_torch.scene.bssrdf import row_is_disney_sss
    for r in rows:
        check_row(r)
    disney_sss = any(row_is_disney_sss(r) for r in rows)

    def col(k):
        d, per_channel = _DEFAULTS[k]
        if per_channel:
            a = [np.broadcast_to(np.asarray(r.get(k, d), np.float32),
                                 (n_channels,)) for r in rows] \
                or [np.full(n_channels, d, np.float32)]
        else:
            a = [r.get(k, d) for r in rows] or [d]
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def i32(k, d):
        return torch.as_tensor(np.array([r.get(k, d) for r in rows] or [d],
                                        np.int32), device=device)

    return MaterialTable(
        mtype=i32("type", MATTE), ndf=i32("ndf", NDF_TR),
        kd_tex=i32("kd_tex", -1), fourier_id=i32("fourier_id", -1),
        **{k: col(k) for k in _DEFAULTS},
        has_beckmann=any(r.get("ndf") == NDF_BECKMANN for r in rows),
        has_disney_trans=any(
            r.get("type") == DISNEY
            and (r.get("spec_trans", 0.0) > 0 or r.get("thin", 0.0))
            for r in rows),
        has_disney_sss=disney_sss,
        has_hair=any(r.get("type") == HAIR for r in rows),
        has_fourier=any(r.get("type") == FOURIER for r in rows),
        present=_close_present({int(r.get("type", MATTE)) for r in rows}
                               or {MATTE}, disney_sss))


def _close_present(types: set, disney_sss: bool = False) -> tuple:
    """The present types, closed under the rewrites of the subsurface
    transport (integrators/common.py): a SUBSURFACE row becomes SSS_EXIT
    or MIRROR for the bounce, an entered DisneyBSSRDF row SSS_EXIT."""
    if SUBSURFACE in types:
        types = types | {MATTE, MIRROR, SSS_EXIT}
    if disney_sss:
        types = types | {MATTE, SSS_EXIT}
    return tuple(sorted(types))


def gather_materials(table: MaterialTable, mat_id: torch.Tensor
                     ) -> MaterialTable:
    """Per-ray material rows (mat_id: (R,), clipped into range)."""
    idx = mat_id.long().clamp(0, table.mtype.shape[0] - 1)
    return dataclasses.replace(table, **{
        k: vecmath.take(getattr(table, k), idx) for k in tensor_fields()})


def _present(mp: MaterialTable, *types: int) -> bool:
    """Can any of ``types`` occur in this table? (empty: unknown)"""
    if not mp.present:
        return True
    return any(t in mp.present for t in types)


def has_specular(mp: MaterialTable) -> bool:
    """Can a row of this table sample a delta lobe? (the static rule by
    which `whitted` and `direct` continue past the first bounce)"""
    return _present(mp, MIRROR, GLASS, DISPERSIVE_GLASS, NONE)


# ---------------------------------------------------------------------------
# local-frame helpers (reflection.h:47-124)
# ---------------------------------------------------------------------------

def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return w[..., 2].abs()


def same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0.0


def _z_up(like):
    return torch.tensor([0.0, 0.0, 1.0], device=like.device).expand(
        like.shape)


def roughness_to_alpha(rough):
    """TrowbridgeReitzDistribution::RoughnessToAlpha (microfacet.h:122)."""
    x = torch.log(torch.clamp_min(rough, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


# ---------------------------------------------------------------------------
# Fresnel (reflection.h:281-318)
# ---------------------------------------------------------------------------

def fr_dielectric(cos_theta_i, eta_i, eta_t):
    """Exact dielectric Fresnel (FrDielectric), both sides by the sign of
    cos_theta_i."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = ci > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = ci.abs()
    si = torch.sqrt(torch.clamp_min(1.0 - ci * ci, 1e-12))
    st = ei / et * si
    tir = st >= 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - st * st, 1e-12))
    r_par = (et * ci - ei * ct) / torch.clamp_min(et * ci + ei * ct, 1e-12)
    r_perp = (ei * ci - et * ct) / torch.clamp_min(ei * ci + et * ct, 1e-12)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def fr_conductor(cos_theta_i, eta, k):
    """Conductor Fresnel (FrConductor); eta, k: (..., C)."""
    ci = torch.clamp(cos_theta_i.abs(), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = vecmath.safe_sqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + ci2
    a = vecmath.safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-12)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


# ---------------------------------------------------------------------------
# Trowbridge–Reitz (GGX) distribution (core/microfacet.{h,cpp})
# ---------------------------------------------------------------------------

def tr_d(wh, alpha):
    c2 = wh[..., 2] ** 2
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    a2 = alpha * alpha
    e = c2 + s2 / torch.clamp_min(a2, 1e-12)
    denom = math.pi * a2 * e * e
    return torch.where(wh[..., 2] > 0, 1.0 / torch.clamp_min(denom, 1e-12),
                       0.0)


def tr_lambda(w, alpha):
    c = torch.clamp(w[..., 2].abs(), 1e-6, 1.0)
    tan2 = (1.0 - c * c) / (c * c)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def tr_g(wo, wi, alpha):
    return 1.0 / (1.0 + tr_lambda(wo, alpha) + tr_lambda(wi, alpha))


def tr_g1(w, alpha):
    return 1.0 / (1.0 + tr_lambda(w, alpha))


def tr_sample_wh_aniso(wo, u, ax, ay):
    """Anisotropic visible-normal sampling (Heitz 2018; the
    sampleVisibleArea path of TrowbridgeReitz::Sample_wh); the isotropic
    one when ax is ay."""
    sign = torch.sign(wo[..., 2:3] + 1e-20)
    v = sign * wo
    vh = vecmath.normalize(
        torch.stack([ax * v[..., 0], ay * v[..., 1], v[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = torch.where(
        (lensq > 1e-9)[..., None],
        torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)],
                    dim=-1)
        / torch.sqrt(torch.clamp_min(lensq, 1e-12))[..., None],
        torch.tensor([1.0, 0.0, 0.0], device=wo.device).expand(vh.shape))
    t2 = vecmath.cross(vh, t1)
    d = concentric_sample_disk(u)
    p1 = d[..., 0]
    p2_ = d[..., 1]
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * vecmath.safe_sqrt(1.0 - p1 * p1) \
        + s * p2_
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + vecmath.safe_sqrt(1.0 - p1 * p1 - p2 * p2)[
              ..., None] * vh)
    wh = vecmath.normalize(
        torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                     torch.clamp_min(nh[..., 2], 1e-6)], dim=-1))
    return sign * wh


def tr_sample_wh(wo, u, alpha):
    return tr_sample_wh_aniso(wo, u, alpha, alpha)


def tr_pdf_wh(wo, wh, alpha):
    """VNDF pdf: D(wh) G1(wo) |wo·wh| / |cos wo| (microfacet.h:157)."""
    return (tr_d(wh, alpha) * tr_g1(wo, alpha)
            * vecmath.dot(wo, wh).abs()
            / torch.clamp_min(abs_cos_theta(wo), 1e-6))


# anisotropic TR (microfacet.cpp:115-133), for the Disney rows

def tr_d_aniso(wh, ax, ay):
    e = (wh[..., 0] / ax) ** 2 + (wh[..., 1] / ay) ** 2 + wh[..., 2] ** 2
    denom = math.pi * ax * ay * e * e
    return torch.where(wh[..., 2] > 0, 1.0 / torch.clamp_min(denom, 1e-12),
                       0.0)


def tr_lambda_aniso(w, ax, ay):
    c = torch.clamp(w[..., 2].abs(), 1e-6, 1.0)
    s2 = torch.clamp_min(1.0 - c * c, 0.0)
    x2 = w[..., 0] ** 2
    y2 = w[..., 1] ** 2
    a2 = torch.where(s2 > 1e-12,
                     (x2 * ax * ax + y2 * ay * ay)
                     / torch.clamp_min(x2 + y2, 1e-12),
                     ax * ax)
    tan2 = s2 / (c * c)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + a2 * tan2))


def tr_g1_aniso(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda_aniso(w, ax, ay))


def tr_pdf_wh_aniso(wo, wh, ax, ay):
    whu = wh * torch.sign(wh[..., 2:3] + 1e-20)
    return (tr_d_aniso(whu, ax, ay) * tr_g1_aniso(wo, ax, ay)
            * vecmath.dot(wo, wh).abs()
            / torch.clamp_min(abs_cos_theta(wo), 1e-6))


# ---------------------------------------------------------------------------
# Beckmann–Spizzichino distribution (core/microfacet.h:48-105)
# ---------------------------------------------------------------------------

def beck_d(wh, alpha):
    c2 = wh[..., 2] ** 2
    s2 = torch.clamp_min(1.0 - c2, 0.0)
    tan2 = s2 / torch.clamp_min(c2, 1e-12)
    a2 = torch.clamp_min(alpha * alpha, 1e-12)
    d = torch.exp(-tan2 / a2) / (math.pi * a2
                                 * torch.clamp_min(c2 * c2, 1e-12))
    return torch.where(wh[..., 2] > 0, d, 0.0)


def beck_lambda(w, alpha):
    """Beckmann Λ, rational approximation (microfacet.cpp:89-97)."""
    c = torch.clamp(w[..., 2].abs(), 1e-6, 1.0)
    abs_tan = vecmath.safe_sqrt(1.0 - c * c) / c
    a = 1.0 / torch.clamp_min(alpha * abs_tan, 1e-9)
    lam = ((1.0 - 1.259 * a + 0.396 * a * a)
           / torch.clamp_min(3.535 * a + 2.181 * a * a, 1e-9))
    return torch.where(a >= 1.6, 0.0, lam)


def beck_g(wo, wi, alpha):
    return 1.0 / (1.0 + beck_lambda(wo, alpha) + beck_lambda(wi, alpha))


def beck_sample_wh_full(wo, u, alpha):
    """Full-distribution Beckmann sampling (microfacet.cpp Sample_wh, the
    !sampleVisibleArea branch: tan²θ = −α² ln(1 − u₁)), flipped into wo's
    hemisphere; its pdf is ``beck_pdf_wh_full``. The render samples the
    visible normals (``beck_sample_wh``): this one is for A/B variance."""
    u1 = torch.clamp_max(u[..., 0], 0.99999)
    tan2t = -alpha * alpha * torch.log1p(-u1)
    phi = 2.0 * math.pi * u[..., 1]
    cost = 1.0 / torch.sqrt(1.0 + tan2t)
    sint = vecmath.safe_sqrt(1.0 - cost * cost)
    wh = torch.stack([sint * torch.cos(phi), sint * torch.sin(phi), cost],
                     dim=-1)
    return wh * torch.sign(wo[..., 2:3] + 1e-20)


def beck_pdf_wh_full(wo, wh, alpha):
    """The full distribution's pdf D(wh)·|cos θh| (microfacet.cpp Pdf)."""
    return beck_d(wh, alpha) * abs_cos_theta(wh)


def beck_g1(w, alpha):
    return 1.0 / (1.0 + beck_lambda(w, alpha))


_SQRT_PI_INV = 0.5641895835477563  # 1/sqrt(pi)


def _beck_sample11(cos_ti, u1, u2):
    """Slope-space sampling of the visible Beckmann P22 (microfacet.cpp
    BeckmannSample11:39-118): ten guarded Newton/bisection steps of the
    erf-domain CDF inversion, the normal-incidence closed form merged.
    torch's erf / erfinv are not XLA's polynomials, so sampled directions
    differ from pbrt_tpu's in the last bits."""
    erf, erfinv = torch.special.erf, torch.special.erfinv
    sin_ti = vecmath.safe_sqrt(1.0 - cos_ti * cos_ti)
    cos_s = torch.clamp(cos_ti, 1e-6, 1.0)
    tan_ti = sin_ti / cos_s
    cot_ti = cos_s / torch.clamp_min(sin_ti, 1e-12)
    c_hi = erf(cot_ti)
    sx = torch.clamp_min(u1, 1e-6)
    theta_i = torch.acos(torch.clamp(cos_ti, -1.0, 1.0))
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    norm = 1.0 / (1.0 + c_hi + _SQRT_PI_INV * tan_ti
                  * torch.exp(-cot_ti * cot_ti))
    a = torch.full_like(c_hi, -1.0)
    c = c_hi
    b = c_hi - (1.0 + c_hi) * torch.pow(torch.clamp_min(1.0 - sx, 1e-12),
                                        fit)
    for _ in range(10):
        b = torch.where((b >= a) & (b <= c), b, 0.5 * (a + c))
        inv_erf = erfinv(torch.clamp(b, -0.999999, 0.999999))
        value = (norm * (1.0 + b + _SQRT_PI_INV * tan_ti
                         * torch.exp(-inv_erf * inv_erf)) - sx)
        deriv = norm * (1.0 - inv_erf * tan_ti)
        c = torch.where(value > 0, b, c)
        a = torch.where(value > 0, a, b)
        step = value / torch.where(deriv.abs() > 1e-12, deriv,
                                   torch.where(deriv >= 0, 1e-12, -1e-12))
        b = torch.where(value.abs() < 1e-5, b, b - step)
    slope_x = erfinv(torch.clamp(b, -0.999999, 0.999999))
    slope_y = erfinv(torch.clamp(2.0 * torch.clamp_min(u2, 1e-6) - 1.0,
                                 -0.999999, 0.999999))
    r = torch.sqrt(-torch.log1p(-torch.clamp_max(u1, 0.999999)))
    phi = 2.0 * math.pi * u2
    near_n = cos_ti > 0.9999
    slope_x = torch.where(near_n, r * torch.cos(phi), slope_x)
    slope_y = torch.where(near_n, r * torch.sin(phi), slope_y)
    return slope_x, slope_y


def beck_sample_wh(wo, u, alpha):
    """Visible-normal Beckmann sampling (microfacet.cpp
    BeckmannSample:120-140), flipped to wo's hemisphere."""
    flip = wo[..., 2:3] < 0
    wi = torch.where(flip, -wo, wo)
    wi_s = vecmath.normalize(
        torch.stack([alpha * wi[..., 0], alpha * wi[..., 1], wi[..., 2]],
                    dim=-1))
    sin_t = vecmath.safe_sqrt(1.0 - wi_s[..., 2] ** 2)
    cos_phi = torch.where(sin_t > 1e-9, wi_s[..., 0]
                          / torch.clamp_min(sin_t, 1e-12), 1.0)
    sin_phi = torch.where(sin_t > 1e-9, wi_s[..., 1]
                          / torch.clamp_min(sin_t, 1e-12), 0.0)
    sx, sy = _beck_sample11(wi_s[..., 2], u[..., 0], u[..., 1])
    tmp = cos_phi * sx - sin_phi * sy
    sy = sin_phi * sx + cos_phi * sy
    sx = alpha * tmp
    sy = alpha * sy
    wh = vecmath.normalize(torch.stack([-sx, -sy, torch.ones_like(sx)],
                                       dim=-1))
    return torch.where(flip, -wh, wh)


def beck_pdf_wh(wo, wh, alpha):
    return (beck_d(wh, alpha) * beck_g1(wo, alpha)
            * vecmath.dot(wo, wh).abs()
            / torch.clamp_min(abs_cos_theta(wo), 1e-6))


# NDF dispatch: ndf None → TR alone (a table without a Beckmann row)

def mf_d(wh, alpha, ndf=None):
    d = tr_d(wh, alpha)
    return d if ndf is None else torch.where(ndf == NDF_BECKMANN,
                                             beck_d(wh, alpha), d)


def mf_g(wo, wi, alpha, ndf=None):
    g = tr_g(wo, wi, alpha)
    return g if ndf is None else torch.where(ndf == NDF_BECKMANN,
                                             beck_g(wo, wi, alpha), g)


def mf_sample_wh(wo, u, alpha, ndf=None):
    wh = tr_sample_wh(wo, u, alpha)
    if ndf is None:
        return wh
    return torch.where((ndf == NDF_BECKMANN)[..., None],
                       beck_sample_wh(wo, u, alpha), wh)


def mf_pdf_wh(wo, wh, alpha, ndf=None):
    p = tr_pdf_wh(wo, wh, alpha)
    return p if ndf is None else torch.where(ndf == NDF_BECKMANN,
                                             beck_pdf_wh(wo, wh, alpha), p)


# ---------------------------------------------------------------------------
# lobes
# ---------------------------------------------------------------------------

def _oren_nayar_f(kd, sigma_deg, wo, wi):
    """OrenNayar::f (reflection.cpp:86+); sigma in degrees."""
    sigma = torch.deg2rad(sigma_deg)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_theta_i = vecmath.safe_sqrt(1.0 - wi[..., 2] ** 2)
    sin_theta_o = vecmath.safe_sqrt(1.0 - wo[..., 2] ** 2)
    denom_i = torch.clamp_min(sin_theta_i, 1e-6)
    denom_o = torch.clamp_min(sin_theta_o, 1e-6)
    cos_dphi = ((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
                / (denom_i * denom_o))
    max_cos = torch.where((sin_theta_i > 1e-4) & (sin_theta_o > 1e-4),
                          torch.clamp_min(cos_dphi, 0.0), 0.0)
    abs_ci = wi[..., 2].abs()
    abs_co = wo[..., 2].abs()
    sin_alpha = torch.where(abs_ci > abs_co, sin_theta_o, sin_theta_i)
    tan_beta = torch.where(abs_ci > abs_co,
                           sin_theta_i / torch.clamp_min(abs_ci, 1e-6),
                           sin_theta_o / torch.clamp_min(abs_co, 1e-6))
    return kd * (INV_PI * (A + B * max_cos * sin_alpha * tan_beta))[..., None]


def _upper(wh):
    """The half vector turned into the upper hemisphere (Faceforward(wh,
    (0, 0, 1))): pbrt's microfacet D is even in cos θh, and
    MicrofacetReflection takes the Fresnel term at wi·(this), so that a
    reflection under the surface (inside a dielectric) sees the inside's
    Fresnel, total internal reflection included. pbrt_tpu evaluates D and
    F at wh itself, where its D is 0 below the surface: it drops that
    reflection (ROADMAP queue 3)."""
    return wh * torch.sign(wh[..., 2:3] + 1e-20)


def _microfacet_reflection_f(Rs, alpha, fresnel, wo, wi, ndf=None):
    """MicrofacetReflection::f (reflection.cpp:303+); ``fresnel`` maps
    cos(wh·wi) → (..., C)."""
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh = wo + wi
    degenerate = (vecmath.length_squared(wh) < 1e-12) | (ci < 1e-6) \
        | (co < 1e-6)
    wh = _upper(vecmath.normalize(wh))
    F = fresnel(vecmath.dot(wi, wh))
    f = (Rs * (mf_d(wh, alpha, ndf) * mf_g(wo, wi, alpha, ndf))[..., None]
         * F / torch.clamp_min(4.0 * ci * co, 1e-6)[..., None])
    return torch.where(degenerate[..., None], 0.0, f)


def _microfacet_reflection_pdf(alpha, wo, wi, ndf=None):
    wh = _upper(vecmath.normalize(wo + wi))
    pdf = mf_pdf_wh(wo, wh, alpha, ndf) / torch.clamp_min(
        4.0 * vecmath.dot(wo, wh).abs(), 1e-6)
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def _transmission_half(wo, wi, eta, degenerate_cos=True):
    """The half vector of a refraction pair (reflection.cpp:338+): wh
    (upper hemisphere), wo·wh, wi·wh, eta_p, validity."""
    cos_o = cos_theta(wo)
    eta_p = torch.where(cos_o > 0.0, eta, 1.0 / eta)
    wh = wo + wi * eta_p[..., None]
    degenerate = vecmath.length_squared(wh) < 1e-12
    if degenerate_cos:
        degenerate = degenerate | ((cos_theta(wi) * cos_o).abs() < 1e-7)
    wh = vecmath.normalize(torch.where(degenerate[..., None], _z_up(wh), wh))
    return wh, eta_p, degenerate


def _microfacet_transmission_f(Kt, alpha, eta, wo, wi, ndf=None):
    """MicrofacetTransmission::f (reflection.cpp:338+), radiance mode;
    eta: (R,) with etaA = 1."""
    cos_o = cos_theta(wo)
    cos_i = cos_theta(wi)
    wh, eta_p, degenerate = _transmission_half(wo, wi, eta)
    wh = wh * torch.sign(wh[..., 2:3] + 1e-20)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    F = fr_dielectric(dot_o, torch.ones_like(eta), eta)
    sqrt_denom = dot_o + eta_p * dot_i
    factor = 1.0 / eta_p
    val = ((1.0 - F) * (
        mf_d(wh, alpha, ndf) * mf_g(wo, wi, alpha, ndf) * eta_p * eta_p
        * dot_i.abs() * dot_o.abs() * factor * factor
        / torch.clamp_min((cos_i * cos_o * sqrt_denom * sqrt_denom).abs(),
                          1e-10)).abs())
    return torch.where(valid[..., None], Kt * val[..., None], 0.0)


def _microfacet_transmission_pdf(alpha, eta, wo, wi, ndf=None):
    """MicrofacetTransmission::Pdf: VNDF pdf(wh) · |dwh/dwi|."""
    wh, eta_p, degenerate = _transmission_half(wo, wi, eta, False)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    whu = wh * torch.sign(wh[..., 2:3] + 1e-20)
    sqrt_denom = dot_o + eta_p * dot_i
    dwh_dwi = ((eta_p * eta_p * dot_i)
               / torch.clamp_min(sqrt_denom * sqrt_denom, 1e-10)).abs()
    return torch.where(valid, mf_pdf_wh(wo, whu, alpha, ndf) * dwh_dwi, 0.0)


def _pow5(x):
    return x * x * x * x * x


def _fresnel_moment1(eta):
    """First Fresnel reflectance moment (bssrdf.cpp:43-53) per lane."""
    e = eta
    e2 = e * e
    e3 = e2 * e
    e4 = e3 * e
    e5 = e4 * e
    lo = (0.45966 - 1.73965 * e + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * e - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(e < 1.0, lo, hi)


def _sss_exit_sw(mp, wi):
    """SeparableBSSRDF::Sw (core/bssrdf.h:89-92), the exit vertex's
    Fresnel-weighted lobe: (1 − Fr(cos θ_wi)) / (c·π), c = 1 −
    2·FresnelMoment1(1/η). Without the η² adjoint factor of
    SeparableBSSRDFAdapter::f: pbrt pairs it with the entry's 1/η², and
    the entry here is a probability branch with no η factor."""
    C = mp.kd.shape[-1]
    c_norm = 1.0 - 2.0 * _fresnel_moment1(1.0 / torch.clamp_min(mp.eta,
                                                                1e-3))
    fr = fr_dielectric(cos_theta(wi), torch.ones_like(mp.eta), mp.eta)
    sw = (1.0 - fr) / torch.clamp_min(c_norm * math.pi, 1e-6)
    return sw[..., None].expand(sw.shape + (C,))


# ---------------------------------------------------------------------------
# Disney (materials/disney.cpp)
# ---------------------------------------------------------------------------

def _disney_lum(c):
    """Spectrum::y() used for the Disney tint normalization
    (disney.cpp:494: `Float lum = c.y()`), of RGB or 60-bin colors."""
    return spec_mod.luminance(
        c, spec_mod.RGB if c.shape[-1] == 3 else spec_mod.SAMPLED)


def _disney_alphas(mp):
    """alpha = roughness² split by the anisotropy aspect (:541-545)."""
    aspect = torch.sqrt(1.0 - mp.anisotropic * 0.9)
    r2 = mp.roughness * mp.roughness
    return (torch.clamp_min(r2 / aspect, 0.001),
            torch.clamp_min(r2 * aspect, 0.001))


def _disney_trans_alphas(mp):
    """The transmission alphas: thin rows IOR-scale the roughness first
    (:573-578)."""
    ax, ay = _disney_alphas(mp)
    aspect = torch.sqrt(1.0 - mp.anisotropic * 0.9)
    rscaled = (0.65 * mp.eta - 0.35) * mp.roughness
    r2 = rscaled * rscaled
    thin = mp.thin > 0.5
    return (torch.where(thin, torch.clamp_min(r2 / aspect, 0.001), ax),
            torch.where(thin, torch.clamp_min(r2 * aspect, 0.001), ay))


def _gtr1(cos_h, alpha):
    """GTR1 NDF (disney.cpp:252-256)."""
    a2 = alpha * alpha
    return (a2 - 1.0) / torch.clamp_min(
        math.pi * torch.log(torch.clamp_min(a2, 1e-9))
        * (1.0 + (a2 - 1.0) * cos_h * cos_h), 1e-9)


def _smith_g_ggx(cos_t, alpha):
    """smithG_GGX (disney.cpp:259-264)."""
    a2 = alpha * alpha
    c2 = cos_t * cos_t
    return 1.0 / torch.clamp_min(cos_t + torch.sqrt(a2 + c2 - a2 * c2), 1e-6)


def _disney_cc_gloss(mp):
    return (1.0 - mp.clearcoat_gloss) * 0.1 + mp.clearcoat_gloss * 0.001


def _disney_sss_mask(mp):
    """Rows whose DisneyDiffuse lobe gives way to {SpecularTransmission
    entry + DisneyBSSRDF} (disney.cpp:506-527: not thin, diffuseWeight
    > 0, scatterdistance non-black)."""
    dw = (1.0 - mp.metallic) * (1.0 - mp.spec_trans)
    return ((mp.scatter_d.amax(dim=-1) > 0) & ~(mp.thin > 0.5) & (dw > 0))


def _disney_lobe_counts(mp):
    """The lobe census of DisneyMaterial::ComputeScatteringFunctions
    (disney.cpp:504-589): the four diffuse-family lobes fold into one
    cosine lobe of multiplicity k_diff. A scatterdistance row swaps
    DisneyDiffuse for the delta SpecularTransmission entry of the BSSRDF
    (:519-527): k_diff drops by one and n_entry = 1 joins the census
    (BSDF::Pdf's count includes it; the subsurface transport, not the
    direction sampler, samples it). Returns (k_diff, n_cc, n_mt, n_lt,
    n_total, n_entry), all (R,) float."""
    thin = mp.thin > 0.5
    dw = (1.0 - mp.metallic) * (1.0 - mp.spec_trans)
    k_diff = torch.where(
        dw > 0, torch.where(thin, 3.0, 2.0) + (mp.sheen > 0).float(), 0.0)
    n_entry = torch.zeros_like(k_diff)
    if mp.has_disney_sss:
        sss = _disney_sss_mask(mp)
        k_diff = torch.where(sss, k_diff - 1.0, k_diff)
        n_entry = sss.float()
    n_cc = (mp.clearcoat > 0).float()
    n_mt = (mp.spec_trans > 0).float()
    n_lt = thin.float()
    n = k_diff + 1.0 + n_cc + n_mt + n_lt + n_entry
    return k_diff, n_cc, n_mt, n_lt, n, n_entry


def _safe_half(wo, wi):
    wh = wo + wi
    wh_ok = vecmath.length_squared(wh) > 1e-12
    return vecmath.normalize(torch.where(wh_ok[..., None], wh,
                                         _z_up(wh))), wh_ok


def _disney_f_refl(mp, kd, wo, wi):
    """Reflection-side lobes (disney.cpp:92-363, wired per :504-564):
    Burley diffuse, fake subsurface, retro, sheen, anisotropic GGX with
    DisneyFresnel and GTR1 clearcoat."""
    c = torch.clamp_min(kd, 0.0)
    co = abs_cos_theta(wo)
    ci = abs_cos_theta(wi)
    wh, wh_ok = _safe_half(wo, wi)
    cos_d = vecmath.dot(wi, wh)

    lum = _disney_lum(c)
    tint = torch.where((lum > 0)[..., None],
                       c / torch.clamp_min(lum, 1e-6)[..., None], 1.0)
    dw = (1.0 - mp.metallic) * (1.0 - mp.spec_trans)
    dt = mp.diff_trans * 0.5
    thin = mp.thin > 0.5
    rough = mp.roughness

    fo = _pow5(1.0 - co)
    fi = _pow5(1.0 - ci)
    base_diff = c * (INV_PI * (1.0 - 0.5 * fo) * (1.0 - 0.5 * fi))[..., None]
    fss90 = cos_d * cos_d * rough
    fss = (1.0 + fo * (fss90 - 1.0)) * (1.0 + fi * (fss90 - 1.0))
    ss = 1.25 * (fss * (1.0 / torch.clamp_min(co + ci, 1e-6) - 0.5) + 0.5)
    fake_ss = c * (INV_PI * ss)[..., None]
    w_base = torch.where(thin, (1.0 - mp.flatness) * (1.0 - dt), 1.0)
    w_fake = torch.where(thin, mp.flatness * (1.0 - dt), 0.0)
    if mp.has_disney_sss:
        # a scatterdistance row has no DisneyDiffuse lobe: the BSSRDF
        # takes its place (:519-527); retro and sheen stay
        w_base = torch.where(_disney_sss_mask(mp), 0.0, w_base)
    rr = 2.0 * rough * cos_d * cos_d
    retro = c * (INV_PI * rr * (fo + fi + fo * fi * (rr - 1.0)))[..., None]
    csheen = (1.0 - mp.sheen_tint)[..., None] + mp.sheen_tint[..., None] \
        * tint
    sheen = mp.sheen[..., None] * csheen * _pow5(1.0 - cos_d.abs())[..., None]
    diffuse_part = dw[..., None] * (w_base[..., None] * base_diff
                                    + w_fake[..., None] * fake_ss
                                    + retro + sheen)

    ax, ay = _disney_alphas(mp)
    r0 = ((mp.eta - 1.0) / (mp.eta + 1.0)) ** 2
    cspec0 = ((1.0 - mp.metallic)[..., None]
              * r0[..., None] * ((1.0 - mp.spec_tint)[..., None]
                                 + mp.spec_tint[..., None] * tint)
              + mp.metallic[..., None] * c)
    # DisneyFresnel (disney.cpp:326-344) at the face-forwarded half vector
    wh_u = _upper(wh)
    cos_f = vecmath.dot(wi, wh_u)
    fr_d = fr_dielectric(cos_f, torch.ones_like(mp.eta), mp.eta)
    fr_schlick = cspec0 + (1.0 - cspec0) * _pow5(
        torch.clamp(1.0 - cos_f, 0.0, 1.0))[..., None]
    f_spec_fres = ((1.0 - mp.metallic)[..., None] * fr_d[..., None]
                   + mp.metallic[..., None] * fr_schlick)
    g_sep = tr_g1_aniso(wo, ax, ay) * tr_g1_aniso(wi, ax, ay)
    spec = (tr_d_aniso(wh_u, ax, ay) * g_sep
            / torch.clamp_min(4.0 * ci * co, 1e-6))[..., None] * f_spec_fres

    gloss = _disney_cc_gloss(mp)
    d_cc = _gtr1(wh[..., 2].abs(), gloss)
    f_cc = 0.04 + 0.96 * _pow5(1.0 - vecmath.dot(wo, wh).abs())
    g_cc = _smith_g_ggx(co, 0.25) * _smith_g_ggx(ci, 0.25)
    cc = (0.25 * mp.clearcoat * d_cc * f_cc * g_cc)[..., None]

    out = diffuse_part + spec + cc
    ok = same_hemisphere(wo, wi) & wh_ok
    return torch.where(ok[..., None], out, 0.0)


def _mt_f_aniso(T, ax, ay, eta, wo, wi, sep_g):
    """Anisotropic MicrofacetTransmission::f (reflection.cpp:279-304),
    radiance mode; ``sep_g`` selects Disney's separable G1·G1."""
    cos_o = cos_theta(wo)
    cos_i = cos_theta(wi)
    wh, eta_p, degenerate = _transmission_half(wo, wi, eta)
    wh = wh * torch.sign(wh[..., 2:3] + 1e-20)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    F = fr_dielectric(dot_o, torch.ones_like(eta), eta)
    sqrt_denom = dot_o + eta_p * dot_i
    factor = 1.0 / eta_p
    g_corr = 1.0 / (1.0 + tr_lambda_aniso(wo, ax, ay)
                    + tr_lambda_aniso(wi, ax, ay))
    g_sep = tr_g1_aniso(wo, ax, ay) * tr_g1_aniso(wi, ax, ay)
    G = torch.where(sep_g, g_sep, g_corr)
    val = ((1.0 - F) * (
        tr_d_aniso(wh, ax, ay) * G * eta_p * eta_p
        * dot_i.abs() * dot_o.abs() * factor * factor
        / torch.clamp_min((cos_i * cos_o * sqrt_denom * sqrt_denom).abs(),
                          1e-10)).abs())
    return torch.where(valid[..., None], T * val[..., None], 0.0)


def _mt_pdf_aniso(ax, ay, eta, wo, wi):
    """Anisotropic MicrofacetTransmission::Pdf (reflection.cpp:477-494)."""
    wh, eta_p, degenerate = _transmission_half(wo, wi, eta, False)
    dot_o = vecmath.dot(wo, wh)
    dot_i = vecmath.dot(wi, wh)
    valid = (dot_o * dot_i < 0.0) & ~same_hemisphere(wo, wi) & ~degenerate
    whu = wh * torch.sign(wh[..., 2:3] + 1e-20)
    sqrt_denom = dot_o + eta_p * dot_i
    dwh_dwi = ((eta_p * eta_p * dot_i)
               / torch.clamp_min(sqrt_denom * sqrt_denom, 1e-10)).abs()
    return torch.where(valid, tr_pdf_wh_aniso(wo, whu, ax, ay) * dwh_dwi,
                       0.0)


def _disney_f_trans(mp, kd, wo, wi):
    """Transmission-side lobes (disney.cpp:566-589): microfacet
    transmission T = strans·√c and, on thin rows, Lambertian
    transmission dt·c."""
    c = torch.clamp_min(kd, 0.0)
    T = mp.spec_trans[..., None] * torch.sqrt(c)
    axt, ayt = _disney_trans_alphas(mp)
    mt = _mt_f_aniso(T, axt, ayt, mp.eta, wo, wi, sep_g=~(mp.thin > 0.5))
    dt = mp.diff_trans * 0.5
    lt = (dt[..., None] * c) * INV_PI
    lt = torch.where((mp.thin > 0.5)[..., None], lt, 0.0)
    return torch.where(same_hemisphere(wo, wi)[..., None], 0.0, mt + lt)


def _disney_f(mp, kd, wo, wi):
    out = _disney_f_refl(mp, kd, wo, wi)
    if mp.has_disney_trans:
        out = out + _disney_f_trans(mp, kd, wo, wi)
    return out


def _disney_cc_pdf(mp, wo, wi):
    """DisneyClearcoat::Pdf (disney.cpp:307-320)."""
    wh, wh_ok = _safe_half(wo, wi)
    d_cc = _gtr1(wh[..., 2].abs(), _disney_cc_gloss(mp))
    pdf = d_cc * wh[..., 2].abs() \
        / torch.clamp_min(4.0 * vecmath.dot(wo, wh).abs(), 1e-6)
    return torch.where(same_hemisphere(wo, wi) & wh_ok, pdf, 0.0)


def _disney_pdf(mp, wo, wi):
    """BSDF::Pdf over the Disney lobes: the average of the lobes' pdfs
    (reflection.cpp:637-650), the diffuse family at multiplicity k_diff."""
    k_diff, n_cc, n_mt, n_lt, n, _ = _disney_lobe_counts(mp)
    refl = same_hemisphere(wo, wi)
    cos_pdf = abs_cos_theta(wi) * INV_PI
    ax, ay = _disney_alphas(mp)
    whn = vecmath.normalize(wo + wi)
    mf_pdf = torch.where(refl, tr_pdf_wh_aniso(wo, whn, ax, ay)
                         / torch.clamp_min(4.0 * vecmath.dot(wo, whn).abs(),
                                           1e-6), 0.0)
    mf_pdf = torch.where(vecmath.length_squared(wo + wi) > 1e-12, mf_pdf,
                         0.0)
    pdf = k_diff * torch.where(refl, cos_pdf, 0.0) + mf_pdf
    pdf = pdf + n_cc * _disney_cc_pdf(mp, wo, wi)
    if mp.has_disney_trans:
        axt, ayt = _disney_trans_alphas(mp)
        pdf = pdf + n_mt * _mt_pdf_aniso(axt, ayt, mp.eta, wo, wi)
        pdf = pdf + n_lt * torch.where(refl, 0.0, cos_pdf)
    return pdf / torch.clamp_min(n, 1.0)


# ---------------------------------------------------------------------------
# BSDF::f / Pdf / Sample_f
# ---------------------------------------------------------------------------

def _mat_alpha(mp):
    return torch.clamp_min(roughness_to_alpha(mp.roughness), 1e-4)


def _ndf(mp):
    return mp.ndf if mp.has_beckmann else None


def _dielectric_fresnel(eta, C):
    return lambda c: fr_dielectric(c, torch.ones_like(eta), eta)[
        ..., None].expand(c.shape + (C,))


def _hair_args(mp, wo, h):
    """The hair BSDF's per-lane arguments after (wo, ·): the fiber offset
    (0 where the caller passes none), the absorption and the shape."""
    hh = torch.zeros(wo.shape[:-1], device=wo.device) if h is None else h
    return (hh, mp.sss_sigma_a, mp.beta_m, mp.beta_n, mp.hair_alpha,
            mp.eta)


def bsdf_f(mp: MaterialTable, wo, wi, kd_override=None, h=None,
           fourier=None):
    """The non-delta part of the BSDF, f(wo, wi), (R,C) (BSDF::f,
    reflection.cpp:575+): each present family's non-specular lobes,
    selected by type. Mirror, smooth glass and dispersive glass are pure
    delta: f = 0. ``h`` (R,) is the hair rows' fiber offset (0 when None)
    and ``fourier`` the scene's Fourier tables (FOURIER rows are black
    when None)."""
    t = mp.mtype
    C = mp.kd.shape[-1]
    refl = same_hemisphere(wo, wi)
    kd = mp.kd if kd_override is None else kd_override
    out = torch.zeros(wo.shape[:-1] + (C,), device=wo.device)
    alpha = _mat_alpha(mp)
    ndf = _ndf(mp)
    fres_d = _dielectric_fresnel(mp.eta, C)

    if _present(mp, MATTE, PLASTIC, UBER):
        # matte: Lambert or Oren–Nayar (materials/matte.cpp:55-66)
        matte_f = torch.where((mp.sigma > 0.0)[..., None],
                              _oren_nayar_f(kd, mp.sigma, wo, wi),
                              kd * INV_PI)
        matte_f = torch.where(refl[..., None], matte_f, 0.0)
        if _present(mp, MATTE):
            out = torch.where((t == MATTE)[..., None], matte_f, out)
    if _present(mp, SSS_EXIT):
        sw = torch.where(refl[..., None], _sss_exit_sw(mp, wi), 0.0)
        out = torch.where((t == SSS_EXIT)[..., None], sw, out)
    if _present(mp, PLASTIC, UBER):
        # plastic: Lambert + microfacet with dielectric Fresnel; uber's
        # non-specular lobes coincide (materials/{plastic,uber}.cpp)
        plastic_f = matte_f + torch.where(
            refl[..., None], _microfacet_reflection_f(mp.ks, alpha, fres_d,
                                                      wo, wi, ndf=ndf), 0.0)
        out = torch.where(((t == PLASTIC) | (t == UBER))[..., None],
                          plastic_f, out)
    if _present(mp, METAL):
        fres_c = lambda c: fr_conductor(c, mp.metal_eta, mp.metal_k)
        metal_f = torch.where(refl[..., None], _microfacet_reflection_f(
            torch.ones_like(mp.ks), alpha, fres_c, wo, wi, ndf=ndf), 0.0)
        out = torch.where((t == METAL)[..., None], metal_f, out)
    if _present(mp, SUBSTRATE):
        # FresnelBlend (reflection.cpp:327+)
        rd, rs = kd, mp.ks
        diffuse = ((28.0 / (23.0 * math.pi)) * rd * (1.0 - rs)
                   * (1.0 - _pow5(1.0 - 0.5 * abs_cos_theta(wi)))[..., None]
                   * (1.0 - _pow5(1.0 - 0.5 * abs_cos_theta(wo)))[..., None])
        wh = wo + wi
        wh_ok = vecmath.length_squared(wh) > 1e-12
        whn = vecmath.normalize(wh)
        schlick = rs + _pow5(
            1.0 - vecmath.dot(wi, whn).abs())[..., None] * (1.0 - rs)
        spec = (mf_d(_upper(whn), alpha, ndf)
                / torch.clamp_min(4.0 * vecmath.dot(wi, whn).abs()
                                  * torch.maximum(abs_cos_theta(wi),
                                                  abs_cos_theta(wo)), 1e-6)
                )[..., None] * schlick
        substrate_f = torch.where((refl & wh_ok)[..., None], diffuse + spec,
                                  0.0)
        out = torch.where((t == SUBSTRATE)[..., None], substrate_f, out)
    if _present(mp, TRANSLUCENT):
        trans_f = torch.where(refl[..., None], kd * (0.5 * INV_PI),
                              mp.kt * (0.5 * INV_PI))
        out = torch.where((t == TRANSLUCENT)[..., None], trans_f, out)
    if _present(mp, GLASS):
        # rough glass: microfacet reflection + transmission
        # (materials/glass.cpp:58-76)
        rough_glass_f = torch.where(
            refl[..., None],
            _microfacet_reflection_f(mp.kr, alpha, fres_d, wo, wi, ndf=ndf),
            _microfacet_transmission_f(mp.kt, alpha, mp.eta, wo, wi,
                                       ndf=ndf))
        glass_rough = (t == GLASS) & (mp.roughness > 1e-3)
        out = torch.where(glass_rough[..., None], rough_glass_f, out)
    if _present(mp, DISNEY):
        out = torch.where((t == DISNEY)[..., None], _disney_f(mp, kd, wo, wi),
                          out)
    if mp.has_hair:
        from pbrt_tpu_torch.scene import hair as hair_mod
        hh, sa, bm, bn, al, eta = _hair_args(mp, wo, h)
        out = torch.where((t == HAIR)[..., None],
                          hair_mod.hair_f(wo, wi, hh, sa, bm, bn, al, eta),
                          out)
    if mp.has_fourier and fourier is not None:
        from pbrt_tpu_torch.scene import fourier as fourier_mod
        out = torch.where((t == FOURIER)[..., None],
                          fourier_mod.eval_fourier_set(
                              fourier, mp.fourier_id, wo, wi, C), out)
    return out


def bsdf_pdf(mp: MaterialTable, wo, wi, h=None, fourier=None):
    """Solid-angle pdf of bsdf_sample's non-delta lobes, (R,). A FOURIER
    row's is its two-sided cosine lobe's, whatever ``fourier`` is."""
    t = mp.mtype
    refl = same_hemisphere(wo, wi)
    cos_pdf = torch.where(refl, abs_cos_theta(wi) * INV_PI, 0.0)
    alpha = _mat_alpha(mp)
    ndf = _ndf(mp)
    out = torch.zeros(wo.shape[:-1], device=wo.device)
    if _present(mp, PLASTIC, UBER, SUBSTRATE, METAL, GLASS):
        mf_pdf = _microfacet_reflection_pdf(alpha, wo, wi, ndf=ndf)
    if _present(mp, MATTE):
        out = torch.where(t == MATTE, cos_pdf, out)
    if _present(mp, SSS_EXIT):
        out = torch.where(t == SSS_EXIT, cos_pdf, out)
    if _present(mp, PLASTIC, UBER, SUBSTRATE):
        out = torch.where((t == PLASTIC) | (t == UBER) | (t == SUBSTRATE),
                          0.5 * (cos_pdf + mf_pdf), out)
    if _present(mp, METAL):
        out = torch.where(t == METAL, mf_pdf, out)
    if _present(mp, TRANSLUCENT):
        out = torch.where(t == TRANSLUCENT,
                          0.5 * abs_cos_theta(wi) * INV_PI, out)
    if _present(mp, GLASS):
        # two matching lobes: BSDF::Pdf averages them (reflection.cpp:643+)
        glass_rough = (t == GLASS) & (mp.roughness > 1e-3)
        out = torch.where(glass_rough, 0.5 * (
            mf_pdf + _microfacet_transmission_pdf(alpha, mp.eta, wo, wi,
                                                  ndf=ndf)), out)
    if _present(mp, DISNEY):
        out = torch.where(t == DISNEY, _disney_pdf(mp, wo, wi), out)
    if mp.has_hair:
        from pbrt_tpu_torch.scene import hair as hair_mod
        hh, sa, bm, bn, al, eta = _hair_args(mp, wo, h)
        out = torch.where(t == HAIR,
                          hair_mod.hair_pdf(wo, wi, hh, sa, bm, bn, al, eta),
                          out)
    if mp.has_fourier:
        out = torch.where(t == FOURIER, 0.5 * abs_cos_theta(wi) * INV_PI,
                          out)
    return out


def _sel(pairs, default):
    out = default
    for cond, v in pairs:
        while cond.ndim < v.ndim:
            cond = cond[..., None]
        out = torch.where(cond, v, out)
    return out


def bsdf_sample(mp: MaterialTable, wo, u_lobe, u, kd_override=None,
                eta_override=None, h=None, fourier=None):
    """Sample wi ~ BSDF (BSDF::Sample_f, reflection.cpp:605+). Returns
    (wi, f, pdf, flags); the caller computes beta *= f·|cos(wi)|/pdf
    (a delta lobe's f is F/|cos|, its pdf the lobe's probability).
    Plastic, uber and substrate pick their lobe by u_lobe < 0.5 and reject
    a microfacet sample below the horizon; smooth glass reflects or
    refracts by Fresnel against u_lobe (total internal reflection
    reflects); rough glass picks reflection or transmission by
    u_lobe ≥ 0.5, and a failed refraction is a failed sample (pdf 0).
    ``eta_override`` (R,) replaces the dielectric index of the glass
    families (dispersive glass at the hero wavelength,
    materials/dispersive_glass.cpp:90-122). A HAIR row samples its lobes
    exactly (hair.cpp Sample_f) at the fiber offset ``h`` (0 when None);
    a FOURIER row reflects or transmits a cosine lobe by u_lobe < 0.5,
    its f from ``fourier`` (black when None)."""
    t = mp.mtype
    C = mp.kd.shape[-1]
    R = wo.shape[:-1]
    dev = wo.device
    eta_mat = mp.eta if eta_override is None else eta_override
    kd = mp.kd if kd_override is None else kd_override
    alpha = _mat_alpha(mp)
    ndf = _ndf(mp)
    need_mf = _present(mp, PLASTIC, UBER, SUBSTRATE, METAL, GLASS)
    need_glass = _present(mp, GLASS, DISPERSIVE_GLASS)

    # cosine lobe (matte and the diffuse half of plastic, uber, substrate)
    wi_cos = cosine_sample_hemisphere(u)
    wi_cos = wi_cos * torch.sign(wo[..., 2:3] + 1e-20)
    if need_mf:
        wh = mf_sample_wh(wo, u, alpha, ndf)
        wi_mf = vecmath.reflect(wo, wh)
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    if need_glass:
        F = fr_dielectric(cos_theta(wo), torch.ones_like(eta_mat), eta_mat)
        entering = cos_theta(wo) > 0.0
        eta_ratio = torch.where(entering, 1.0 / eta_mat, eta_mat)
        n_loc = torch.where(entering[..., None], _z_up(wo), -_z_up(wo))
        wi_refr, refr_ok = vecmath.refract(wo, n_loc, eta_ratio)
        choose_refl = (u_lobe < F) | ~refr_ok
        wi_glass = torch.where(choose_refl[..., None], wi_mirror, wi_refr)

    pdf_matte = abs_cos_theta(wi_cos) * INV_PI
    rows = []       # (cond, wi, f, pdf)
    if _present(mp, MATTE):
        rows.append((t == MATTE, wi_cos, bsdf_f(mp, wo, wi_cos, kd),
                     pdf_matte))
    if _present(mp, SSS_EXIT):
        rows.append((t == SSS_EXIT, wi_cos,
                     torch.where(same_hemisphere(wo, wi_cos)[..., None],
                                 _sss_exit_sw(mp, wi_cos), 0.0),
                     pdf_matte))
    if _present(mp, PLASTIC, UBER, SUBSTRATE):
        wi_pl = torch.where((u_lobe >= 0.5)[..., None], wi_mf, wi_cos)
        pl_ok = same_hemisphere(wo, wi_pl)
        f_pl = bsdf_f(mp, wo, wi_pl, kd)
        pdf_pl = 0.5 * (abs_cos_theta(wi_pl) * INV_PI
                        + _microfacet_reflection_pdf(alpha, wo, wi_pl,
                                                     ndf=ndf))
        rows.append(((t == PLASTIC) | (t == UBER) | (t == SUBSTRATE), wi_pl,
                     torch.where(pl_ok[..., None], f_pl, 0.0),
                     torch.where(pl_ok, pdf_pl, 0.0)))
    if _present(mp, METAL):
        metal_ok = same_hemisphere(wo, wi_mf)
        f_metal = bsdf_f(mp, wo, wi_mf, kd)
        pdf_metal = _microfacet_reflection_pdf(alpha, wo, wi_mf, ndf=ndf)
        rows.append((t == METAL, wi_mf,
                     torch.where(metal_ok[..., None], f_metal, 0.0),
                     torch.where(metal_ok, pdf_metal, 0.0)))
    glass_rough = (t == GLASS) & (mp.roughness > 1e-3)
    if _present(mp, GLASS):
        # rough glass: reflection or transmission about the sampled wh
        wh_o = wh * torch.sign(vecmath.dot(wh, wo))[..., None]
        wi_rgt, rgt_ok = vecmath.refract(wo, wh_o, eta_ratio)
        pick_rg_trans = u_lobe >= 0.5
        wi_rg = torch.where(pick_rg_trans[..., None], wi_rgt, wi_mf)
        rg_refl = same_hemisphere(wo, wi_rg)
        rg_ok = torch.where(pick_rg_trans, rgt_ok & ~rg_refl, rg_refl)
        f_rg = torch.where(
            rg_refl[..., None],
            _microfacet_reflection_f(mp.kr, alpha,
                                     _dielectric_fresnel(eta_mat, C), wo,
                                     wi_rg, ndf=ndf),
            _microfacet_transmission_f(mp.kt, alpha, eta_mat, wo, wi_rg,
                                       ndf=ndf))
        pdf_rg = 0.5 * (_microfacet_reflection_pdf(alpha, wo, wi_rg, ndf=ndf)
                        + _microfacet_transmission_pdf(alpha, eta_mat, wo,
                                                       wi_rg, ndf=ndf))
        rows.append((glass_rough, wi_rg,
                     torch.where(rg_ok[..., None], f_rg, 0.0),
                     torch.where(rg_ok, pdf_rg, 0.0)))
    if _present(mp, MIRROR):
        # FresnelNoOp: f = kr/|cos|
        rows.append((t == MIRROR, wi_mirror,
                     mp.kr / torch.clamp_min(abs_cos_theta(wi_mirror),
                                             1e-6)[..., None],
                     torch.ones(R, device=dev)))
    if need_glass:
        # FresnelSpecular (reflection.cpp:118+): reflect kr·F/|cos|;
        # refract kt·(1−F)·etaRatio²/|cos| (radiance transport)
        f_g_refl = mp.kr * (F / torch.clamp_min(abs_cos_theta(wi_mirror),
                                                1e-6))[..., None]
        f_g_refr = mp.kt * (((1.0 - F) * eta_ratio * eta_ratio)
                            / torch.clamp_min(abs_cos_theta(wi_refr),
                                              1e-6))[..., None]
        rows.append((((t == GLASS) & ~glass_rough) | (t == DISPERSIVE_GLASS),
                     wi_glass,
                     torch.where(choose_refl[..., None], f_g_refl, f_g_refr),
                     torch.where(choose_refl, F, 1.0 - F)))
    if _present(mp, TRANSLUCENT):
        wi_tr = torch.where((u_lobe < 0.5)[..., None], wi_cos, -wi_cos)
        rows.append((t == TRANSLUCENT, wi_tr, bsdf_f(mp, wo, wi_tr, kd),
                     0.5 * abs_cos_theta(wi_tr) * INV_PI))
    if _present(mp, DISNEY):
        rows.append((t == DISNEY,) + _disney_sample(mp, kd, wo, u_lobe, u,
                                                    wi_cos))
    if mp.has_hair:
        from pbrt_tpu_torch.scene import hair as hair_mod
        hh, sa, bm, bn, al, eta = _hair_args(mp, wo, h)
        wi_hair, f_hair, pdf_hair = hair_mod.hair_sample(
            wo, hh, sa, u_lobe, u[..., 0], u[..., 1], beta_m=bm, beta_n=bn,
            alpha=al, eta=eta)
        rows.append((t == HAIR, wi_hair, f_hair, pdf_hair))
    if mp.has_fourier:
        wi_four = torch.where((u_lobe < 0.5)[..., None], wi_cos, -wi_cos)
        if fourier is not None:
            from pbrt_tpu_torch.scene import fourier as fourier_mod
            f_four = fourier_mod.eval_fourier_set(fourier, mp.fourier_id,
                                                  wo, wi_four, C)
        else:
            f_four = torch.zeros(R + (C,), device=dev)
        rows.append((t == FOURIER, wi_four, f_four,
                     0.5 * abs_cos_theta(wi_four) * INV_PI))
    if _present(mp, NONE):
        # the null material (a medium interface): the ray passes straight
        # through with f·|cos|/pdf = 1 (GeometricPrimitive's early-out
        # when there is no material, core/primitive.cpp)
        rows.append((t == NONE, -wo,
                     torch.ones(R + (C,), device=dev)
                     / torch.clamp_min(abs_cos_theta(-wo), 1e-6)[..., None],
                     torch.ones(R, device=dev)))

    wi = _sel([(c, w) for c, w, _, _ in rows], wi_cos)
    f = _sel([(c, v) for c, _, v, _ in rows],
             torch.zeros(R + (C,), device=dev))
    pdf = _sel([(c, p) for c, _, _, p in rows], pdf_matte)

    is_spec = torch.zeros(R, dtype=torch.bool, device=dev)
    is_trans = torch.zeros(R, dtype=torch.bool, device=dev)
    if _present(mp, NONE):
        is_spec = is_spec | (t == NONE)
        is_trans = is_trans | (t == NONE)
    if _present(mp, MIRROR):
        is_spec = is_spec | (t == MIRROR)
    if need_glass:
        smooth = ((t == GLASS) & ~glass_rough) | (t == DISPERSIVE_GLASS)
        is_spec = is_spec | smooth
        is_trans = is_trans | (smooth & ~choose_refl)
    if _present(mp, TRANSLUCENT):
        is_trans = is_trans | ((t == TRANSLUCENT) & (u_lobe >= 0.5))
    if _present(mp, GLASS):
        is_trans = is_trans | (glass_rough & pick_rg_trans)
    if mp.has_hair:
        is_trans = is_trans | ((t == HAIR) & ~same_hemisphere(wo, wi))
    if mp.has_fourier:
        is_trans = is_trans | ((t == FOURIER) & ~same_hemisphere(wo, wi))
    flags = (is_spec.to(torch.int32) * FLAG_SPECULAR
             | is_trans.to(torch.int32) * FLAG_TRANSMISSION)
    return wi, f, pdf, flags


def cauchy_eta(b, c, wvl_nm):
    """Dispersive glass eta(λ) = B + C/λ², λ in µm
    (materials/dispersive_glass.cpp:62-64, reflection.h:345-380)."""
    lam_um = wvl_nm * 1e-3
    return b + c / (lam_um * lam_um)


def _disney_sample(mp, kd, wo, u_lobe, u, wi_cos):
    """The Disney branch of BSDF::Sample_f: a uniform choice among the
    built lobes (disney.cpp:504-589): the cosine family (k_diff of them),
    anisotropic GGX, GTR1 clearcoat, microfacet transmission, Lambertian
    transmission. A refraction that fails is a failed sample (pdf 0,
    reflection.cpp:470-471). The BSSRDF entry's share was taken by the
    subsurface transport, which rewrites an entered row before this
    runs, so u_lobe picks among the surface lobes only while the pdf
    still divides by the whole census: the sample's density is pbrt's
    BSDF::Sample_f density. Returns (wi, f, pdf)."""
    k_diff, n_cc, n_mt, n_lt, n, n_entry = _disney_lobe_counts(mp)
    n_pick = torch.clamp_min(n - n_entry, 1.0)
    ax, ay = _disney_alphas(mp)
    wi_spec = vecmath.reflect(wo, tr_sample_wh_aniso(wo, u, ax, ay))
    # clearcoat: the exact GTR1 wh inversion (disney.cpp:285-305)
    gloss = _disney_cc_gloss(mp)
    a2g = gloss * gloss
    ct_cc = vecmath.safe_sqrt(
        (1.0 - torch.pow(a2g, 1.0 - u[..., 0])) / (1.0 - a2g))
    st_cc = vecmath.safe_sqrt(1.0 - ct_cc * ct_cc)
    phi_cc = 2.0 * math.pi * u[..., 1]
    wh_cc = torch.stack([st_cc * torch.cos(phi_cc), st_cc * torch.sin(phi_cc),
                         ct_cc], dim=-1) * torch.sign(wo[..., 2:3] + 1e-20)
    wi_cc = vecmath.reflect(wo, wh_cc)
    c1 = k_diff / n_pick
    c2 = c1 + 1.0 / n_pick
    c3 = c2 + n_cc / n_pick
    c4 = c3 + n_mt / n_pick
    wi = torch.where((u_lobe < c1)[..., None], wi_cos, wi_spec)
    wi = torch.where(((u_lobe >= c2) & (u_lobe < c3))[..., None], wi_cc, wi)
    bad_mt = torch.zeros_like(u_lobe, dtype=torch.bool)
    if mp.has_disney_trans:
        axt, ayt = _disney_trans_alphas(mp)
        wh_mt = tr_sample_wh_aniso(wo, u, axt, ayt)
        wh_mt_o = wh_mt * torch.sign(vecmath.dot(wh_mt, wo))[..., None]
        eta_r = torch.where(cos_theta(wo) > 0.0, 1.0 / mp.eta, mp.eta)
        wi_mt, mt_ok = vecmath.refract(wo, wh_mt_o, eta_r)
        pick_mt = (u_lobe >= c3) & (u_lobe < c4)
        wi = torch.where(pick_mt[..., None], wi_mt, wi)
        wi = torch.where((u_lobe >= c4)[..., None], -wi_cos, wi)
        bad_mt = pick_mt & ~mt_ok
    f = torch.where(bad_mt[..., None], 0.0, _disney_f(mp, kd, wo, wi))
    pdf = torch.where(bad_mt, 0.0, _disney_pdf(mp, wo, wi))
    return wi, f, pdf
