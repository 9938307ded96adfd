"""Hair BSDF, the Marschner / Chiang model (port of pbrt_tpu/scene/hair.py).

Counterpart of ``materials/hair.{h,cpp}``: the longitudinal lobes Mp
(hair.cpp:51-61, with the I0 / LogI0 Bessel terms of :63-83), the
azimuthal lobes Np as trimmed logistics (:105-129), the attenuations Ap
for p = R, TT, TRT and the residual lobe (:85-103), and the scales'
2^k·alpha tilts (:255-262, :291-312).

The local frame has x along the fiber (hair.cpp:265-273): sinTheta = w.x,
phi = atan2(w.z, w.y). ``h`` ∈ [−1, 1] is the offset across the curve's
width (2v − 1 of the curve hit's v). Everything is batched over shading
points; the shape parameters are (R,) rows or Python floats.
``hair_sample`` samples the model exactly (the lobe by the Ap pdf, theta
by inverting Mp, phi by inverting the trimmed logistic, hair.cpp:429-483)
and ``hair_pdf`` is its density (hair.cpp:485-521). Where pbrt_tpu takes
√max(x, 0) the port takes ``vecmath.safe_sqrt``: the same values, and no
NaN gradient at 0.
"""

from __future__ import annotations

import math

import torch

from pbrt_tpu_torch.core.vecmath import safe_sqrt
from pbrt_tpu_torch.scene.materials import fr_dielectric

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069


def _sqr(x):
    return x * x


def _ipow(x, n: int):
    """x**n by repeated squaring, in the order of XLA's integer_pow."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def i0(x):
    """Modified Bessel I0 by its 10-term series (hair.cpp:63-76)."""
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        val = val + x2i / (i4 * ifact * ifact)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


def log_i0(x):
    xc = torch.clamp_min(x, 1e-9)
    big = x + 0.5 * (-math.log(2 * math.pi) + torch.log(1.0 / xc)
                     + 1.0 / (8.0 * xc))
    return torch.where(x > 12.0, big,
                       torch.log(torch.clamp_min(i0(x), 1e-30)))


def mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe (hair.cpp:51-61)."""
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small_v = torch.exp(log_i0(a) - b - 1.0 / v + 0.6931
                        + torch.log(1.0 / (2.0 * v)))
    big_v = torch.exp(-b) * i0(a) / (torch.sinh(1.0 / v) * 2.0 * v)
    return torch.where(v <= 0.1, small_v, big_v)


def _logistic(x, s):
    x = x.abs()
    e = torch.exp(-x / s)
    return e / (s * _sqr(1.0 + e))


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-x / s))


def trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(torch.full_like(s, b), s)
                              - _logistic_cdf(torch.full_like(s, a), s))


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * math.pi


def _mod(x, y: float):
    """x mod y with the divisor's sign (jnp.mod)."""
    r = torch.fmod(x, y)
    return torch.where((r != 0.0) & ((r < 0.0) != (y < 0.0)), r + y, r)


def np_lobe(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = _mod(dphi + math.pi, 2.0 * math.pi) - math.pi
    return trimmed_logistic(dphi, s, -math.pi, math.pi)


def _as_rows(x, like):
    """A shape parameter as an (R,) tensor (rows pass through)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full_like(like, float(x))


def _variances(beta_m):
    v0 = _sqr(0.726 * beta_m + 0.812 * _sqr(beta_m)
              + 3.7 * _ipow(beta_m, 20))
    return [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]


def _azimuthal_s(beta_n):
    return SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * _sqr(beta_n)
                             + 5.372 * _ipow(beta_n, 22))


def _alpha_terms(alpha_deg):
    """sin and cos of 2^k·alpha, k = 0, 1, 2 (hair.cpp:255-262)."""
    s0 = torch.sin(alpha_deg * (math.pi / 180.0))
    c0 = safe_sqrt(1.0 - s0 * s0)
    sin2k, cos2k = [s0], [c0]
    for _ in range(2):
        sin2k.append(2 * cos2k[-1] * sin2k[-1])
        cos2k.append(_sqr(cos2k[-1]) - _sqr(sin2k[-1]))
    return sin2k, cos2k


def _ap_terms(cos_to, eta, h, T):
    """Attenuations Ap for p = R, TT, TRT and the residual
    (hair.cpp:85-103): P_MAX + 1 tensors (R,C)."""
    cos_go = safe_sqrt(1.0 - _sqr(h))
    f0 = fr_dielectric(cos_to * cos_go, torch.ones_like(cos_to),
                       eta * torch.ones_like(cos_to))[..., None]
    ap = [f0 * torch.ones_like(T), _sqr(1.0 - f0) * T]
    for _ in range(2, P_MAX):
        ap.append(ap[-1] * T * f0)
    ap.append(ap[P_MAX - 1] * f0 * T / torch.clamp_min(1.0 - T * f0, 1e-4))
    return ap


def _hair_angles(wo, h, eta):
    """The shared angles (hair.cpp:265-290)."""
    sin_to = wo[..., 0]
    cos_to = safe_sqrt(1.0 - _sqr(sin_to))
    phi_o = torch.atan2(wo[..., 2], wo[..., 1])
    sin_tt = sin_to / eta
    cos_tt = safe_sqrt(1.0 - _sqr(sin_tt))
    etap = torch.sqrt(torch.clamp_min(eta * eta - _sqr(sin_to), 1e-9)) \
        / torch.clamp_min(cos_to, 1e-6)
    sin_gt = h / etap
    cos_gt = safe_sqrt(1.0 - _sqr(sin_gt))
    gamma_t = torch.asin(torch.clamp(sin_gt, -1.0, 1.0))
    gamma_o = torch.asin(torch.clamp(h, -1.0, 1.0))
    return sin_to, cos_to, phi_o, cos_tt, cos_gt, gamma_t, gamma_o


def _tilted_theta_o(p: int, sin_to, cos_to, sin2k, cos2k):
    """sinThetaOp, |cosThetaOp| with the 2^p·alpha tilt
    (hair.cpp:291-312)."""
    if p == 0:
        sin_top = sin_to * cos2k[1] - cos_to * sin2k[1]
        cos_top = cos_to * cos2k[1] + sin_to * sin2k[1]
    elif p == 1:
        sin_top = sin_to * cos2k[0] + cos_to * sin2k[0]
        cos_top = cos_to * cos2k[0] - sin_to * sin2k[0]
    else:
        sin_top = sin_to * cos2k[2] + cos_to * sin2k[2]
        cos_top = cos_to * cos2k[2] - sin_to * sin2k[2]
    return sin_top, cos_top.abs()


def _transmittance(sigma_a, cos_gt, cos_tt):
    return torch.exp(-sigma_a * (2.0 * cos_gt
                                 / torch.clamp_min(cos_tt, 1e-6))[..., None])


def hair_ap_pdf(wo, h, sigma_a, eta):
    """ComputeApPdf (hair.cpp:411-427): the (R, P_MAX+1) discrete lobe pdf
    from the channels' mean attenuation."""
    eta = _as_rows(eta, wo[..., 0])
    _, cos_to, _, cos_tt, cos_gt, _, _ = _hair_angles(wo, h, eta)
    ap = _ap_terms(cos_to, eta, h, _transmittance(sigma_a, cos_gt, cos_tt))
    y = torch.stack([a.mean(-1) for a in ap], dim=-1)
    return y / torch.clamp_min(y.sum(-1, keepdim=True), 1e-12)


def hair_pdf(wo, wi, h, sigma_a, beta_m=0.3, beta_n=0.3, alpha=2.0,
             eta=1.55):
    """HairBSDF::Pdf (hair.cpp:485-521): Σp apPdf[p]·Mp·Np, (R,)."""
    like = wo[..., 0]
    beta_m, beta_n, alpha, eta = (_as_rows(x, like)
                                  for x in (beta_m, beta_n, alpha, eta))
    sin_to, cos_to, phi_o, _, _, gamma_t, gamma_o = _hair_angles(wo, h, eta)
    sin_ti = wi[..., 0]
    cos_ti = safe_sqrt(1.0 - _sqr(sin_ti))
    phi = torch.atan2(wi[..., 2], wi[..., 1]) - phi_o
    ap_pdf = hair_ap_pdf(wo, h, sigma_a, eta)
    v = _variances(beta_m)
    s = _azimuthal_s(beta_n)
    sin2k, cos2k = _alpha_terms(alpha)
    pdf = torch.zeros_like(sin_to)
    for p in range(P_MAX):
        sin_top, cos_top = _tilted_theta_o(p, sin_to, cos_to, sin2k, cos2k)
        pdf = pdf + (mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
                     * ap_pdf[..., p] * np_lobe(phi, p, s, gamma_o, gamma_t))
    return pdf + (mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
                  * ap_pdf[..., P_MAX] / (2.0 * math.pi))


def _sample_trimmed_logistic(u, s, a, b):
    """SampleTrimmedLogistic (hair.cpp:142-148)."""
    cdf_a = _logistic_cdf(torch.full_like(s, a), s)
    k = _logistic_cdf(torch.full_like(s, b), s) - cdf_a
    denom = torch.clamp(u * k + cdf_a, 1e-6, 1.0 - 1e-6)
    return torch.clamp(-s * torch.log(1.0 / denom - 1.0), a, b)


def hair_sample(wo, h, sigma_a, u_p, u_theta, u_phi2, u_phi=None,
                beta_m=0.3, beta_n=0.3, alpha=2.0, eta=1.55):
    """HairBSDF::Sample_f (hair.cpp:429-483), batched. u_p picks the lobe
    from the Ap pdf, (u_theta, u_phi2) sample Mp, u_phi samples Np (when
    None, u_p rescaled within the picked lobe's CDF segment, the
    DemuxFloat role of hair.cpp:433-441). Returns (wi, f, pdf)."""
    like = wo[..., 0]
    beta_m, beta_n, alpha, eta = (_as_rows(x, like)
                                  for x in (beta_m, beta_n, alpha, eta))
    sin_to, cos_to, phi_o, _, _, gamma_t, gamma_o = _hair_angles(wo, h, eta)
    ap_pdf = hair_ap_pdf(wo, h, sigma_a, eta)
    cdf = torch.cumsum(ap_pdf, dim=-1)
    p_sel = torch.clamp(torch.sum(u_p[..., None] > cdf, dim=-1), 0, P_MAX)
    if u_phi is None:
        prev = torch.clamp_min(p_sel - 1, 0)[..., None]
        cdf_prev = torch.where(p_sel > 0, cdf.gather(-1, prev)[..., 0], 0.0)
        seg = ap_pdf.gather(-1, p_sel[..., None])[..., 0]
        u_phi = torch.clamp((u_p - cdf_prev) / torch.clamp_min(seg, 1e-9),
                            0.0, 1.0 - 1e-6)
    v = _variances(beta_m)
    sin2k, cos2k = _alpha_terms(alpha)
    s = _azimuthal_s(beta_n)
    # the tilted thetaO of the picked lobe; the residual lobe samples
    # untilted (hair.cpp:448-459)
    tops = [_tilted_theta_o(p, sin_to, cos_to, sin2k, cos2k)
            for p in range(P_MAX)] + [(sin_to, cos_to)]
    at = p_sel[..., None]
    sin_top = torch.stack([tp[0] for tp in tops], -1).gather(-1, at)[..., 0]
    cos_top = torch.stack([tp[1] for tp in tops], -1).gather(-1, at)[..., 0]
    v_sel = torch.stack(v, -1).gather(-1, at)[..., 0]
    # longitudinal: invert Mp (hair.cpp:461-470)
    ut = torch.clamp_min(u_theta, 1e-5)
    cos_theta = 1.0 + v_sel * torch.log(
        ut + (1.0 - ut) * torch.exp(-2.0 / torch.clamp_min(v_sel, 1e-6)))
    sin_theta = safe_sqrt(1.0 - _sqr(cos_theta))
    cos_phi = torch.cos(2.0 * math.pi * u_phi2)
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi * cos_top
    cos_ti = safe_sqrt(1.0 - _sqr(sin_ti))
    # azimuthal (hair.cpp:472-478)
    dphi_lobe = _phi_fn(p_sel, gamma_o, gamma_t) \
        + _sample_trimmed_logistic(u_phi, s, -math.pi, math.pi)
    dphi = torch.where(p_sel < P_MAX, dphi_lobe, 2.0 * math.pi * u_phi)
    phi_i = phi_o + dphi
    wi = torch.stack([sin_ti, cos_ti * torch.cos(phi_i),
                      cos_ti * torch.sin(phi_i)], dim=-1)
    f = hair_f(wo, wi, h, sigma_a, beta_m, beta_n, alpha, eta)
    pdf = hair_pdf(wo, wi, h, sigma_a, beta_m, beta_n, alpha, eta)
    return wi, f, pdf


def hair_f(wo, wi, h, sigma_a, beta_m=0.3, beta_n=0.3, alpha=2.0,
           eta=1.55):
    """HairBSDF::f (hair.cpp:264-324), batched. wo, wi (R,3) in the local
    frame (x along the fiber); h (R,); sigma_a (R,C). Returns (R,C)."""
    like = wo[..., 0]
    beta_m, beta_n, alpha, eta = (_as_rows(x, like)
                                  for x in (beta_m, beta_n, alpha, eta))
    sin_to, cos_to, phi_o, cos_tt, cos_gt, gamma_t, gamma_o = \
        _hair_angles(wo, h, eta)
    sin_ti = wi[..., 0]
    cos_ti = safe_sqrt(1.0 - _sqr(sin_ti))
    phi = torch.atan2(wi[..., 2], wi[..., 1]) - phi_o
    T = _transmittance(sigma_a, cos_gt, cos_tt)
    ap = _ap_terms(cos_to, eta, h, T)
    v = _variances(beta_m)
    s = _azimuthal_s(beta_n)
    sin2k, cos2k = _alpha_terms(alpha)
    fsum = torch.zeros_like(T)
    for p in range(P_MAX):
        sin_top, cos_top = _tilted_theta_o(p, sin_to, cos_to, sin2k, cos2k)
        fsum = fsum + (mp(cos_ti, cos_top, sin_ti, sin_top, v[p])
                       * np_lobe(phi, p, s, gamma_o, gamma_t))[..., None] \
            * ap[p]
    fsum = fsum + (mp(cos_ti, cos_to, sin_ti, sin_to, v[P_MAX])
                   / (2.0 * math.pi))[..., None] * ap[P_MAX]
    return fsum / torch.clamp_min(wi[..., 2].abs(), 1e-6)[..., None]


def sigma_a_from_concentration(ce: float, cp: float) -> torch.Tensor:
    """HairBSDF::SigmaAFromConcentration: eumelanin and pheomelanin
    concentrations → RGB absorption (float32)."""
    eumelanin = torch.tensor([0.419, 0.697, 1.37])
    pheomelanin = torch.tensor([0.187, 0.4, 1.05])
    return ce * eumelanin + cp * pheomelanin


def sigma_a_from_reflectance(c, beta_n: float) -> torch.Tensor:
    """HairBSDF::SigmaAFromReflectance: an RGB color → absorption."""
    denom = (5.969 - 0.215 * beta_n + 2.532 * _sqr(beta_n)
             - 10.73 * beta_n ** 3 + 5.574 * beta_n ** 4
             + 0.245 * beta_n ** 5)
    c = torch.as_tensor(c, dtype=torch.float32)
    return _sqr(torch.log(torch.clamp_min(c, 1e-4)) / denom)
