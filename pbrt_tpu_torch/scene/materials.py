"""Material table and BSDF evaluation: the matte rows (a subset of
pbrt_tpu/scene/materials.py).

A row carries ``type`` (0 = matte), ``kd`` (C channels) and ``sigma``
(Oren–Nayar roughness, degrees; 0 = Lambert). ``bsdf_f``, ``bsdf_pdf`` and
``bsdf_sample`` work in the local shading frame (z = shading normal) on
gathered per-ray rows, with pbrt_tpu's lobe flags. Every other material
type and parameter raises here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core.sampling import INV_PI, cosine_sample_hemisphere

MATTE = 0
ROW_KEYS = frozenset({"type", "kd", "sigma"})

# lobe flags returned by bsdf_sample
FLAG_SPECULAR = 1
FLAG_TRANSMISSION = 2


@dataclasses.dataclass
class MaterialTable:
    mtype: torch.Tensor   # (M,) int32
    kd: torch.Tensor      # (M,C) diffuse reflectance
    sigma: torch.Tensor   # (M,) Oren–Nayar sigma (degrees)


def check_row(row: dict) -> None:
    extra = set(row) - ROW_KEYS
    if extra or int(row.get("type", MATTE)) != MATTE:
        raise NotImplementedError(
            f"material {row.get('type', MATTE)} with {sorted(extra)}: only "
            "matte rows (type, kd, sigma) are ported; the rest is ROADMAP "
            "queue 1 item 8")


def make_material_table(rows: list[dict], n_channels: int,
                        device="cpu") -> MaterialTable:
    """Host-side builder from parameter dicts (defaults as pbrt_tpu's)."""
    for r in rows:
        check_row(r)
    kd = np.array(
        [np.broadcast_to(np.asarray(r.get("kd", 0.5), np.float32),
                         (n_channels,)) for r in rows]
        or [np.full(n_channels, 0.5, np.float32)], np.float32)
    return MaterialTable(
        mtype=torch.tensor([int(r.get("type", MATTE)) for r in rows]
                           or [MATTE], dtype=torch.int32, device=device),
        kd=torch.as_tensor(kd, device=device),
        sigma=torch.as_tensor(np.array([r.get("sigma", 0.0) for r in rows]
                                       or [0.0], np.float32),
                              device=device))


def gather_materials(table: MaterialTable, mat_id: torch.Tensor
                     ) -> MaterialTable:
    """Per-ray material rows (mat_id: (R,), clipped into range)."""
    idx = mat_id.long().clamp(0, table.mtype.shape[0] - 1)
    return MaterialTable(mtype=table.mtype[idx], kd=table.kd[idx],
                         sigma=table.sigma[idx])


def same_hemisphere(wo, wi):
    return wo[..., 2] * wi[..., 2] > 0.0


def _oren_nayar_f(kd, sigma_deg, wo, wi):
    """OrenNayar::f (reflection.cpp:86+); sigma in degrees."""
    sigma = torch.deg2rad(sigma_deg)
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    sin_theta_i = torch.sqrt(torch.clamp_min(1.0 - wi[..., 2] ** 2, 0.0))
    sin_theta_o = torch.sqrt(torch.clamp_min(1.0 - wo[..., 2] ** 2, 0.0))
    # cos(phi_i - phi_o)
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


def bsdf_f(mp: MaterialTable, wo, wi, kd_override=None):
    """The non-delta part of the BSDF, f(wo, wi), (R,C): Lambert, or
    Oren–Nayar where sigma > 0 (materials/matte.cpp:55-66)."""
    kd = mp.kd if kd_override is None else kd_override
    lamb = kd * INV_PI
    on = _oren_nayar_f(kd, mp.sigma, wo, wi)
    matte_f = torch.where((mp.sigma > 0.0)[..., None], on, lamb)
    matte_f = torch.where(same_hemisphere(wo, wi)[..., None], matte_f, 0.0)
    return torch.where((mp.mtype == MATTE)[..., None], matte_f, 0.0)


def bsdf_pdf(mp: MaterialTable, wo, wi):
    """Solid-angle pdf of bsdf_sample, (R,)."""
    cos_pdf = torch.where(same_hemisphere(wo, wi),
                          wi[..., 2].abs() * INV_PI, 0.0)
    return torch.where(mp.mtype == MATTE, cos_pdf, 0.0)


def bsdf_sample(mp: MaterialTable, wo, u_lobe, u, kd_override=None):
    """Sample wi ~ BSDF (BSDF::Sample_f, reflection.cpp:605+): the cosine
    lobe on wo's side. Returns (wi, f, pdf, flags); the caller computes
    beta *= f·|cos(wi)|/pdf. ``u_lobe`` picks among lobes; a matte row has
    one, so it is not read."""
    wi = cosine_sample_hemisphere(u)
    wi = wi * torch.sign(wo[..., 2:3] + 1e-20)   # same hemisphere as wo
    pdf = wi[..., 2].abs() * INV_PI
    f = bsdf_f(mp, wo, wi, kd_override=kd_override)
    flags = torch.zeros_like(mp.mtype)   # a matte lobe is neither
    return wi, f, pdf, flags
