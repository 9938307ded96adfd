"""Participating media: homogeneous and density-grid media (port of
pbrt_tpu/scene/media.py).

Counterpart of pbrt's ``src/media/`` (homogeneous.cpp: closed-form
Beer–Lambert transmittance and exponential distance sampling; grid.cpp:
a density grid with ratio-tracking transmittance and delta-tracking
distance sampling, media/grid.h:51,85-87) and of the Henyey–Greenstein
phase function (core/medium.h:50-114).

The tracking loops take at most ``_MAX_TRACKING_STEPS`` steps with masks,
as pbrt_tpu's ``fori_loop``s do, and draw their random numbers from the
same counter hash, so both packages walk the same steps lane for lane; a
loop stops early once no lane is left walking, which changes no lane.
Media attach per primitive (MediumInterface): a scene holds a tuple of
media, and rays carry a per-lane medium id (−1 is vacuum) that the
``*_set`` functions dispatch on, each medium evaluated on its own lanes
only (gathered, then scattered back).
"""

from __future__ import annotations

import dataclasses

import torch

from pbrt_tpu_torch.core import rng as rng_mod
from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import INV_4PI

_M32 = 0xFFFFFFFF
_MAX_TRACKING_STEPS = 64
# tracking steps drawn at once, between the checks for an early stop
_BLOCK = 8
_CORNERS = [[dx, dy, dz] for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]


@dataclasses.dataclass
class Medium:
    sigma_a: torch.Tensor      # (C,)
    sigma_s: torch.Tensor      # (C,)
    g: torch.Tensor            # () HG asymmetry
    density: torch.Tensor      # (D,H,W) grid density (1,1,1: homogeneous)
    grid_lo: torch.Tensor      # (3,)
    grid_hi: torch.Tensor      # (3,)
    max_density: torch.Tensor  # () the majorant's density factor
    is_grid: bool = False

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s


def _spec(v, n_channels, device):
    return torch.as_tensor(v, dtype=torch.float32,
                           device=device).expand(n_channels).clone()


def make_homogeneous(sigma_a, sigma_s, g=0.0, n_channels=3,
                     device="cpu") -> Medium:
    return Medium(sigma_a=_spec(sigma_a, n_channels, device),
                  sigma_s=_spec(sigma_s, n_channels, device),
                  g=torch.tensor(float(g), device=device),
                  density=torch.ones((1, 1, 1), device=device),
                  grid_lo=torch.zeros(3, device=device),
                  grid_hi=torch.ones(3, device=device),
                  max_density=torch.tensor(1.0, device=device),
                  is_grid=False)


def make_grid(sigma_a, sigma_s, density, lo, hi, g=0.0, n_channels=3,
              device="cpu") -> Medium:
    d = torch.as_tensor(density, dtype=torch.float32, device=device)
    return Medium(sigma_a=_spec(sigma_a, n_channels, device),
                  sigma_s=_spec(sigma_s, n_channels, device),
                  g=torch.tensor(float(g), device=device), density=d,
                  grid_lo=torch.as_tensor(lo, dtype=torch.float32,
                                          device=device),
                  grid_hi=torch.as_tensor(hi, dtype=torch.float32,
                                          device=device),
                  max_density=d.max(), is_grid=True)


def density_at(med: Medium, p: torch.Tensor) -> torch.Tensor:
    """Trilinear grid lookup (GridDensityMedium::Density), 0 outside the
    grid's box; 1 for a homogeneous medium. A tap outside the sample
    lattice is 0, as pbrt's D() (grid.h:61-69)."""
    if not med.is_grid:
        return torch.ones(p.shape[:-1], device=p.device)
    D, H, W = med.density.shape
    u = (p - med.grid_lo) / torch.clamp_min(med.grid_hi - med.grid_lo, 1e-9)
    inside = ((u >= 0.0) & (u <= 1.0)).all(-1)
    g = u * torch.tensor([W, H, D], dtype=torch.float32,
                         device=p.device) - 0.5
    gf = torch.floor(g)
    f = g - gf
    # the eight lattice taps in one gather, in the order 000, 100, 010,
    # 110, 001, 101, 011, 111 (x fastest)
    idx = gf.to(torch.int32).long()[..., None, :] + torch.tensor(
        _CORNERS, device=p.device)
    x, y, z = idx.unbind(-1)
    ok = (x >= 0) & (x < W) & (y >= 0) & (y < H) & (z >= 0) & (z < D)
    taps = torch.where(ok, med.density[z.clamp(0, D - 1), y.clamp(0, H - 1),
                                       x.clamp(0, W - 1)], 0.0)
    t000, t100, t010, t110, t001, t101, t011, t111 = taps.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    d00 = t000 * (1 - fx) + t100 * fx
    d10 = t010 * (1 - fx) + t110 * fx
    d01 = t001 * (1 - fx) + t101 * fx
    d11 = t011 * (1 - fx) + t111 * fx
    d0 = d00 * (1 - fy) + d10 * fy
    d1 = d01 * (1 - fy) + d11 * fy
    return torch.where(inside, d0 * (1 - fz) + d1 * fz, 0.0)


# ---------------------------------------------------------------------------
# Henyey–Greenstein (core/medium.h:50-102, medium.cpp)
# ---------------------------------------------------------------------------

def hg_phase(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp_min(
        denom * torch.sqrt(torch.clamp_min(denom, 1e-9)), 1e-9)


def sample_hg(wo, u, g):
    """wi drawn from HG about wo's frame (HenyeyGreenstein::Sample_p).
    Returns (wi, phase value)."""
    g_safe = torch.where(g.abs() > 1e-3, g, 1e-3 * torch.sign(g + 1e-9))
    sq = (1.0 - g * g) / (1.0 + g - 2.0 * g * u[..., 0])
    cos_theta_g = -(1.0 + g * g - sq * sq) / (2.0 * g_safe)
    cos_theta_iso = 1.0 - 2.0 * u[..., 0]
    cos_theta = torch.where(g.abs() < 1e-3, cos_theta_iso, cos_theta_g)
    sin_theta = vecmath.safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * torch.pi * u[..., 1]
    v1, v2 = vecmath.coordinate_system(wo)
    wi = ((sin_theta * torch.cos(phi))[..., None] * v1
          + (sin_theta * torch.sin(phi))[..., None] * v2
          + cos_theta[..., None] * wo)
    return wi, hg_phase(cos_theta, g)


# ---------------------------------------------------------------------------
# transmittance and distance sampling
# ---------------------------------------------------------------------------

def _uniforms(u_seed, i0: int, dim: int):
    """The tracking uniforms of steps i0 .. i0 + _BLOCK − 1, (R, _BLOCK):
    the counter hash of (seed, step, dim), one draw per step."""
    steps = torch.arange(i0, i0 + _BLOCK, device=u_seed.device)
    return rng_mod.uniform(u_seed[:, None].expand(-1, _BLOCK), steps[None],
                           dim)


def transmittance(med: Medium, p0, p1, u_seed) -> torch.Tensor:
    """Tr between two points (R,C). Homogeneous: Beer–Lambert
    (homogeneous.cpp Tr); grid: ratio tracking (grid.cpp:85-87) with the
    counter hash keyed on ``u_seed`` (R,) uint32 values in int64."""
    d = p1 - p0
    dist = vecmath.length(d)
    st = med.sigma_t
    if not med.is_grid:
        return torch.exp(-torch.clamp_max(st * dist[..., None], 80.0))

    st_max = st.max()
    inv_maj = 1.0 / torch.clamp_min(st_max * med.max_density, 1e-9)
    dn = d / torch.clamp_min(dist, 1e-9)[..., None]
    t = dist * 0.0
    tr = t + 1.0
    alive = dist >= 0.0
    for i0 in range(0, _MAX_TRACKING_STEPS, _BLOCK):
        if not bool(alive.any()):
            break
        us = _uniforms(u_seed, i0, 9001)
        for k in range(_BLOCK):
            t = t - torch.log(1.0 - us[:, k]) * inv_maj
            ok = alive & (t < dist)
            dens = density_at(med, p0 + t[..., None] * dn)
            ratio = 1.0 - dens * st_max * inv_maj
            tr = torch.where(ok, tr * torch.clamp_min(ratio, 0.0), tr)
            alive = ok
    # the spectral shape through the ratio of the sigma_t channels
    w = st / torch.clamp_min(st_max, 1e-9)
    return torch.pow(torch.clamp_min(tr, 1e-9)[..., None], w)


def sample_distance(med: Medium, o, dn, t_max, u, u_seed):
    """A medium interaction along [0, t_max). Homogeneous (homogeneous.cpp
    Sample): a channel chosen uniformly, exponential in its sigma_t, the
    pdf averaged over channels. Grid: delta tracking (grid.cpp Sample).
    Returns (t, sampled_medium, weight_medium (R,C), weight_surface (R,C)):
    the throughput factor of a medium event (sigma_s·Tr/pdf) and of a
    surface event (Tr/pdf)."""
    st = med.sigma_t
    C = st.shape[0]
    if not med.is_grid:
        ch = torch.clamp_max((u * C).to(torch.int32), C - 1).long()
        sig_ch = st[ch]
        u2 = torch.remainder(u * C, 1.0)
        t = -torch.log(torch.clamp_min(1.0 - u2, 1e-9)) \
            / torch.clamp_min(sig_ch, 1e-9)
        sampled = t < t_max
        t_eff = torch.minimum(t, t_max)
        tr = torch.exp(-torch.clamp_max(st * t_eff[..., None], 80.0))
        # the pdf averaged over channels (homogeneous.cpp:71-76)
        pdf_med = (st * tr).mean(-1)
        pdf_surf = tr.mean(-1)
        w_med = tr * med.sigma_s / torch.clamp_min(pdf_med, 1e-20)[..., None]
        w_surf = tr / torch.clamp_min(pdf_surf, 1e-20)[..., None]
        return t_eff, sampled, w_med, w_surf

    # delta tracking (grid.cpp:51-84) against the majorant channel
    st_max = st.max()
    inv_maj = 1.0 / torch.clamp_min(st_max * med.max_density, 1e-9)
    t = t_max * 0.0
    done = t_max < 0.0
    hit_medium = done
    for i0 in range(0, _MAX_TRACKING_STEPS, _BLOCK):
        if bool(done.all()):
            break
        u1s = _uniforms(u_seed, i0, 9002)
        u2s = _uniforms(u_seed, i0, 9003)
        for k in range(_BLOCK):
            t_new = t - torch.log(1.0 - u1s[:, k]) * inv_maj
            past = t_new >= t_max
            dens = density_at(med, o + t_new[..., None] * dn)
            real = u2s[:, k] < dens * st_max * inv_maj
            newly_hit = ~done & ~past & real
            t = torch.where(done, t, torch.where(past, t_max, t_new))
            hit_medium = hit_medium | newly_hit
            done = done | past | newly_hit
    w_med = (med.sigma_s / torch.clamp_min(st, 1e-9)).expand(
        t.shape + (C,))
    w_surf = torch.ones(t.shape + (C,), device=t.device)
    return t, hit_medium, w_med, w_surf


# ---------------------------------------------------------------------------
# per-lane medium sets (MediumInterface, core/medium.h:114)
# ---------------------------------------------------------------------------

def _lanes_of(med_id, k):
    """The lanes in medium k, as indices (a host sync)."""
    return torch.nonzero(med_id == k).squeeze(-1)


def transmittance_set(media, med_id, p0, p1, u_seed) -> torch.Tensor:
    """Tr between two points through each lane's medium ``med_id`` (−1:
    vacuum, Tr = 1)."""
    C = media[0].sigma_t.shape[0] if media else 3
    out = torch.ones(p0.shape[:-1] + (C,), device=p0.device)
    for k, med in enumerate(media):
        idx = _lanes_of(med_id, k)
        if idx.numel():
            out = out.index_put(
                (idx,), transmittance(med, p0[idx], p1[idx], u_seed[idx]))
    return out


def sample_distance_set(media, med_id, o, dn, t_max, u, u_seed):
    """sample_distance by each lane's medium; vacuum lanes never scatter
    (sampled False, weights 1)."""
    C = media[0].sigma_t.shape[0] if media else 3
    shape = t_max.shape
    t = t_max
    sampled = torch.zeros(shape, dtype=torch.bool, device=t_max.device)
    w_med = torch.ones(shape + (C,), device=t_max.device)
    w_surf = torch.ones(shape + (C,), device=t_max.device)
    for k, med in enumerate(media):
        idx = _lanes_of(med_id, k)
        if not idx.numel():
            continue
        t_k, s_k, wm_k, ws_k = sample_distance(
            med, o[idx], dn[idx], t_max[idx], u[idx], u_seed[idx])
        t = t.index_put((idx,), t_k)
        sampled = sampled.index_put((idx,), s_k)
        w_med = w_med.index_put((idx,), wm_k)
        w_surf = w_surf.index_put((idx,), ws_k)
    return t, sampled, w_med, w_surf


def phase_g_set(media, med_id) -> torch.Tensor:
    """Each lane's HG asymmetry g in its current medium (0 in vacuum)."""
    g = torch.zeros(med_id.shape, device=med_id.device)
    for k, med in enumerate(media):
        g = torch.where(med_id == k, med.g, g)
    return g


def seed_mix(a, ka, b, kb, c) -> torch.Tensor:
    """pbrt_tpu's tracking seed ``a·ka ^ (b·kb + c)`` in uint32
    arithmetic, held in int64."""
    return ((a.to(torch.int64) * ka) & _M32) ^ (
        (b.to(torch.int64) * kb + c) & _M32)
