"""Light table: point, spot, distant, diffuse-area (with light portals),
infinite, goniometric and projection lights (port of
pbrt_tpu/scene/lights.py).

Lights are rows of an SoA table; ``sample_li`` / ``pdf_li`` are batched
over shading points with branchless type dispatch over the types present.
The fork's PortalArealight is an AREA row with portal rows attached
(padded (L, MAXP) tensors) and a strategy tag; portal sampling itself
lives in scene/portals.py. An area light binds to one primitive (one light
row per emissive primitive). As in pbrt_tpu, the scene has one
environment map (the infinite light's lat-long radiance, +y up, a 1×1 map
for a constant one) and one goniometric / projection map, shared by the
rows of those types.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec_mod
from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (INV_4PI, Distribution2D,
                                          distribution_2d_pdf,
                                          make_distribution_1d,
                                          make_distribution_2d,
                                          sample_distribution_2d,
                                          uniform_sample_sphere)
from pbrt_tpu_torch.core.vecmath import absdot, dot, normalize
from pbrt_tpu_torch.scene import shapes

POINT = 0
SPOT = 1
DISTANT = 2
AREA = 3
INFINITE = 4
GONIO = 5
PROJECTION = 6
_TYPES = {"point": POINT, "spot": SPOT, "distant": DISTANT, "area": AREA,
          "infinite": INFINITE, "goniometric": GONIO,
          "projection": PROJECTION}

# portal strategies (lights/portal_arealight.h:12)
STRAT_LIGHT = 0
STRAT_PORTAL = 1
STRAT_PROJECTION = 2
_STRATEGIES = {"light": STRAT_LIGHT, "portal": STRAT_PORTAL,
               "projection": STRAT_PROJECTION}

MAXP = 4  # hard cap on portals per light, as in pbrt_tpu


@dataclasses.dataclass
class LightTable:
    ltype: torch.Tensor          # (L,) int32
    emit: torch.Tensor           # (L,C) radiance (area/infinite/distant) or
                                 # intensity
    pos: torch.Tensor            # (L,3)
    dir: torch.Tensor            # (L,3) normalized (spot/distant)
    cos_total: torch.Tensor      # (L,) spot outer cone
    cos_falloff: torch.Tensor    # (L,) spot inner cone
    prim_id: torch.Tensor        # (L,) the area light's global prim (−1)
    two_sided: torch.Tensor      # (L,) bool
    strategy: torch.Tensor       # (L,) int32
    n_portals: torch.Tensor      # (L,) int32
    portal_lo: torch.Tensor      # (L,P,3)
    portal_hi: torch.Tensor      # (L,P,3)
    portal_ax: torch.Tensor      # (L,P) int32
    portal_facing: torch.Tensor  # (L,P) bool
    gonio_map: torch.Tensor      # (Hg,Wg,C) goniometric lat-long map or
                                 # projector image (lights/goniometric.cpp,
                                 # lights/projection.cpp)
    proj_fov: torch.Tensor       # (L,) projection field of view (degrees)
    env_map: torch.Tensor        # (H,W,C) the infinite light's radiance
    env_distr: Distribution2D    # its importance distribution
    power: torch.Tensor          # (L,C) Power() per light
    # sorted tuple of the light types present: sample_li / pdf_li only
    # evaluate the families a scene instantiates
    present: tuple = ()
    # any portal area light in the scene? (guards the portal-strategy
    # machinery of estimate_direct)
    has_portals: bool = True
    # any area light WITHOUT portals? Only such a light and an infinite
    # one get the BSDF half of two-sample MIS (delta and portal lights are
    # single-sample), so estimate_direct skips that half's trace when
    # there is neither
    has_plain_area: bool = True

    @property
    def n(self) -> int:
        return self.ltype.shape[0]


def _lt_present(lt: LightTable, *types: int) -> bool:
    """Can any of `types` occur in this table? (empty = unknown)"""
    if not lt.present:
        return True
    return any(tt in lt.present for tt in types)


def _rgb_map(m, C: int) -> np.ndarray:
    """A light map of C channels; an RGB map in a sampled scene is lifted
    to 60 bins (``from_rgb``), as pbrt_tpu lifts it."""
    m = np.asarray(m, np.float32)
    if m.ndim == 3 and m.shape[-1] == 3 and C != 3:
        m = spec_mod.rgb_to_spectrum(m)
    if m.ndim != 3 or m.shape[-1] != C:
        raise ValueError(f"a light map must be (H, W, {C}), not {m.shape}")
    return m


def takes_bsdf_half(lt: LightTable) -> bool:
    """Can a light of this table take the BSDF half of two-sample MIS?
    (an area light without portals, or an infinite light)"""
    return lt.has_plain_area or _lt_present(lt, INFINITE)


def _prim_area_host(builder, gid: int) -> float:
    nt, ns = len(builder.tris), len(builder.spheres)
    if gid < 0:
        return 0.0
    if gid < nt:
        r = builder.tris[gid]
        v0, v1, v2 = (np.asarray(r[k], np.float64) for k in
                      ("v0", "v1", "v2"))
        return float(0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0)))
    gid -= nt
    if gid < ns:
        return float(4 * np.pi * builder.spheres[gid]["radius"] ** 2)
    r = builder.planes[gid - ns]
    lo = np.asarray(r["lo"], np.float64)
    hi = np.asarray(r["hi"], np.float64)
    ax0 = {2: 0, 0: 1, 1: 2}[r["ax"]]
    ax1 = {2: 1, 0: 2, 1: 0}[r["ax"]]
    return float((hi[ax0] - lo[ax0]) * (hi[ax1] - lo[ax1]))


def build_light_table(builder, world_lo, world_hi, device="cpu"
                      ) -> LightTable:
    """builder.light_rows (dicts) → LightTable. Row keys: type ('point' |
    'spot' | 'distant' | 'area' | 'infinite' | 'goniometric' |
    'projection'), L/I (spectrum), scale, pos, dir, cone_angle,
    cone_delta, prim (global id or (family, local) pair), two_sided,
    strategy, portals=[(lo, hi, ax, facing), ...], env_map (H,W,C; the
    last infinite row's wins), map (Hg,Wg,C) and fov (goniometric /
    projection; the last map wins). world_lo, world_hi: the scene bounds
    (for the power of a distant and an infinite light)."""
    rows = builder.light_rows
    C = builder.n_channels
    n = max(1, len(rows))
    ltype = np.full(n, POINT, np.int32)
    emit = np.zeros((n, C), np.float32)
    pos = np.zeros((n, 3), np.float32)
    ldir = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    cos_total = np.full(n, -1.0, np.float32)
    cos_falloff = np.full(n, -1.0, np.float32)
    prim_id = np.full(n, -1, np.int32)
    two_sided = np.zeros(n, bool)
    strategy = np.zeros(n, np.int32)
    n_portals = np.zeros(n, np.int32)
    maxp = max([1] + [min(len(r.get("portals", [])), MAXP) for r in rows])
    p_lo = np.zeros((n, maxp, 3), np.float32)
    p_hi = np.zeros((n, maxp, 3), np.float32)
    p_ax = np.full((n, maxp), 2, np.int32)
    p_fw = np.zeros((n, maxp), bool)
    env_map = np.zeros((1, 1, C), np.float32)
    gonio_map = np.ones((1, 1, C), np.float32)
    proj_fov = np.full(n, 45.0, np.float32)
    for i, r in enumerate(rows):
        ltype[i] = _TYPES[r.get("type", "point")]
        e = np.asarray(r.get("L", r.get("I", np.ones(C))), np.float32)
        sc = np.asarray(r.get("scale", np.ones(C)), np.float32)
        emit[i] = np.broadcast_to(e * sc, (C,))
        pos[i] = np.asarray(r.get("pos", (0, 0, 0)), np.float32)
        d = np.asarray(r.get("dir", (0, 0, 1)), np.float32)
        ldir[i] = d / max(np.linalg.norm(d), 1e-12)
        if ltype[i] == SPOT:
            ang = float(r.get("cone_angle", 30.0))
            delta = float(r.get("cone_delta", 5.0))
            cos_total[i] = np.cos(np.radians(ang))
            cos_falloff[i] = np.cos(np.radians(ang - delta))
        pr = r.get("prim", -1)
        prim_id[i] = builder.prim_index(*pr) if isinstance(pr, tuple) \
            else int(pr)
        two_sided[i] = bool(r.get("two_sided", False))
        strategy[i] = _STRATEGIES[r.get("strategy", "light")]
        portals = r.get("portals", [])
        n_portals[i] = len(portals)
        for j, (plo, phi, pax, pfw) in enumerate(portals[:maxp]):
            p_lo[i, j] = plo
            p_hi[i, j] = phi
            p_ax[i, j] = pax
            p_fw[i, j] = pfw
        if ltype[i] in (GONIO, PROJECTION):
            proj_fov[i] = float(r.get("fov", 45.0))
            if r.get("map") is not None:
                gonio_map = _rgb_map(r["map"], C)
        if ltype[i] == INFINITE and r.get("env_map") is not None:
            env_map = _rgb_map(r["env_map"], C)

    # the environment's importance distribution: the channel mean weighted
    # by sin(theta) (lights/infinite.cpp:58-70)
    h = env_map.shape[0]
    sin_theta = np.sin((np.arange(h) + 0.5) / h * np.pi)[:, None]
    env_f = env_map.mean(-1) * sin_theta + 1e-9

    # Power() per light (for the power light distribution; light.h Power)
    wr = float(np.linalg.norm(np.asarray(world_hi) - np.asarray(world_lo))
               / 2 + 1e-3)
    power = np.zeros((n, C), np.float32)
    for i in range(len(rows)):
        if ltype[i] == POINT:
            power[i] = 4 * np.pi * emit[i]
        elif ltype[i] == SPOT:
            power[i] = emit[i] * 2 * np.pi * (
                1 - 0.5 * (cos_falloff[i] + cos_total[i]))
        elif ltype[i] == DISTANT:
            power[i] = emit[i] * np.pi * wr * wr
        elif ltype[i] == AREA:
            area = _prim_area_host(builder, int(prim_id[i]))
            power[i] = emit[i] * area * np.pi * (2.0 if two_sided[i] else 1.0)
        elif ltype[i] == INFINITE:
            power[i] = env_map.mean((0, 1)) * emit[i] * np.pi * wr * wr
        elif ltype[i] == GONIO:
            power[i] = 4 * np.pi * emit[i] * gonio_map.mean((0, 1))
        elif ltype[i] == PROJECTION:
            power[i] = emit[i] * gonio_map.mean((0, 1)) * 2 * np.pi \
                * (1 - np.cos(np.radians(proj_fov[i]) / 2))

    def t(a):
        return torch.as_tensor(a, device=device)

    return LightTable(
        ltype=t(ltype), emit=t(emit), pos=t(pos), dir=t(ldir),
        cos_total=t(cos_total), cos_falloff=t(cos_falloff),
        prim_id=t(prim_id), two_sided=t(two_sided), strategy=t(strategy),
        n_portals=t(n_portals), portal_lo=t(p_lo), portal_hi=t(p_hi),
        portal_ax=t(p_ax), portal_facing=t(p_fw), gonio_map=t(gonio_map),
        proj_fov=t(proj_fov), env_map=t(env_map),
        env_distr=make_distribution_2d(t(env_f.astype(np.float32))),
        power=t(power),
        present=tuple(sorted({int(v) for v in ltype} or {POINT})),
        has_portals=bool((n_portals > 0).any()),
        has_plain_area=bool(((ltype == AREA) & (n_portals == 0)).any()))


# ---------------------------------------------------------------------------
# Gathering per-ray light rows and area-prim geometry
# ---------------------------------------------------------------------------

def gather_lights(lt: LightTable, idx: torch.Tensor) -> LightTable:
    """Per-ray light rows (idx: (R,), clipped into range); ``power`` stays
    the whole table's."""
    idx = idx.long().clamp(0, lt.n - 1)
    return LightTable(
        ltype=lt.ltype[idx], emit=lt.emit[idx], pos=lt.pos[idx],
        dir=lt.dir[idx], cos_total=lt.cos_total[idx],
        cos_falloff=lt.cos_falloff[idx], prim_id=lt.prim_id[idx],
        two_sided=lt.two_sided[idx], strategy=lt.strategy[idx],
        n_portals=lt.n_portals[idx], portal_lo=lt.portal_lo[idx],
        portal_hi=lt.portal_hi[idx], portal_ax=lt.portal_ax[idx],
        portal_facing=lt.portal_facing[idx], gonio_map=lt.gonio_map,
        proj_fov=lt.proj_fov[idx], env_map=lt.env_map,
        env_distr=lt.env_distr, power=lt.power, present=lt.present,
        has_portals=lt.has_portals, has_plain_area=lt.has_plain_area)


@dataclasses.dataclass
class AreaPrim:
    """Per-ray gathered geometry of an area light's primitive."""
    is_tri: torch.Tensor
    is_sph: torch.Tensor
    is_pln: torch.Tensor
    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    center: torch.Tensor
    radius: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    ax: torch.Tensor
    facing: torch.Tensor


def gather_area_prim(scene, prim_id: torch.Tensor) -> AreaPrim:
    g = scene.geom
    nt, ns, npl = scene.n_tri, scene.n_sph, scene.n_pln
    prim_id = prim_id.long()
    ti = prim_id.clamp(0, max(nt - 1, 0))
    si = (prim_id - nt).clamp(0, max(ns - 1, 0))
    pi = (prim_id - nt - ns).clamp(0, max(npl - 1, 0))
    return AreaPrim(
        is_tri=(prim_id >= 0) & (prim_id < nt),
        is_sph=(prim_id >= nt) & (prim_id < nt + ns),
        is_pln=(prim_id >= nt + ns) & (prim_id < nt + ns + npl),
        v0=g.tri_v0[ti], v1=g.tri_v1[ti], v2=g.tri_v2[ti],
        center=g.sph_center[si], radius=g.sph_radius[si],
        lo=g.pln_lo[pi], hi=g.pln_hi[pi], ax=g.pln_ax[pi],
        facing=g.pln_facing[pi])


def area_light_L(lt_emit, two_sided, n_light, w):
    """DiffuseAreaLight::L (lights/diffuse.h:60-66): emit iff twoSided or
    the outgoing direction w is on the normal side."""
    ok = two_sided | (dot(n_light, w) > 0.0)
    return torch.where(ok[..., None], lt_emit, 0.0)


# ---------------------------------------------------------------------------
# Sample_Li / Pdf_Li (batched, branchless type dispatch)
# ---------------------------------------------------------------------------

def _sel(default, *pairs):
    out = default
    for c, v in pairs:
        while c.ndim < v.ndim:
            c = c[..., None]
        out = torch.where(c, v, out)
    return out


def _latlong(d):
    """(theta, phi) of unit directions in the +y-up lat-long frame."""
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0])
    return theta, torch.where(phi < 0, phi + 2 * math.pi, phi)


def _texel(m, theta, phi):
    h, w = m.shape[0], m.shape[1]
    x = torch.clamp((phi / (2 * math.pi) * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((theta / math.pi * h).to(torch.int64), 0, h - 1)
    return m[y, x]


def emission_scale(lt: LightTable, g: LightTable, d_emit):
    """Direction-dependent emission of a delta-position light along the
    emission direction ``d_emit`` (R,3): the spot's quartic cone falloff
    (spot.cpp Falloff), the goniometric lat-long map (goniometric.cpp
    Scale), the projector image inside its window (projection.cpp
    Projection); 1 for other types. Returns (R, C)."""
    R = d_emit.shape[0]
    out = torch.ones((R, lt.emit.shape[-1]), device=d_emit.device)
    if _lt_present(lt, SPOT):
        cos_t = dot(d_emit, g.dir)
        dcos = torch.clamp_min(g.cos_falloff - g.cos_total, 1e-6)
        t = torch.clamp((cos_t - g.cos_total) / dcos, 0.0, 1.0)
        fall = torch.where(cos_t < g.cos_total, 0.0,
                           torch.where(cos_t > g.cos_falloff, 1.0,
                                       (t * t) * (t * t)))
        out = torch.where((g.ltype == SPOT)[..., None], fall[..., None], out)
    if _lt_present(lt, GONIO):
        theta, phi = _latlong(d_emit)
        out = torch.where((g.ltype == GONIO)[..., None],
                          _texel(lt.gonio_map, theta, phi), out)
    if _lt_present(lt, PROJECTION):
        hg, wg = lt.gonio_map.shape[0], lt.gonio_map.shape[1]
        cos_p = dot(d_emit, g.dir)
        tan_half = torch.tan(torch.deg2rad(g.proj_fov) / 2.0)
        t1p, t2p = vecmath.coordinate_system(g.dir)
        x_p = dot(d_emit, t1p) / torch.clamp_min(cos_p, 1e-6)
        y_p = dot(d_emit, t2p) / torch.clamp_min(cos_p, 1e-6)
        inside = (cos_p > 0) & (x_p.abs() < tan_half) \
            & (y_p.abs() < tan_half)
        px = torch.clamp(((x_p / tan_half * 0.5 + 0.5) * wg)
                         .to(torch.int64), 0, wg - 1)
        py = torch.clamp(((y_p / tan_half * 0.5 + 0.5) * hg)
                         .to(torch.int64), 0, hg - 1)
        out = torch.where((g.ltype == PROJECTION)[..., None],
                          lt.gonio_map[py, px]
                          * torch.where(inside, 1.0, 0.0)[..., None], out)
    return out


def _const_env(lt: LightTable) -> bool:
    return lt.env_map.shape[0] * lt.env_map.shape[1] == 1


def _env_pdf(lt: LightTable, d):
    """Solid-angle density of the environment's importance sampling."""
    if _const_env(lt):
        return torch.full(d.shape[:-1], INV_4PI, device=d.device)
    theta, phi = _latlong(d)
    uv = torch.stack([phi / (2 * math.pi), theta / math.pi], dim=-1)
    sin_t = torch.clamp_min(torch.sin(theta), 1e-6)
    return distribution_2d_pdf(lt.env_distr, uv) \
        / (2.0 * math.pi * math.pi * sin_t)


def sample_li(scene, light_idx, ref_p, u):
    """Light::Sample_Li analogue. light_idx: (R,) chosen light per ray;
    ref_p: (R,3); u: (R,2). Returns a dict with wi (R,3), li (R,C), pdf
    (R,) [solid angle], p_light (R,3) (for shadow rays; a far point for a
    distant or infinite light), n_light (R,3), is_delta (R,)."""
    lt = scene.lights
    g = gather_lights(lt, light_idx)
    R = ref_p.shape[0]

    # point, and the delta-position lights it modulates
    to_l = g.pos - ref_p
    d2 = vecmath.length_squared(to_l)
    wi_pt = normalize(to_l)
    li_pt = g.emit / torch.clamp_min(d2, 1e-12)[..., None]
    wi_rows, li_rows, pdf_rows, p_rows, n_rows = [], [], [], [], []
    if _lt_present(lt, SPOT, GONIO, PROJECTION):
        li_rows.append(((g.ltype == SPOT) | (g.ltype == GONIO)
                        | (g.ltype == PROJECTION),
                        li_pt * emission_scale(lt, g, -wi_pt)))
    if _lt_present(lt, DISTANT):
        # distant: wi = -dir, sample point far away
        is_dist = g.ltype == DISTANT
        wi_dist = -g.dir
        wi_rows.append((is_dist, wi_dist))
        li_rows.append((is_dist, g.emit))
        p_rows.append((is_dist,
                       ref_p + wi_dist * (2.0 * scene.world_radius())))

    if _lt_present(lt, AREA):
        # area: sample the bound primitive
        is_area = g.ltype == AREA
        ap = gather_area_prim(scene, g.prim_id)
        p_tri, n_tri, ipdf_tri = shapes.sample_triangle(ap.v0, ap.v1, ap.v2,
                                                        u)
        p_pln, n_pln, ipdf_pln = shapes.sample_aaplane(ap.lo, ap.hi, ap.ax,
                                                       ap.facing, u)
        p_sph, n_sph, pdf_sph_sa = shapes.sample_sphere_from_ref(
            ap.center, ap.radius, ref_p, u)
        p_area = torch.where(ap.is_sph[..., None], p_sph,
                             torch.where(ap.is_pln[..., None], p_pln, p_tri))
        n_area = torch.where(ap.is_sph[..., None], n_sph,
                             torch.where(ap.is_pln[..., None], n_pln, n_tri))
        to_area = p_area - ref_p
        d2a = vecmath.length_squared(to_area)
        wi_area = normalize(to_area)
        # area pdf → solid angle (shape.cpp Shape::Pdf(ref,wi))
        area_pdf = torch.where(ap.is_pln, ipdf_pln, ipdf_tri)
        cos_l = absdot(n_area, -wi_area)
        pdf_area = torch.where(
            ap.is_sph, pdf_sph_sa,
            d2a * area_pdf / torch.clamp_min(cos_l, 1e-9))
        li_area = area_light_L(g.emit, g.two_sided, n_area, -wi_area)
        li_area = torch.where((d2a > 1e-12)[..., None], li_area, 0.0)
        wi_rows.append((is_area, wi_area))
        li_rows.append((is_area, li_area))
        pdf_rows.append((is_area, pdf_area))
        p_rows.append((is_area, p_area))
        n_rows.append((is_area, n_area))

    if _lt_present(lt, INFINITE):
        # infinite: importance-sample the map (lights/infinite.cpp:108-140);
        # a constant (1×1) map samples the uniform sphere
        is_inf = g.ltype == INFINITE
        if _const_env(lt):
            wi_inf = uniform_sample_sphere(u)
            pdf_inf = torch.full((R,), INV_4PI, device=ref_p.device)
            li_inf = lt.env_map[0, 0] * g.emit
        else:
            uv, pdf_uv = sample_distribution_2d(lt.env_distr, u)
            theta = uv[..., 1] * math.pi
            phi = uv[..., 0] * 2.0 * math.pi
            sin_t = torch.sin(theta)
            wi_inf = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                                  sin_t * torch.sin(phi)], dim=-1)
            pdf_inf = pdf_uv / torch.clamp_min(
                2.0 * math.pi * math.pi * sin_t, 1e-9)
            li_inf = env_radiance(lt, wi_inf) * g.emit
        wi_rows.append((is_inf, wi_inf))
        li_rows.append((is_inf, li_inf))
        pdf_rows.append((is_inf, pdf_inf))
        p_rows.append((is_inf, ref_p + wi_inf * (2.0 * scene.world_radius())))

    wi = _sel(wi_pt, *wi_rows)
    return dict(wi=wi, li=_sel(li_pt, *li_rows),
                pdf=_sel(torch.ones(R, device=ref_p.device), *pdf_rows),
                p_light=_sel(g.pos, *p_rows), n_light=_sel(-wi, *n_rows),
                is_delta=(g.ltype == POINT) | (g.ltype == SPOT)
                | (g.ltype == DISTANT) | (g.ltype == GONIO)
                | (g.ltype == PROJECTION))


def pdf_li(scene, light_idx, ref_p, wi):
    """Light::Pdf_Li analogue (solid-angle density of sample_li for wi);
    0 for delta lights."""
    lt = scene.lights
    R = ref_p.shape[0]
    pdf = torch.zeros(R, device=ref_p.device)
    if not _lt_present(lt, AREA, INFINITE):
        return pdf
    g = gather_lights(lt, light_idx)
    if _lt_present(lt, INFINITE):
        pdf = torch.where(g.ltype == INFINITE, _env_pdf(lt, wi), pdf)
    if not _lt_present(lt, AREA):
        return pdf
    # area: intersect the bound primitive along wi (one prim per ray)
    ap = gather_area_prim(scene, g.prim_id)
    tmax = torch.full((R,), vecmath.INF, device=ref_p.device)
    t_tri, _, _, hit_tri = shapes.intersect_triangle_paired(
        ref_p, wi, tmax, ap.v0, ap.v1, ap.v2)
    t_pln, _, _, hit_pln = shapes.intersect_aaplane_paired(
        ref_p, wi, tmax, ap.lo, ap.hi, ap.ax)
    t_hit = torch.where(ap.is_pln, t_pln, t_tri)
    hit = torch.where(ap.is_pln, hit_pln, hit_tri)
    n_l = torch.where(ap.is_pln[..., None],
                      shapes.aaplane_normal(ap.ax, ap.facing),
                      shapes.triangle_normal(ap.v0, ap.v1, ap.v2))
    area = torch.where(ap.is_pln, shapes.aaplane_area(ap.lo, ap.hi, ap.ax),
                       shapes.triangle_area(ap.v0, ap.v1, ap.v2))
    pdf_flat = torch.where(
        hit, (t_hit * t_hit) / torch.clamp_min(absdot(n_l, -wi) * area, 1e-9),
        0.0)
    pdf_sph = shapes.sphere_pdf_wi(ap.center, ap.radius, ref_p, wi) \
        if scene.n_sph else pdf
    pdf_area = torch.where(ap.is_sph, pdf_sph, pdf_flat)
    return torch.where(g.ltype == AREA, pdf_area, pdf)


def infinite_pdf_li(scene, d):
    """Solid-angle pdf of the infinite light's Sample_Li for directions d,
    already multiplied by the uniform light-selection pmf
    (InfiniteAreaLight::Pdf_Li, lights/infinite.cpp:142-152)."""
    lt = scene.lights
    if not _lt_present(lt, INFINITE):
        return torch.zeros(d.shape[:-1], device=d.device)
    has_inf = (lt.ltype == INFINITE).any()
    return torch.where(has_inf, _env_pdf(lt, d) / lt.n, 0.0)


def env_radiance(lt: LightTable, d):
    """InfiniteAreaLight::Le lookup (lights/infinite.cpp:94-106) of unit
    directions d (R,3): the map's texel (nearest) in the +y-up lat-long
    frame."""
    if _const_env(lt):
        return lt.env_map[0, 0].expand(d.shape[:-1] + lt.env_map.shape[-1:])
    theta, phi = _latlong(d)
    return _texel(lt.env_map, theta, phi)


def escaped_radiance(scene, d):
    """Sum of the infinite lights' Le along escaped rays (scene.h:50-74):
    the one map scaled by every infinite row's emission."""
    lt = scene.lights
    if not _lt_present(lt, INFINITE):
        return torch.zeros(d.shape[:-1] + (lt.emit.shape[-1],),
                           device=d.device)
    scale = torch.where((lt.ltype == INFINITE)[:, None], lt.emit,
                        0.0).sum(0)
    return env_radiance(lt, d) * scale


def power_distribution(lt: LightTable):
    """The power light distribution's CDF over lights (lightdistrib.cpp)."""
    return make_distribution_1d(torch.clamp_min(lt.power.sum(-1), 0.0))
