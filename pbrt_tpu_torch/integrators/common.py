"""Shared integrator machinery: shading frames, light selection and next
event estimation with MIS and the portal dispatch (port of
pbrt_tpu/integrators/common.py:34-253).

Counterpart of ``core/integrator.cpp``'s UniformSampleOneLight and
EstimateDirect, including the fork's portal dispatch, and of the
uniform and power light distributions.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (power_heuristic,
                                          sample_distribution_1d_discrete)
from pbrt_tpu_torch.core.vecmath import absdot, dot
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import portals as portals_mod
from pbrt_tpu_torch.scene import textures as tex_mod
from pbrt_tpu_torch.scene.lights import (AREA, STRAT_LIGHT,
                                         STRAT_PROJECTION)


# ---------------------------------------------------------------------------
# shading frames
# ---------------------------------------------------------------------------

def make_frame(ns):
    """Orthonormal (t1, t2, ns) basis per shading point."""
    return vecmath.coordinate_system(ns)


def shading_frame(hit, mp=None):
    """Shading basis (no hair rows are ported, so no fiber alignment)."""
    return make_frame(hit.ns)


def to_local(t1, t2, n, w):
    return torch.stack([dot(w, t1), dot(w, t2), dot(w, n)], dim=-1)


def to_world(t1, t2, n, w):
    return w[..., 0:1] * t1 + w[..., 1:2] * t2 + w[..., 2:3] * n


# ---------------------------------------------------------------------------
# light selection (lightdistrib.h Uniform/Power)
# ---------------------------------------------------------------------------

def choose_light(scene, u, power_distr=None):
    """Pick a light per ray. Returns (idx (R,), select_pmf (R,)).
    ``power_distr`` is a Distribution1D (power strategy) or None
    (uniform)."""
    if power_distr is not None:
        return sample_distribution_1d_discrete(power_distr, u)
    n = scene.lights.n
    idx = torch.clamp_max((u * n).to(torch.int32), n - 1)
    return idx, torch.full_like(u, 1.0 / n)


# ---------------------------------------------------------------------------
# traced emission: radiance arriving from the first hit along wi
# ---------------------------------------------------------------------------

def trace_radiance(scene, p, ns, wi):
    """Closest-hit trace from (offset) p along wi; returns (hit, Le (R,C),
    light_id) where Le is the emission of whatever was hit, toward p
    (lightIsect.Le(-wi) in portal_arealight.cpp:140-148)."""
    o = vecmath.offset_ray_origin(p, ns, wi)
    tmax = torch.full(p.shape[:1], vecmath.INF, device=p.device)
    hit = isect_mod.intersect(scene, o, wi, tmax)
    light_id = scene.light_at(hit.prim_id)
    light_id = torch.where(hit.valid, light_id, -1)
    g = lights_mod.gather_lights(scene.lights, light_id.clamp_min(0))
    le = lights_mod.area_light_L(g.emit, g.two_sided, hit.ng, -wi)
    le = torch.where((light_id >= 0)[..., None], le, 0.0)
    return hit, le, light_id


# ---------------------------------------------------------------------------
# EstimateDirect (core/integrator.cpp:124-258 + portal dispatch :130-133)
# ---------------------------------------------------------------------------

def estimate_direct(scene, hit, mp, wo_world, u_select, u_light, u_scatter,
                    u_bsdf_lobe, power_distr=None, with_bsdf_half=True):
    """One-light NEE estimate at shading points ``hit`` with materials
    ``mp`` (gathered rows), kd resolved through the rows' textures.
    Returns Ld (R,C).

    Standard lights: two-sample MIS (light strategy + BSDF strategy) as
    EstimateDirect; portal area lights (fork): strategy-dispatched single
    sample estimators per portal_arealight.cpp:29-239 (no MIS), including
    the behind-all-portals fallback to plain light sampling.

    The BSDF-strategy half only ever contributes for an area light
    without portals or an infinite light; a scene with neither skips its
    trace."""
    lt = scene.lights
    light_idx, sel_pmf = choose_light(scene, u_select, power_distr)
    g = lights_mod.gather_lights(lt, light_idx)
    is_portal_light = (g.ltype == AREA) & (g.n_portals > 0)

    t1, t2 = shading_frame(hit, mp)
    wo = to_local(t1, t2, hit.ns, wo_world)
    kd_eff = tex_mod.resolve_kd(scene, mp, hit, wo=wo_world)

    # ---- light-strategy sample (Sample_Li)
    ls = lights_mod.sample_li(scene, light_idx, hit.p, u_light)

    # ---- portal strategy directions (only when the scene has portal
    # lights; the reference's dynamic_cast dispatch at integrator.cpp:130
    # likewise never runs without one)
    if lt.has_portals:
        in_front = portals_mod.portals_in_front(hit.p, g)
        pidx, psel_pdf, behind_all = portals_mod.select_visible_portal(
            in_front, u_select)
        ap = lights_mod.gather_area_prim(scene, g.prim_id)
        wi_port, pdf_port, _ = portals_mod.sample_portal(g, pidx, hit.p,
                                                         u_light)
        # projection needs the light rect (aaplane-backed portal lights)
        wi_proj, pdf_proj, _ = portals_mod.sample_projection(
            g, pidx, ap.lo, ap.hi, ap.ax, hit.p, u_light)

        use_portal_dir = (is_portal_light & ~behind_all
                          & (g.strategy != STRAT_LIGHT))
        use_proj = use_portal_dir & (g.strategy == STRAT_PROJECTION)
        wi_nee = torch.where(
            use_portal_dir[..., None],
            torch.where(use_proj[..., None], wi_proj, wi_port), ls["wi"])
        pdf_nee = torch.where(use_portal_dir,
                              torch.where(use_proj, pdf_proj, pdf_port),
                              ls["pdf"])
    else:
        is_portal_light = torch.zeros_like(is_portal_light)
        use_proj = is_portal_light
        psel_pdf = torch.ones_like(u_select)
        wi_nee = ls["wi"]
        pdf_nee = ls["pdf"]

    # ---- one closest-hit trace serves visibility AND portal emission
    hit2, le2, hit2_light = trace_radiance(scene, hit.p, hit.ns, wi_nee)

    # received radiance per branch
    dist = vecmath.length(ls["p_light"] - hit.p)
    blocked_delta = hit2.valid & (hit2.t < dist * (1.0 - 1e-3))
    li_delta = torch.where(blocked_delta[..., None], 0.0, ls["li"])
    li_area = torch.where((hit2_light == light_idx)[..., None], ls["li"], 0.0)
    # an infinite light's sample arrives when the ray escapes
    li_inf = torch.where(hit2.valid[..., None], 0.0, ls["li"])
    is_inf = g.ltype == lights_mod.INFINITE
    li_std = torch.where(ls["is_delta"][..., None], li_delta,
                         torch.where(is_inf[..., None], li_inf, li_area))
    # portal estimators: whatever emitter the ray hits
    li = torch.where(is_portal_light[..., None], le2, li_std)

    # ---- BSDF at the sampled direction
    wi_loc = to_local(t1, t2, hit.ns, wi_nee)
    f = mat_mod.bsdf_f(mp, wo, wi_loc, kd_override=kd_eff) \
        * absdot(wi_nee, hit.ns)[..., None]
    scatter_pdf = mat_mod.bsdf_pdf(mp, wo, wi_loc)

    # ---- combine
    ok = (pdf_nee > 0.0) & hit.valid
    # standard: delta lights weight 1; area lights power-heuristic MIS
    w_mis = torch.where(ls["is_delta"], 1.0,
                        power_heuristic(1.0, pdf_nee, 1.0, scatter_pdf))
    ld_std = f * li * (w_mis / torch.clamp_min(pdf_nee, 1e-20))[..., None]

    # portal single-sample estimators
    #   strategy 'portal': f*Li/pdf (NOT divided by the selection pmf:
    #   portal_arealight.cpp:103-109 returns EstimateDirectPortal directly)
    #   strategy 'projection': (f*Li/pdf) / portalPdf (:108)
    #   strategy 'light' or behind-all: f*Li/lightPdf (:115-160)
    ld_portal = f * li / torch.clamp_min(pdf_nee, 1e-20)[..., None]
    ld_portal = torch.where(
        use_proj[..., None],
        ld_portal / torch.clamp_min(psel_pdf, 1e-20)[..., None], ld_portal)

    ld = torch.where(is_portal_light[..., None], ld_portal, ld_std)
    ld = torch.where(ok[..., None], ld, 0.0)

    # ---- BSDF-strategy half of two-sample MIS (non-portal, non-delta)
    if with_bsdf_half and lights_mod.takes_bsdf_half(lt):
        wi_b_loc, f_b, pdf_b, flags = mat_mod.bsdf_sample(
            mp, wo, u_bsdf_lobe, u_scatter, kd_override=kd_eff)
        wi_b = to_world(t1, t2, hit.ns, wi_b_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        f_b = f_b * absdot(wi_b, hit.ns)[..., None]
        hit3, le3, hit3_light = trace_radiance(scene, hit.p, hit.ns, wi_b)
        # radiance only counts when this very light is hit, or the ray
        # escapes to the chosen infinite light
        li_b = torch.where((hit3_light == light_idx)[..., None], le3, 0.0)
        li_b = torch.where((is_inf & ~hit3.valid)[..., None],
                           lights_mod.escaped_radiance(scene, wi_b), li_b)
        light_pdf_b = lights_mod.pdf_li(scene, light_idx, hit.p, wi_b)
        w_b = power_heuristic(1.0, pdf_b, 1.0, light_pdf_b)
        ld_b = f_b * li_b * (w_b / torch.clamp_min(pdf_b, 1e-20))[..., None]
        # EstimateDirect samples with BSDF_ALL & ~BSDF_SPECULAR
        # (integrator.cpp:128,186): specular lobes are handled by the path
        # continuation, so exclude them here
        ld_b = torch.where((hit.valid & ~ls["is_delta"] & ~is_portal_light
                            & (pdf_b > 0) & ~is_spec)[..., None], ld_b, 0.0)
        ld = ld + ld_b

    # divide by the light-selection pmf (UniformSampleOneLight,
    # integrator.cpp:116-121)
    return ld / torch.clamp_min(sel_pmf, 1e-20)[..., None]
