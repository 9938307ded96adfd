"""Shared integrator machinery: shading frames, light selection, next
event estimation with MIS and the portal dispatch, and the subsurface
transport (port of pbrt_tpu/integrators/common.py).

Counterpart of ``core/integrator.cpp``'s UniformSampleOneLight and
EstimateDirect, including the fork's portal dispatch, of the uniform and
power light distributions, and of SeparableBSSRDF::Sample_S
(core/bssrdf.cpp:234-353) as path.cpp's BSSRDF block runs it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (power_heuristic,
                                          sample_distribution_1d_discrete)
from pbrt_tpu_torch.core.vecmath import absdot, dot
from pbrt_tpu_torch.scene import bssrdf as bssrdf_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lightdistrib
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
    """Shading basis; for HAIR rows t1 lies along the fiber's tangent
    ∂p/∂u (the BSDF's ss = dpdu, core/reflection.h:170; hair.cpp's frame
    has x along the fiber)."""
    t1, t2 = make_frame(hit.ns)
    if mp is not None and mp.has_hair and hit.dpdu is not None:
        fiber = hit.dpdu - dot(hit.dpdu, hit.ns)[..., None] * hit.ns
        ok = vecmath.length_squared(fiber) > 1e-12
        fiber = vecmath.normalize(torch.where(ok[..., None], fiber, t1))
        is_hair = (mp.mtype == mat_mod.HAIR)[..., None]
        t1, t2 = (torch.where(is_hair, fiber, t1),
                  torch.where(is_hair, vecmath.cross(hit.ns, fiber), t2))
    return t1, t2


def hair_offset(mp, hit):
    """The hair's offset h = 2v − 1 ∈ [−1, 1] across the curve's width,
    from the hit's v (curve.cpp); None when no row is HAIR."""
    if not mp.has_hair:
        return None
    return torch.clamp(2.0 * hit.uv[..., 1] - 1.0, -1.0, 1.0)


def to_local(t1, t2, n, w):
    return torch.stack([dot(w, t1), dot(w, t2), dot(w, n)], dim=-1)


def to_world(t1, t2, n, w):
    return w[..., 0:1] * t1 + w[..., 1:2] * t2 + w[..., 2:3] * n


# ---------------------------------------------------------------------------
# light selection (lightdistrib.h Uniform/Power)
# ---------------------------------------------------------------------------

def choose_light(scene, u, power_distr=None, p=None):
    """Pick a light per ray. Returns (idx (R,), select_pmf (R,)).
    ``power_distr`` is a Distribution1D (power strategy), a
    SpatialLightDistribution (spatial strategy, drawn in the voxel of the
    shading point ``p``; without ``p``, in the voxel of the world origin,
    as pbrt_tpu does) or None (uniform): the three lightdistrib.h
    variants."""
    if isinstance(power_distr, lightdistrib.SpatialLightDistribution):
        if p is None:
            p = torch.zeros(u.shape + (3,), device=u.device)
        return lightdistrib.sample_spatial(power_distr, scene, p, u)
    if power_distr is not None:
        return sample_distribution_1d_discrete(power_distr, u)
    n = scene.lights.n
    idx = torch.clamp_max((u * n).to(torch.int32), n - 1)
    return idx, torch.full_like(u, 1.0 / n)


# ---------------------------------------------------------------------------
# traced emission: radiance arriving from the first hit along wi
# ---------------------------------------------------------------------------

def trace_radiance(scene, p, ns, wi, time=None):
    """Closest-hit trace from (offset) p along wi, at the rays' shutter
    times ``time`` on a scene with motion; returns (hit, Le (R,C),
    light_id) where Le is the emission of whatever was hit, toward p
    (lightIsect.Le(-wi) in portal_arealight.cpp:140-148)."""
    o = vecmath.offset_ray_origin(p, ns, wi)
    tmax = torch.full(p.shape[:1], vecmath.INF, device=p.device)
    hit = isect_mod.intersect(scene, o, wi, tmax, time=time)
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
                    u_bsdf_lobe, power_distr=None, with_bsdf_half=True,
                    time=None):
    """One-light NEE estimate at shading points ``hit`` with materials
    ``mp`` (gathered rows), kd resolved through the rows' textures.
    Returns Ld (R,C).

    Standard lights: two-sample MIS (light strategy + BSDF strategy) as
    EstimateDirect; portal area lights (fork): strategy-dispatched single
    sample estimators per portal_arealight.cpp:29-239 (no MIS), including
    the behind-all-portals fallback to plain light sampling.

    The BSDF-strategy half only ever contributes for an area light
    without portals or an infinite light; a scene with neither skips its
    trace. ``time``: the rays' shutter times on a scene with motion, which
    both traces take (the light samples themselves do not move, as in
    pbrt_tpu)."""
    lt = scene.lights
    light_idx, sel_pmf = choose_light(scene, u_select, power_distr,
                                      p=hit.p)
    g = lights_mod.gather_lights(lt, light_idx)
    is_portal_light = (g.ltype == AREA) & (g.n_portals > 0)

    t1, t2 = shading_frame(hit, mp)
    wo = to_local(t1, t2, hit.ns, wo_world)
    kd_eff = tex_mod.resolve_kd(scene, mp, hit, wo=wo_world)
    h_hair = hair_offset(mp, hit)

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
    hit2, le2, hit2_light = trace_radiance(scene, hit.p, hit.ns, wi_nee,
                                           time=time)

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
    f = mat_mod.bsdf_f(mp, wo, wi_loc, kd_override=kd_eff, h=h_hair,
                       fourier=scene.fourier) \
        * absdot(wi_nee, hit.ns)[..., None]
    scatter_pdf = mat_mod.bsdf_pdf(mp, wo, wi_loc, h=h_hair,
                                   fourier=scene.fourier)

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
            mp, wo, u_bsdf_lobe, u_scatter, kd_override=kd_eff, h=h_hair,
            fourier=scene.fourier)
        wi_b = to_world(t1, t2, hit.ns, wi_b_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        f_b = f_b * absdot(wi_b, hit.ns)[..., None]
        hit3, le3, hit3_light = trace_radiance(scene, hit.p, hit.ns, wi_b,
                                               time=time)
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


# ---------------------------------------------------------------------------
# subsurface scattering (core/bssrdf.{h,cpp} SeparableBSSRDF, materials/
# {subsurface,kdsubsurface,disney}.cpp)
# ---------------------------------------------------------------------------

# probe-chain steps a bounce (pbrt's chain is unbounded; pbrt_tpu's bound)
N_CHAIN = 8


def subsurface_transport(scene, hit, mp, beta, wo_world, pid, sidx, sfn,
                         seed, dims, time=None, eligible=None):
    """Separable-BSSRDF transport at the lanes that hit a SUBSURFACE row
    or a solid Disney row with scatterdistance, as pbrt_tpu runs it.

    A SUBSURFACE lane reflects specularly with probability Fr (its row
    becomes MIRROR for the bounce) or enters; a Disney lane enters through
    the census's delta-transmission slot with probability 1/n and weight
    n·(1 − Fr). An entering lane picks a projection axis (normal ½, the
    two tangents ¼ each) and a channel, both from one uniform, samples an
    exit radius from that channel's profile (``bssrdf.sample_sr``) and
    walks a probe segment of half-length √(rMax² − r²) through the disk
    point, in ``N_CHAIN`` closest-hit queries on the scene's kernels. Of
    the admissible hits (a SUBSURFACE hit for a SUBSURFACE lane: pbrt_tpu
    admits by family; the same row for a Disney lane) one is picked
    uniformly and the pdf divided by their count. The lane moves to the
    exit with weight Sr / Pdf_Sp (the three-axis MIS, clamped at 1e3;
    a Disney row also times its reflectance diffuseWeight·color), its row
    becomes SSS_EXIT (the Sw lobe) and wo points along the exit's shading
    normal. A lane with no admissible exit dies. ``eligible`` leaves out
    lanes that are not at a surface vertex this bounce (volpath's medium
    events). ``time``: the rays' shutter times, which the probe queries
    take on a scene with motion.

    Returns (hit', mp', beta', entered, wo')."""
    C = scene.n_channels
    R = hit.p.shape[0]
    valid = hit.valid if eligible is None else hit.valid & eligible
    is_tab = (mp.mtype == mat_mod.SUBSURFACE) & valid
    has_dis = scene.materials.has_disney_sss
    if has_dis:
        is_dis = ((mp.mtype == mat_mod.DISNEY) & mat_mod._disney_sss_mask(mp)
                  & valid)
    else:
        is_dis = torch.zeros_like(is_tab)
    sseed = seed ^ 0x5550
    u_f = sfn(pid, sidx, dims["select"], sseed)
    u_ch = sfn(pid, sidx, dims["mis_lobe"], sseed)
    u_r = sfn(pid, sidx, dims["light_u"][0], sseed)
    u_phi = sfn(pid, sidx, dims["light_u"][1], sseed)

    # the interface's Fresnel about the outward-facing normal, so a mesh's
    # winding cannot flip a lane into the total-reflection branch
    ns_o = vecmath.face_forward(hit.ns, wo_world)
    cos_o = dot(wo_world, ns_o)
    f_in = mat_mod.fr_dielectric(cos_o, torch.ones_like(cos_o), mp.eta)
    spec_refl = is_tab & (u_f < f_in)
    enter = is_tab & ~spec_refl
    if has_dis:
        # BSDF::Sample_f picks the delta entry with probability 1/n and
        # divides its pdf by the matching count (reflection.h:575-580):
        # the surviving weight is n·(1 − Fr); Fr only attenuates
        n_dis = mat_mod._disney_lobe_counts(mp)[4]
        p_entry = 1.0 / torch.clamp_min(n_dis, 1.0)
        enter_dis = is_dis & (u_f < p_entry)
        enter = enter | enter_dis
        beta = torch.where(enter_dis[:, None],
                           beta * (n_dis * (1.0 - f_in))[:, None], beta)

    # the projection axis (Sample_Sp:336-353: ns ½, ss ¼, ts ¼) and the
    # channel (uniform, :355-357), both folded into u_ch as pbrt reuses u1
    tabs = scene.sss
    mat_id = scene.mat_at(hit.prim_id)
    t1, t2 = make_frame(ns_o)
    ax = torch.where(u_ch < 0.5, 0, torch.where(u_ch < 0.75, 1, 2))
    u_ch2 = torch.where(u_ch < 0.5, u_ch * 2.0,
                        torch.where(u_ch < 0.75, (u_ch - 0.5) * 4.0,
                                    (u_ch - 0.75) * 4.0))

    def pick3(a, b, c):
        axn = ax[:, None]
        return torch.where(axn == 0, a, torch.where(axn == 1, b, c))

    # (vx, vy, vz): normal axis (t1, t2, ns), ss axis (t2, ns, t1), ts
    # axis (ns, t1, t2)
    vx = pick3(t1, t2, ns_o)
    vy = pick3(t2, ns_o, t1)
    vz = pick3(ns_o, t1, t2)
    ch = torch.clamp_max((u_ch2 * C).to(torch.int32), C - 1)
    row_id = mat_id.clamp_min(0) * C + ch
    r, r_valid = bssrdf_mod.sample_sr(tabs, row_id,
                                      u_r.clamp(1e-6, 1.0 - 1e-6))
    rmax_c = vecmath.take(tabs.r_max, bssrdf_mod._rows(tabs, row_id))
    in_prof = r_valid & (r > 0) & (r < rmax_c)
    r = torch.minimum(torch.clamp_min(r, 1e-5), torch.clamp_min(rmax_c,
                                                                2e-5))

    # the probe segment of length 2·√(rMax² − r²) through the disk point,
    # along −vz (Sample_Sp:359-366)
    phi = 2.0 * math.pi * u_phi
    disk = (torch.cos(phi)[:, None] * vx + torch.sin(phi)[:, None] * vy) \
        * r[:, None]
    h_probe = torch.clamp_min(torch.sqrt(torch.clamp_min(
        rmax_c * rmax_c - r * r, 0.0)), 1e-3)
    o_cur = hit.p + disk + vz * h_probe[:, None]
    t_rem = 2.0 * h_probe
    eps = 1e-4 * torch.clamp_min(h_probe, 1.0)
    # the intersection chain (Sample_Sp:294-329): walk the segment and
    # collect the admissible hits
    mtypes = scene.materials.mtype
    chain = []
    for _ in range(N_CHAIN):
        pr = isect_mod.intersect(scene, o_cur, -vz, t_rem,
                                 surface_only=True, time=time)
        pr_mat = scene.mat_at(pr.prim_id)
        adm_kind = vecmath.take(mtypes, pr_mat.long().clamp(
            0, mtypes.shape[0] - 1)) == mat_mod.SUBSURFACE
        if has_dis:
            # pbrt admits hits on the same material (Sample_Sp:311); a
            # Disney lane matches its row exactly, a SUBSURFACE lane its
            # family (pbrt_tpu's approximation)
            adm_kind = torch.where(is_dis, pr_mat == mat_id, adm_kind)
        chain.append((pr.valid & adm_kind, pr))
        o_cur = pr.p - vz * eps[:, None]
        t_rem = torch.clamp_min(t_rem - pr.t - eps, 0.0)
    n_found = sum(a.to(torch.int32) for a, _ in chain)
    # a uniform pick among the admissible hits, by the rest of u_ch
    u_pick = u_ch2 * C - ch.to(torch.float32)
    sel = torch.minimum((u_pick * n_found).to(torch.int32),
                        torch.clamp_min(n_found - 1, 0))
    rank = torch.zeros_like(sel)
    first = chain[0][1]
    pick_p, pick_ns, pick_ng = first.p, first.ns, first.ng
    for a, pr in chain:
        take = a & (rank == sel)
        pick_p = torch.where(take[:, None], pr.p, pick_p)
        pick_ns = torch.where(take[:, None], pr.ns, pick_ns)
        pick_ng = torch.where(take[:, None], pr.ng, pick_ng)
        rank = rank + a.to(torch.int32)
    ok = enter & in_prof & (n_found > 0)

    # Sp and Pdf_Sp at the exit (bssrdf.cpp:198-231, 331-353): the value
    # Sr_c(|pi − po|), the pdf Σ_axis P(axis)·|n_exit·axis|·mean_c
    # Pdf_Sr_c(radius projected along the axis). The exit normal is the
    # surface's own (pbrt's pi.shading.n), not one facing the entry
    d_vec = hit.p - pick_p
    dl = torch.stack([dot(d_vec, t1), dot(d_vec, t2), dot(d_vec, ns_o)],
                     dim=-1)
    nl = torch.stack([dot(pick_ns, t1), dot(pick_ns, t2),
                      dot(pick_ns, ns_o)], dim=-1)
    r_act = torch.clamp_min(vecmath.length(d_vec), 1e-6)
    r_proj = torch.clamp_min(torch.stack([
        torch.sqrt(dl[:, 1] ** 2 + dl[:, 2] ** 2),       # along ss
        torch.sqrt(dl[:, 2] ** 2 + dl[:, 0] ** 2),       # along ts
        torch.sqrt(dl[:, 0] ** 2 + dl[:, 1] ** 2),       # along ns
    ], dim=-1), 1e-6)
    sr_all = []
    pdf_axis_sum = 0.0
    base_row = mat_id.clamp_min(0) * C
    for c in range(C):
        (sr_c, p_ss, p_ts, p_ns), _, rhoeff_c = bssrdf_mod.eval_profile_multi(
            tabs, base_row + c,
            [r_act, r_proj[:, 0], r_proj[:, 1], r_proj[:, 2]])
        sr_all.append(sr_c)
        inv_rho = 1.0 / torch.clamp_min(rhoeff_c, 1e-6)
        pdf_axis_sum = pdf_axis_sum + inv_rho * (
            p_ss * nl[:, 0].abs() * 0.25
            + p_ts * nl[:, 1].abs() * 0.25
            + p_ns * nl[:, 2].abs() * 0.5)
    sr_all = torch.stack(sr_all, dim=-1)
    # the pdf over the uniform pick among the chain's hits (Sample_Sp:327)
    pdf_mix = pdf_axis_sum / C / torch.clamp_min(n_found, 1)
    # no second (1 − Fr): the entry was chosen with probability 1 − Fr
    w_ss = sr_all / torch.clamp_min(pdf_mix, 1e-12)[:, None]
    # a probe in another channel's profile tail gives unbounded ratios
    w_ss = torch.clamp_max(w_ss, 1e3)
    if has_dis:
        # the Disney rows tabulate the normalized profile: the reflectance
        # R = diffuseWeight·color (disney.cpp:524-525, textured at the
        # entry) scales it here
        kd_here = torch.clamp_min(tex_mod.resolve_kd(scene, mp, hit), 0.0)
        dw_dis = ((1.0 - mp.metallic) * (1.0 - mp.spec_trans))[:, None]
        w_ss = torch.where(is_dis[:, None], w_ss * kd_here * dw_dis, w_ss)

    # no admissible exit: the sample dies (path.cpp's `if (S.IsBlack() ||
    # pdf == 0) break`)
    dead = enter & ~ok
    new_hit = dataclasses.replace(
        hit,
        p=torch.where(ok[:, None], pick_p, hit.p),
        ns=torch.where(enter[:, None],
                       torch.where(ok[:, None], pick_ns, ns_o), hit.ns),
        ng=torch.where(ok[:, None], pick_ng, hit.ng))
    white = torch.ones((R, C), device=beta.device)
    # the exit lobe SSS_EXIT (SeparableBSSRDFAdapter's Sw,
    # core/bssrdf.h:87-95)
    new_mp = dataclasses.replace(
        mp,
        mtype=torch.where(spec_refl, mat_mod.MIRROR,
                          torch.where(enter, mat_mod.SSS_EXIT, mp.mtype)),
        kd=torch.where(enter[:, None], white, mp.kd),
        kr=torch.where(spec_refl[:, None], white, mp.kr))
    new_beta = torch.where(ok[:, None], beta * w_ss,
                           torch.where(dead[:, None], 0.0, beta))
    # pbrt re-points wo along the exit's shading normal (Sample_Sp:369)
    wo_eff = torch.where(ok[:, None], new_hit.ns, wo_world)
    return new_hit, new_mp, new_beta, enter, wo_eff
