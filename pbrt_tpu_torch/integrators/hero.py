"""Hero-wavelength spectral sampling (HWSS) integrators (port of
pbrt_tpu/integrators/hero.py).

- The hero base: packets of four wavelengths drawn from the lights'
  summed power spectrum with West et al.'s rotation
  (integrators/hero.{h,cpp}:46-48,59-65,125-134; nWvls = 4, hero.h:57).
- ``hero_path`` (integrators/hero_path.cpp): BSDF sampling only. On the
  first dispersive transmission the throughput collapses to the packet's
  bins, per-wavelength pdf products ``path_wvl_pdf`` accumulate, and
  emission is weighted by 1/(wvlPdf · Σᵢ pathWvlPdfᵢ).
- ``hero_path_mis`` (integrators/hero_path_mis.cpp): adds next event
  estimation, weighted against BSDF sampling by the HWSS MIS weights of
  Wilkie et al. 2014 (:183-218, :256-270) after the collapse and by the
  balance heuristic before it.

A scene must carry 60-bin (SAMPLED) spectra; the radiance is (R, 60) and
the film converts with ``core/spectrum.py::spectrum_to_rgb``. Dispersive
glass takes eta(λ) of the hero wavelength (Cauchy,
materials/dispersive_glass.cpp:62-64) through ``bsdf_sample``'s
``eta_override``; the packet's other wavelengths see its delta lobe as 0.

The loop is a Python loop of ``max_depth + 1`` bounces with active masks,
as ``render._li_loop``: the last bounce collects emission only (no shadow
ray, no continuation), so a pass launches the closest-hit query
``max_depth + 1`` times and, with next event estimation, the shadow query
``max_depth`` times, known before it runs.
"""

from __future__ import annotations

import math

import torch

from pbrt_tpu_torch.core import spectrum as spec_mod
from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.vecmath import absdot, dot
from pbrt_tpu_torch.integrators import common
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import shapes

N_WVLS = 4          # hero.h:57
DIM_WVL = 5         # the sample dimension of the wavelength uniform


def sample_hero_wavelengths(scene, pid, sidx, sfn, seed):
    """hero.cpp:125-134: rotate one uniform into four and invert the
    lights' power spectrum's CDF. Returns (λ (R,4), bin (R,4) int32,
    bin pmf (R,4))."""
    distr = spec_mod.make_spectral_distribution(scene.lights.power.sum(0))
    u0 = sfn(pid, sidx, DIM_WVL, seed)
    wvls, pmfs = zip(*(spec_mod.sample_wavelength(
        distr, spec_mod.rotate_sample(u0, i, N_WVLS))
        for i in range(N_WVLS)))
    wvls = torch.stack(wvls, dim=-1)
    return wvls, spec_mod.index_from_wavelength(wvls), torch.stack(pmfs, -1)


def _wvl_pdf_spectrum(idx, pmfs, C):
    """The wvlPdf spectrum: ones but the packet's bins, which hold their
    pmf, the later wavelength's where two share a bin
    (hero_path.cpp:75-79)."""
    chan = torch.arange(C, device=idx.device)
    out = torch.ones((idx.shape[0], C), device=idx.device)
    for i in range(N_WVLS):
        out = torch.where(chan == idx[:, i:i + 1], pmfs[:, i:i + 1], out)
    return out


def _scatter_bins(idx, vals, C):
    """(R,4) values → an (R,C) spectrum holding each at its bin (+=)."""
    chan = torch.arange(C, device=idx.device)
    out = torch.zeros((idx.shape[0], C), device=idx.device)
    for i in range(N_WVLS):
        out = out + torch.where(chan == idx[:, i:i + 1], vals[:, i:i + 1],
                                0.0)
    return out


def _at_bins(spec, idx):
    """spec (R,C) read at the packet's bins idx (R,4) → (R,4)."""
    return torch.gather(spec, -1, idx.long().clamp(0, spec.shape[-1] - 1))


def _pdf_emitter_hero(scene, hit, light_id, d_cur):
    """PdfEmitterHero (hero_path_mis.cpp:46-78): the hit emitter's area
    density in solid angle times the uniform light-selection pmf."""
    gl = lights_mod.gather_lights(scene.lights, light_id.clamp_min(0))
    ap = lights_mod.gather_area_prim(
        scene, torch.where(light_id >= 0, gl.prim_id, -1))
    area = torch.where(
        ap.is_pln, shapes.aaplane_area(ap.lo, ap.hi, ap.ax),
        torch.where(ap.is_sph, 4.0 * math.pi * ap.radius * ap.radius,
                    shapes.triangle_area(ap.v0, ap.v1, ap.v2)))
    em_pdf = (hit.t * hit.t) / torch.clamp_min(
        absdot(hit.ng, -d_cur) * area, 1e-9)
    return torch.where(light_id >= 0, em_pdf / scene.lights.n, 0.0)


def _li_hero(scene, o, d, pid, sidx, sfn, cfg, power_distr, use_nee):
    """The HWSS wavefront loop shared by hero_path and hero_path_mis."""
    from pbrt_tpu_torch.integrators.render import _bounce_dims, _sample2

    R = o.shape[0]
    C = scene.n_channels
    dev = o.device
    if C != spec_mod.N_SPECTRAL_SAMPLES:
        raise ValueError("the hero integrators need a scene built with "
                         "SAMPLED (60-bin) spectra")
    wvls, wvl_idx, wvl_pmfs = sample_hero_wavelengths(scene, pid, sidx, sfn,
                                                      cfg.seed)
    # pbrt_tpu traces the bounce dims inside its fori_loop (the halton
    # sampler's second formula); the wavelength dim outside it
    sfn = getattr(sfn, "in_loop", sfn)
    wvl_pdf = _wvl_pdf_spectrum(wvl_idx, wvl_pmfs, C)
    hero_bin = wvl_idx[:, 0]

    L = torch.zeros((R, C), device=dev)
    beta = torch.ones((R, C), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    is_wvl_dep = torch.zeros(R, dtype=torch.bool, device=dev)
    last_spec = torch.zeros(R, dtype=torch.bool, device=dev)
    path_wvl_pdf = torch.ones((R, N_WVLS), device=dev)
    prev_path_wvl_pdf = torch.ones((R, N_WVLS), device=dev)
    bsdf_pdf_prev = torch.zeros(R, device=dev)
    eta_scale = torch.ones(R, device=dev)
    o_cur, d_cur = o, d
    inf = torch.full((R,), vecmath.INF, device=dev)

    for b in range(cfg.max_depth + 1):
        last = b == cfg.max_depth
        dims = _bounce_dims(b)
        hit = isect_mod.intersect(scene, o_cur, d_cur, inf)

        light_id = torch.where(hit.valid, scene.light_at(hit.prim_id), -1)
        gl = lights_mod.gather_lights(scene.lights, light_id.clamp_min(0))
        le = lights_mod.area_light_L(gl.emit, gl.two_sided, hit.ng, -d_cur)
        le = torch.where((light_id >= 0)[..., None], le, 0.0)
        env = lights_mod.escaped_radiance(scene, d_cur)
        emit = torch.where(hit.valid[..., None], le, env)

        if use_nee:
            # MIS against emitter sampling: area emitters by
            # PdfEmitterHero, escaped rays by the infinite light's Pdf_Li
            # (hero_path_mis.cpp:160-171)
            em_pdf = torch.where(hit.valid,
                                 _pdf_emitter_hero(scene, hit, light_id,
                                                   d_cur),
                                 lights_mod.infinite_pdf_li(scene, d_cur))
            em_pdf = torch.where(last_spec, 0.0, em_pdf) if b else \
                torch.zeros_like(em_pdf)
            denom_h = wvl_pdf * (path_wvl_pdf + prev_path_wvl_pdf
                                 * em_pdf[..., None]).sum(-1)[..., None]
            w_hwss = 1.0 / torch.clamp_min(denom_h, 1e-20)
            w_scalar = (torch.ones_like(em_pdf) if b == 0 else torch.where(
                last_spec, 1.0, bsdf_pdf_prev / torch.clamp_min(
                    bsdf_pdf_prev + em_pdf, 1e-20)))[..., None]
        else:
            # hero_path: no MIS, but the collapse still divides by
            # wvlPdf·Σ pathWvlPdf (hero_path.cpp:94-110)
            w_hwss = 1.0 / torch.clamp_min(
                wvl_pdf * path_wvl_pdf.sum(-1)[..., None], 1e-20)
            w_scalar = 1.0
        w = torch.where(is_wvl_dep[..., None], w_hwss, w_scalar)
        L = L + torch.where(active[..., None], beta * emit * w, 0.0)
        if last:
            # the final iteration collects emission only
            # (hero_path_mis.cpp:228 breaks before the emitter sample)
            break

        active = active & hit.valid
        mp = mat_mod.gather_materials(scene.materials,
                                      scene.mat_at(hit.prim_id))
        t1, t2 = common.make_frame(hit.ns)
        wo = common.to_local(t1, t2, hit.ns, -d_cur)
        is_disp = mp.mtype == mat_mod.DISPERSIVE_GLASS

        if use_nee:
            # SampleEmitterHero (hero_path_mis.cpp:80-116, 199-238)
            u_sel = sfn(pid, sidx, dims["select"], cfg.seed)
            u_l = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
            light_idx, sel_pmf = common.choose_light(scene, u_sel,
                                                     power_distr)
            ls = lights_mod.sample_li(scene, light_idx, hit.p, u_l)
            vis = isect_mod.unoccluded(scene, hit.p, hit.ns,
                                       ls["p_light"]) \
                & (ls["pdf"] > 0) & active
            em_pdf_nee = ls["pdf"] * sel_pmf
            li = ls["li"] / torch.clamp_min(em_pdf_nee, 1e-20)[..., None]
            wi_loc = common.to_local(t1, t2, hit.ns, ls["wi"])
            f_nee = mat_mod.bsdf_f(mp, wo, wi_loc)
            pdf_nee_b = mat_mod.bsdf_pdf(mp, wo, wi_loc)
            # the HWSS against the scalar weight (:205-227): a dispersive
            # BSDF is a delta lobe, f = pdf = 0 at every wavelength
            f_h = _scatter_bins(wvl_idx, _at_bins(f_nee, wvl_idx)
                                * torch.where(is_disp[..., None], 0.0, 1.0),
                                C)
            pdf_h = torch.where(is_disp[..., None], 0.0,
                                pdf_nee_b[..., None]).expand(R, N_WVLS)
            denom = wvl_pdf * (path_wvl_pdf * em_pdf_nee[..., None]
                               + path_wvl_pdf * pdf_h).sum(-1)[..., None]
            w_nee_h = em_pdf_nee[..., None] / torch.clamp_min(denom, 1e-20)
            w_nee_s = (em_pdf_nee / torch.clamp_min(em_pdf_nee + pdf_nee_b,
                                                    1e-20))[..., None]
            use_h = (is_wvl_dep | is_disp)[..., None]
            f_sel = torch.where(use_h, f_h, f_nee)
            w_nee = torch.where(use_h, w_nee_h, w_nee_s)
            cosw = absdot(ls["wi"], hit.ns)[..., None]
            L = L + torch.where(vis[..., None],
                                beta * li * f_sel * cosw * w_nee, 0.0)

        # continuation: Sample_f at the hero wavelength
        u_cl = sfn(pid, sidx, dims["cont_lobe"], cfg.seed)
        u_cu = _sample2(sfn, pid, sidx, dims["cont_u"], cfg.seed)
        eta_hero = torch.where(is_disp, mat_mod.cauchy_eta(
            mp.cauchy_b, mp.cauchy_c, wvls[:, 0]), mp.eta)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(
            mp, wo, u_cl, u_cu, eta_override=eta_hero)
        wi = common.to_world(t1, t2, hit.ns, wi_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        is_trans = (flags & mat_mod.FLAG_TRANSMISSION) > 0
        cur_wvl_dep = is_disp & is_trans          # hero_path.cpp:144
        now_dep = is_wvl_dep | cur_wvl_dep

        cosw = absdot(wi, hit.ns)
        # scalar path: beta *= f cos / pdf
        beta_scalar = beta * f * (cosw / torch.clamp_min(pdf, 1e-20))[
            ..., None]
        # the HWSS path: collapse to the hero bin, no pdf divide
        # (:147-160); the rotated wavelengths take the same BSDF's f, but
        # a dispersive delta lobe gives them 0
        f_other = mat_mod.bsdf_f(mp, wo, wi_loc)
        pdf_other = mat_mod.bsdf_pdf(mp, wo, wi_loc)
        f_rot = torch.where(cur_wvl_dep[..., None], 0.0,
                            _at_bins(f_other, wvl_idx)[:, 1:])
        f_hwss = spec_mod.zero_all_bins_but(f, hero_bin) + _scatter_bins(
            wvl_idx, torch.cat([torch.zeros_like(f_rot[:, :1]), f_rot], -1),
            C)
        beta_hwss = beta * f_hwss * cosw[..., None]
        new_pwp = torch.cat(
            [path_wvl_pdf[:, :1] * pdf[..., None],
             path_wvl_pdf[:, 1:] * torch.where(cur_wvl_dep[..., None], 0.0,
                                               pdf_other[..., None])],
            dim=-1)
        beta_new = torch.where(now_dep[..., None], beta_hwss, beta_scalar)
        prev_pwp_new = torch.where(now_dep[..., None], path_wvl_pdf,
                                   prev_path_wvl_pdf)
        pwp_new = torch.where(now_dep[..., None], new_pwp, path_wvl_pdf)

        alive = active & (pdf > 0) & (beta_new.amax(dim=-1) > 0)
        eta2 = eta_hero * eta_hero
        eta_sc = torch.where(is_spec & is_trans,
                             torch.where(dot(-d_cur, hit.ng) > 0, eta2,
                                         1.0 / torch.clamp_min(eta2, 1e-9)),
                             1.0)
        eta_scale = eta_scale * torch.where(alive, eta_sc, 1.0)

        # russian roulette (:167-176)
        if b > 3:
            rr_max = beta_new.amax(dim=-1) * eta_scale
            q = torch.clamp_min(1.0 - rr_max, 0.05)
            u_rr = sfn(pid, sidx, dims["rr"], cfg.seed)
            do_rr = rr_max < cfg.rr_threshold
            killed = do_rr & (u_rr < q)
            beta_new = torch.where(
                (do_rr & ~killed)[..., None],
                beta_new / torch.clamp_min(1.0 - q, 1e-6)[..., None],
                beta_new)
            alive = alive & ~killed

        o_next = vecmath.offset_ray_origin(hit.p, hit.ng, wi)
        beta = torch.where(alive[..., None], beta_new, beta)
        o_cur = torch.where(alive[..., None], o_next, o_cur)
        d_cur = torch.where(alive[..., None], wi, d_cur)
        path_wvl_pdf = torch.where(alive[..., None], pwp_new, path_wvl_pdf)
        prev_path_wvl_pdf = torch.where(alive[..., None], prev_pwp_new,
                                        prev_path_wvl_pdf)
        is_wvl_dep = torch.where(alive, now_dep, is_wvl_dep)
        last_spec = torch.where(alive, is_spec, last_spec)
        bsdf_pdf_prev = torch.where(alive, pdf, bsdf_pdf_prev)
        active = alive
    return L


def li_hero_path(scene, o, d, pid, sidx, sfn, cfg, power_distr):
    """`hero_path` (integrators/hero_path.cpp)."""
    return _li_hero(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    use_nee=False)


def li_hero_path_mis(scene, o, d, pid, sidx, sfn, cfg, power_distr):
    """`hero_path_mis` (integrators/hero_path_mis.cpp)."""
    return _li_hero(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    use_nee=True)
