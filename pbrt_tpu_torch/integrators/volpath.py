"""Volumetric path tracing (port of pbrt_tpu/integrators/volpath.py).

Counterpart of ``integrators/volpath.cpp``: on every segment the lane's
current medium is sampled for a scattering event (volpath.cpp:55-79); a
medium interaction does next event estimation with transmittance-weighted
visibility and continues by Henyey–Greenstein phase sampling; a surface
interaction behaves as in `path`. Media attach per primitive
(MediumInterface): rays carry a medium id that switches where a
transmissive boundary is crossed (SurfaceInteraction::SpawnRay,
core/interaction.h:66-80), and shadow rays gather transmittance segment by
segment through null-material boundaries (VisibilityTester::Tr,
core/light.cpp:64-85).

Both halves of the two-sample MIS of NEE are taken at surface and medium
vertices, and a null boundary keeps the incoming specular state: the two
transport faults that tests/test_oracle.py:293-303 records in pbrt_tpu's
history are not repeated here.

The loop is a Python loop of ``max_depth + 1`` bounces with active masks,
as ``render._li_loop``: the last bounce samples the medium and collects
emission only. A bounce launches the closest-hit query nine times (the
bounce's ray, ``_TR_SEGMENTS`` segments of the shadow ray and as many of
the scattering-strategy ray), the last bounce once, whatever the data.
"""

from __future__ import annotations

import dataclasses

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.core.vecmath import absdot
from pbrt_tpu_torch.integrators import common
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import media as media_mod

# a shadow ray passes at most this many null-material boundaries
# (VisibilityTester::Tr's unbounded loop, bounded as in pbrt_tpu)
_TR_SEGMENTS = 4
_M32 = 0xFFFFFFFF


def _crossing_medium(scene, prim_id, entering):
    """The medium id past ``prim_id``: inside when entering."""
    idx = prim_id.long().clamp(0, scene.prim_med_in.shape[0] - 1)
    return torch.where(entering, scene.prim_med_in[idx],
                       scene.prim_med_out[idx])


def _is_null(scene, prim_id):
    return scene.materials.mtype[scene.mat_at(prim_id).long().clamp(
        0, scene.materials.mtype.shape[0] - 1)] == mat_mod.NONE


def _add_u32(seed, k: int):
    return (seed + k) & _M32


def tr_segmented(scene, media, med0, p0, p1, seed):
    """Transmittance p0 → p1 through up to _TR_SEGMENTS null-material
    boundaries (VisibilityTester::Tr): a real surface blocks; a null one
    adds the current medium's Tr and switches the medium. Returns
    ((R,C) Tr, (R,) blocked)."""
    R, C = p0.shape[0], scene.n_channels
    p, med = p0, med0
    tr = torch.ones((R, C), device=p0.device)
    done = torch.zeros(R, dtype=torch.bool, device=p0.device)
    blocked = done
    for i in range(_TR_SEGMENTS):
        seg = p1 - p
        dist = vecmath.length(seg)
        dn = seg / torch.clamp_min(dist, 1e-12)[..., None]
        hit = isect_mod.intersect(scene, p, dn, dist * (1.0 - 1e-3))
        null_mat = _is_null(scene, hit.prim_id)
        passes = hit.valid & null_mat
        p_seg_end = torch.where(hit.valid[..., None], hit.p, p1)
        tr_seg = media_mod.transmittance_set(media, med, p, p_seg_end,
                                             _add_u32(seed, i * 7919))
        tr = torch.where(done[..., None], tr, tr * tr_seg)
        blocked = blocked | (~done & hit.valid & ~null_mat)
        # cross the null boundary: switch medium, restart past the surface
        entering = vecmath.dot(dn, hit.ng) < 0
        cross = ~done & passes
        med = torch.where(cross, _crossing_medium(scene, hit.prim_id,
                                                  entering), med)
        p = torch.where(cross[..., None],
                        vecmath.offset_ray_origin(hit.p, hit.ng, dn), p)
        done = done | ~passes
    return torch.where(blocked[..., None], 0.0, tr), blocked


def _walk_to_real_surface(scene, media, o, wi, med, seed):
    """IntersectTr (scene.cpp:59-83), as EstimateDirect's scattering half
    with media uses it: walk through null boundaries, gathering each
    segment's Tr and switching media, to the first real surface or an
    escape. Returns (hit, (R,C) Tr)."""
    R, C = o.shape[0], scene.n_channels
    inf = torch.full((R,), vecmath.INF, device=o.device)
    tr = torch.ones((R, C), device=o.device)
    found = torch.zeros(R, dtype=torch.bool, device=o.device)
    far = 2.0 * scene.world_radius()
    hit = isect_mod.intersect(scene, o, wi, inf)
    for k in range(_TR_SEGMENTS):
        seg_end = torch.where(hit.valid[..., None], hit.p, o + far * wi)
        tr_k = media_mod.transmittance_set(media, med, o, seg_end,
                                           _add_u32(seed, k * 104729))
        tr = torch.where(found[..., None], tr, tr * tr_k)
        is_null = hit.valid & _is_null(scene, hit.prim_id)
        found = found | ~is_null          # a real hit or an escape
        if k == _TR_SEGMENTS - 1:
            break
        entering = vecmath.dot(wi, hit.ng) < 0
        med = torch.where(~found & is_null,
                          _crossing_medium(scene, hit.prim_id, entering), med)
        o = torch.where((~found)[..., None],
                        vecmath.offset_ray_origin(hit.p, hit.ng, wi), o)
        nxt = isect_mod.intersect(scene, o, wi, inf)
        hit = dataclasses.replace(nxt, **{
            f: torch.where(found if getattr(hit, f).ndim == 1
                           else found[..., None], getattr(hit, f),
                           getattr(nxt, f))
            for f in ("valid", "t", "p", "ng", "ns", "prim_id")})
    return hit, tr


def li_volpath(scene, o, d, pid, sidx, sfn, cfg, power_distr):
    """`volpath`. A scene without media renders as `path`."""
    from pbrt_tpu_torch.integrators.render import (_bounce_dims, _sample2,
                                                   li_path)
    media, cam_med = tuple(scene.media or ()), scene.camera_med
    if not media:
        return li_path(scene, o, d, pid, sidx, sfn, cfg, power_distr)
    sfn = getattr(sfn, "in_loop", sfn)
    R, C, dev = o.shape[0], scene.n_channels, o.device
    L = torch.zeros((R, C), device=dev)
    beta = torch.ones((R, C), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    specular = torch.ones(R, dtype=torch.bool, device=dev)
    o_cur, d_cur = o, d
    cur_med = torch.full((R,), cam_med, dtype=scene.prim_med_in.dtype,
                         device=dev)
    inf = torch.full((R,), vecmath.INF, device=dev)
    sseed = int(cfg.seed) ^ 0x777

    def nee_from(p, n, is_medium, cur_med, mp, wo_world, b, dims, hit):
        """NEE at a surface or a medium vertex (EstimateDirect with
        handleMedia, integrator.cpp:124-186): ``n`` is the shading normal,
        or −d at a medium vertex."""
        u_sel = sfn(pid, sidx, dims["select"], cfg.seed)
        u_l = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
        # no shading point, as in pbrt_tpu (volpath.py:128): under the
        # spatial strategy every lane draws from the voxel that holds
        # the world origin (unbiased; ROADMAP queue 3)
        light_idx, sel_pmf = common.choose_light(scene, u_sel, power_distr)
        ls = lights_mod.sample_li(scene, light_idx, p, u_l)
        ism = is_medium[..., None]
        p_from = torch.where(ism, p,
                             vecmath.offset_ray_origin(p, n, ls["wi"]))
        tr, blocked = tr_segmented(
            scene, media, cur_med, p_from, ls["p_light"],
            media_mod.seed_mix(pid, 2654435761, sidx, 0xb5297a4d, b))
        t1, t2 = common.shading_frame(hit, mp)
        m1, m2 = common.make_frame(n)
        t1 = torch.where(ism, m1, t1)
        t2 = torch.where(ism, m2, t2)
        wi_loc = common.to_local(t1, t2, n, ls["wi"])
        wo_loc = common.to_local(t1, t2, n, wo_world)
        h_hair = common.hair_offset(mp, hit)
        f_surf = mat_mod.bsdf_f(mp, wo_loc, wi_loc, h=h_hair,
                                fourier=scene.fourier) \
            * absdot(ls["wi"], n)[..., None]
        sp_surf = mat_mod.bsdf_pdf(mp, wo_loc, wi_loc, h=h_hair,
                                   fourier=scene.fourier)
        g_lane = media_mod.phase_g_set(media, cur_med)
        ph = media_mod.hg_phase(vecmath.dot(wo_world, ls["wi"]), g_lane)
        f = torch.where(ism, ph[..., None].expand(R, C), f_surf)
        sp = torch.where(is_medium, ph, sp_surf)
        light_pdf = ls["pdf"] * sel_pmf
        w = torch.where(ls["is_delta"], 1.0,
                        power_heuristic(1.0, light_pdf, 1.0, sp))
        ld = f * ls["li"] * tr * (
            w / torch.clamp_min(light_pdf, 1e-20))[..., None]
        ld = torch.where((~blocked & (ls["pdf"] > 0))[..., None], ld, 0.0)

        # the scattering-strategy half: sample the BSDF (surface) or the
        # phase function (medium), walk to the first real surface and
        # count this light's radiance with Tr and the power heuristic
        u_bl = sfn(pid, sidx, dims["mis_lobe"], sseed)
        u_bu = _sample2(sfn, pid, sidx, dims["mis_u"], sseed)
        wi_b_loc, f_b, pdf_b, flags_b = mat_mod.bsdf_sample(
            mp, wo_loc, u_bl, u_bu, h=h_hair, fourier=scene.fourier)
        wi_b_surf = common.to_world(t1, t2, n, wi_b_loc)
        wi_b_med, ph_b = media_mod.sample_hg(wo_world, u_bu, g_lane)
        wi_b = torch.where(ism, wi_b_med, wi_b_surf)
        f_b = torch.where(ism, ph_b[..., None].expand(R, C), f_b)
        pdf_b2 = torch.where(is_medium, ph_b, pdf_b)
        cos_b = torch.where(is_medium, 1.0, absdot(wi_b, n))
        is_spec_b = ~is_medium & ((flags_b & mat_mod.FLAG_SPECULAR) > 0)
        o_b = torch.where(ism, p, vecmath.offset_ray_origin(p, n, wi_b))
        hit_b, tr_b = _walk_to_real_surface(
            scene, media, o_b, wi_b, cur_med,
            media_mod.seed_mix(pid, 0x85ebca6b, sidx, 0x68e31da4, b))
        hit_b_light = torch.where(hit_b.valid,
                                  scene.light_at(hit_b.prim_id), -1)
        gb = lights_mod.gather_lights(scene.lights,
                                      light_idx.clamp_min(0))
        li_b = lights_mod.area_light_L(gb.emit, gb.two_sided, hit_b.ng,
                                       -wi_b)
        li_b = torch.where((hit_b_light == light_idx)[..., None], li_b, 0.0)
        is_inf_b = gb.ltype == lights_mod.INFINITE
        li_b = torch.where((is_inf_b & ~hit_b.valid)[..., None],
                           lights_mod.escaped_radiance(scene, wi_b), li_b)
        light_pdf_b = lights_mod.pdf_li(scene, light_idx, p, wi_b) * sel_pmf
        w_b = power_heuristic(1.0, pdf_b2, 1.0, light_pdf_b)
        ld_b = f_b * li_b * tr_b * (
            cos_b * w_b / torch.clamp_min(pdf_b2, 1e-20))[..., None]
        good_b = ~ls["is_delta"] & (pdf_b2 > 0) & ~is_spec_b
        return ld + torch.where(good_b[..., None], ld_b, 0.0)

    for b in range(cfg.max_depth + 1):
        dims = _bounce_dims(b)
        hit = isect_mod.intersect(scene, o_cur, d_cur, inf)
        t_max = torch.where(hit.valid, hit.t, 2.0 * scene.world_radius())

        # a medium event in the lane's current medium (volpath.cpp:55-66),
        # the tracking keyed on the pixel, the sample and the bounce
        u_med = sfn(pid, sidx, dims["mis_lobe"], cfg.seed)
        seed = media_mod.seed_mix(pid, 0x9e3779b9, sidx, 0x1b873593, b)
        t_m, in_medium, w_med, w_surf = media_mod.sample_distance_set(
            media, cur_med, o_cur, d_cur, t_max, u_med, seed)
        beta = torch.where(active[..., None],
                           beta * torch.where(in_medium[..., None], w_med,
                                              w_surf), beta)
        p_med = o_cur + t_m[..., None] * d_cur

        # emission on camera and specular surface vertices, attenuated
        light_id = torch.where(hit.valid, scene.light_at(hit.prim_id), -1)
        gl = lights_mod.gather_lights(scene.lights, light_id.clamp_min(0))
        le = lights_mod.area_light_L(gl.emit, gl.two_sided, hit.ng, -d_cur)
        le = torch.where((light_id >= 0)[..., None], le, 0.0)
        emit = torch.where(hit.valid[..., None], le,
                           lights_mod.escaped_radiance(scene, d_cur))
        take_emit = active & specular & ~in_medium
        L = L + torch.where(take_emit[..., None], beta * emit, 0.0)
        if b == cfg.max_depth:
            # the last bounce scatters no more (volpath.cpp:85,113)
            break

        mp = mat_mod.gather_materials(scene.materials,
                                      scene.mat_at(hit.prim_id))
        is_null = mp.mtype == mat_mod.NONE
        wo_w = -d_cur
        if scene.has_sss:
            # the BSSRDF block of path, as pbrt's volpath runs it
            # (volpath.cpp:151-163), at surface vertices only
            hit, mp, beta, _, wo_w = common.subsurface_transport(
                scene, hit, mp, beta, -d_cur, pid, sidx, sfn, cfg.seed,
                dims, eligible=~in_medium)
        # NEE from the vertex: the medium point or the surface point; a
        # null-material surface is not a scattering vertex
        p_v = torch.where(in_medium[..., None], p_med, hit.p)
        n_v = torch.where(in_medium[..., None], -d_cur, hit.ns)
        alive_v = active & (in_medium | (hit.valid & ~is_null))
        ld = nee_from(p_v, n_v, in_medium, cur_med, mp, wo_w, b, dims, hit)
        L = L + torch.where(alive_v[..., None], beta * ld, 0.0)

        # continuation: phase sampling in the medium, BSDF on a surface
        u_cl = sfn(pid, sidx, dims["cont_lobe"], cfg.seed)
        u_cu = _sample2(sfn, pid, sidx, dims["cont_u"], cfg.seed)
        # pbrt's convention: wo points back along the incoming ray, so
        # forward scattering (g > 0) keeps wi near d
        wi_med, _ = media_mod.sample_hg(
            -d_cur, u_cu, media_mod.phase_g_set(media, cur_med))
        t1, t2 = common.shading_frame(hit, mp)
        wo = common.to_local(t1, t2, hit.ns, wo_w)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(
            mp, wo, u_cl, u_cu, h=common.hair_offset(mp, hit),
            fourier=scene.fourier)
        wi_surf = common.to_world(t1, t2, hit.ns, wi_loc)
        thr_surf = f * (absdot(wi_surf, hit.ns)
                        / torch.clamp_min(pdf, 1e-20))[..., None]
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        is_trans = (flags & mat_mod.FLAG_TRANSMISSION) > 0
        wi = torch.where(in_medium[..., None], wi_med, wi_surf)
        thr = torch.where(in_medium[..., None], 1.0, thr_surf)  # HG f/pdf
        ok_surf = ~in_medium & hit.valid & (pdf > 0)
        beta_new = beta * thr
        alive = (active & (in_medium | ok_surf)
                 & (beta_new.amax(dim=-1) > 0))

        # the medium switches where a transmissive boundary is crossed
        crossed = alive & ~in_medium & is_trans
        entering = vecmath.dot(wi, hit.ng) < 0
        cur_med = torch.where(
            crossed, _crossing_medium(scene, hit.prim_id, entering), cur_med)

        # russian roulette (volpath.cpp:177-184)
        if b > 3:
            rr_max = beta_new.amax(dim=-1)
            q = torch.clamp_min(1.0 - rr_max, 0.05)
            u_rr = sfn(pid, sidx, dims["rr"], cfg.seed)
            do_rr = rr_max < cfg.rr_threshold
            killed = do_rr & (u_rr < q)
            beta_new = torch.where(
                (do_rr & ~killed)[..., None],
                beta_new / torch.clamp_min(1.0 - q, 1e-6)[..., None],
                beta_new)
            alive = alive & ~killed

        o_next = torch.where(in_medium[..., None], p_med,
                             vecmath.offset_ray_origin(hit.p, hit.ng, wi))
        beta = torch.where(alive[..., None], beta_new, beta)
        o_cur = torch.where(alive[..., None], o_next, o_cur)
        d_cur = torch.where(alive[..., None], wi, d_cur)
        # a null boundary keeps the incoming specular state (pbrt's
        # `if (!isect.bsdf) { ray = SpawnRay; bounces--; continue; }`)
        specular = torch.where(
            alive, torch.where(is_null & ~in_medium, specular,
                               is_spec & ~in_medium), specular)
        active = alive
    return L
