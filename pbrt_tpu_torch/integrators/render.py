"""Render entry points and the sampler-integrator family as wavefront
programs (port of pbrt_tpu/integrators/render.py: RenderConfig, the integrators
`path`, `mypath`, `directlighting`, `whitted` and `ambientocclusion`, the
volumetric `volpath` of integrators/volpath.py, the hero-wavelength
`hero_path` and `hero_path_mis` of integrators/hero.py, the camera
strategies of bidirectional path tracing, `bdpt` and `bdpt_t1`, of
integrators/bdpt.py, render_pass and render).

``render_pass`` evaluates ``chunk`` samples of every pixel in one batch
of rays: the (pixel, sample) lane layout, the pcg4d sample dimensions and
the film reduction are pbrt_tpu's, so both packages trace the same rays.
``render`` loops over spp chunks, over the whole film or a crop window,
or, as pbrt_tpu's does, hands `bdpt` (with its light-tracing splats),
`mlt` and `sppm` to their own render functions (integrators/bdpt.py,
integrators/mlt.py, integrators/sppm.py).
`path` runs the fused path-bounce kernel (ops/fused_path.py) on scenes
inside its profile (the independent sampler only); every other scene,
sampler and integrator goes through the generic wavefront loop
``_li_loop``, whose closest-hit queries run on the brute-force
intersection kernel (ops/intersect.py) or, on a scene with a BVH, the
traversal kernel (ops/bvh.py).
"""

from __future__ import annotations

import dataclasses

import math

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (cosine_sample_hemisphere,
                                          uniform_sample_hemisphere)
from pbrt_tpu_torch.core.vecmath import absdot
from pbrt_tpu_torch.integrators import bdpt as bdpt_mod
from pbrt_tpu_torch.integrators import common
from pbrt_tpu_torch.integrators import hero as hero_mod
from pbrt_tpu_torch.integrators import volpath as volpath_mod
from pbrt_tpu_torch.ops import fused_path
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lightdistrib
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import textures as tex_mod
from pbrt_tpu_torch.scene.types import require_device, to_device

# per-bounce sample-dimension layout
# (0-5: pixel xy, lens xy, time, hero wavelength)
_DIM_BASE = 6
_DIM_STRIDE = 10


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    integrator: str = "path"       # path | direct | whitted | ao | mypath
    sampler: str = "independent"
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "uniform"   # uniform | power | spatial
    ao_radius: float = 1e6
    ao_cos_sample: bool = True
    seed: int = 0
    # also return the per-bounce counts of live lanes from the wavefront
    # loop (bench.py's dead-lane accounting); off in production renders
    collect_stats: bool = False


def _bounce_dims(b):
    base = _DIM_BASE + b * _DIM_STRIDE
    return dict(select=base, light_u=(base + 1, base + 2), mis_lobe=base + 3,
                mis_u=(base + 4, base + 5), cont_lobe=base + 6,
                cont_u=(base + 7, base + 8), rr=base + 9)


def _sample2(sfn, pid, sidx, dims, seed):
    return torch.stack([sfn(pid, sidx, dims[0], seed),
                        sfn(pid, sidx, dims[1], seed)], dim=-1)


# ---------------------------------------------------------------------------
# integrators (Li over a ray batch)
# ---------------------------------------------------------------------------

def li_direct(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
              time=None):
    """`directlighting` with the UniformSampleOne strategy
    (integrators/directlighting.cpp:49-101) + specular recursion up to
    max_depth via the wavefront loop."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=False, time=time)


def li_path(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
            time=None):
    """`path` (integrators/path.cpp): NEE every bounce + BSDF
    continuation, emission on camera vertices, russian roulette.

    Scenes inside the fused profile (Scene.fused_profile: all-matte
    triangles + one aaplane area light) run the fused bounce kernel, which
    draws its own pcg4d samples; the two paths give matching pixels
    (identical sample streams)."""
    if fused_path.eligible(scene, cfg):
        return fused_path.li_path_fused(scene, o, d, pid, sidx, cfg)
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=True, time=time)


def li_mypath(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
              time=None):
    """fork `mypath` (integrators/mypath.cpp:31-142): path tracing whose
    direct estimation is light-sampling only (no BSDF half), portal
    dispatch intact."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=True, bsdf_half=False, time=time)


def li_whitted(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
               time=None):
    """`whitted` (integrators/whitted.cpp): direct lighting through the
    same NEE estimator + specular recursion."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=False, time=time)


def li_ao(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
          time=None):
    """`ambientocclusion` (integrators/ao.cpp:57-103)."""
    R = o.shape[0]
    inf = torch.full((R,), vecmath.INF, device=o.device)
    hit = isect_mod.intersect(scene, o, d, inf, time=time)
    u = _sample2(sfn, pid, sidx, _bounce_dims(0)["light_u"], cfg.seed)
    # frame on the geometry FACING THE RAY (ao.cpp:77 Faceforward(n,
    # -ray.d)): otherwise back-facing windings send the hemisphere
    # through the surface
    n_ao = vecmath.face_forward(hit.ns, -d)
    t1, t2 = common.make_frame(n_ao)
    # pbrt's estimator is Dot(wi,n)/pdf with no albedo normalization
    # (ao.cpp:97-98): cosine sampling contributes π per unoccluded ray,
    # uniform sampling 2π·cosθ
    if cfg.ao_cos_sample:
        w_loc = cosine_sample_hemisphere(u)
        ratio = torch.full((R,), math.pi, device=o.device)
    else:
        w_loc = uniform_sample_hemisphere(u)
        ratio = 2.0 * math.pi * w_loc[..., 2]
    w = common.to_world(t1, t2, n_ao, w_loc)
    o2 = vecmath.offset_ray_origin(hit.p, n_ao, w)
    occ = isect_mod.intersect_p(scene, o2, w,
                                torch.full_like(inf, cfg.ao_radius),
                                time=time)
    vis = torch.where(hit.valid, (~occ).to(torch.float32) * ratio, 0.0)
    return vis[..., None].expand(R, scene.n_channels)


def _li_loop(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
             nee=True, indirect=True, bsdf_half=True, time=None):
    """Shared wavefront loop (PathIntegrator::Li shape, path.cpp /
    mypath.cpp:31-142): a Python loop over bounces with active masks,
    every lane doing every bounce's work. ``time``: each lane's shutter
    time on a scene with motion, which every query of the lane takes.

    Where pbrt_tpu's traced loop can only mask, this one skips, with the
    same result and by static rules only (so a render's kernel launches
    are known before it runs, on the card as on the CPU): the final
    iteration (emission only) runs no NEE and no continuation, and a loop
    that continues through specular lobes only (`indirect=False`:
    `whitted`, `direct`) stops after the first bounce when no material row
    can sample a delta lobe.

    With ``cfg.collect_stats`` it returns (L, live): live (n_bounces,)
    float32 on the lanes' device holds the count of active lanes as each
    bounce starts, as pbrt_tpu's loop counts them (0 for the bounces a
    static stop skips: every path has ended there). No count is read on
    the host."""
    R = o.shape[0]
    C = scene.n_channels
    dev = o.device
    # pbrt_tpu traces these dims inside its fori_loop; a sampler with a
    # second formula for traced dims (halton) gives it as ``in_loop``
    sfn = getattr(sfn, "in_loop", sfn)
    L = torch.zeros((R, C), device=dev)
    beta = torch.ones((R, C), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    specular = torch.ones(R, dtype=torch.bool, device=dev)  # bounce 0 emits
    eta_scale = torch.ones(R, device=dev)
    o_cur, d_cur = o, d
    inf = torch.full((R,), vecmath.INF, device=dev)

    n_bounces = cfg.max_depth + 1 if indirect else min(cfg.max_depth + 1, 8)
    live = (torch.zeros(n_bounces, device=dev) if cfg.collect_stats
            else None)
    for b in range(n_bounces):
        if live is not None:
            live[b] = active.sum(dtype=torch.float32)
        # pbrt's termination order (path.cpp:23-24 `if (!foundIntersection
        # || bounces >= maxDepth) break;`): the FINAL iteration collects
        # emission only, no NEE and no continuation
        last = b >= n_bounces - 1
        dims = _bounce_dims(b)
        hit = isect_mod.intersect(scene, o_cur, d_cur, inf, time=time)

        # emitted radiance at camera/specular vertices (path.cpp:291-310)
        light_id = torch.where(hit.valid, scene.light_at(hit.prim_id), -1)
        gl = lights_mod.gather_lights(scene.lights, light_id.clamp_min(0))
        le = lights_mod.area_light_L(gl.emit, gl.two_sided, hit.ng, -d_cur)
        le = torch.where((light_id >= 0)[..., None], le, 0.0)
        env = lights_mod.escaped_radiance(scene, d_cur)
        emit = torch.where(hit.valid[..., None], le, env)
        L = L + torch.where((active & specular)[..., None], beta * emit, 0.0)
        if last:
            break

        active = active & hit.valid
        mp = mat_mod.gather_materials(scene.materials,
                                      scene.mat_at(hit.prim_id))
        wo_w = -d_cur
        if scene.has_sss and indirect:
            # subsurface: a BSSRDF lane reflects at its interface or moves
            # to its sampled exit, where NEE and the continuation run
            # about the exit's frame (wo along the exit normal)
            hit, mp, beta, _, wo_w = common.subsurface_transport(
                scene, hit, mp, beta, -d_cur, pid, sidx, sfn, cfg.seed,
                dims, time=time)

        if nee:
            u_sel = sfn(pid, sidx, dims["select"], cfg.seed)
            u_l = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
            u_ml = sfn(pid, sidx, dims["mis_lobe"], cfg.seed)
            u_mu = _sample2(sfn, pid, sidx, dims["mis_u"], cfg.seed)
            ld = common.estimate_direct(
                scene, hit, mp, wo_w, u_sel, u_l, u_mu, u_ml,
                power_distr=power_distr, with_bsdf_half=bsdf_half,
                time=time)
            L = L + torch.where(active[..., None], beta * ld, 0.0)
        if not (indirect or mat_mod.has_specular(scene.materials)):
            # whitted/direct continue through *specular* lobes only, and
            # no row has one: every lane ends here
            break

        # continuation (path.cpp:320-360)
        t1, t2 = common.shading_frame(hit, mp)
        wo = common.to_local(t1, t2, hit.ns, wo_w)
        u_cl = sfn(pid, sidx, dims["cont_lobe"], cfg.seed)
        u_cu = _sample2(sfn, pid, sidx, dims["cont_u"], cfg.seed)
        kd_eff = tex_mod.resolve_kd(scene, mp, hit, wo=-d_cur)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(
            mp, wo, u_cl, u_cu, kd_override=kd_eff,
            h=common.hair_offset(mp, hit), fourier=scene.fourier)
        wi = common.to_world(t1, t2, hit.ns, wi_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        is_trans = (flags & mat_mod.FLAG_TRANSMISSION) > 0
        throughput = f * (absdot(wi, hit.ns)
                          / torch.clamp_min(pdf, 1e-20))[..., None]
        beta_new = beta * throughput
        alive = active & (pdf > 0) & (beta_new.amax(dim=-1) > 0)
        if not indirect:
            alive = alive & is_spec
        # the eta scale of russian roulette (path.cpp:344-352): a specular
        # transmission entering (by the geometric normal) multiplies it by
        # eta², leaving by 1/eta²
        eta2 = mp.eta * mp.eta
        entering = vecmath.dot(-d_cur, hit.ng) > 0
        eta_sc = torch.where(is_spec & is_trans,
                             torch.where(entering, eta2,
                                         1.0 / torch.clamp_min(eta2, 1e-9)),
                             1.0)
        eta_scale = eta_scale * torch.where(alive, eta_sc, 1.0)

        # russian roulette (path.cpp:362-370)
        if indirect and b > 3:
            rr_beta_max = beta_new.amax(dim=-1) * eta_scale
            q = torch.clamp_min(1.0 - rr_beta_max, 0.05)
            u_rr = sfn(pid, sidx, dims["rr"], cfg.seed)
            do_rr = rr_beta_max < cfg.rr_threshold
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
        specular = torch.where(alive, is_spec if nee else True, specular)
        active = alive
    if live is not None:
        return L, live
    return L


_INTEGRATORS = {"path": li_path, "direct": li_direct,
                "directlighting": li_direct, "whitted": li_whitted,
                "ao": li_ao, "ambientocclusion": li_ao, "mypath": li_mypath,
                "volpath": volpath_mod.li_volpath,
                "hero_path": hero_mod.li_hero_path,
                "hero_path_mis": hero_mod.li_hero_path_mis,
                "bdpt": bdpt_mod.li_bdpt, "bdpt_t1": bdpt_mod.li_bdpt_t1}
# integrators that read the camera (bdpt's first-segment density)
_CAMERA_INTEGRATORS = ("bdpt", "bdpt_t1")
# integrators that take each lane's shutter time on a scene with motion;
# pbrt_tpu's hero, volpath, bdpt, mlt and sppm ignore it (ROADMAP queue 3)
_TIME_INTEGRATORS = ("path", "direct", "directlighting", "whitted", "ao",
                     "ambientocclusion", "mypath")
_LIGHT_STRATEGIES = ("uniform", "power", "spatial")


# pbrt_tpu's integrators the port has not yet, by ROADMAP queue 1 item
_UNPORTED_INTEGRATORS = {}
# integrators that run the wavefront loop ``_li_loop`` (``path`` through
# the loop whenever ``collect_stats`` is set), the only ones that count
# live lanes
_STATS_INTEGRATORS = ("path", "direct", "directlighting", "whitted",
                      "mypath")


def camera_rays(cam, filt, cfg: RenderConfig, width: int, height: int,
                chunk: int, spp_offset: int, device, crop=None):
    """The pass's lanes: lane r = s·(pixels) + pixel, over the whole image
    or the ``crop`` = (px0, py0, wc, hc) pixel bounds. The pixel id is
    always the full image's, so a crop draws the same samples as the full
    frame. Returns (rays, pid, sidx, filter weight)."""
    px0, py0, wc, hc = crop if crop is not None else (0, 0, width, height)
    n_pix = wc * hc
    lid = torch.arange(n_pix, dtype=torch.int64, device=device).repeat(chunk)
    sidx = (torch.arange(chunk, dtype=torch.int64, device=device)
            .repeat_interleave(n_pix) + int(spp_offset))
    sfn = make_sampler(cfg.sampler, resolution=(width, height))
    px = (px0 + lid % wc).to(torch.float32)
    py = (py0 + lid // wc).to(torch.float32)
    pid = py.to(torch.int64) * width + px.to(torch.int64)
    u_film = _sample2(sfn, pid, sidx, (0, 1), cfg.seed)
    off, w_filt = film_mod.sample_filter_offset(filt, u_film)
    p_film = torch.stack([px + 0.5, py + 0.5], dim=-1) + off
    u_lens = _sample2(sfn, pid, sidx, (2, 3), cfg.seed)
    u_time = sfn(pid, sidx, 4, cfg.seed)
    rays = cam_mod.generate_rays(cam, p_film, u_lens, u_time)
    return rays, pid, sidx, w_filt


def render_pass(scene, cam, filt, cfg: RenderConfig, width: int, height: int,
                chunk: int, spp_offset: int, device="cuda",
                power_distr=None, crop=None, check_finite=False
                ) -> torch.Tensor:
    """Evaluate `chunk` samples for every pixel; returns the (H,W,C) sum
    of filter-weighted radiance (divide by the total spp outside), or the
    (hc,wc,C) sum over ``crop`` = (px0, py0, wc, hc), the cropped pixel
    bounds (Film::croppedPixelBounds, core/film.cpp:58-66). The scene,
    camera and filter must already live on ``device``.

    With ``cfg.collect_stats`` it returns (img, live), live the
    (n_bounces,) float32 counts of live lanes as each bounce of the
    wavefront loop starts (``_li_loop``); an integrator that does not
    run that loop raises ``ValueError``."""
    device = require_device(device)
    if cfg.integrator not in _INTEGRATORS:
        raise NotImplementedError(
            f"integrator {cfg.integrator!r}: ROADMAP queue 1 item "
            f"{_UNPORTED_INTEGRATORS.get(cfg.integrator, '9')}")
    if cfg.collect_stats and cfg.integrator not in _STATS_INTEGRATORS:
        raise ValueError(f"collect_stats: integrator {cfg.integrator!r} "
                         "does not run the wavefront loop that counts live "
                         "lanes")
    if cfg.light_strategy not in _LIGHT_STRATEGIES:
        raise ValueError(f"unknown light strategy {cfg.light_strategy!r}")
    rays, pid, sidx, w_filt = camera_rays(cam, filt, cfg, width, height,
                                          chunk, spp_offset, device, crop)
    sfn = make_sampler(cfg.sampler, resolution=(width, height))
    if power_distr is None:
        power_distr = light_distribution(scene, cfg.light_strategy)
    kw = {"cam": cam} if cfg.integrator in _CAMERA_INTEGRATORS else {}
    if scene.has_motion and cfg.integrator in _TIME_INTEGRATORS:
        # the lane's shutter time (sample dimension 4, as the camera drew
        # it): the rays' time through every query of the pass
        u_time = sfn(pid, sidx, 4, cfg.seed)
        kw["time"] = cam.shutter_open + u_time * (cam.shutter_close
                                                  - cam.shutter_open)
    L = _INTEGRATORS[cfg.integrator](scene, rays.o, rays.d, pid, sidx, sfn,
                                     cfg, power_distr, **kw)
    live = None
    if cfg.collect_stats:
        L, live = L
    if check_finite and not bool(torch.isfinite(L).all()):
        raise FloatingPointError(
            f"non-finite radiance in the pass at spp offset {spp_offset}")
    # clamp NaN/negative/inf to black (integrator.cpp:592-613)
    bad = (~torch.isfinite(L)).any(-1) | (L.sum(-1) < -1e-5)
    L = torch.where(bad[..., None], 0.0, L)
    contrib = L * w_filt[..., None]
    _, _, wc, hc = crop if crop is not None else (0, 0, width, height)
    img = contrib.reshape(chunk, wc * hc, -1).sum(0).reshape(hc, wc, -1)
    if live is not None:
        return img, live
    return img


def light_distribution(scene, strategy: str):
    """The light-selection distribution of a strategy: None (uniform),
    the power CDF, or the spatial voxel table
    (scene/lightdistrib.py)."""
    if strategy == "power":
        return lights_mod.power_distribution(scene.lights)
    if strategy == "spatial":
        return lightdistrib.build_spatial_distribution(scene)
    return None


def _iparam(ip, name, default):
    """One integrator parameter from the parser's Params bag (``.one``)
    or a plain dict (programmatic callers)."""
    if ip is None:
        return default
    if hasattr(ip, "one"):
        return ip.one(name, default)
    return ip.get(name, default)


def crop_bounds(crop_window, width: int, height: int):
    """(x0, x1, y0, y1) NDC fractions → (px0, py0, wc, hc) pixel bounds
    (Film::croppedPixelBounds, core/film.cpp:58-66)."""
    x0, x1, y0, y1 = [float(v) for v in crop_window]
    px0 = int(math.ceil(width * min(x0, x1)))
    px1 = max(px0 + 1, int(math.ceil(width * max(x0, x1))))
    py0 = int(math.ceil(height * min(y0, y1)))
    py1 = max(py0 + 1, int(math.ceil(height * max(y0, y1))))
    return (px0, py0, min(px1, width) - px0, min(py1, height) - py0)


def render(scene, cam, spp: int = 16, integrator: str = "path",
           sampler: str = "independent", filter_name: str = "box",
           filter_kwargs: dict | None = None, max_depth: int = 5,
           seed: int = 0, chunk_spp: int | None = None,
           light_strategy: str = "uniform", rr_threshold: float = 1.0,
           crop_window=None, integrator_params=None, check_finite=False,
           progress=None, device="cuda") -> torch.Tensor:
    """Full render → (H, W, C) radiance image on ``device`` (C = 60 for a
    scene of sampled spectra: convert with ``spectrum_to_rgb``), looping over
    spp chunks of ``chunk_spp`` samples per pixel. Runs on the card unless
    the caller asks for ``device="cpu"``, and raises when there is no
    card.

    ``crop_window`` = (x0, x1, y0, y1) NDC fractions (Film "float
    cropwindow"); the image is then the cropped region only, with the
    full frame's samples. ``integrator_params`` is the scene file's
    Integrator ParamSet, as pbrt_tpu's ``render`` takes it: `mlt` reads
    ``mutationsperpixel`` (default ``spp``), ``chains`` and
    ``bootstrapsamples`` from it, `sppm` ``photonsperiteration`` (−1, the
    default: the film's pixel count), ``radius`` (1.0) and ``iterations``
    or ``numiterations`` (64). ``check_finite`` raises on the first
    pass whose radiance holds a NaN or an infinity, before the clamp to
    black (the CLI's ``--debug-nans``). ``progress`` (a
    ``utils.progress.ProgressReporter``) advances by each pass's spp.

    As pbrt_tpu's ``render`` (and pbrt's MakeIntegrator, which lets bdpt,
    mlt and sppm override Render), `bdpt` goes to ``bdpt.render_bdpt``,
    `mlt` to ``mlt.render_mlt`` and `sppm` to ``sppm.render_sppm``: they
    take the whole film, the box filter and their own samplers, so the
    sampler, filter, chunk, light strategy and crop window do not reach
    them."""
    device = require_device(device)
    ip = integrator_params
    if integrator in _UNPORTED_INTEGRATORS:
        raise NotImplementedError(
            f"integrator {integrator!r}: ROADMAP queue 1 item "
            f"{_UNPORTED_INTEGRATORS[integrator]}")
    if integrator == "bdpt":
        return bdpt_mod.render_bdpt(scene, cam, spp=spp, max_depth=max_depth,
                                    seed=seed, progress=progress,
                                    device=device)
    if integrator == "mlt":
        from pbrt_tpu_torch.integrators import mlt as mlt_mod
        # pbrt ignores the sampler's pixelsamples for MLT (mlt.cpp:270-276)
        return mlt_mod.render_mlt(
            scene, cam,
            mutations_per_pixel=int(_iparam(ip, "mutationsperpixel", spp)),
            n_chains=int(_iparam(ip, "chains", 4096)),
            n_bootstrap=int(_iparam(ip, "bootstrapsamples", 16384)),
            max_depth=max_depth, seed=seed, device=device)
    if integrator == "sppm":
        from pbrt_tpu_torch.integrators import sppm as sppm_mod
        width, height = cam.resolution
        ppi = int(_iparam(ip, "photonsperiteration", -1))
        if ppi <= 0:
            ppi = width * height     # pbrt: −1 → the film's pixel count
        # pbrt's initial search radius is 1.0 world units (sppm.cpp:514)
        return sppm_mod.render_sppm(
            scene, cam,
            n_iterations=int(_iparam(ip, "iterations",
                                     _iparam(ip, "numiterations", 64))),
            photons_per_iter=ppi,
            initial_radius=float(_iparam(ip, "radius", 1.0)),
            max_depth=max_depth, seed=seed, device=device)
    width, height = cam.resolution
    scene = to_device(scene, device)
    cam = to_device(cam, device)
    filt = film_mod.make_filter(filter_name, **(filter_kwargs or {}),
                                device=device)
    cfg = RenderConfig(integrator=integrator, sampler=sampler,
                       max_depth=max_depth, seed=seed,
                       light_strategy=light_strategy,
                       rr_threshold=rr_threshold)
    if chunk_spp is None:
        # bound the lanes per pass: 2^21 fill the GPU (32 spp of a 256²
        # film, the main path's chunk); the CPU twins materialize per-lane
        # intermediates (≈ 2 KB a lane at 3 channels), so their passes
        # hold 2^18 lanes (2^16 at 60 channels). Then as few passes as
        # that allows, of equal size: a CPU pass's fixed cost is most of
        # a small pass's time
        target = (2_097_152 if device.type == "cuda"
                  else max(65_536, 786_432 // scene.n_channels))
        max_chunk = max(1, min(spp, target // (width * height) or 1))
        chunk_spp = -(-spp // -(-spp // max_chunk))
    crop = (crop_bounds(crop_window, width, height)
            if crop_window is not None else None)
    _, _, wc, hc = crop if crop is not None else (0, 0, width, height)
    img = torch.zeros((hc, wc, scene.n_channels), device=device)
    power_distr = light_distribution(scene, light_strategy)
    done = 0
    while done < spp:
        c = min(chunk_spp, spp - done)
        img = img + render_pass(scene, cam, filt, cfg, width, height, c,
                                done, device, power_distr=power_distr,
                                crop=crop, check_finite=check_finite)
        done += c
        if progress is not None:
            progress.update(c)
    if progress is not None:
        progress.finish()
    return img / spp


render_image = render
