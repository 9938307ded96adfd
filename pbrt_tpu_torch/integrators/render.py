"""Render entry points and the sampler-integrator family as wavefront
programs (port of pbrt_tpu/integrators/render.py: RenderConfig, the integrators
`path`, `mypath`, `directlighting`, `whitted` and `ambientocclusion`, the
hero-wavelength `hero_path` and `hero_path_mis` of integrators/hero.py,
render_pass and render).

``render_pass`` evaluates ``chunk`` samples of every pixel in one batch
of rays: the (pixel, sample) lane layout, the pcg4d sample dimensions and
the film reduction are pbrt_tpu's, so both packages trace the same rays.
``render`` loops over spp chunks, over the whole film or a crop window.
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
from pbrt_tpu_torch.integrators import common
from pbrt_tpu_torch.integrators import hero as hero_mod
from pbrt_tpu_torch.ops import fused_path
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod
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
    light_strategy: str = "uniform"   # uniform | power
    ao_radius: float = 1e6
    ao_cos_sample: bool = True
    seed: int = 0


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

def li_direct(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr):
    """`directlighting` with the UniformSampleOne strategy
    (integrators/directlighting.cpp:49-101) + specular recursion up to
    max_depth via the wavefront loop."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=False)


def li_path(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr):
    """`path` (integrators/path.cpp): NEE every bounce + BSDF
    continuation, emission on camera vertices, russian roulette.

    Scenes inside the fused profile (Scene.fused_profile: all-matte
    triangles + one aaplane area light) run the fused bounce kernel, which
    draws its own pcg4d samples; the two paths give matching pixels
    (identical sample streams)."""
    if fused_path.eligible(scene, cfg):
        return fused_path.li_path_fused(scene, o, d, pid, sidx, cfg)
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=True)


def li_mypath(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr):
    """fork `mypath` (integrators/mypath.cpp:31-142): path tracing whose
    direct estimation is light-sampling only (no BSDF half), portal
    dispatch intact."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=True, bsdf_half=False)


def li_whitted(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr):
    """`whitted` (integrators/whitted.cpp): direct lighting through the
    same NEE estimator + specular recursion."""
    return _li_loop(scene, o, d, pid, sidx, sfn, cfg, power_distr,
                    nee=True, indirect=False)


def li_ao(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr):
    """`ambientocclusion` (integrators/ao.cpp:57-103)."""
    R = o.shape[0]
    inf = torch.full((R,), vecmath.INF, device=o.device)
    hit = isect_mod.intersect(scene, o, d, inf)
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
                                torch.full_like(inf, cfg.ao_radius))
    vis = torch.where(hit.valid, (~occ).to(torch.float32) * ratio, 0.0)
    return vis[..., None].expand(R, scene.n_channels)


def _li_loop(scene, o, d, pid, sidx, sfn, cfg: RenderConfig, power_distr,
             nee=True, indirect=True, bsdf_half=True):
    """Shared wavefront loop (PathIntegrator::Li shape, path.cpp /
    mypath.cpp:31-142): a Python loop over bounces with active masks,
    every lane doing every bounce's work.

    Where pbrt_tpu's traced loop can only mask, this one skips, with the
    same result and by static rules only (so a render's kernel launches
    are known before it runs, on the card as on the CPU): the final
    iteration (emission only) runs no NEE and no continuation, and a loop
    that continues through specular lobes only (`indirect=False`:
    `whitted`, `direct`) stops after the first bounce when no material row
    can sample a delta lobe."""
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
    for b in range(n_bounces):
        # pbrt's termination order (path.cpp:23-24 `if (!foundIntersection
        # || bounces >= maxDepth) break;`): the FINAL iteration collects
        # emission only, no NEE and no continuation
        last = b >= n_bounces - 1
        dims = _bounce_dims(b)
        hit = isect_mod.intersect(scene, o_cur, d_cur, inf)

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

        if nee:
            u_sel = sfn(pid, sidx, dims["select"], cfg.seed)
            u_l = _sample2(sfn, pid, sidx, dims["light_u"], cfg.seed)
            u_ml = sfn(pid, sidx, dims["mis_lobe"], cfg.seed)
            u_mu = _sample2(sfn, pid, sidx, dims["mis_u"], cfg.seed)
            ld = common.estimate_direct(
                scene, hit, mp, wo_w, u_sel, u_l, u_mu, u_ml,
                power_distr=power_distr, with_bsdf_half=bsdf_half)
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
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(mp, wo, u_cl, u_cu)
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
    return L


_INTEGRATORS = {"path": li_path, "direct": li_direct,
                "directlighting": li_direct, "whitted": li_whitted,
                "ao": li_ao, "ambientocclusion": li_ao, "mypath": li_mypath,
                "hero_path": hero_mod.li_hero_path,
                "hero_path_mis": hero_mod.li_hero_path_mis}


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
    camera and filter must already live on ``device``."""
    device = require_device(device)
    if cfg.integrator not in _INTEGRATORS:
        raise NotImplementedError(
            f"integrator {cfg.integrator!r}: ROADMAP queue 1 item 9")
    if cfg.light_strategy not in ("uniform", "power"):
        raise NotImplementedError(
            f"light strategy {cfg.light_strategy!r}: ROADMAP queue 1 item 9")
    rays, pid, sidx, w_filt = camera_rays(cam, filt, cfg, width, height,
                                          chunk, spp_offset, device, crop)
    sfn = make_sampler(cfg.sampler, resolution=(width, height))
    if power_distr is None and cfg.light_strategy == "power":
        power_distr = lights_mod.power_distribution(scene.lights)
    L = _INTEGRATORS[cfg.integrator](scene, rays.o, rays.d, pid, sidx, sfn,
                                     cfg, power_distr)
    if check_finite and not bool(torch.isfinite(L).all()):
        raise FloatingPointError(
            f"non-finite radiance in the pass at spp offset {spp_offset}")
    # clamp NaN/negative/inf to black (integrator.cpp:592-613)
    bad = (~torch.isfinite(L)).any(-1) | (L.sum(-1) < -1e-5)
    L = torch.where(bad[..., None], 0.0, L)
    contrib = L * w_filt[..., None]
    _, _, wc, hc = crop if crop is not None else (0, 0, width, height)
    img = contrib.reshape(chunk, wc * hc, -1).sum(0)
    return img.reshape(hc, wc, -1)


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
    Integrator ParamSet, as pbrt_tpu's ``render`` takes it; the ported
    integrators read nothing from it (pbrt_tpu reads it only for bdpt,
    mlt and sppm). ``check_finite`` raises on the first pass whose
    radiance holds a NaN or an infinity, before the clamp to black (the
    CLI's ``--debug-nans``). ``progress`` (a
    ``utils.progress.ProgressReporter``) advances by each pass's spp."""
    del integrator_params   # read only by integrators not ported yet
    device = require_device(device)
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
        # bound the rays per pass: 2^21 lanes fill the GPU (32 spp of a
        # 256² film, the main path's chunk); the CPU twin materializes
        # per-lane intermediates, so keep its passes small
        target = 2_097_152 if device.type == "cuda" else 65_536
        chunk_spp = max(1, min(spp, target // (width * height) or 1))
    crop = (crop_bounds(crop_window, width, height)
            if crop_window is not None else None)
    _, _, wc, hc = crop if crop is not None else (0, 0, width, height)
    img = torch.zeros((hc, wc, scene.n_channels), device=device)
    done = 0
    while done < spp:
        c = min(chunk_spp, spp - done)
        img = img + render_pass(scene, cam, filt, cfg, width, height, c,
                                done, device, crop=crop,
                                check_finite=check_finite)
        done += c
        if progress is not None:
            progress.update(c)
    if progress is not None:
        progress.finish()
    return img / spp
