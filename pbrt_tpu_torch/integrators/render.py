"""Render entry points (port of pbrt_tpu/integrators/render.py: RenderConfig,
_bounce_dims, _sample2, li_path, render_pass and render).

``render_pass`` evaluates ``chunk`` samples of every pixel in one batch
of rays: the (pixel, sample) lane layout, the pcg4d sample dimensions and
the film reduction are pbrt_tpu's, so both packages trace the same rays.
``render`` loops over spp chunks. The path integrator runs the fused
path-bounce kernel (ops/fused_path.py); the generic wavefront loop that
carries every other integrator and scene is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from pbrt_tpu_torch.ops import fused_path
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene.types import to_device

# per-bounce sample-dimension layout
# (0-5: pixel xy, lens xy, time, hero wavelength)
_DIM_BASE = 6
_DIM_STRIDE = 10


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    integrator: str = "path"
    sampler: str = "independent"
    max_depth: int = 5
    rr_threshold: float = 1.0
    light_strategy: str = "uniform"
    seed: int = 0


def _bounce_dims(b):
    base = _DIM_BASE + b * _DIM_STRIDE
    return dict(select=base, light_u=(base + 1, base + 2), mis_lobe=base + 3,
                mis_u=(base + 4, base + 5), cont_lobe=base + 6,
                cont_u=(base + 7, base + 8), rr=base + 9)


def _sample2(sfn, pid, sidx, dims, seed):
    return torch.stack([sfn(pid, sidx, dims[0], seed),
                        sfn(pid, sidx, dims[1], seed)], dim=-1)


def li_path(scene, o, d, pid, sidx, cfg: RenderConfig):
    """`path` (integrators/path.cpp): NEE every bounce + BSDF
    continuation, emission on camera vertices, russian roulette. Runs
    the fused kernel, which draws its own pcg4d samples; scenes outside
    its profile need the generic loop (which will take the sampler)."""
    if not fused_path.eligible(scene, cfg):
        raise NotImplementedError("generic _li_loop: ROADMAP queue 1 item 5")
    return fused_path.li_path_fused(scene, o, d, pid, sidx, cfg)


_INTEGRATORS = {"path": li_path}


def camera_rays(cam, filt, cfg: RenderConfig, width: int, height: int,
                chunk: int, spp_offset: int, device):
    """The pass's lanes: lane r = s·W·H + pixel. Returns (rays, pid, sidx,
    filter weight)."""
    n_pix = width * height
    lid = torch.arange(n_pix, dtype=torch.int64, device=device).repeat(chunk)
    sidx = (torch.arange(chunk, dtype=torch.int64, device=device)
            .repeat_interleave(n_pix) + int(spp_offset))
    sfn = make_sampler(cfg.sampler, resolution=(width, height))
    px = (lid % width).to(torch.float32)
    py = (lid // width).to(torch.float32)
    pid = py.to(torch.int64) * width + px.to(torch.int64)
    u_film = _sample2(sfn, pid, sidx, (0, 1), cfg.seed)
    off, w_filt = film_mod.sample_filter_offset(filt, u_film)
    p_film = torch.stack([px + 0.5, py + 0.5], dim=-1) + off
    u_lens = _sample2(sfn, pid, sidx, (2, 3), cfg.seed)
    u_time = sfn(pid, sidx, 4, cfg.seed)
    rays = cam_mod.generate_rays(cam, p_film, u_lens, u_time)
    return rays, pid, sidx, w_filt


def render_pass(scene, cam, filt, cfg: RenderConfig, width: int, height: int,
                chunk: int, spp_offset: int, device="cpu") -> torch.Tensor:
    """Evaluate `chunk` samples for every pixel; returns the (H,W,C) sum
    of filter-weighted radiance (divide by the total spp outside). The
    scene, camera and filter must already live on ``device``."""
    if cfg.integrator not in _INTEGRATORS:
        raise NotImplementedError(
            f"integrator {cfg.integrator!r}: ROADMAP queue 1 items 5 and 9")
    rays, pid, sidx, w_filt = camera_rays(cam, filt, cfg, width, height,
                                          chunk, spp_offset, device)
    L = _INTEGRATORS[cfg.integrator](scene, rays.o, rays.d, pid, sidx, cfg)
    # clamp NaN/negative/inf to black (integrator.cpp:592-613)
    bad = (~torch.isfinite(L)).any(-1) | (L.sum(-1) < -1e-5)
    L = torch.where(bad[..., None], 0.0, L)
    contrib = L * w_filt[..., None]
    img = contrib.reshape(chunk, width * height, -1).sum(0)
    return img.reshape(height, width, -1)


def render(scene, cam, spp: int = 16, integrator: str = "path",
           sampler: str = "independent", filter_name: str = "box",
           filter_kwargs: dict | None = None, max_depth: int = 5,
           seed: int = 0, chunk_spp: int | None = None,
           light_strategy: str = "uniform", rr_threshold: float = 1.0,
           crop_window=None, device="cpu") -> torch.Tensor:
    """Full render → (H, W, C) radiance image on ``device``, looping over
    spp chunks of ``chunk_spp`` samples per pixel."""
    if crop_window is not None:
        raise NotImplementedError("crop windows: ROADMAP queue 1 item 7")
    device = torch.device(device)
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
        # bound the rays per pass: ~2M lanes fill the GPU; the CPU twin
        # materializes per-lane intermediates, so keep its passes small
        target = 2_000_000 if device.type == "cuda" else 65_536
        chunk_spp = max(1, min(spp, target // (width * height) or 1))
    img = torch.zeros((height, width, scene.n_channels), device=device)
    done = 0
    while done < spp:
        c = min(chunk_spp, spp - done)
        img = img + render_pass(scene, cam, filt, cfg, width, height, c,
                                done, device)
        done += c
    return img / spp
