"""The spatial light distribution (port of pbrt_tpu/scene/lightdistrib.py).

Counterpart of ``core/lightdistrib.{h,cpp}``'s SpatialLightDistribution
(:69-104): the scene bounds are cut into a 16³ voxel grid, and each
light's contribution to each voxel is estimated from 32 jittered points
(Sample_Li without visibility, lightdistrib.cpp:219-247), giving one CDF
over the lights per voxel. pbrt's lock-free hash table of voxels built on
demand (:91-117) becomes one dense (V, L) table built up front, as in
pbrt_tpu. The uniform and power distributions live in
``integrators/common.py::choose_light`` and ``scene/lights.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from pbrt_tpu_torch.core import rng as rng_mod
from pbrt_tpu_torch.core.sampling import (Distribution1D,
                                          make_distribution_1d,
                                          sample_distribution_1d_discrete)
from pbrt_tpu_torch.scene import lights as lights_mod

MAX_VOXELS_PER_AXIS = 16   # pbrt uses up to 64; pbrt_tpu's grid is 16³
N_EST_SAMPLES = 32         # Monte Carlo samples per (voxel, light)


@dataclasses.dataclass
class SpatialLightDistribution:
    cdf: torch.Tensor        # (V, L+1) per-voxel CDF
    func: torch.Tensor       # (V, L)
    func_int: torch.Tensor   # (V,)
    res: tuple               # (3,) voxel grid resolution


def build_spatial_distribution(scene) -> SpatialLightDistribution:
    """Per-voxel light CDFs (SpatialLightDistribution's constructor and
    ComputeDistribution, lightdistrib.cpp:106-257), on the scene's
    device."""
    n_lights = scene.lights.n
    lo, hi = scene.world_lo, scene.world_hi
    dev = lo.device
    diag = hi - lo
    res = (MAX_VOXELS_PER_AXIS,) * 3
    n_vox = res[0] * res[1] * res[2]
    vox = torch.arange(n_vox, dtype=torch.int64, device=dev)
    vz = vox % res[2]
    vy = (vox // res[2]) % res[1]
    vx = vox // (res[2] * res[1])
    res_f = torch.tensor(res, dtype=torch.float32, device=dev)
    vmin = lo + torch.stack([vx, vy, vz], -1).to(torch.float32) / res_f \
        * diag
    vsize = diag / res_f

    func = torch.zeros((n_vox, n_lights), device=dev)
    for li in range(n_lights):
        acc = torch.zeros(n_vox, device=dev)
        idx = torch.full((n_vox,), li, dtype=torch.int32, device=dev)
        for s in range(N_EST_SAMPLES):
            u = torch.stack([rng_mod.uniform(vox, s, 3 * li + k)
                             for k in range(3)], -1)
            p = vmin + u * vsize
            u2 = torch.stack([rng_mod.uniform(vox, s, 100 + k)
                              for k in range(2)], -1)
            ls = lights_mod.sample_li(scene, idx, p, u2)
            lum = ls["li"].sum(-1) / torch.clamp_min(ls["pdf"], 1e-9)
            acc = acc + torch.where(torch.isfinite(lum), lum, 0.0)
        func[:, li] = acc / N_EST_SAMPLES
    # a floor, so that no light is unreachable (lightdistrib.cpp:249-253)
    fmax = func.amax(dim=-1, keepdim=True)
    func = torch.maximum(func, 1e-3 * fmax + 1e-12)
    d = make_distribution_1d(func)
    return SpatialLightDistribution(cdf=d.cdf, func=d.func,
                                    func_int=d.func_int, res=res)


def lookup_voxel(dist: SpatialLightDistribution, scene, p: torch.Tensor
                 ) -> torch.Tensor:
    """The voxel (flat index) that holds each point of ``p`` (R, 3),
    clipped into the grid."""
    lo, hi = scene.world_lo, scene.world_hi
    u = (p - lo) / torch.clamp_min(hi - lo, 1e-9)
    res = dist.res
    res_f = torch.tensor(res, dtype=torch.float32, device=p.device)
    hi_i = torch.tensor([r - 1 for r in res], dtype=torch.int32,
                        device=p.device)
    c = torch.minimum(torch.clamp_min((u * res_f).to(torch.int32), 0), hi_i)
    return ((c[..., 0] * res[1] + c[..., 1]) * res[2] + c[..., 2]).long()


def sample_spatial(dist: SpatialLightDistribution, scene, p: torch.Tensor,
                   u: torch.Tensor):
    """Pick a light per shading point from its voxel's CDF. Returns
    (light_idx, pmf)."""
    vox = lookup_voxel(dist, scene, p)
    d = Distribution1D(func=dist.func[vox], cdf=dist.cdf[vox],
                       func_int=dist.func_int[vox])
    return sample_distribution_1d_discrete(d, u)
