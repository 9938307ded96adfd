"""Primary-sample-space Metropolis light transport (port of
pbrt_tpu/integrators/mlt.py).

Counterpart of ``integrators/mlt.cpp``: MLTSampler's primary-sample
vector with large and small mutations (:75-95), the bootstrap
normalization b (:177-200), and Markov chains that splat their proposed
and current states (:212-249). As in pbrt_tpu, thousands of chains run at
once, one per lane: each mutation step evaluates every chain's proposal
in one wavefront pass of the `path` integrator, whose sampler reads the
chain's primary-sample vector X by column instead of hashing, and the
two film splats of a step are scatter-adds (``film.splat``). On a scene
in the fused profile the target runs the fused kernel, as pbrt_tpu's
does; everywhere else the generic loop and its intersection kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import rng as rng_mod
from pbrt_tpu_torch.core import spectrum as spec_mod
from pbrt_tpu_torch.core.sampling import (make_distribution_1d,
                                          sample_distribution_1d_discrete)
from pbrt_tpu_torch.integrators.render import _INTEGRATORS, RenderConfig
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene.types import require_device, to_device

SIGMA = 0.01           # mlt.cpp's small-step sigma
P_LARGE = 0.3          # large-step probability
_SQRT2 = float(np.sqrt(np.float32(2.0)))    # jnp.sqrt(2.0) in float32


def _n_dims(max_depth: int) -> int:
    return 6 + (max_depth + 1) * 10


def column_sampler(X: torch.Tensor):
    """The sampler of a primary-sample vector X (R, D): a dimension reads
    column ``dim`` of X (the last one past the end); a dimension given as
    a tensor reads each lane's column with ``torch.gather``."""
    D = X.shape[1]

    def sfn(pid, sidx, dim, seed=0):
        if isinstance(dim, torch.Tensor):
            idx = dim.long().clamp(0, D - 1).expand(X.shape[0])
            return torch.gather(X, 1, idx[:, None])[:, 0]
        return X[:, min(int(dim), D - 1)]
    return sfn


def _eval_target(scene, cam, X, cfg):
    """Radiance (R, C), its luminance I (R,) and the film position (R, 2)
    of the primary samples X (R, D): X[:, 0:2] place the film sample,
    X[:, 2:5] the lens and time, the rest drive the integrator."""
    R = X.shape[0]
    res = torch.tensor(cam.resolution, dtype=torch.float32, device=X.device)
    p_film = X[:, 0:2] * res[None, :]
    rays = cam_mod.generate_rays(cam, p_film, X[:, 2:4], X[:, 4])
    pid = torch.zeros(R, dtype=torch.int64, device=X.device)
    sidx = torch.zeros(R, dtype=torch.int64, device=X.device)
    L = _INTEGRATORS[cfg.integrator](scene, rays.o, rays.d, pid, sidx,
                                     column_sampler(X), cfg, None)
    bad = (~torch.isfinite(L)).any(-1)
    L = torch.where(bad[..., None], 0.0, L)
    I = spec_mod.luminance(
        L, spec_mod.RGB if scene.n_channels == 3 else spec_mod.SAMPLED)
    return L, torch.clamp_min(I, 0.0), p_film


def _mutate(X, step_key: int, chain_ids, p_large: float = P_LARGE):
    """A large step (fresh uniforms) or a small step (a gaussian
    perturbation wrapped into [0, 1)), MLTSampler's mutations
    (mlt.cpp:75-95). Both draw from (chain, step) only, not the seed, as
    pbrt_tpu's do."""
    R, D = X.shape
    u_kind = rng_mod.uniform(chain_ids, step_key, 9990)
    is_large = u_kind < p_large
    dims = torch.arange(D, dtype=torch.int64, device=X.device)
    u = rng_mod.u32_to_uniform(rng_mod.pcg4d(
        chain_ids[:, None].expand(R, D), step_key, dims[None, :].expand(R, D),
        7)[0])
    eps = 1e-6
    g = _SQRT2 * torch.erfinv(torch.clamp(2.0 * u - 1.0, -1 + eps, 1 - eps))
    X_small = torch.remainder(X + SIGMA * g, 1.0)
    return torch.where(is_large[:, None], u, X_small), is_large


def _mlt_chains(scene, cam, X, b, seed: int, cfg, n_steps: int, width: int,
                height: int):
    """The Markov-chain phase: ``n_steps`` Metropolis mutations of every
    chain, each step splatting the proposal and the current state with
    Kelemen's weights (mlt.cpp:212-249). ``b`` is the bootstrap
    normalization, a float32 0-d tensor. Returns the (H, W, C) film."""
    R = X.shape[0]
    C = scene.n_channels
    chain_ids = torch.arange(R, dtype=torch.int64, device=X.device)
    L_cur, I_cur, p_cur = _eval_target(scene, cam, X, cfg)
    film = torch.zeros((height, width, C), device=X.device)
    for step in range(n_steps):
        X_prop, is_large = _mutate(X, step, chain_ids)
        L_prop, I_prop, p_prop = _eval_target(scene, cam, X_prop, cfg)
        a = torch.clamp_max(I_prop / torch.clamp_min(I_cur, 1e-12), 1.0)
        a = torch.where(I_cur <= 0, 1.0, a)
        w_prop = (a + is_large.to(torch.float32)) \
            / torch.clamp_min(I_prop / b + P_LARGE, 1e-12)
        w_cur = (1.0 - a) / torch.clamp_min(I_cur / b + P_LARGE, 1e-12)
        film = film_mod.splat(film, p_prop, L_prop * w_prop[:, None],
                              I_prop > 0)
        film = film_mod.splat(film, p_cur, L_cur * w_cur[:, None], I_cur > 0)
        accept = rng_mod.uniform(chain_ids, step, 9992, seed) < a
        X = torch.where(accept[:, None], X_prop, X)
        L_cur = torch.where(accept[:, None], L_prop, L_cur)
        I_cur = torch.where(accept, I_prop, I_cur)
        p_cur = torch.where(accept[:, None], p_prop, p_cur)
    return film


def bootstrap_samples(n_bootstrap: int, D: int, seed: int, device,
                      block: int = 1 << 16):
    """The bootstrap's primary samples (n_bootstrap, D): pcg4d of (id,
    dim, seed, 11), drawn in blocks of rows (each row is its own)."""
    rows = []
    dims = torch.arange(D, dtype=torch.int64, device=device)
    for lo in range(0, n_bootstrap, block):
        ids = torch.arange(lo, min(lo + block, n_bootstrap),
                           dtype=torch.int64, device=device)
        rows.append(rng_mod.u32_to_uniform(rng_mod.pcg4d(
            ids[:, None].expand(-1, D), dims[None, :].expand(ids.shape[0], D),
            seed, 11)[0]))
    return torch.cat(rows)


def eval_in_blocks(scene, cam, X, cfg, block: int):
    """``_eval_target`` over X in blocks of rows (each lane is its own):
    (L, I, p_film)."""
    outs = [_eval_target(scene, cam, X[lo:lo + block], cfg)
            for lo in range(0, X.shape[0], block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def bootstrap(scene, cam, n_bootstrap: int, D: int, seed: int, cfg, device):
    """The bootstrap (mlt.cpp:177-200): (Xb, I_boot, b) with b = E[I]
    over uniform primary samples, as a Python float."""
    Xb = bootstrap_samples(n_bootstrap, D, seed, device)
    block = (1 << 21) if device.type == "cuda" else (1 << 16)
    _, I_boot, _ = eval_in_blocks(scene, cam, Xb, cfg, block)
    return Xb, I_boot, float(I_boot.mean())


def start_states(Xb, I_boot, n_chains: int, seed: int):
    """Initial chain states resampled from the bootstrap ∝ I
    (mlt.cpp:204-210): (X (n_chains, D), the bootstrap indices)."""
    distr = make_distribution_1d(I_boot)
    chain_ids = torch.arange(n_chains, dtype=torch.int64,
                             device=I_boot.device)
    u0 = rng_mod.uniform(chain_ids, 0, 9991, seed)
    start_idx, _ = sample_distribution_1d_discrete(distr, u0)
    return Xb[start_idx], start_idx


def render_mlt(scene, cam, mutations_per_pixel: int = 4,
               n_chains: int = 4096, n_bootstrap: int = 16384,
               max_depth: int = 5, seed: int = 0, integrator: str = "path",
               device="cuda"):
    """MLTIntegrator::Render (mlt.cpp:165+): (H, W, C). The chains take
    max(1, W·H·mutations_per_pixel // n_chains) steps; ``seed`` keys the
    bootstrap, the start states and the acceptance draws."""
    device = require_device(device)
    scene = to_device(scene, device)
    cam = to_device(cam, device)
    width, height = cam.resolution
    C = scene.n_channels
    D = _n_dims(max_depth)
    cfg = RenderConfig(integrator=integrator, max_depth=max_depth, seed=0)
    Xb, I_boot, b = bootstrap(scene, cam, n_bootstrap, D, seed, cfg, device)
    if b <= 0:
        return torch.zeros((height, width, C), device=device)
    X, _ = start_states(Xb, I_boot, n_chains, seed)
    del Xb, I_boot
    n_steps = max(1, (width * height * mutations_per_pixel) // n_chains)
    film = _mlt_chains(scene, cam, X,
                       torch.tensor(b, dtype=torch.float32, device=device),
                       seed, cfg, n_steps, width, height)
    # Kelemen's weights already carry 1/b (w = ·/(I/b + pLarge)); what is
    # left is mutations → pixel area
    return film * (1.0 / (n_steps * n_chains / (width * height)))
