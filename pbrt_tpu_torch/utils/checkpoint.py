"""Render checkpoint and resume (port of pbrt_tpu/utils/checkpoint.py), a
capability the reference lacks (SURVEY.md §5: the film is written once at
the end).

The film's sum, the samples done and the seed are plain data, so a
checkpoint is one npz with pbrt_tpu's keys (``film_sum``, ``spp_done``,
``seed``, ``meta_*``): a checkpoint either package wrote resumes in the
other. Resuming continues at the recorded sample offset with the same
sample streams (the samplers key on the absolute sample index), so a
resumed render equals the uninterrupted one. As pbrt_tpu's, a resumed
render takes its seed from the caller, not from the checkpoint.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path: str, film_sum: np.ndarray, spp_done: int,
                    seed: int, meta: dict = None):
    """Write the checkpoint atomically (a temporary file, then a rename)."""
    tmp = path + ".tmp"
    np.savez_compressed(tmp, film_sum=np.asarray(film_sum),
                        spp_done=spp_done, seed=seed,
                        **{f"meta_{k}": v for k, v in (meta or {}).items()})
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load_checkpoint(path: str):
    z = np.load(path, allow_pickle=False)
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return dict(film_sum=z["film_sum"], spp_done=int(z["spp_done"]),
                seed=int(z["seed"]), meta=meta)


def render_with_checkpoints(scene, cam, spp, checkpoint_path, every_spp=32,
                            device="cuda", **render_kwargs) -> torch.Tensor:
    """Render ``spp`` samples in passes of ``every_spp``, writing the film
    after each pass to ``checkpoint_path`` (None: no file) and resuming
    from it where it exists. ``render_kwargs``: ``filter_name``,
    ``integrator``, ``sampler``, ``max_depth``, ``seed``. The film sums on
    the host in float32, as pbrt_tpu's. Returns the (H, W, C) image on
    ``device``."""
    from pbrt_tpu_torch.integrators.render import RenderConfig, render_pass
    from pbrt_tpu_torch.scene import film as film_mod
    from pbrt_tpu_torch.scene.types import require_device, to_device

    device = require_device(device)
    w, h = (int(x) for x in cam.resolution)
    filt = film_mod.make_filter(render_kwargs.pop("filter_name", "box"),
                                device=device)
    cfg = RenderConfig(
        integrator=render_kwargs.pop("integrator", "path"),
        sampler=render_kwargs.pop("sampler", "independent"),
        max_depth=render_kwargs.pop("max_depth", 5),
        seed=render_kwargs.pop("seed", 0))
    if render_kwargs:
        raise TypeError(f"unknown render arguments {sorted(render_kwargs)}")
    scene = to_device(scene, device)
    cam = to_device(cam, device)

    done = 0
    film = np.zeros((h, w, scene.n_channels), np.float32)
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = load_checkpoint(checkpoint_path)
        film = ck["film_sum"]
        done = ck["spp_done"]
    while done < spp:
        c = min(every_spp, spp - done)
        with torch.no_grad():
            out = render_pass(scene, cam, filt, cfg, w, h, c, done, device)
        film = film + out.cpu().numpy()
        done += c
        if checkpoint_path:
            save_checkpoint(checkpoint_path, film, done, cfg.seed)
    return torch.as_tensor(film / spp, device=device)
