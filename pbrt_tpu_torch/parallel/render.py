"""Sharded render and the distributed inverse-rendering step over
torch.distributed (port of pbrt_tpu/parallel/render.py).

The decomposition is pbrt_tpu's (which replaces the reference's
ParallelFor2D tile pool, core/integrator.cpp:533-546), over ranks that
each drive one device:

- **dp** (the sample axis): ``spp`` is cut into dp chunks of
  ``ceil(spp / dp)`` samples; rank (i, ·) renders sample indices
  ``i·chunk + [0, chunk)``. One ``all_reduce`` (SUM) over the ranks of
  a dp column merges their films (the FilmTile merge, core/film.h:93).
- **sp** (the row axis): the film's rows, padded to a multiple of sp,
  are cut into slabs of ``ceil(H / sp)`` rows; rank (·, j) renders slab
  j. An ``all_gather`` over the ranks of an sp row assembles the image,
  which every rank then holds.

Each rank's slab is the port's ``render_pass`` with ``spp_offset`` and
``crop``; its sampler sees the padded film (``resolution=(W, h_eff)``),
as pbrt_tpu's does. Non-finite and negative lanes are zeroed in the pass
and the merged film is divided by ``spp_eff = chunk·dp``.

Gradients: the merge is an autograd function whose backward hands each
rank the image gradient of its own slab's rows. A rank that evaluates
the (replicated) loss and backpropagates thus gets its own share of the
parameter gradients: its samples of its slab, through the integrator's
autograd (on the main path the fused kernel's ``replay``). One
``all_reduce`` (SUM) of those shares over the mesh gives every rank the
whole gradient. The collectives run at every world size, one included.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.distributed as dist

from pbrt_tpu_torch.integrators.render import (RenderConfig,
                                               light_distribution,
                                               render_pass)
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene.types import to_device


def mesh_shape(n: int, axes=("dp", "sp")) -> dict:
    """pbrt_tpu's factorisation of n devices: dp alone for one axis, else
    (dp, sp) as square as possible with dp ≥ sp."""
    if len(axes) == 1:
        return {axes[0]: n}
    sp = 1
    for cand in range(math.isqrt(n), 0, -1):
        if n % cand == 0:
            sp = cand
            break
    return {axes[0]: n // sp, axes[1]: sp}


@dataclasses.dataclass(eq=False)
class Mesh:
    """A (dp, sp) grid of ranks, dp major (rank = i·sp + j), as seen by
    one rank: its coordinates, the group of its dp column (the ranks that
    render its slab, whose films are summed) and of its sp row (the ranks
    whose slabs make its image). Hashed by identity, so a training step
    can be cached per mesh."""
    shape: dict
    dp_index: int
    sp_index: int
    dp_group: object
    sp_group: object
    device: torch.device


def make_mesh(n_devices: int | None = None, axes=("dp", "sp"),
              shape=None) -> Mesh:
    """The mesh over the process group's ``n_devices`` ranks (default:
    all), factored as pbrt_tpu's ``make_mesh`` does, or as ``shape`` =
    (dp, sp) asks. Every rank calls it, in the same order as every other
    call that makes groups. Its device is the backend's: this rank's card
    under NCCL, the CPU under gloo."""
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a process group of "
                         f"{world}: one rank a device, all of them")
    if shape is None:
        sh = mesh_shape(n, axes)
        dp, sp = sh["dp"], sh.get("sp", 1)
    else:
        dp, sp = int(shape[0]), int(shape[1])
    if dp * sp != n or (len(axes) == 1 and sp != 1):
        raise ValueError(f"mesh {dp}×{sp} over {n} ranks")
    rank = dist.get_rank()
    # every rank makes every group, columns then rows
    cols = [dist.new_group([i * sp + j for i in range(dp)])
            for j in range(sp)]
    rows = [dist.new_group([i * sp + j for j in range(sp)])
            for i in range(dp)]
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    shape_out = {"dp": dp, "sp": sp} if len(axes) > 1 else {"dp": dp}
    return Mesh(shape=shape_out, dp_index=rank // sp, sp_index=rank % sp,
                dp_group=cols[rank % sp], sp_group=rows[rank // sp],
                device=device)


class _FilmMerge(torch.autograd.Function):
    """Forward: sum the dp column's slabs, gather the sp row's slabs into
    the (h_eff, W, C) film, crop it to ``height``. Backward: this rank's
    slab rows of the image gradient (the rows past ``height`` get none)."""

    @staticmethod
    def forward(ctx, local, mesh, height):
        rows = local.shape[0]
        slab = local.detach().contiguous().clone()
        dist.all_reduce(slab, op=dist.ReduceOp.SUM, group=mesh.dp_group)
        parts = [torch.empty_like(slab)
                 for _ in range(mesh.shape.get("sp", 1))]
        dist.all_gather(parts, slab, group=mesh.sp_group)
        ctx.row0, ctx.rows, ctx.height = mesh.sp_index * rows, rows, height
        return torch.cat(parts, 0)[:height]

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))
        stop = min(ctx.row0 + ctx.rows, ctx.height)
        if stop > ctx.row0:
            out[:stop - ctx.row0] = g[ctx.row0:stop]
        return out, None, None


def render_sharded(scene, cam, mesh: Mesh, spp: int = 16,
                   integrator: str = "path", sampler: str = "independent",
                   filter_name: str = "box", max_depth: int = 5,
                   seed: int = 0, light_strategy: str = "uniform",
                   resolution=None) -> torch.Tensor:
    """Render over the mesh → the (H, W, C) image, on every rank, on the
    mesh's device. ``spp`` is rounded up to a multiple of dp (a few extra
    samples, still unbiased) and the rows padded to a multiple of sp (the
    padded rows render off the film and are cropped away).
    ``resolution`` = (W, H) overrides the camera's."""
    width, height = (cam.resolution if resolution is None
                     else resolution)
    width, height = int(width), int(height)
    dp, sp = mesh.shape["dp"], mesh.shape.get("sp", 1)
    chunk = -(-spp // dp)
    spp_eff = chunk * dp
    h_eff = height + (-height) % sp
    rows = h_eff // sp
    dev = mesh.device
    scene = to_device(scene, dev)
    cam = to_device(cam, dev)
    filt = film_mod.make_filter(filter_name, device=dev)
    cfg = RenderConfig(integrator=integrator, sampler=sampler,
                       max_depth=max_depth, seed=seed,
                       light_strategy=light_strategy)
    local = render_pass(scene, cam, filt, cfg, width, h_eff, chunk,
                        mesh.dp_index * chunk, dev,
                        power_distr=light_distribution(scene, light_strategy),
                        crop=(0, mesh.sp_index * rows, width, rows))
    return _FilmMerge.apply(local, mesh, height) / spp_eff


# ---------------------------------------------------------------------------
# the distributed inverse-rendering training step
# ---------------------------------------------------------------------------

def _set_params(scene, p):
    """The scene with materials.kd and lights.emit replaced where ``p``
    has them (the parameters pbrt_tpu's step takes)."""
    mats = (dataclasses.replace(scene.materials, kd=p["kd"])
            if "kd" in p else scene.materials)
    lts = (dataclasses.replace(scene.lights, emit=p["emit"])
           if "emit" in p else scene.lights)
    return dataclasses.replace(scene, materials=mats, lights=lts)


@functools.lru_cache(maxsize=32)
def make_train_step(mesh: Mesh, spp=4, integrator="path", max_depth=3,
                    seed=0, resolution=None):
    """One training step over ``mesh``, made once per (mesh, config):
    ``step(scene, cam, params, target, lr) → (new_params, loss)``. The
    loss is the MSE of the sharded render against ``target``; each rank
    backpropagates its own share (its samples of its slab), the shares
    are summed over the mesh by one ``all_reduce`` a parameter, and every
    rank takes the same SGD step. ``params``: {"kd": materials.kd,
    "emit": lights.emit}, either or both."""

    def step(scene, cam, params, target, lr):
        names = sorted(params)
        leaves = {k: params[k].detach().clone().requires_grad_()
                  for k in names}
        img = render_sharded(_set_params(scene, leaves), cam, mesh, spp=spp,
                             integrator=integrator, max_depth=max_depth,
                             seed=seed, resolution=resolution)
        loss = torch.mean((img - target.to(img.device)) ** 2)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                    allow_unused=True)
        new = {}
        for k, g in zip(names, grads):
            g = torch.zeros_like(leaves[k]) if g is None else g.contiguous()
            dist.all_reduce(g, op=dist.ReduceOp.SUM)
            new[k] = (leaves[k] - lr * g).detach()
        return new, loss.detach()

    return step


def inverse_render_step(scene, cam, mesh: Mesh, target, params, lr=0.1,
                        spp=4, integrator="path", max_depth=3, seed=0):
    """One SGD step on ``params`` ({"kd", "emit"}) through the cached
    ``make_train_step`` of this mesh and config. Returns (new_params,
    loss)."""
    w, h = cam.resolution
    step = make_train_step(mesh, spp=spp, integrator=integrator,
                           max_depth=max_depth, seed=seed,
                           resolution=(int(w), int(h)))
    return step(scene, cam, params, target, lr)
