"""Prep for the traversal-kernel experiments (port of tools/kexp_prep.py):
build a scene's BVH once, make the ray sets and the reference traversal
results, and save them as one ``.npz`` that every run of
``pbrt_tpu_torch.tools.kexp_run`` starts from.

Usage:
    python -m pbrt_tpu_torch.tools.kexp_prep [--scene heightfield|soup]
        [--size N] [--rays N] [--res N] [--out PATH] [--device cpu]

The file goes to ``build/kexp/<scene>.npz`` unless ``--out`` names another
place. It holds the binary flat tree (``lo hi right count axis v0 v1 v2``,
for the packers, and ``prim_order``, the triangle behind each leaf-ordered
slot: the BVH build's spatial splits put one triangle into several leaves),
the ray sets and, for 16,384 mixed rays, the hits of the binary traversal
twin ``ops/bvh_binary.py::_traverse_reference`` (``o_mix d_mix t_x i_x``).
Ray sets, ``--rays`` rays each (default 2,097,152, one 32-spp pass at
256²):

  o_p d_p      primary rays of the camera, as a render pass issues them;
  o_r d_r      random rays from triangle vertices plus N(0, 0.5²), in
               random directions;
  o_rs d_rs    the same random set in octant + origin-Morton order;
  o_b d_b      first-bounce rays: from the primary rays' hit points into
               the normal's hemisphere;
  d_sh tmax_sh shadow rays from the bounce origins ``o_b`` to points on the
               scene's first aaplane (its light), tmax just short of it;
  tmax         1e30 for the other sets.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

from pbrt_tpu_torch import entry
from pbrt_tpu_torch.integrators import render as render_mod
from pbrt_tpu_torch.ops import bvh_binary
from pbrt_tpu_torch.scene import bvh as bvh_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene.types import require_device

OUT_DIR = os.path.join("build", "kexp")
# the packers' eight inputs, then the triangle behind each leaf slot
TREE_KEYS = ("lo", "hi", "right", "count", "axis", "v0", "v1", "v2",
             "prim_order")
N_CHECK = 16384


def primary_rays(res, spp, device):
    """The res² × spp camera rays of one render pass (lane = sample ·
    res² + pixel), contiguous (o, d)."""
    rays, _, _, _ = render_mod.camera_rays(
        entry._camera((res, res), device),
        film_mod.make_filter("box", device=device),
        render_mod.RenderConfig(), res, res, spp, 0, device)
    return rays.o.contiguous(), rays.d.contiguous()


def random_rays(v0, n, seed=0):
    """Origins at random triangle vertices plus N(0, 0.5²), directions
    uniform on the sphere (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    pick = rng.randint(0, v0.shape[0], n)
    o = v0[pick] + rng.randn(n, 3).astype(np.float32) * 0.5
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d


def morton_order(o, d):
    """The permutation into direction-octant, then 30-bit origin-Morton
    order (numpy; the sorted-traversal ceiling of a ray sort)."""
    octant = ((d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2
              + (d[:, 2] < 0)).astype(np.uint32)
    lo, hi = o.min(0), o.max(0)
    q = np.clip((o - lo) / (hi - lo + 1e-9) * 1023.0, 0,
                1023).astype(np.uint32)
    morton = ((bvh_mod._spread_bits10(q[:, 0]) << 2)
              | (bvh_mod._spread_bits10(q[:, 1]) << 1)
              | bvh_mod._spread_bits10(q[:, 2]))
    key = (octant.astype(np.uint64) << 32) | morton.astype(np.uint64)
    return np.argsort(key, kind="stable")


def bounce_rays(scene, o, d):
    """Rays as a path's second bounce sends them: from the hit points of
    rays (o, d) (offset along the normal), in seeded random directions of
    the normal's hemisphere. Lanes that missed keep their ray."""
    dev = o.device
    inf = torch.full((o.shape[0],), math.inf, device=dev)
    hit = isect_mod.intersect(scene, o, d, inf)
    gen = torch.Generator(device="cpu").manual_seed(3)
    w = torch.nn.functional.normalize(
        torch.randn(o.shape[0], 3, generator=gen), dim=-1).to(dev)
    n = torch.where((hit.ng * d).sum(-1, keepdim=True) > 0, -hit.ng, hit.ng)
    w = torch.where((w * n).sum(-1, keepdim=True) < 0, -w, w)
    o2 = torch.where(hit.valid[:, None], hit.p + 1e-3 * n, o)
    d2 = torch.where(hit.valid[:, None], w, d)
    return o2.contiguous(), d2.contiguous()


def shadow_rays(scene, o):
    """Shadow rays as next-event estimation sends them: from the origins
    ``o`` to seeded uniform points on the scene's first aaplane (the light
    of entry.py's cornell scenes and soup), tmax just short of it. Returns
    (d, tmax)."""
    dev = o.device
    lo, hi = scene.geom.pln_lo[0], scene.geom.pln_hi[0]
    gen = torch.Generator(device="cpu").manual_seed(5)
    u = torch.rand(o.shape[0], 2, generator=gen).to(dev)
    a, b = [k for k in range(3) if k != int(scene.geom.pln_ax[0])]
    target = lo.expand(o.shape[0], 3).clone()
    target[:, a] += (hi[a] - lo[a]) * u[:, 0]
    target[:, b] += (hi[b] - lo[b]) * u[:, 1]
    w = target - o
    dist = w.norm(dim=-1)
    return (w / dist[:, None]).contiguous(), (dist * (1.0 - 1e-3)).contiguous()


def tree_arrays(bvh):
    """A FlatBVH as the file holds it: numpy arrays under TREE_KEYS."""
    return {k: getattr(bvh, k).cpu().numpy() for k in TREE_KEYS}


def prep(scene=None, *, n_rays=2_097_152, res=256, device="cuda", out=None):
    """Build the harness's inputs for ``scene`` (default
    ``entry._heightfield_cornell(device)``; it must live on ``device`` and
    carry a BVH) and return them as a dict of numpy arrays; saved to
    ``out`` when given. ``n_rays`` must be a multiple of ``res²``."""
    device = require_device(device)
    if scene is None:
        scene = entry._heightfield_cornell(device)
    if scene.bvh is None or n_rays % (res * res) or n_rays < 2:
        raise ValueError(f"prep needs a scene with a BVH and n_rays "
                         f"({n_rays}) a multiple of res² ({res * res})")
    bvh = scene.bvh
    z = tree_arrays(bvh)

    o_p, d_p = primary_rays(res, n_rays // (res * res), device)
    o_r, d_r = random_rays(z["v0"], n_rays)
    perm = morton_order(o_r, d_r)
    o_b, d_b = bounce_rays(scene, o_p, d_p)
    z.update(o_p=o_p.cpu().numpy(), d_p=d_p.cpu().numpy(), o_r=o_r, d_r=d_r,
             o_rs=o_r[perm], d_rs=d_r[perm], o_b=o_b.cpu().numpy(),
             d_b=d_b.cpu().numpy(), tmax=np.full(n_rays, 1e30, np.float32))
    if scene.n_pln:
        d_sh, tmax_sh = shadow_rays(scene, o_b)
        z.update(d_sh=d_sh.cpu().numpy(), tmax_sh=tmax_sh.cpu().numpy())

    # reference hits for the agreement checks: primary rays spread over
    # the image, then random rays
    half = min(N_CHECK, n_rays) // 2
    pick = np.arange(half) * (n_rays // half)
    z["o_mix"] = np.concatenate([z["o_p"][pick], o_r[:half]])
    z["d_mix"] = np.concatenate([z["d_p"][pick], d_r[:half]])
    t_x, i_x = bvh_binary._traverse_reference(
        bvh, torch.as_tensor(z["o_mix"], device=device),
        torch.as_tensor(z["d_mix"], device=device),
        torch.full((2 * half,), 1e30, device=device), False)
    z.update(t_x=t_x.cpu().numpy(), i_x=i_x.cpu().numpy())
    if out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez(out, **z)
    return z


def make_scene(name, device, size=None):
    """The harness's two scenes: ``heightfield`` (``size`` = the floor's
    side, default 256 → 133,130 triangles) and ``soup`` (``size`` = the
    triangle count, default 100,000)."""
    if name == "heightfield":
        return entry._heightfield_cornell(device, n=size or 256)
    if name == "soup":
        return entry._triangle_soup(device, n=size or 100_000)
    raise ValueError(f"unknown scene {name!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="heightfield",
                    choices=("heightfield", "soup"))
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--rays", type=int, default=2_097_152)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    out = args.out or os.path.join(OUT_DIR, f"{args.scene}.npz")
    z = prep(make_scene(args.scene, device, args.size), n_rays=args.rays,
             res=args.res, device=device, out=out)
    print("saved", out, {k: v.shape for k, v in z.items()})


if __name__ == "__main__":
    main()
