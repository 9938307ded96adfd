"""SAH kd-tree accelerator (port of pbrt_tpu/scene/kdtree.py).

Counterpart of ``accelerators/kdtreeaccel.cpp`` (KdTreeAccel: SAH build
:265, the flattened KdAccelNode array, the iterative walk :350), chosen
by ``Accelerator "kdtree"`` in a scene file over more than 256
triangles (frontend/parser.py, as pbrt_tpu's parser); the BVH stays the
default (scene/bvh.py).

``build_kdtree`` is pbrt_tpu's host SAH build in numpy: the same
candidate edges (on the widest axis that has any, at most 32 taken by
``linspace``), the same costs, the same rule for triangles flat on the
split plane and the same ``max_depth = round(8 + 1.3·log2 n)``, so its
arrays equal pbrt_tpu's. It counts triangles on each side of an edge by
binary search over the node's sorted bounds and splits the id lists with
masks, which gives the same counts and lists in the same order as
pbrt_tpu's per-edge sums and list comprehensions, in less host time.

Queries walk the tree through ops/kdtree.py (``csrc/kd_traverse.cu`` on
a CUDA tensor, its twin on a CPU tensor); the spheres and aaplanes then
go through the brute-force kernel with the walk's ``t`` as their bound,
as on the BVH path, and the disks in plain torch. As pbrt_tpu's kd path
(pbrt_tpu/scene/kdtree.py:251-287), there is no instance walk, no curve
fold and no shutter time. The any-hit query gives pbrt_tpu's answer, the
closest-hit query's ``valid``, through the walk's any-hit instantiation,
which stops at the first triangle hit; the other families are folded in
below ``tmax``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.ops import kdtree as kd_ops

MAX_PRIMS_PER_LEAF = 4
ISECT_COST = 80.0
TRAV_COST = 1.0
EMPTY_BONUS = 0.5


@dataclasses.dataclass
class KdTree:
    split_pos: torch.Tensor    # (N,) float32 split plane (leaf: 0)
    axis: torch.Tensor         # (N,) int32 0/1/2, 3 = leaf
    above_child: torch.Tensor  # (N,) int32 interior: the above child;
    #                            leaf: its offset into prim_ids
    n_prims: torch.Tensor      # (N,) int32 leaf prim count
    prim_ids: torch.Tensor     # (E,) int32 the leaves' triangle lists
    world_lo: torch.Tensor     # (3,) float32
    world_hi: torch.Tensor     # (3,)
    v0: torch.Tensor           # (T,3) triangles in the scene's order
    v1: torch.Tensor
    v2: torch.Tensor
    # the kernel's layout (ops/kdtree.py::pack_nodes, pack_tris)
    nodes: torch.Tensor        # (N,2) int32, 8-byte nodes
    tris: torch.Tensor         # (E,12) float32 records in leaf order: v0,
    #                            e1, e2, the triangle's index (int bits)
    max_leaf: int = MAX_PRIMS_PER_LEAF
    depth: int = 0             # interior nodes on the longest root path


def _tree_depth(axis, above):
    """Interior nodes on the longest root-to-leaf path of the flat tree
    (the below child of node i is i + 1)."""
    depth = np.zeros(len(axis), np.int64)
    for i in range(len(axis)):
        if axis[i] != kd_ops.LEAF:
            depth[i + 1] = depth[above[i]] = depth[i] + 1
    return int(depth.max()) if len(depth) else 0


def make_kdtree(split_pos, axis, above_child, n_prims, prim_ids, world_lo,
                world_hi, v0, v1, v2, max_leaf, device="cpu") -> KdTree:
    """A KdTree on ``device`` from the flat arrays (numpy or tensors)."""
    def t(x, dtype):
        return torch.as_tensor(np.array(np.asarray(x), dtype=dtype),
                               device=device)

    f32, i32 = np.float32, np.int32
    arrs = dict(split_pos=t(split_pos, f32), axis=t(axis, i32),
                above_child=t(above_child, i32), n_prims=t(n_prims, i32),
                prim_ids=t(prim_ids, i32), world_lo=t(world_lo, f32),
                world_hi=t(world_hi, f32), v0=t(v0, f32), v1=t(v1, f32),
                v2=t(v2, f32))
    return KdTree(**arrs,
                  nodes=kd_ops.pack_nodes(arrs["split_pos"], arrs["axis"],
                                          arrs["above_child"],
                                          arrs["n_prims"]),
                  tris=kd_ops.pack_tris(arrs["v0"], arrs["v1"], arrs["v2"],
                                        arrs["prim_ids"]),
                  max_leaf=int(max_leaf),
                  depth=_tree_depth(np.asarray(axis),
                                    np.asarray(above_child)))


def _sa(d):
    return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                + d[..., 2] * d[..., 0])


def build_kdtree(scene, max_depth=None) -> KdTree:
    """pbrt_tpu's ``build_kdtree`` over the scene's triangles, on the
    scene's device."""
    n = scene.n_tri
    v0, v1, v2 = (getattr(scene.geom, k)[:n].detach().cpu().numpy()
                  for k in ("tri_v0", "tri_v1", "tri_v2"))
    lo_p = np.minimum(np.minimum(v0, v1), v2)
    hi_p = np.maximum(np.maximum(v0, v1), v2)
    wlo = lo_p.min(0) - 1e-4
    whi = hi_p.max(0) + 1e-4
    if max_depth is None:
        max_depth = int(round(8 + 1.3 * np.log2(max(n, 1))))

    split_pos, axis, above, nprims, prim_ids = [], [], [], [], []

    def make_leaf(ids):
        split_pos.append(0.0)
        axis.append(3)
        above.append(len(prim_ids))
        nprims.append(len(ids))
        prim_ids.extend(ids.tolist())
        return len(axis) - 1

    def best_split(ids, blo, bhi):
        """(cost, axis, edge) of the cheapest candidate plane on the first
        axis (widest first) that has candidates, or None. The costs are
        pbrt_tpu's per-edge expressions evaluated elementwise; argmin keeps
        the first of equal costs, as its strict ``cost < best``."""
        d = bhi - blo
        total_sa = 2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
        inv_sa = 1.0 / max(total_sa, 1e-12)
        for ax in np.argsort(-d):
            lo_a, hi_a = lo_p[ids, ax], hi_p[ids, ax]
            edges = np.unique(np.concatenate([lo_a, hi_a]))
            edges = edges[(edges > blo[ax]) & (edges < bhi[ax])]
            if len(edges) == 0:
                continue
            if len(edges) > 32:
                edges = edges[np.linspace(0, len(edges) - 1, 32, dtype=int)]
            # prims starting below / ending above each edge
            nb = np.searchsorted(np.sort(lo_a), edges, side="left")
            na = len(ids) - np.searchsorted(np.sort(hi_a), edges,
                                            side="right")
            # float64, as pbrt_tpu's np.float32 edge against blo's float64
            e64 = edges.astype(np.float64)
            d0 = np.tile(d, (len(edges), 1))
            d0[:, ax] = e64 - blo[ax]
            d1 = np.tile(d, (len(edges), 1))
            d1[:, ax] = bhi[ax] - e64
            eb = np.where((nb == 0) | (na == 0), EMPTY_BONUS, 0.0)
            cost = TRAV_COST + ISECT_COST * (1 - eb) * inv_sa \
                * (_sa(d0) * nb + _sa(d1) * na)
            k = int(np.argmin(cost))
            return float(cost[k]), int(ax), edges[k]
        return None

    def build(ids, blo, bhi, depth):
        if len(ids) <= MAX_PRIMS_PER_LEAF or depth == 0:
            return make_leaf(ids)
        best = best_split(ids, blo, bhi)
        if best is None or best[0] > ISECT_COST * len(ids):
            return make_leaf(ids)
        _, ax, e = best
        lo_a, hi_a = lo_p[ids, ax], hi_p[ids, ax]
        # prims flat on the split plane (lo == hi == e) land below only
        below_ids = ids[(lo_a < e) | ((lo_a == e) & (hi_a == e))]
        above_ids = ids[hi_a > e]
        my = len(axis)
        split_pos.append(float(e))
        axis.append(ax)
        above.append(-1)
        nprims.append(0)
        bhi2 = bhi.copy()
        bhi2[ax] = e
        build(below_ids, blo.copy(), bhi2, depth - 1)
        blo3 = blo.copy()
        blo3[ax] = e
        above[my] = len(axis)
        build(above_ids, blo3, bhi.copy(), depth - 1)
        return my

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        build(np.arange(n), wlo.astype(np.float64), whi.astype(np.float64),
              max_depth)
    finally:
        sys.setrecursionlimit(old_limit)
    return make_kdtree(split_pos, axis, above, nprims, prim_ids or [0],
                       wlo, whi, v0, v1, v2,
                       max(nprims) if nprims else 1,
                       device=scene.geom.tri_v0.device)


def kdtree_intersect_tris(kd: KdTree, o, d, tmax, any_hit=False):
    """Closest triangle hit through the kd walk: (t, tri index, hit); with
    ``any_hit`` the first hit the walk meets (only ``hit`` is the closest
    hit's)."""
    t, i = kd_ops.kd_traverse(kd, o, d, tmax, any_hit)
    return t, i, i >= 0


# ---------------------------------------------------------------------------
# scene-level entry points (dispatched from scene/intersect.py when the
# aggregate is a KdTree: Accelerator "kdtree")
# ---------------------------------------------------------------------------

def _closest(scene, o, d, tmax):
    """(t, prim) of the closest triangle, sphere, aaplane or disk below
    tmax, pbrt_tpu's ``intersect_kd`` fold: the walk, then the spheres
    and aaplanes through the brute-force kernel below the walk's t (its
    strict ``t < best_t`` is pbrt_tpu's ``anyh & (tb < best_t)``), then
    the disks."""
    from pbrt_tpu_torch.scene import bvh as bvh_mod
    from pbrt_tpu_torch.scene import intersect as isect_mod

    o_q, d_q, tmax_q = bvh_mod._query_args(o, d, tmax)
    best_t = torch.clamp_max(tmax_q, ik.BIG)
    t, tri_idx, h = kdtree_intersect_tris(scene.bvh, o_q, d_q, best_t)
    upd = h & (t < best_t)
    best_t = torch.where(upd, t, best_t)
    prim_id = torch.where(upd, tri_idx, -1)
    if scene.n_sph or scene.n_pln:
        best_t, prim_b = bvh_mod._brute_families(scene, o_q, d_q, best_t)
        prim_id = torch.where(prim_b >= 0, prim_b + scene.n_tri, prim_id)
    return isect_mod.closest_disk(scene, o_q, d_q, best_t, prim_id)


def intersect_kd(scene, o, d, tmax, surface_only=False):
    """Closest hit of a scene whose aggregate is a kd-tree. The query is
    not differentiated."""
    from pbrt_tpu_torch.scene import intersect as isect_mod

    with torch.no_grad():
        best_t, prim_id = _closest(scene, o, d, tmax)
    return isect_mod.finalize_hit(scene, o, d, best_t, prim_id,
                                  surface_only)


def intersect_p_kd(scene, o, d, tmax):
    """Any-hit (shadow) query: pbrt_tpu's ``intersect_p_kd``, the closest
    hit's validity, which is whether any triangle, sphere, aaplane or disk
    is hit below tmax. The walk stops at its first triangle hit; the
    spheres and aaplanes through the brute-force kernel and the disks are
    then tested below the walk's t (tmax itself where it missed)."""
    from pbrt_tpu_torch.scene import bvh as bvh_mod
    from pbrt_tpu_torch.scene import intersect as isect_mod

    with torch.no_grad():
        o_q, d_q, tmax_q = bvh_mod._query_args(o, d, tmax)
        best_t = torch.clamp_max(tmax_q, ik.BIG)
        t, _, occ = kdtree_intersect_tris(scene.bvh, o_q, d_q, best_t,
                                          any_hit=True)
        if scene.n_sph or scene.n_pln:
            occ = occ | (bvh_mod._brute_families(scene, o_q, d_q, t)[1] >= 0)
        if scene.n_dsk:
            occ = occ | isect_mod.any_disk(scene, o_q, d_q, t)
    return occ
