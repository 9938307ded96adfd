"""BVH: host-side build + flattened on-device traversal (port of
pbrt_tpu/scene/bvh.py).

Counterpart of ``accelerators/bvh.{h,cpp}``: the build (binned SAH with
spatial splits through the native C++ builder ``csrc/bvh_builder.cpp``,
or midpoint / equal-counts / Morton splits in numpy) runs on the host and
is flattened into the depth-first LinearBVHNode layout (bvh.cpp:223) as
tensors. The BVH covers the triangles only; the handful of spheres and
aaplanes of a scene stay brute force.

Closest-hit and any-hit queries go through the traversal kernel of
ops/bvh.py in the callers' ray order: on a CUDA tensor
``csrc/bvh_traverse.cu`` (one ray per thread with its own stack, 4-wide
nodes over the builder's ≤ 4-triangle leaves), on a CPU tensor the
kernel's twin, which walks the same records in the same order. The flat
node arrays stay on the host; only what a query reads goes to the scene's
device: the 4-wide layout and ``prim_order`` at build time.

Motion blur (tri rows 18 wide) is not ported and raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings

import numpy as np
import torch

from pbrt_tpu_torch.ops import bvh as bvh_ops
from pbrt_tpu_torch.ops import intersect as ik

LEAF_MAX = bvh_ops.LEAF_MAX
N_BUCKETS = 12


@dataclasses.dataclass
class FlatBVH:
    # the flat depth-first tree, on the host
    lo: torch.Tensor          # (N,3) node bounds
    hi: torch.Tensor          # (N,3)
    right: torch.Tensor       # (N,) interior: 2nd child; leaf: prim offset
    count: torch.Tensor       # (N,) 0 = interior, else leaf prim count
    axis: torch.Tensor        # (N,) split axis
    v0: torch.Tensor          # (P,3) leaf-ordered triangle copies
    v1: torch.Tensor
    v2: torch.Tensor
    # on the scene's device
    prim_order: torch.Tensor  # (P,) triangle index per leaf slot; under
    #                           spatial splits P > n_tri (duplicates)
    # the traversal kernel's layout (ops/bvh.py::pack_wide)
    nodes: torch.Tensor       # (Nw,32) float32 4-wide node records
    tris: torch.Tensor        # (max(P,1),12) float32 triangle records
    cnt_bits: int = 3         # bits of a slot encoding that hold a count
    stack_need: int = 1       # stack entries the per-ray walk needs
    built_by: str = ""        # native-sbvh | native-sah | numpy-<method>


def build_bvh(scene, split_method: str = "sah") -> FlatBVH:
    """BVH build (BVHAccel::recursiveBuild, bvh.cpp:203+), iterative with
    an explicit stack; flattened directly, and packed for the scene's
    device.

    ``split_method`` mirrors bvh.h:58 SplitMethod: "sah" (binned, through
    the native C++ builder with spatial splits, or the numpy loop below
    where there is no host compiler to build it with), "middle" (centroid midpoint), "equal" (median
    split), "hlbvh" (30-bit Morton order, splits at Morton bit prefixes)."""
    if split_method not in ("sah", "middle", "equal", "hlbvh"):
        raise ValueError(f"unknown BVH split method {split_method!r}")
    g = scene.geom
    device = g.tri_v0.device
    v0, v1, v2 = (x[:scene.n_tri].detach().cpu().numpy()
                  for x in (g.tri_v0, g.tri_v1, g.tri_v2))
    n = v0.shape[0]
    lo_p = np.minimum(np.minimum(v0, v1), v2)
    hi_p = np.maximum(np.maximum(v0, v1), v2)
    cent = 0.5 * (lo_p + hi_p)

    if split_method == "sah":
        native = _build_native(lo_p, hi_p, v0, v1, v2)
        if native is not None:
            *nodes, order, built_by = native
            return _finish_flat(*nodes, order, v0[order], v1[order],
                                v2[order], device=device, built_by=built_by)

    order = np.arange(n)
    morton = None
    if split_method == "hlbvh":
        # 30-bit Morton codes over the centroid bounds (bvh.cpp:203-204)
        clo_all = cent.min(0)
        cext = np.maximum(cent.max(0) - clo_all, 1e-12)
        q = np.minimum(((cent - clo_all) / cext) * 1024.0,
                       1023.0).astype(np.uint32)
        morton = ((_spread_bits10(q[:, 0]) << 2)
                  | (_spread_bits10(q[:, 1]) << 1) | _spread_bits10(q[:, 2]))
        perm = np.argsort(morton, kind="stable")
        order = order[perm]
        morton = morton[perm]
    nodes = []  # dicts: lo, hi, right, count, axis

    def make_leaf(lo, hi, start, count):
        nodes.append(dict(lo=lo, hi=hi, right=start, count=count, axis=0))

    # stack entries: (range_start, range_end, parent_idx, is_second_child)
    stack = [(0, n, -1, False)]
    while stack:
        start, end, parent, second = stack.pop()
        idxs = order[start:end]
        lo = lo_p[idxs].min(0)
        hi = hi_p[idxs].max(0)
        my_idx = len(nodes)
        if second and parent >= 0:
            nodes[parent]["right"] = my_idx
        count = end - start
        if count <= LEAF_MAX:
            make_leaf(lo, hi, start, count)
            continue
        c = cent[idxs]
        clo, chi = c.min(0), c.max(0)
        dim = int(np.argmax(chi - clo))
        if chi[dim] - clo[dim] < 1e-12:
            make_leaf(lo, hi, start, count)
            continue
        if split_method == "middle":
            # SplitMethod::Middle (bvh.cpp): centroid-midpoint partition
            pmid = 0.5 * (clo[dim] + chi[dim])
            left_mask = c[:, dim] < pmid
            if left_mask.sum() in (0, count):
                left_mask = np.zeros(count, bool)
                left_mask[np.argsort(c[:, dim],
                                     kind="stable")[:count // 2]] = True
            mid = _partition(order, idxs, left_mask, start, end)
        elif split_method == "equal":
            # SplitMethod::EqualCounts: median split along dim
            left_mask = np.zeros(count, bool)
            left_mask[np.argsort(c[:, dim],
                                 kind="stable")[:count // 2]] = True
            mid = _partition(order, idxs, left_mask, start, end)
        elif split_method == "hlbvh":
            # order is Morton-sorted: split where the highest differing
            # bit of the range's codes flips (LBVH treelet emission)
            m0, m1 = morton[start], morton[end - 1]
            if m0 == m1:
                mid = start + count // 2
            else:
                bit = int(m0 ^ m1).bit_length() - 1
                thresh = (int(m1) >> bit) << bit
                mid = start + int(np.searchsorted(morton[start:end],
                                                  thresh, side="left"))
                if mid in (start, end):
                    mid = start + count // 2
        else:
            # binned SAH
            b = np.minimum(((c[:, dim] - clo[dim]) / (chi[dim] - clo[dim])
                            * N_BUCKETS).astype(np.int32), N_BUCKETS - 1)
            costs = np.full(N_BUCKETS - 1, np.inf)
            for split in range(N_BUCKETS - 1):
                left = b <= split
                nl = left.sum()
                nr = count - nl
                if nl == 0 or nr == 0:
                    continue
                costs[split] = (
                    nl * _surface_area(lo_p[idxs[left]].min(0),
                                       hi_p[idxs[left]].max(0))
                    + nr * _surface_area(lo_p[idxs[~left]].min(0),
                                         hi_p[idxs[~left]].max(0)))
            split = int(np.argmin(costs))
            if not np.isfinite(costs[split]):
                mid = start + count // 2
            else:
                mid = _partition(order, idxs, b <= split, start, end)
        nodes.append(dict(lo=lo, hi=hi, right=-1, count=0, axis=dim))
        # push right first so left is processed next (depth-first: left
        # child = my_idx + 1)
        stack.append((mid, end, my_idx, True))
        stack.append((start, mid, my_idx, False))

    lo_a = np.stack([nd["lo"] for nd in nodes]).astype(np.float32)
    hi_a = np.stack([nd["hi"] for nd in nodes]).astype(np.float32)
    right_a = np.asarray([nd["right"] for nd in nodes], np.int32)
    count_a = np.asarray([nd["count"] for nd in nodes], np.int32)
    axis_a = np.asarray([nd["axis"] for nd in nodes], np.int32)
    return _finish_flat(lo_a, hi_a, right_a, count_a, axis_a, order,
                        v0[order], v1[order], v2[order], device=device,
                        built_by=f"numpy-{split_method}")


def _surface_area(a, b):
    return max(1e-12, 2.0 * ((b[0] - a[0]) * (b[1] - a[1])
                             + (b[1] - a[1]) * (b[2] - a[2])
                             + (b[2] - a[2]) * (b[0] - a[0])))


def _partition(order, idxs, left_mask, start, end):
    left_ids = idxs[left_mask]
    right_ids = idxs[~left_mask]
    order[start:start + len(left_ids)] = left_ids
    order[start + len(left_ids):end] = right_ids
    return start + len(left_ids)


def _finish_flat(lo_a, hi_a, right_a, count_a, axis_a, order, v0, v1, v2,
                 device="cpu", built_by="") -> FlatBVH:
    """Assemble the FlatBVH from numpy node arrays and the LEAF-ORDERED
    vertices ``v0, v1, v2`` (the BVH build's ``v[order]``; the tree of
    another package carries over through this too): the tree itself as host
    tensors, the kernel's 4-wide layout and ``prim_order`` on ``device``."""
    lo_a, hi_a = (np.ascontiguousarray(x, np.float32) for x in (lo_a, hi_a))
    right_a, count_a, axis_a = (np.ascontiguousarray(x, np.int32)
                                for x in (right_a, count_a, axis_a))
    v0, v1, v2 = (np.ascontiguousarray(x, np.float32) for x in (v0, v1, v2))
    nodes, tris, cnt_bits, need = bvh_ops.pack_wide(
        lo_a, hi_a, right_a, count_a, axis_a, v0, v1, v2)
    def t(a, device="cpu"):
        return torch.tensor(a, device=device)   # a copy: `a` may be read-only

    return FlatBVH(
        lo=t(lo_a), hi=t(hi_a), right=t(right_a), count=t(count_a),
        axis=t(axis_a), v0=t(v0), v1=t(v1), v2=t(v2),
        prim_order=t(np.asarray(order, np.int32), device),
        nodes=t(nodes, device), tris=t(tris, device), cnt_bits=cnt_bits,
        stack_need=need, built_by=built_by)


def _build_native(lo_p, hi_p, v0, v1, v2):
    """Call the C++ builder (csrc/bvh_builder.cpp, compiled by g++ at first
    use). None, with a warning, only where there is no g++: the numpy loop
    then takes over (minutes at 100,000 triangles, and no spatial splits).
    A compile or load that fails raises.

    Prefers the SBVH build (spatial splits with clipped-reference
    duplication, Stich et al. 2009): the emitted prim order may contain
    DUPLICATE references, which every consumer indexes through (the leaf
    tables are built from v0[order]). Falls back to the plain binned SAH
    entry when the duplication exceeds the output capacity."""
    from pbrt_tpu_torch.ops import _build

    try:
        lib = _build.load_host("bvh_builder")
    except _build.CompilerNotFound as err:
        warnings.warn(f"{err}; building the BVH with the numpy SAH loop")
        return None
    n = lo_p.shape[0]
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    c_int = ctypes.c_int
    lib.bvh_build_sbvh.restype = c_int
    lib.bvh_build_sbvh.argtypes = [fp, fp, fp, c_int, c_int, fp, fp, ip, ip,
                                   ip, ip, c_int, ip]
    lib.bvh_build_sah.restype = c_int
    lib.bvh_build_sah.argtypes = [fp, fp, c_int, c_int, fp, fp, ip, ip, ip,
                                  ip]

    def outputs(cap, order_cap):
        return (np.empty((cap, 3), np.float32), np.empty((cap, 3), np.float32),
                np.empty(cap, np.int32), np.empty(cap, np.int32),
                np.empty(cap, np.int32), np.empty(order_cap, np.int32))

    def ptrs(arrays):
        return [a.ctypes.data_as(fp if a.dtype == np.float32 else ip)
                for a in arrays]

    order_cap = 2 * max(n, 1)
    out = outputs(2 * order_cap, order_cap)
    vc = [np.ascontiguousarray(v, np.float32) for v in (v0, v1, v2)]
    n_refs = c_int(0)
    nn = lib.bvh_build_sbvh(*ptrs(vc), n, LEAF_MAX, *ptrs(out), order_cap,
                            ctypes.byref(n_refs))
    if nn > 0:
        return (*(a[:nn] for a in out[:5]), out[5][:n_refs.value],
                "native-sbvh")
    # capacity exceeded (pathological duplication) → SAH fallback

    out = outputs(2 * max(n, 1), n)
    bounds = [np.ascontiguousarray(x, np.float32) for x in (lo_p, hi_p)]
    nn = lib.bvh_build_sah(*ptrs(bounds), n, LEAF_MAX, *ptrs(out))
    if nn <= 0:
        return None
    return (*(a[:nn] for a in out[:5]), out[5], "native-sah")


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _spread_bits10(x):
    """Interleave-ready 10-bit spread (Morton encode helper), on a numpy
    uint32 array or an int64 tensor."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _ray_sort_order(o, d):
    """The permutation that sorts rays by direction octant, then by the
    30-bit Morton code of their origin (pbrt_tpu's ``_packet_traverse``
    key), as one stable sort of an int64 key (torch's CPU uint32 has no
    shifts). The render path does not sort: rays are independent in a
    per-ray kernel, and on the H100 the sort cost more than it saved
    (PERF.md). chip_smoke.py times the sorted order with it."""
    neg = (d < 0).to(torch.int64)
    octant = neg[:, 0] * 4 + neg[:, 1] * 2 + neg[:, 2]
    lo = o.amin(dim=0)
    hi = o.amax(dim=0)
    q = ((o - lo) / (hi - lo + 1e-9) * 1023.0).to(torch.int64).clamp(0, 1023)
    morton = ((_spread_bits10(q[:, 0]) << 2)
              | (_spread_bits10(q[:, 1]) << 1) | _spread_bits10(q[:, 2]))
    key = (octant << 27) | (morton >> 3)
    return torch.sort(key, stable=True).indices


def bvh_intersect_tris(bvh: FlatBVH, o, d, tmax):
    """Closest triangle hit via BVH, in the callers' ray order. Returns (t,
    global_tri_idx, hit)."""
    t, leaf_i = bvh_ops.bvh_traverse(bvh, o, d, tmax, False)
    hit = leaf_i >= 0
    tri_idx = torch.where(hit, bvh.prim_order[leaf_i.long().clamp_min(0)], -1)
    return t, tri_idx, hit


def bvh_intersect_p_tris(bvh: FlatBVH, o, d, tmax):
    return bvh_ops.bvh_traverse(bvh, o, d, tmax, True)[1] >= 0


# ---------------------------------------------------------------------------
# scene-level entry points (dispatched from scene/intersect.py)
# ---------------------------------------------------------------------------

def _brute_families(scene, o, d, tmax):
    """(t, prim) of the closest sphere or aaplane below tmax through the
    brute-force kernel (launched with no triangles); prim counts from 0
    over spheres then aaplanes, −1 where none is nearer than tmax (t is
    then tmax itself)."""
    tri, sph, pln = ik.pack_scene(scene, tris=False)
    return ik.intersect_brute(tri, sph, pln, o, d, tmax, 0, scene.n_sph,
                              scene.n_pln)


def _query_args(o, d, tmax):
    return (o.detach().contiguous(), d.detach().contiguous(),
            tmax.detach().contiguous())


def intersect_bvh(scene, o, d, tmax):
    """Closest hit of a scene with a BVH: the triangles through the
    traversal kernel, then the spheres and aaplanes brute force with the
    traversal's ``best_t`` as their tmax (the kernel's strict ``t <
    best_t`` is pbrt_tpu's update rule ``anyh & (tb < best_t)``). The query
    is not differentiated."""
    from pbrt_tpu_torch.scene import intersect as isect_mod

    with torch.no_grad():
        o_q, d_q, tmax_q = _query_args(o, d, tmax)
        best_t = torch.clamp_max(tmax_q, bvh_ops.BIG)
        t, tri_idx, h = bvh_intersect_tris(scene.bvh, o_q, d_q, best_t)
        upd = h & (t < best_t)
        best_t = torch.where(upd, t, best_t)
        prim_id = torch.where(upd, tri_idx, -1)
        if scene.n_sph or scene.n_pln:
            best_t, prim_b = _brute_families(scene, o_q, d_q, best_t)
            prim_id = torch.where(prim_b >= 0, prim_b + scene.n_tri, prim_id)
    return isect_mod.finalize_hit(scene, o, d, best_t, prim_id)


def intersect_p_bvh(scene, o, d, tmax):
    """Any-hit (shadow) query of a scene with a BVH → occluded mask."""
    with torch.no_grad():
        o_q, d_q, tmax_q = _query_args(o, d, tmax)
        occ = bvh_intersect_p_tris(scene.bvh, o_q, d_q, tmax_q)
        if scene.n_sph or scene.n_pln:
            occ = occ | (_brute_families(scene, o_q, d_q, tmax_q)[1] >= 0)
    return occ
