"""The kd-tree walk: closest triangle hit, or any hit, of each ray against a
kd-tree (scene/kdtree.py::KdTree).

pbrt_tpu walks its kd-tree in plain JAX (pbrt_tpu/scene/kdtree.py
``_traverse_one``, a vmapped ``lax.while_loop``; no Pallas kernel), so
this module's kernel, ``csrc/kd_traverse.cu``, is the port's own: pbrt's
near/far walk of KdTreeAccel::Intersect with the visited node in
registers and a stack of far children only, 8-byte nodes, 48-byte
triangle records in leaf order, persistent warps, one step (a node or a
triangle) a loop iteration, and an any-hit instantiation that ends a ray
at its first hit.

``kd_traverse`` dispatches on the device of its tensors: a CUDA tensor
launches the kernel (and adds one to ``kd_traverse.launches``, and to
``kd_traverse.any_hit_launches`` for the any-hit walk); a CPU tensor runs
``traverse_reference``, the plain-torch twin that walks the same nodes in
the same order with the same float operations, vectorised over rays as
pbrt_tpu's vmap is. Nothing falls back from one to the other. The walk
returns ``(t, prim)``: the closest hit distance below ``tmax`` (``tmax``
itself on a miss) and the triangle's index in the scene's table (−1 on a
miss); the any-hit walk's ``prim >= 0`` is the closest-hit walk's, and
its ``(t, prim)`` are those of the first hit it met. It is not
differentiated: callers run it under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes

import torch

from pbrt_tpu_torch.ops.intersect import _check, ray_tri_reference

LEAF = 3              # the kind of a leaf node (an interior node's: its axis)
MAX_DEPTH = 64        # the deepest tree the kernel walks (its stack)


def pack_nodes(split_pos, axis, above_child, n_prims):
    """The kernel's (N, 2) int32 node records, pbrt's 8-byte KdAccelNode:
    an interior node holds the split position's float bits and axis |
    above_child << 2; a leaf its first triangle record (its offset into
    ``prim_ids``) and 3 | n_prims << 2."""
    axis = axis.to(torch.int32)
    above = above_child.to(torch.int32)
    leaf = axis == LEAF
    split_bits = split_pos.to(torch.float32).view(torch.int32)
    return torch.stack([
        torch.where(leaf, above, split_bits),
        torch.where(leaf, LEAF | (n_prims.to(torch.int32) << 2),
                    axis | (above << 2))], dim=-1).contiguous()


def pack_tris(v0, v1, v2, prim_ids):
    """(E, 12) float32 triangle records in leaf order, one for each entry
    of ``prim_ids``: v0, e1 = v1 − v0, e2 = v2 − v0 (the edges the leaf
    test forms, pbrt_tpu's intersect_triangle_paired), the triangle's
    index as int bits, two words of padding: three float4 a record."""
    ids = prim_ids.long()
    a = v0[ids]
    rec = torch.zeros((ids.shape[0], 12), dtype=torch.float32,
                      device=v0.device)
    rec[:, 0:3] = a
    rec[:, 3:6] = v1[ids] - a
    rec[:, 6:9] = v2[ids] - a
    rec[:, 9] = prim_ids.to(torch.int32).view(torch.float32)
    return rec


def check_depth(kd):
    """Raise unless the kernel's stack holds the far children pending on
    every root path of ``kd`` (at most its depth)."""
    if kd.depth > MAX_DEPTH:
        raise ValueError(f"a kd-tree {kd.depth} levels deep needs more than "
                         f"the kernel's stack of {MAX_DEPTH}")


# ---------------------------------------------------------------------------
# the plain-torch twin
# ---------------------------------------------------------------------------

def _inv_dir(d):
    return 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)


def traverse_reference(kd, o, d, tmax, any_hit=False, counts=False):
    """What the kernel computes: pbrt_tpu's ``_traverse_one`` for every
    ray, each step visiting one node of every ray whose walk is not done:
    a skipped node or a leaf pops the stack of far children, an interior
    node descends (and pushes its far child when the ray reaches both).
    With ``any_hit`` a ray's walk ends at its first accepted hit. Returns
    (t (R,) float32, prim (R,) int32), and with ``counts`` also
    {"node_steps": nodes visited, "tri_tests": triangles tested}, each
    summed over the rays (the kernel's work on these rays)."""
    dev = o.device
    R = o.shape[0]
    nodes = kd.nodes.to(dev)
    tris = kd.tris.to(dev)
    n_rec = tris.shape[0]
    inv_d = _inv_dir(d)
    t0s = (kd.world_lo.to(dev) - o) * inv_d
    t1s = (kd.world_hi.to(dev) - o) * inv_d
    tn = torch.amax(torch.minimum(t0s, t1s), dim=-1)
    tf = torch.amin(torch.maximum(t0s, t1s), dim=-1)
    best_t = tmax.clone()
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dev)
    # the node each walk visits next, with its [tmin, tmax]
    tmin = torch.clamp_min(tn, 0.0)
    tmx = torch.minimum(tf, best_t)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    depth = max(kd.depth, 1)
    sn = torch.zeros((R, depth), dtype=torch.int64, device=dev)
    s0 = torch.zeros((R, depth), dtype=torch.float32, device=dev)
    s1 = torch.zeros((R, depth), dtype=torch.float32, device=dev)
    sp = torch.zeros(R, dtype=torch.int64, device=dev)
    n_steps, n_tests = 0, torch.zeros((), dtype=torch.int64, device=dev)
    lanes = torch.nonzero(tmin <= tmx)[:, 0]
    while lanes.numel():
        nd = node[lanes]
        t_lo = tmin[lanes]
        tmaxn = torch.minimum(tmx[lanes], best_t[lanes])
        skip = t_lo > tmaxn
        rec = nodes[nd]
        kind = rec[:, 1] & 3
        n_steps += lanes.numel()

        # leaves: their records in order, to the leaf's count
        leaf = ~skip & (kind == LEAF)
        pop = skip | leaf
        if bool(leaf.any()):
            ll = lanes[leaf]
            first, lc = rec[leaf, 0].long(), rec[leaf, 1] >> 2
            bt, bi = best_t[ll], best_i[ll]
            ol, dl = o[ll], d[ll]
            for k in range(int(lc.max())):
                row = tris[(first + k).clamp_max(n_rec - 1)]
                t, h = ray_tri_reference(ol, dl, row[:, :9], bt)
                tested = k < lc
                if any_hit:
                    tested = tested & (bi < 0)
                if counts:
                    n_tests += tested.sum()
                h = h & tested
                bt = torch.where(h, t, bt)
                bi = torch.where(h, row[:, 9].contiguous().view(torch.int32),
                                 bi)
            best_t[ll] = bt
            best_i[ll] = bi
            if any_hit:           # the walk ends at its first hit
                pop[leaf] = bi < 0

        # interior nodes: descend into the near child and push the far one,
        # or descend into the only child the ray's segment reaches
        inner = ~skip & (kind != LEAF)
        il = lanes[inner]
        if il.numel():
            axc = kind[inner].long()[:, None]
            o_ax = o[il].gather(1, axc)[:, 0]
            d_ax = d[il].gather(1, axc)[:, 0]
            i_ax = inv_d[il].gather(1, axc)[:, 0]
            split = rec[inner, 0].contiguous().view(torch.float32)
            above = (rec[inner, 1] >> 2).long()
            tmin_i, tmax_i, nd_i = t_lo[inner], tmaxn[inner], nd[inner]
            t_plane = (split - o_ax) * i_ax
            below_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0))
            first = torch.where(below_first, nd_i + 1, above)
            second = torch.where(below_first, above, nd_i + 1)
            near_only = (t_plane > tmax_i) | (t_plane <= 0)
            far_only = t_plane < tmin_i
            both = ~near_only & ~far_only
            bl = il[both]
            at = sp[bl]
            sn[bl, at] = second[both]
            s0[bl, at] = t_plane[both]
            s1[bl, at] = tmax_i[both]
            sp[bl] = at + 1
            node[il] = torch.where(near_only | both, first, second)
            tmx[il] = torch.where(both, t_plane, tmax_i)

        # a skipped node or a leaf: the next far child, or the walk ends
        pl = lanes[pop]
        pl = pl[sp[pl] > 0]
        top = sp[pl] - 1
        node[pl] = sn[pl, top]
        tmin[pl] = s0[pl, top]
        tmx[pl] = s1[pl, top]
        sp[pl] = top
        lanes = torch.cat([il, pl])
    if counts:
        return best_t, best_i, {"node_steps": n_steps,
                                "tri_tests": int(n_tests)}
    return best_t, best_i


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from pbrt_tpu_torch.ops import _build

    lib = _build.load("kd_traverse")
    if lib.kd_traverse_launch.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kd_traverse_launch.argtypes = [vp] * 8 + [i32] * 2 + [vp] * 2
        lib.kd_traverse_launch.restype = i32
    return lib


def kd_traverse(kd, o, d, tmax, any_hit=False):
    """Closest triangle hit (``any_hit``: the first hit met) of rays o, d
    (R,3) below tmax (R,) in the kd-tree ``kd`` (scene/kdtree.py::KdTree).
    Returns t (R,) float32 and prim (R,) int32.

    On the CPU this is the twin; on CUDA it launches the kernel and adds
    one to ``kd_traverse.launches`` (and ``.any_hit_launches``). Any other
    device raises."""
    if o.device.type == "cpu":
        return traverse_reference(kd, o, d, tmax, any_hit)
    dev = o.device
    if dev.type != "cuda":
        raise NotImplementedError(f"kd_traverse on {dev}")
    R = o.shape[0]
    f32 = torch.float32
    if R <= 0:
        raise ValueError(f"R={R}")
    check_depth(kd)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    _check("nodes", kd.nodes, torch.int32, (kd.nodes.shape[0], 2), dev)
    _check("tris", kd.tris, f32, (kd.tris.shape[0], 12), dev)
    world = torch.cat([kd.world_lo, kd.world_hi]).contiguous()
    _check("world", world, f32, (6,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().kd_traverse_launch(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), kd.nodes.data_ptr(),
        kd.tris.data_ptr(), world.data_ptr(), t.data_ptr(), prim.data_ptr(),
        R, int(bool(any_hit)), next_ray.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"kd_traverse kernel launch failed: CUDA error "
                           f"{err}")
    _counts.launches += 1
    _counts.any_hit_launches += bool(any_hit)
    return t, prim


# the counts live on the wrapper, also when a caller wraps the module's name
_counts = kd_traverse
kd_traverse.launches = 0
kd_traverse.any_hit_launches = 0
