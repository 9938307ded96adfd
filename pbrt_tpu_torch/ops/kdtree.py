"""The kd-tree walk: closest triangle hit of each ray against a kd-tree
(scene/kdtree.py::KdTree).

pbrt_tpu walks its kd-tree in plain JAX (pbrt_tpu/scene/kdtree.py
``_traverse_one``, a vmapped ``lax.while_loop``; no Pallas kernel), so
this module's kernel, ``csrc/kd_traverse.cu``, is the port's own: one ray
a thread, the near/far (node, tmin, tmax) stack of pbrt's
KdTreeAccel::Intersect in local memory, nodes read through ``__ldg``.

``kd_traverse`` dispatches on the device of its tensors: a CUDA tensor
launches the kernel (and adds one to ``kd_traverse.launches``); a CPU
tensor runs ``traverse_reference``, the plain-torch twin that walks the
same nodes in the same order with the same float operations, vectorised
over rays as pbrt_tpu's vmap is. Nothing falls back from one to the
other. The walk returns ``(t, prim)``: the closest hit distance below
``tmax`` (``tmax`` itself on a miss) and the triangle's index in the
scene's table (−1 on a miss). It is not differentiated: callers run it
under ``torch.no_grad()``.
"""

from __future__ import annotations

import ctypes

import torch

from pbrt_tpu_torch.ops.intersect import _check, ray_tri_reference

STACK_DEPTH = 64      # csrc/kd_traverse.cu kStack, pbrt_tpu's STACK_DEPTH
LEAF = 3              # the axis value of a leaf


def pack_nodes(split_pos, axis, above_child, n_prims):
    """The kernel's (N, 4) int32 node records: the split position's float
    bits, the axis (3 = leaf), the above child (a leaf: its offset into
    ``prim_ids``) and the leaf's prim count."""
    return torch.stack([split_pos.to(torch.float32).view(torch.int32),
                        axis.to(torch.int32), above_child.to(torch.int32),
                        n_prims.to(torch.int32)], dim=-1).contiguous()


def pack_tris(v0, v1, v2):
    """(T, 9) float32 triangle rows v0, e1 = v1 − v0, e2 = v2 − v0: the
    edges the leaf test forms (pbrt_tpu's intersect_triangle_paired)."""
    return torch.cat([v0, v1 - v0, v2 - v0], dim=-1).contiguous()


# ---------------------------------------------------------------------------
# the plain-torch twin
# ---------------------------------------------------------------------------

def _inv_dir(d):
    return 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)


def traverse_reference(kd, o, d, tmax, counts=False):
    """What the kernel computes: pbrt_tpu's ``_traverse_one`` for every
    ray, each step of the loop advancing every ray whose stack is not
    empty. Returns (t (R,) float32, prim (R,) int32), and with ``counts``
    also {"node_steps": nodes popped, "tri_tests": triangles tested}, each
    summed over the rays (the kernel's work on these rays)."""
    dev = o.device
    R = o.shape[0]
    nodes = kd.nodes.to(dev)
    prim_ids = kd.prim_ids.to(dev)
    tris = kd.tris.to(dev)
    n_ids = prim_ids.shape[0]
    inv_d = _inv_dir(d)
    t0s = (kd.world_lo.to(dev) - o) * inv_d
    t1s = (kd.world_hi.to(dev) - o) * inv_d
    tn = torch.amax(torch.minimum(t0s, t1s), dim=-1)
    tf = torch.amin(torch.maximum(t0s, t1s), dim=-1)
    best_t = tmax.clone()
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dev)
    tmin0 = torch.clamp_min(tn, 0.0)
    tmax0 = torch.minimum(tf, best_t)
    sn = torch.zeros((R, STACK_DEPTH), dtype=torch.int64, device=dev)
    s0 = torch.zeros((R, STACK_DEPTH), dtype=torch.float32, device=dev)
    s1 = torch.zeros((R, STACK_DEPTH), dtype=torch.float32, device=dev)
    s0[:, 0] = tmin0
    s1[:, 0] = tmax0
    sp = (tmin0 <= tmax0).to(torch.int64)
    n_steps = n_tests = 0
    lanes = torch.nonzero(sp > 0)[:, 0]
    while lanes.numel():
        top = sp[lanes] - 1
        node = sn[lanes, top]
        tmin = s0[lanes, top]
        tmaxn = torch.minimum(s1[lanes, top], best_t[lanes])
        live = ~(tmin > tmaxn)
        rec = nodes[node]
        split = rec[:, 0].contiguous().view(torch.float32)
        ax, above, cnt = rec[:, 1], rec[:, 2].long(), rec[:, 3]
        n_steps += lanes.numel()

        # leaves: their triangles in prim_ids order, to the leaf's count
        leaf = live & (ax == LEAF)
        if bool(leaf.any()):
            ll = lanes[leaf]
            off, lc = above[leaf], cnt[leaf]
            n_tests += int(lc.sum())
            bt, bi = best_t[ll], best_i[ll]
            ol, dl = o[ll], d[ll]
            for k in range(int(lc.max())):
                pi = prim_ids[(off + k).clamp(0, n_ids - 1)]
                t, h = ray_tri_reference(ol, dl, tris[pi.long()], bt)
                h = h & (k < lc)
                bt = torch.where(h, t, bt)
                bi = torch.where(h, pi, bi)
            best_t[ll] = bt
            best_i[ll] = bi

        # interior nodes: push the far child under the near one, or only
        # the child the ray's segment reaches
        inner = live & (ax != LEAF)
        il = lanes[inner]
        spl = top[inner]
        if il.numel():
            axc = ax[inner].long().clamp(0, 2)[:, None]
            o_ax = o[il].gather(1, axc)[:, 0]
            d_ax = d[il].gather(1, axc)[:, 0]
            i_ax = inv_d[il].gather(1, axc)[:, 0]
            sp_i = split[inner]
            tmin_i, tmax_i = tmin[inner], tmaxn[inner]
            nd_i, ab_i = node[inner], above[inner]
            t_plane = (sp_i - o_ax) * i_ax
            below_first = (o_ax < sp_i) | ((o_ax == sp_i) & (d_ax <= 0))
            first = torch.where(below_first, nd_i + 1, ab_i)
            second = torch.where(below_first, ab_i, nd_i + 1)
            near_only = (t_plane > tmax_i) | (t_plane <= 0)
            far_only = t_plane < tmin_i
            both = ~near_only & ~far_only
            bl, bsp = il[both], spl[both]
            sn[bl, bsp] = second[both]
            s0[bl, bsp] = t_plane[both]
            s1[bl, bsp] = tmax_i[both]
            at = spl + both.long()
            sn[il, at] = torch.where(near_only, first,
                                     torch.where(far_only, second, first))
            s0[il, at] = tmin_i
            s1[il, at] = torch.where(both, t_plane, tmax_i)
            top = top.clone()
            top[inner] = at + 1
        sp[lanes] = top
        lanes = lanes[top > 0]
    if counts:
        return best_t, best_i, {"node_steps": n_steps, "tri_tests": n_tests}
    return best_t, best_i


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from pbrt_tpu_torch.ops import _build

    lib = _build.load("kd_traverse")
    if lib.kd_traverse_launch.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kd_traverse_launch.argtypes = [vp] * 9 + [i32] * 2 + [vp]
        lib.kd_traverse_launch.restype = i32
    return lib


def kd_traverse(kd, o, d, tmax):
    """Closest triangle hit of rays o, d (R,3) below tmax (R,) in the
    kd-tree ``kd`` (scene/kdtree.py::KdTree). Returns t (R,) float32 and
    prim (R,) int32.

    On the CPU this is the twin; on CUDA it launches the kernel (and adds
    one to ``kd_traverse.launches``). Any other device raises."""
    if o.device.type == "cpu":
        return traverse_reference(kd, o, d, tmax)
    if o.device.type != "cuda":
        raise NotImplementedError(f"kd_traverse on {o.device}")
    dev = o.device
    R = o.shape[0]
    f32 = torch.float32
    if R <= 0:
        raise ValueError(f"R={R}")
    if kd.depth + 1 > STACK_DEPTH:
        raise ValueError(f"a kd-tree {kd.depth} levels deep needs more than "
                         f"the kernel's stack of {STACK_DEPTH}")
    n_nodes, n_ids = kd.nodes.shape[0], kd.prim_ids.shape[0]
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    _check("nodes", kd.nodes, torch.int32, (n_nodes, 4), dev)
    _check("prim_ids", kd.prim_ids, torch.int32, (n_ids,), dev)
    _check("tris", kd.tris, f32, (kd.tris.shape[0], 9), dev)
    world = torch.cat([kd.world_lo, kd.world_hi]).contiguous()
    _check("world", world, f32, (6,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().kd_traverse_launch(
        o.data_ptr(), d.data_ptr(), tmax.data_ptr(), kd.nodes.data_ptr(),
        kd.prim_ids.data_ptr(), kd.tris.data_ptr(), world.data_ptr(),
        t.data_ptr(), prim.data_ptr(), R, n_ids, stream)
    if err != 0:
        raise RuntimeError(f"kd_traverse kernel launch failed: CUDA error "
                           f"{err}")
    kd_traverse.launches += 1
    return t, prim


kd_traverse.launches = 0
