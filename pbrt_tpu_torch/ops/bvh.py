"""Per-ray BVH traversal on 4-wide nodes (port of pbrt_tpu/ops/bvh_pallas.py).

For every ray it walks the BVH of a scene's triangles
(scene/bvh.py::FlatBVH) and returns ``(t, leaf_i)``: the closest hit
distance below ``tmax`` and the LEAF-ORDERED triangle index, −1 on a miss
(the caller maps it through ``prim_order``). With ``any_hit`` a ray stops
at its first hit and only ``leaf_i >= 0`` is meaningful.

The layout (``pack_wide``) is the BVH builder's own binary tree with its
leaves of at most ``LEAF_MAX`` = 4 triangles, two binary levels merged into
one 4-wide node, no leaf collapsed further. A node is one 128-byte record,
in breadth-first order: the four children's bounds transposed (``lo.x`` of
all four in one 16-byte word, and so on), the four slot encodings and the
parent's split axis. A slot's encoding is ``first << cnt_bits | count`` for
a leaf (its first triangle record and its triangle count), ``node <<
cnt_bits`` for a wide node, −1 for an empty slot. Triangles are 48-byte
records ``[v0.xyz e1.x] [e1.yz e2.xy] [e2.z pad pad pad]`` in leaf order,
so a record's index is the leaf-ordered index that ``prim_order`` maps.
``bvh_traverse`` dispatches on the device of its rays: a CUDA tensor
launches ``csrc/bvh_traverse.cu``; a CPU tensor runs
``_traverse_wide_reference``, the plain-torch twin that walks the same
records in the same order with the same arithmetic. Nothing falls back from
one to the other. The query is not differentiated (pbrt_tpu's custom_vjp
returns zero cotangents): callers run it under ``torch.no_grad()``.

The TPU kernel walks ray packets down a 4-wide tree whose leaves were
collapsed to at most 16 triangles, because a step of its shared-stack loop
costs far more than a masked triangle test. Here one thread walks one ray;
a wide node costs four slab tests from one 128-byte record, and a third of
the dependent steps of the binary walk (ops/bvh_binary.py, the harness's
``binary`` experiment) outweighs the bytes (PERF.md §6).
The packers ``_wide_nodes``, ``wide_stack_need`` and ``_bfs_records`` also
build the kernel-experiment harness's layouts (tools/kexp_kernels.py).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.ops.intersect import _check

BIG = 1e30
LEAF_MAX = 4          # triangles per leaf of the builders' trees
WIDE = 4              # children per node of the production layout
NODE_WORDS = {4: 32, 8: 64}   # a wide node: 7·wide + 1 words, padded
TRI_F = 12            # floats per triangle record: v0 e1 e2 + 3 pad
STACK = 96            # entries of a thread's stack (kStack)
# 1 + 2·gamma(3): the conservative scale of the slab test's far distance
GSCALE = 1.0 + 2.0 * vecmath.gamma(3)


# ---------------------------------------------------------------------------
# the packers (host, numpy)
# ---------------------------------------------------------------------------

def _collapse_tree(lo, hi, right, count, axis, max_leaf=16):
    """Collapse subtrees of at most ``max_leaf`` triangles into single
    leaves, giving a new flat DFS tree (host, numpy; pbrt_tpu's
    ops/bvh_pallas.py::_collapse_tree). The BVH build's DFS leaf order makes
    every subtree's triangles one contiguous range, so a collapsed leaf is
    just (start, count). Returns lo, hi (float32) and right, count, axis
    (int64) of the new tree. The harness's packers start from it; the
    production layout does not collapse."""
    lo, hi = np.asarray(lo), np.asarray(hi)
    right, count, axis = (np.asarray(x, np.int64) for x in (right, count,
                                                            axis))
    n = right.shape[0]
    start = np.zeros(n, np.int64)
    end = np.zeros(n, np.int64)
    # children come after their parent in DFS order, so a reverse sweep
    # sees them first
    for i in range(n - 1, -1, -1):
        if count[i] > 0:
            start[i] = right[i]
            end[i] = right[i] + count[i]
        else:
            start[i] = start[i + 1]
            end[i] = end[right[i]]
    out = dict(lo=[], hi=[], right=[], count=[], axis=[])
    # an explicit stack in place of recursion: (node, parent to patch)
    todo = [(0, -1)]
    while todo:
        i, patch = todo.pop()
        me = len(out["lo"])
        if patch >= 0:
            out["right"][patch] = me      # second child: after the first's
        out["lo"].append(lo[i])           # whole subtree
        out["hi"].append(hi[i])
        sub = end[i] - start[i]
        if count[i] > 0 or sub <= max_leaf:
            out["right"].append(int(start[i]))
            out["count"].append(int(sub))
            out["axis"].append(0)
            continue
        out["right"].append(-1)
        out["count"].append(0)
        out["axis"].append(int(axis[i]))
        todo.append((int(right[i]), me))
        todo.append((i + 1, -1))
    return (np.asarray(out["lo"], np.float32),
            np.asarray(out["hi"], np.float32),
            np.asarray(out["right"], np.int64),
            np.asarray(out["count"], np.int64),
            np.asarray(out["axis"], np.int64))


def _wide_nodes(lo, hi, right, count, axis, wide, leaf_target, cnt_bits):
    """Merge binary levels into ``wide``-wide nodes, numbered in pre-order
    from the root. A slot's encoding is ``target << cnt_bits | count``: the
    leaf's target (``leaf_target[node]``) and triangle count, a wide node's
    id with count 0, or −1 for an empty slot. Returns meta (wide+1, Nw)
    int32 (the encodings, then the parent's split axis) and nbs (6·wide,
    Nw) float32 (per slot lo.xyz, hi.xyz)."""
    right_l, count_l = right.tolist(), count.tolist()
    levels = {8: 3, 4: 2}[wide]
    wmeta, wslots = [], []

    def expand(i, depth):
        if depth == 0 or count_l[i] > 0:
            return [i]
        return expand(i + 1, depth - 1) + expand(right_l[i], depth - 1)

    # pre-order numbering with an explicit stack: (binary node, the wide
    # node and slot that point at it)
    todo = [(0, -1, -1)]
    while todo:
        b, parent, slot = todo.pop()
        wid = len(wmeta)
        if parent >= 0:
            wmeta[parent][slot] = wid << cnt_bits
        slots = [b] if count_l[b] > 0 else (
            expand(b + 1, levels - 1) + expand(right_l[b], levels - 1))
        row = [-1] * wide + [int(axis[b])]
        inner = []
        for k, si in enumerate(slots):
            if count_l[si] > 0:
                row[k] = int(leaf_target[si]) << cnt_bits | count_l[si]
            else:
                inner.append((si, wid, k))
        wmeta.append(row)
        wslots.append(slots + [-1] * (wide - len(slots)))
        todo.extend(reversed(inner))      # the first slot's subtree first
    top = max(max(r[:wide]) for r in wmeta)
    if top >= 2 ** 31:
        raise ValueError(
            f"a slot encoding ({top}) does not fit 32 bits: {len(wmeta)} "
            f"wide nodes and the leaf targets shifted by cnt_bits={cnt_bits}")
    meta = np.asarray(wmeta, np.int32).T.copy()
    slots = np.asarray(wslots, np.int64)                    # (Nw, wide)
    used = slots >= 0
    bounds = np.zeros((len(wmeta), wide, 6), np.float32)
    bounds[..., 0:3][used] = lo[slots[used]]
    bounds[..., 3:6][used] = hi[slots[used]]
    nbs = np.ascontiguousarray(bounds.reshape(len(wmeta), wide * 6).T)
    return meta, nbs


def wide_stack_need(meta, wide, cnt_bits) -> int:
    """Stack entries a walk can need: popping a wide node pushes up to c
    children (net c − 1), so U[w] = (c − 1) + max over children of U, 1
    for a leaf. Wide nodes are numbered parents first, so a reverse sweep
    sees children first (pbrt_tpu's ops/bvh_pallas.py::pack_bvh)."""
    enc = meta[:wide].T.astype(np.int64)
    mask = (1 << cnt_bits) - 1
    umax = np.ones(enc.shape[0], np.int64)
    for wid in range(enc.shape[0] - 1, -1, -1):
        e = enc[wid][enc[wid] >= 0]
        if e.size:
            leaf = (e & mask) > 0
            child = np.where(leaf, 1, umax[np.where(leaf, 0, e >> cnt_bits)])
            umax[wid] = (e.size - 1) + child.max()
    return int(umax[0])


def _bfs_records(meta, nbs, wide, cnt_bits):
    """The wide nodes of ``_wide_nodes`` as the kernels' records, in
    BREADTH-FIRST order (so "the first n" are the top of the tree): (Nw,
    32 | 64) float32, words ``f·W + k`` for f = lo.x lo.y lo.z hi.x hi.y
    hi.z of child k, words ``6W + k`` the slot encodings re-targeted to
    the new numbering and word ``7W`` the parent's split axis (int bits),
    padded to 128 or 256 bytes."""
    nw = meta.shape[1]
    mask = (1 << cnt_bits) - 1
    enc = meta[:wide].T.astype(np.int64)                    # (Nw, wide)
    inner = (enc >= 0) & ((enc & mask) == 0)
    # breadth-first order of the wide nodes, level by level
    order, front = [np.zeros(1, np.int64)], np.zeros(1, np.int64)
    while front.size:
        front = (enc[front] >> cnt_bits)[inner[front]]
        order.append(front)
    order = np.concatenate(order)
    if order.size != nw:
        raise ValueError(f"{order.size} of {nw} wide nodes reachable")
    new_id = np.empty(nw, np.int64)
    new_id[order] = np.arange(nw)
    enc = np.where(inner, new_id[np.where(inner, enc >> cnt_bits, 0)]
                   << cnt_bits, enc)
    nodes = np.zeros((nw, NODE_WORDS[wide]), np.float32)
    nodes[:, :6 * wide] = (nbs.T.reshape(nw, wide, 6).transpose(0, 2, 1)
                           .reshape(nw, 6 * wide))
    nodes[:, 6 * wide:7 * wide] = enc.astype(np.int32).view(np.float32)
    nodes[:, 7 * wide] = meta[wide].astype(np.int32).view(np.float32)
    return nodes[order]


def _tri_records(v0, v1, v2):
    """(max(P,1), 12) float32 records v0, e1 = v1 − v0, e2 = v2 − v0 and
    three floats of padding: three aligned 16-byte loads a triangle."""
    p = v0.shape[0]
    tris = np.zeros((max(p, 1), TRI_F), np.float32)
    tris[:p, 0:3] = v0
    tris[:p, 3:6] = v1 - v0
    tris[:p, 6:9] = v2 - v0
    return tris


def pack_wide(lo, hi, right, count, axis, v0, v1, v2):
    """Host-side packing of a flat DFS binary BVH (numpy in, numpy out;
    ``v0, v1, v2`` LEAF-ORDERED) into the traversal kernel's layout: 4-wide
    nodes over the tree's own leaves. Returns ``nodes`` (Nw, 32) float32
    (``_bfs_records``), ``tris`` (max(P,1), 12) float32
    (``_tri_records``), ``cnt_bits`` (the bits of a slot encoding that
    hold a leaf's count: enough for the largest leaf, at least 3) and the
    stack the walk needs. Raises when that exceeds what the kernel holds."""
    right = np.asarray(right, np.int64)
    count = np.asarray(count, np.int64)
    cnt_bits = max(3, int(count.max()).bit_length())
    meta, nbs = _wide_nodes(np.asarray(lo, np.float32),
                            np.asarray(hi, np.float32), right, count,
                            np.asarray(axis, np.int64), WIDE, right, cnt_bits)
    need = wide_stack_need(meta, WIDE, cnt_bits)
    if need > STACK:
        raise ValueError(
            f"the 4-wide tree needs a traversal stack of {need} entries "
            f"(> STACK={STACK}); raise ops.bvh.STACK and kStack in "
            "csrc/bvh_traverse.cu for this scene")
    return (_bfs_records(meta, nbs, WIDE, cnt_bits), _tri_records(v0, v1, v2),
            cnt_bits, need)


# ---------------------------------------------------------------------------
# the plain-torch twin
# ---------------------------------------------------------------------------

def _record_fields(tris, target, cnt):
    """The (n, L, 9) fields v0 e1 e2 of the leaves whose first record is
    ``target`` (L = the largest count; slots past a leaf's count read its
    last table row and are masked by the caller), and their int32 (n, L)
    leaf-ordered indices."""
    k = torch.arange(int(cnt.max()), device=target.device)
    idx = target[:, None] + k
    rec = tris[idx.clamp_max(tris.shape[0] - 1)]
    return rec[..., :9], idx.to(torch.int32)


def _traverse_wide_reference(nodes, cnt_bits, leaf_fields, o, d, tmax, *,
                             any_hit, prune=False, count_mode=False,
                             stats=None):
    """What the wide kernels compute, in plain torch over all rays at once:
    one stack per ray, held as an (R, STACK) tensor; every pass of the
    loop pops one entry of every ray still walking and runs the wide-node
    step on those that popped a node and the leaf step on those that
    popped a leaf, with the kernels' node order, push order, triangle order
    (strict ``t < best_t``) and arithmetic, so kernel and twin agree bit
    for bit. ``nodes`` are ``_bfs_records``; ``leaf_fields(target, cnt)``
    returns a leaf's (n, L, 9) triangle fields and (n, L) int32 indices
    (``_record_fields`` for the production layout; the harness's variants
    read their own). ``prune``: the stack also holds each entry's entry
    distance and a popped entry at or beyond ``best_t`` is skipped.
    Returns t (R,) float32 and idx (R,) int32: the leaf-ordered triangle
    index, or with ``count_mode`` ``n_int·65536 + n_leaf``, the wide-node
    and leaf steps of the ray's walk. ``stats``, if a dict, receives the
    counts of slab tests (non-empty slots), triangle tests and steps."""
    W = nodes.shape[1] // 8
    dev, R = o.device, o.shape[0]
    half, mask, cb = W // 2, (1 << cnt_bits) - 1, cnt_bits
    inv_d = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    best_t = torch.clamp_max(tmax, BIG).clone()
    best_i = torch.full((R,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((R, STACK), dtype=torch.int32, device=dev)
    tn_stack = torch.zeros((R, STACK), device=dev) if prune else None
    sp = torch.ones(R, dtype=torch.int64, device=dev)    # the root is pushed
    n_int = torch.zeros(R, dtype=torch.int64, device=dev)
    n_leaf = torch.zeros(R, dtype=torch.int64, device=dev)
    jj = torch.arange(W, device=dev)
    n_slab = n_tri = 0
    walking = torch.arange(R, device=dev)
    while walking.numel():
        top = sp[walking] - 1
        e = stack[walking, top].long()
        sp[walking] = top
        cnt, target = e & mask, e >> cb
        live = (tn_stack[walking, top] < best_t[walking]) if prune else \
            torch.ones_like(cnt, dtype=torch.bool)
        is_leaf = cnt > 0

        sel = is_leaf & live                      # ---- the leaf step
        li, lt, lc = walking[sel], target[sel], cnt[sel]
        if li.numel():
            f, tri_i = leaf_fields(lt, lc)
            ox, oy, oz = (o[li, k:k + 1] for k in range(3))
            dx, dy, dz = (d[li, k:k + 1] for k in range(3))
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = f.unbind(-1)
            # Möller–Trumbore in the kernel's operation order (ray_tri.cuh)
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            okd = det.abs() > 1e-12
            inv_det = torch.where(okd, 1.0 / det, 0.0)
            rx = ox - v0x
            ry = oy - v0y
            rz = oz - v0z
            u = (rx * px + ry * py + rz * pz) * inv_det
            qx = ry * e1z - rz * e1y
            qy = rz * e1x - rx * e1z
            qz = rx * e1y - ry * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            kk = torch.arange(f.shape[1], device=dev)
            ok = (okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (tt > 1e-4) & (kk < lc[:, None]))
            bt, bi = best_t[li], best_i[li]
            for k in range(f.shape[1]):
                hit = ok[:, k] & (tt[:, k] < bt)
                bt = torch.where(hit, tt[:, k], bt)
                bi = torch.where(hit, tri_i[:, k], bi)
            best_t[li], best_i[li] = bt, bi
            n_leaf[li] += 1
            n_tri += int(lc.sum())

        sel = ~is_leaf & live                     # ---- the wide-node step
        wi = walking[sel]
        if wi.numel():
            rec = nodes[target[sel]]
            lo = rec[:, :3 * W].reshape(-1, 3, W)
            hi = rec[:, 3 * W:6 * W].reshape(-1, 3, W)
            enc = rec[:, 6 * W:7 * W].contiguous().view(torch.int32)
            axis = rec[:, 7 * W:7 * W + 1].contiguous().view(torch.int32)
            t0 = (lo - o[wi][:, :, None]) * inv_d[wi][:, :, None]
            t1 = (hi - o[wi][:, :, None]) * inv_d[wi][:, :, None]
            tn = torch.minimum(t0, t1).amax(dim=1)
            tf = torch.maximum(t0, t1).amin(dim=1) * GSCALE
            enter = ((tn <= tf) & (tf > 0.0) & (tn < best_t[wi][:, None])
                     & (enc >= 0))
            # push order: slots 0..W-1 when the ray runs down the parent's
            # split axis, else the far half first; the last pushed is the
            # first popped
            sneg = torch.gather(d[wi], 1, axis.long()) < 0.0
            slot = torch.where(sneg, jj, (jj + half) % W)
            vk = torch.gather(enter, 1, slot)
            at = sp[wi][:, None] + torch.cumsum(vk, 1) - vk.long()
            rows = wi[:, None].expand(-1, W)[vk]
            stack[rows, at[vk]] = torch.gather(enc, 1, slot)[vk]
            if prune:
                tn_stack[rows, at[vk]] = torch.gather(tn, 1, slot)[vk]
            sp[wi] += vk.sum(1)
            n_int[wi] += 1
            n_slab += int((enc >= 0).sum())

        keep = sp[walking] > 0
        if any_hit:
            keep &= best_i[walking] < 0
        walking = walking[keep]
    if stats is not None:
        for key, val in (("slab_tests", n_slab), ("tri_tests", n_tri),
                         ("int_steps", int(n_int.sum())),
                         ("leaf_steps", int(n_leaf.sum()))):
            stats[key] = stats.get(key, 0) + val
    if count_mode:
        return best_t, (n_int * 65536 + n_leaf).to(torch.int32)
    return best_t, best_i


def traverse_reference(bvh, o, d, tmax, any_hit: bool, *, count_mode=False,
                       stats=None):
    """The twin on ``bvh``'s production layout (``nodes``, ``tris``,
    ``cnt_bits`` of a scene/bvh.py::FlatBVH)."""
    return _traverse_wide_reference(
        bvh.nodes, bvh.cnt_bits, functools.partial(_record_fields, bvh.tris),
        o, d, tmax, any_hit=any_hit, count_mode=count_mode, stats=stats)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from pbrt_tpu_torch.ops import _build

    fn = _build.load("bvh_traverse").bvh_traverse_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [i32, i32, ctypes.c_float, i32, i32, vp, vp]
        fn.restype = i32
    return fn


def bvh_traverse(bvh, o, d, tmax, any_hit: bool, *, count_mode=False,
                 persistent=True):
    """Traverse ``bvh`` (a scene/bvh.py::FlatBVH: ``nodes``, ``tris``,
    ``cnt_bits``, ``stack_need`` on the rays' device) with rays o, d (R,3)
    within tmax (R,). Returns t (R,) float32 and leaf_i (R,) int32 (with
    ``count_mode``, the step code of ``_traverse_wide_reference``).

    On the CPU this is the twin; on CUDA it launches the kernel (and adds
    one to ``bvh_traverse.launches``). Any other device raises. The render
    path launches the persistent grid, whose warps fetch 32 rays at a time;
    ``persistent=False`` (one thread per ray) is the harness's other side of
    that choice."""
    if o.device.type == "cpu":
        return traverse_reference(bvh, o, d, tmax, any_hit,
                                  count_mode=count_mode)
    if o.device.type != "cuda":
        raise NotImplementedError(f"bvh_traverse on {o.device}")
    dev, R, f32 = o.device, o.shape[0], torch.float32
    nodes, tris = bvh.nodes, bvh.tris
    if not 0 < R < 2 ** 30 or bvh.stack_need > STACK:
        raise ValueError(f"bad sizes R={R} stack_need={bvh.stack_need}")
    _check("nodes", nodes, f32, (nodes.shape[0], NODE_WORDS[WIDE]), dev)
    _check("tris", tris, f32, (tris.shape[0], TRI_F), dev)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    leaf_i = torch.empty(R, dtype=torch.int32, device=dev)
    # the next ray a persistent warp takes; zeroed on the launch's stream
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev) \
        if persistent else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(),
                 d.data_ptr(), tmax.data_ptr(), t.data_ptr(),
                 leaf_i.data_ptr(), R, bvh.cnt_bits, GSCALE,
                 int(bool(any_hit)), int(bool(count_mode)),
                 None if next_ray is None else next_ray.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse kernel launch failed: CUDA error "
                           f"{err}")
    bvh_traverse.launches += 1
    return t, leaf_i


bvh_traverse.launches = 0
