"""Per-ray BVH traversal kernel (port of pbrt_tpu/ops/bvh_pallas.py).

For every ray it walks the binary BVH of a scene's triangles
(scene/bvh.py::FlatBVH) and returns ``(t, leaf_i)``: the closest hit
distance below ``tmax`` and the LEAF-ORDERED triangle index, −1 on a miss
(the caller maps it through ``prim_order``). With ``any_hit`` a ray stops
at its first hit and only ``leaf_i >= 0`` is meaningful.

``bvh_traverse`` dispatches on the device of its rays: a CUDA tensor
launches ``csrc/bvh_traverse.cu`` on the layout of ``pack_bvh``; a CPU
tensor runs ``_traverse_reference``, the plain-torch twin that visits the
same nodes and triangles in the same order with the same arithmetic, over
a layout of its own (``_pack_threaded``) that the tree makes on first use.
Nothing falls back from one to the other. The query is not differentiated
(pbrt_tpu's custom_vjp returns zero cotangents): callers run it under
``torch.no_grad()``.

The TPU kernel walks ray packets down a 4-wide tree whose leaves were
collapsed to at most 16 triangles, because a step of its shared-stack loop
costs far more than a masked triangle test. Here a step is one thread's
two 16-byte loads, and a triangle test (46 operations, 48 bytes) costs more
than a slab test (23 operations, 32 bytes), so the kernel walks the
builder's own binary tree with leaves of at most ``LEAF_MAX`` = 4 triangles:
fewer triangle tests per ray, and the same tree as the twin's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.ops.intersect import _check

BIG = 1e30
LEAF_MAX = 4          # triangles per leaf of the builders' trees
STACK = 64            # node indices a thread's stack holds (kStack)
NODE_F = 8            # floats per packed node
TRI_F = 12            # floats per packed triangle: v0 e1 e2 + 3 pad
# 1 + 2·gamma(3): the conservative scale of the slab test's far distance
GSCALE = 1.0 + 2.0 * vecmath.gamma(3)


def stack_need(right: np.ndarray, count: np.ndarray) -> int:
    """Stack entries the per-ray walk can need: popping an interior node
    pushes both children, so while the near child's subtree runs the far
    child waits below it; the worst order over rays costs one entry per
    level, i.e. the tree's depth counted in nodes. The tree is DFS-flat
    (a child's index is above its parent's), so a level-by-level sweep
    from the root reaches every node."""
    depth = 1
    front = np.zeros(1, np.int64)
    while True:
        inner = front[count[front] == 0]
        if inner.size == 0:
            return depth
        front = np.concatenate([inner + 1, right[inner].astype(np.int64)])
        depth += 1


def pack_bvh(lo, hi, right, count, axis, v0, v1, v2):
    """Host-side packing of a flat DFS binary BVH into the kernel's layout
    (numpy in, numpy out). ``v0, v1, v2`` are the LEAF-ORDERED vertices.

    Returns ``nodes`` (N,8) float32: lo.xyz, hi.xyz, then as int bits
    ``right`` (second child of an interior node, first triangle of a leaf)
    and ``count << 2 | axis``; ``tris`` (max(P,1),12) float32: v0, e1 =
    v1 − v0, e2 = v2 − v0 and three floats of padding, so a node is two and
    a triangle three aligned 16-byte loads; and the stack depth the walk
    needs. Raises when that exceeds what the kernel holds."""
    right = np.asarray(right, np.int32)
    count = np.asarray(count, np.int32)
    need = stack_need(right, count)
    if need > STACK:
        raise ValueError(
            f"the BVH is {need} nodes deep and its traversal needs a stack "
            f"of {need} entries (> STACK={STACK}); raise ops.bvh.STACK and "
            "kStack in csrc/bvh_traverse.cu for this scene")
    n = right.shape[0]
    nodes = np.empty((n, NODE_F), np.float32)
    nodes[:, 0:3] = lo
    nodes[:, 3:6] = hi
    nodes[:, 6] = right.view(np.float32)
    nodes[:, 7] = ((count << 2) | np.asarray(axis, np.int32)).astype(
        np.int32).view(np.float32)
    p = v0.shape[0]
    tris = np.zeros((max(p, 1), TRI_F), np.float32)
    tris[:p, 0:3] = v0
    tris[:p, 3:6] = v1 - v0
    tris[:p, 6:9] = v2 - v0
    return nodes, tris, need


def _collapse_tree(lo, hi, right, count, axis, max_leaf=16):
    """Collapse subtrees of at most ``max_leaf`` triangles into single
    leaves, giving a new flat DFS tree (host, numpy; pbrt_tpu's
    ops/bvh_pallas.py::_collapse_tree). The BVH build's DFS leaf order makes
    every subtree's triangles one contiguous range, so a collapsed leaf is
    just (start, count). Returns lo, hi (float32) and right, count, axis
    (int64) of the new tree. The wide-node packers of
    tools/kexp_kernels.py start from it."""
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


# ---------------------------------------------------------------------------
# plain-torch twin of the kernel: its per-octant threaded layout (host, built
# on first use) and the walk over it
# ---------------------------------------------------------------------------

def _octant_links(right: np.ndarray, count: np.ndarray, axis: np.ndarray):
    """Hit/miss successor links of the DFS-flat BVH for the 8 direction
    octants. For octant o at interior node i the near child is left (i+1)
    when direction bit (o >> axis[i]) & 1 == 0, else right[i]; ``miss`` is
    the node visited after i's subtree is exhausted or skipped.

    DFS layout ⇒ parent index < child index; far-child miss pointers form
    ancestor chains resolved by pointer jumping (log passes, no Python
    per-node loop). Returns (first (8,N), miss (8,N)) int32, miss sentinel
    = N (traversal done)."""
    N = right.shape[0]
    interior = count == 0
    idx = np.arange(N, dtype=np.int32)
    left = idx + 1
    ii = np.nonzero(interior)[0]
    parent = np.full(N, -1, np.int32)
    parent[left[ii]] = ii
    parent[right[ii]] = ii

    first = np.zeros((8, N), np.int32)
    miss = np.empty((8, N), np.int32)
    has_parent = parent >= 0
    p_safe = np.maximum(parent, 0)
    for o in range(8):
        bit = (o >> axis) & 1                       # per-node direction bit
        near = np.where(bit == 0, left, right).astype(np.int32)
        first[o] = np.where(interior, near, 0)
        # a node's miss: root → N; near child of p → far sibling;
        # far child of p → miss[p] (chase ancestors)
        pbit = bit[p_safe]
        p_near = np.where(pbit == 0, left[p_safe], right[p_safe])
        is_near = has_parent & (idx == p_near)
        is_far = has_parent & ~is_near
        base = np.where(is_near,
                        np.where(pbit == 0, right[p_safe], left[p_safe]),
                        N).astype(np.int32)        # root/far placeholder N
        # src chain: far children take their parent's value
        src = np.where(is_far, parent, idx).astype(np.int32)
        for _ in range(max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)):
            nxt = src[src]
            if np.array_equal(nxt, src):
                break
            src = nxt
        miss[o] = base[src]
    return first, miss


def _pack_threaded(bvh_lo, bvh_hi, right, count, axis, v0, v1, v2, dv=None):
    """Pack per-octant node rows (8N, 10) + padded leaf triangles (P+pad, 9)
    so each traversal step is one node-row gather and one 4-row tri gather.
    Two-keyframe motion (``dv``, 18-column tri rows) is not ported."""
    if dv is not None:
        raise NotImplementedError("motion blur: ROADMAP queue 1 item 8")
    N = right.shape[0]
    first, miss = _octant_links(right, count, axis)
    lo = np.asarray(bvh_lo, np.float32)
    hi = np.asarray(bvh_hi, np.float32)
    P = v0.shape[0]
    pad = LEAF_MAX
    # leaf off/cnt; interior nodes point at the degenerate pad rows
    is_leaf = count > 0
    off = np.where(is_leaf, right, P).astype(np.int32)
    cnt = count.astype(np.int32)
    rows = np.empty((8, N, 10), np.float32)
    rows[:, :, 0:3] = lo[None]
    rows[:, :, 3:6] = hi[None]
    rows[:, :, 6] = first.astype(np.int32).view(np.float32)
    rows[:, :, 7] = miss.astype(np.int32).view(np.float32)
    rows[:, :, 8] = off.view(np.float32)[None]
    rows[:, :, 9] = cnt.view(np.float32)[None]
    tri9 = np.zeros((P + pad, 9), np.float32)
    tri9[:P, 0:3] = v0
    tri9[:P, 3:6] = v1
    tri9[:P, 6:9] = v2
    return rows.reshape(8 * N, 10), tri9


def _traverse_reference(bvh, o, d, tmax, any_hit: bool, stats=None):
    """What the kernel computes, vectorized over rays: pbrt_tpu's threaded
    stackless walk (scene/bvh.py::_traverse_batch there) over the whole
    (R,) batch, a Python loop whose step is one node-row gather, one slab
    test, one 4-row triangle gather and selects, until every ray is done.
    Per direction octant it visits the nodes near-first by the kernel's
    sign rule and tests a leaf's triangles in the kernel's order
    (sequential, strict ``t < best_t``), with the kernel's arithmetic and
    start value min(tmax, 1e30), so the two agree bit for bit. Returns t
    (R,) float32 and leaf_i (R,) int32. ``stats``, if a dict, receives the
    counts of slab and triangle tests made."""
    R = o.shape[0]
    nodes8, tri9 = bvh.threaded(o.device)
    N = nodes8.shape[0] // 8
    inv_d = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    neg = (d < 0).to(torch.int64)
    base = (neg[:, 0] | (neg[:, 1] << 1) | (neg[:, 2] << 2)) * N
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    k4 = torch.arange(LEAF_MAX, device=o.device)
    pad_rows = tri9.shape[0] - LEAF_MAX + k4

    cur = torch.zeros(R, dtype=torch.int64, device=o.device)
    best_t = torch.clamp_max(tmax, BIG)
    best_i = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    n_slab = n_tri = 0
    while True:
        active = cur < N
        if not bool(active.any()):
            break
        rows = nodes8[base + cur.clamp_max(N - 1)]          # (R,10)
        first, miss, off, cnt = (rows[:, 6:10].contiguous()
                                 .view(torch.int32).long().unbind(-1))
        hit_box = active & vecmath.bounds_intersect_p(
            rows[:, 0:3], rows[:, 3:6], o, inv_d, best_t)
        is_leaf = cnt > 0
        do_leaf = hit_box & is_leaf
        if stats is not None:
            n_slab += int(active.sum())
            n_tri += int(cnt[do_leaf].sum())

        # up to LEAF_MAX triangles in one gather: (R,4,9)
        pidx = torch.where(do_leaf[:, None], off[:, None] + k4, pad_rows)
        tr = tri9[pidx]
        v0x, v0y, v0z = tr[..., 0], tr[..., 1], tr[..., 2]
        e1x, e1y, e1z = tr[..., 3] - v0x, tr[..., 4] - v0y, tr[..., 5] - v0z
        e2x, e2y, e2z = tr[..., 6] - v0x, tr[..., 7] - v0y, tr[..., 8] - v0z
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
        t4 = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok4 = (okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t4 > 1e-4)
               & (k4 < cnt[:, None]) & do_leaf[:, None])
        for k in range(LEAF_MAX):
            hit = ok4[:, k] & (t4[:, k] < best_t)
            best_t = torch.where(hit, t4[:, k], best_t)
            best_i = torch.where(hit, (off + k).to(torch.int32), best_i)

        nxt = torch.where(hit_box & ~is_leaf, first, miss)
        if any_hit:
            nxt = torch.where(best_i >= 0, N, nxt)
        cur = torch.where(active, nxt, cur)
    if stats is not None:
        stats["slab_tests"] = stats.get("slab_tests", 0) + n_slab
        stats["tri_tests"] = stats.get("tri_tests", 0) + n_tri
    return best_t, best_i


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from pbrt_tpu_torch.ops import _build

    fn = _build.load("bvh_traverse").bvh_traverse_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [i32, ctypes.c_float, i32, vp]
        fn.restype = i32
    return fn


def bvh_traverse(bvh, o, d, tmax, any_hit: bool):
    """Traverse ``bvh`` (a scene/bvh.py::FlatBVH packed for the rays' device:
    ``pk_nodes``, ``pk_tris``, ``stack_need``, ``threaded(device)``) with
    rays o, d (R,3) within tmax (R,). Returns t (R,) float32, leaf_i (R,)
    int32.

    On the CPU this is the twin; on CUDA it launches the kernel (and adds
    one to ``bvh_traverse.launches``). Any other device raises."""
    if o.device.type == "cpu":
        return _traverse_reference(bvh, o, d, tmax, any_hit)
    if o.device.type != "cuda":
        raise NotImplementedError(f"bvh_traverse on {o.device}")
    dev = o.device
    R = o.shape[0]
    f32 = torch.float32
    nodes, tris = bvh.pk_nodes, bvh.pk_tris
    if R <= 0 or bvh.stack_need > STACK:
        raise ValueError(f"bad sizes R={R} stack_need={bvh.stack_need}")
    _check("pk_nodes", nodes, f32, (nodes.shape[0], NODE_F), dev)
    _check("pk_tris", tris, f32, (tris.shape[0], TRI_F), dev)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    leaf_i = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(),
                 d.data_ptr(), tmax.data_ptr(), t.data_ptr(),
                 leaf_i.data_ptr(), R, GSCALE, int(bool(any_hit)), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse kernel launch failed: CUDA error "
                           f"{err}")
    bvh_traverse.launches += 1
    return t, leaf_i


bvh_traverse.launches = 0
