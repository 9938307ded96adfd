"""The binary per-ray BVH traversal kernel, kept as the harness's yardstick
(the ``binary`` experiment of tools/kexp_run.py and chip_smoke.py's
old-against-new timings); no render path calls it.

It answers ops/bvh.py's query on the builder's binary tree: for each ray
the closest hit below ``tmax`` (or any hit) and the LEAF-ORDERED triangle
index, −1 on a miss. ``bvh_traverse_binary`` dispatches on the device of
its rays: a CUDA tensor launches ``csrc/bvh_binary.cu`` on the layout of
``pack_bvh`` (``binary_layout``); a CPU tensor runs ``_traverse_reference``,
the plain-torch twin that visits the same nodes and triangles in the same
order with the same arithmetic, over a layout of its own
(``_pack_threaded``, ``threaded_layout``). Both layouts are packed from a
scene/bvh.py::FlatBVH's flat tree when first asked for and kept while the
tree lives.
Nothing falls back from one to the other. The twin is pbrt_tpu's threaded
stackless walk (scene/bvh.py::_traverse_batch there), which the harness
also uses for its reference hits.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.ops.bvh import BIG, GSCALE, LEAF_MAX, TRI_F, _tri_records
from pbrt_tpu_torch.ops.intersect import _check

STACK = 64            # node indices a thread's stack holds (kStack)
NODE_F = 8            # floats per packed node


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
            f"of {need} entries (> STACK={STACK}); raise ops.bvh_binary."
            "STACK and kStack in csrc/bvh_binary.cu for this scene")
    n = right.shape[0]
    nodes = np.empty((n, NODE_F), np.float32)
    nodes[:, 0:3] = lo
    nodes[:, 3:6] = hi
    nodes[:, 6] = right.view(np.float32)
    nodes[:, 7] = ((count << 2) | np.asarray(axis, np.int32)).astype(
        np.int32).view(np.float32)
    return nodes, _tri_records(v0, v1, v2), need


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
    nodes8, tri9 = threaded_layout(bvh, o.device)
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
# the layouts of a tree, packed at first use
# ---------------------------------------------------------------------------

# (id of a tree's 4-wide node records, layout, device) -> (weak reference
# to those records, tables). The records stand for the tree: a copy of a
# scene to the device it is already on (scene/types.py::to_device, as every
# render makes) keeps them, so the copy finds the layouts; an entry goes
# when its records do.
_LAYOUTS: dict = {}


def _cached(bvh, kind, device, make):
    key = (id(bvh.nodes), kind, str(device))
    hit = _LAYOUTS.get(key)
    if hit is None or hit[0]() is not bvh.nodes:
        ref = weakref.ref(bvh.nodes, lambda _, k=key: _LAYOUTS.pop(k, None))
        hit = _LAYOUTS[key] = (ref, make())
    return hit[1]


def _host_tree(bvh):
    return tuple(x.cpu().numpy() for x in (bvh.lo, bvh.hi, bvh.right,
                                           bvh.count, bvh.axis, bvh.v0,
                                           bvh.v1, bvh.v2))


def threaded_layout(bvh, device):
    """The twin's layout of ``bvh``'s binary tree on ``device``: ``nodes8``
    (8N,10) float32, per direction octant o the row o*N+i = [lo, hi,
    first_if_hit, next_if_miss_or_done, off, cnt] with the int fields
    bitcast, and ``tri9`` (P+4,9) [v0|v1|v2] with LEAF_MAX degenerate rows
    of padding."""
    return _cached(bvh, "threaded", device, lambda: tuple(
        torch.tensor(a, device=device)
        for a in _pack_threaded(*_host_tree(bvh))))


def binary_layout(bvh, device):
    """The kernel's layout of ``bvh``'s binary tree on ``device``
    (``pack_bvh``): (nodes (N,8), tris (max(P,1),12), stack need)."""
    def make():
        nodes, tris, need = pack_bvh(*_host_tree(bvh))
        return (torch.tensor(nodes, device=device),
                torch.tensor(tris, device=device), need)

    return _cached(bvh, "binary", device, make)


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from pbrt_tpu_torch.ops import _build

    fn = _build.load("bvh_binary").bvh_binary_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [i32, ctypes.c_float, i32, i32, vp]
        fn.restype = i32
    return fn


def bvh_traverse_binary(bvh, o, d, tmax, any_hit: bool, *,
                        count_mode=False):
    """Traverse the binary tree of ``bvh`` (a scene/bvh.py::FlatBVH) with
    rays o, d (R,3) within tmax (R,). Returns t (R,) float32, leaf_i (R,)
    int32; with ``count_mode`` (CUDA only) leaf_i is ``n_pop·65536 +
    n_leaf``, the nodes popped and the leaves tested on the ray's walk.

    On the CPU this is the twin; on CUDA it launches the kernel (and adds
    one to ``bvh_traverse_binary.launches``). Any other device raises."""
    if o.device.type == "cpu":
        if count_mode:
            raise NotImplementedError("the threaded twin has no count mode")
        return _traverse_reference(bvh, o, d, tmax, any_hit)
    if o.device.type != "cuda":
        raise NotImplementedError(f"bvh_traverse_binary on {o.device}")
    dev = o.device
    R = o.shape[0]
    f32 = torch.float32
    nodes, tris, need = binary_layout(bvh, dev)
    if R <= 0 or need > STACK:
        raise ValueError(f"bad sizes R={R} stack_need={need}")
    _check("binary nodes", nodes, f32, (nodes.shape[0], NODE_F), dev)
    _check("binary tris", tris, f32, (tris.shape[0], TRI_F), dev)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    leaf_i = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(),
                 d.data_ptr(), tmax.data_ptr(), t.data_ptr(),
                 leaf_i.data_ptr(), R, GSCALE, int(bool(any_hit)),
                 int(bool(count_mode)), stream)
    if err != 0:
        raise RuntimeError(f"bvh_binary kernel launch failed: CUDA error "
                           f"{err}")
    bvh_traverse_binary.launches += 1
    return t, leaf_i


bvh_traverse_binary.launches = 0
