"""Wide-BVH traversal variants and the shared-memory probe (port of
tools/kexp_kernels.py and of tools/kexp_run.py::exp_smem_probe).

The query is ops/bvh.py's: for each ray the closest triangle hit below
``tmax`` (or any hit) and the LEAF-ORDERED triangle index, −1 on a miss.
The tree is a wide one: ``pack_params`` collapses the BVH build's binary tree
to leaves of at most ``leaf_max`` triangles and merges two or three binary
levels into 4- or 8-wide nodes; ``pack_dual_leaf`` does the same with leaf
blocks of two sizes. Both return pbrt_tpu's tables (``meta``, ``nbs``,
``blocks``), which ``make_layout`` turns into what the CUDA kernel reads.
The merge into wide nodes (``_wide_nodes``), their breadth-first records
and the twin's walk are ops/bvh.py's, which builds the render path's
4-wide layout with them; the harness adds its own leaf formats.

Variants, as in pbrt_tpu's experiment kernel:

  1   node records staged in shared memory (the first ``smem_nodes`` wide
      nodes in breadth-first order; the rest come through L2), leaf fields
      read one float at a time from the 128-float leaf rows;
  2   1 + leaves read as aligned 48-byte triangle records (three 16-byte
      loads);
  3   2 + entry-distance pruning: the stack holds (encoding, entry
      distance) pairs and a popped entry at or beyond ``best_t`` is skipped
      (never in any-hit mode);
  5   the dual-size leaf rows of ``pack_dual_leaf`` (one row for at most 8
      triangles, two above);
  +10 count mode: the index output carries ``n_int·65536 + n_leaf``, the
      wide-node and leaf steps of the ray's walk.

``traverse`` dispatches on the device of its rays: a CUDA tensor launches
``csrc/kexp_traverse.cu`` (one ray per thread with its own stack, the near
half of a node's children first by the ray's own direction sign), a CPU
tensor runs ``_traverse_wide_reference``, the plain-torch twin that walks
the same nodes and triangles in the same order with the same arithmetic.
Nothing falls back from one to the other. Every launch runs persistent
warps (each takes the next 32 rays from a counter zeroed on the launch's
stream); a staged launch runs one block per SM over unpadded, swizzled
records (``staged_image`` is the shared memory it fills). ``smem_probe``
launches ``csrc/smem_probe.cu``: one block that asks for ``kb`` KB of dynamic shared
memory, writes both ends of it and returns ``x + x[0, 1]``; the size the
kernel may ask for is set only when it differs from the last one granted
(``_ProbeSizes``). ``l2_window`` is the harness's L2 experiment on the
render path's kernel (ops/bvh.py::bvh_traverse): an access-policy window
over its tree on a stream of the experiment's own.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from pbrt_tpu_torch.ops import bvh as bvh_ops
from pbrt_tpu_torch.ops.bvh import (GSCALE, NODE_WORDS, STACK, _bfs_records,
                                    _collapse_tree, _wide_nodes,
                                    wide_stack_need)
from pbrt_tpu_torch.ops.intersect import _check
from pbrt_tpu_torch.scene.types import require_device

LANES = 128            # floats per leaf row
TRI_F = 10             # floats per triangle in a leaf row: v0 e1 e2 index
TRIS_PER_LEAF_ROW = 12
REC_F = 12             # floats per 48-byte triangle record
BLOCKS = (64, 128, 256)       # threads per block the kernel takes
SWIZZLE = 8    # staged chunk c of record r sits in slot c ^ (r % SWIZZLE)
VARIANTS = (1, 2, 3, 5)
DUAL_PP = dict(wide=4, leaf_max=16, cnt_bits=5, block_rows=2,
               tris_per_row=TRIS_PER_LEAF_ROW)
SMEM_DOCUMENTED_KB = 227      # what one block may ask for on an H100


# ---------------------------------------------------------------------------
# the packers (host, numpy): pbrt_tpu's tables, array for array
# ---------------------------------------------------------------------------

def _leaf_triangles(right, count):
    """For every triangle of every leaf, in leaf order: the leaf's number
    b, its slot k in the leaf and its leaf-ordered index; and the leaves'
    node ids."""
    leaves = np.where(count > 0)[0]
    cn = count[leaves]
    b = np.repeat(np.arange(len(leaves)), cn)
    k = np.arange(int(cn.sum())) - np.repeat(np.cumsum(cn) - cn, cn)
    return leaves, b, k, np.repeat(right[leaves], cn) + k


def _fill_rows(blocks, row, base, tri, v0, e1, e2):
    """Write triangles ``tri`` as 10-float records at (row, base)."""
    cols = base[:, None] + np.arange(3)
    blocks[row[:, None], cols] = v0[tri]
    blocks[row[:, None], cols + 3] = e1[tri]
    blocks[row[:, None], cols + 6] = e2[tri]
    blocks[row, base + 9] = tri.astype(np.float32)


def pack_params(lo, hi, right, count, axis, v0, v1, v2, *, wide=4,
                leaf_max=16):
    """Parametrized host packer: binary flat tree → (meta (W+1, Nw) int32,
    nbs (6W, Nw) float32, leaf blocks (n_leaf·block_rows, 128) float32,
    pp). A leaf block holds its triangles as 10-float records (v0, e1, e2,
    leaf-ordered index), 12 to a row."""
    lo, hi, right, count, axis = _collapse_tree(lo, hi, right, count, axis,
                                                max_leaf=leaf_max)
    v0, e1, e2 = np.asarray(v0), v1 - v0, v2 - v0
    tris_per_row = LANES // TRI_F
    block_rows = (leaf_max * TRI_F + LANES - 1) // LANES
    cnt_bits = max(5, leaf_max.bit_length())
    leaves, b, k, tri = _leaf_triangles(right, count)
    blocks = np.zeros((max(len(leaves), 1) * block_rows, LANES), np.float32)
    _fill_rows(blocks, block_rows * b + k // tris_per_row,
               (k % tris_per_row) * TRI_F, tri, v0, e1, e2)
    block_id = np.full(right.shape[0], -1, np.int64)
    block_id[leaves] = np.arange(len(leaves))
    meta, nbs = _wide_nodes(lo, hi, right, count, axis, wide, block_id,
                            cnt_bits)
    return meta, nbs, blocks, dict(wide=wide, leaf_max=leaf_max,
                                   cnt_bits=cnt_bits, block_rows=block_rows,
                                   tris_per_row=tris_per_row)


def pack_dual_leaf(lo, hi, right, count, axis, v0, v1, v2, *, leaf_max=16):
    """Like ``pack_params(wide=4)``, but a leaf encoding addresses a starting
    ROW, and a leaf of at most 8 triangles takes ONE row (8 records of 10
    floats) while a larger one takes two (12 to a row). Variant 5 reads it;
    its parameters are ``DUAL_PP``."""
    lo, hi, right, count, axis = _collapse_tree(lo, hi, right, count, axis,
                                                max_leaf=leaf_max)
    v0, e1, e2 = np.asarray(v0), v1 - v0, v2 - v0
    leaves, b, k, tri = _leaf_triangles(right, count)
    small = count[leaves] <= 8
    n_rows = np.where(small, 1, 2)
    first_row = np.cumsum(n_rows) - n_rows
    blocks = np.zeros((max(int(n_rows.sum()), 1), LANES), np.float32)
    r = np.where(small[b], 0, k // TRIS_PER_LEAF_ROW)
    base = np.where(small[b], k, k % TRIS_PER_LEAF_ROW) * TRI_F
    _fill_rows(blocks, first_row[b] + r, base, tri, v0, e1, e2)
    start_row = np.full(right.shape[0], -1, np.int64)
    start_row[leaves] = first_row
    meta, nbs = _wide_nodes(lo, hi, right, count, axis, 4, start_row,
                            DUAL_PP["cnt_bits"])
    return meta, nbs, blocks


# ---------------------------------------------------------------------------
# the CUDA kernel's layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WideLayout:
    """What ``csrc/kexp_traverse.cu`` and its twin read.

    ``nodes`` (Nw, 32 | 64) float32, wide nodes in BREADTH-FIRST order (so
    the first ``smem_nodes`` of them are the top of the tree): words
    ``f·W + k`` for f = lo.x lo.y lo.z hi.x hi.y hi.z of child k, words
    ``6W + k`` the slot encodings and word ``7W`` the parent's split axis
    (int bits), padded to 128 or 256 bytes. ``rows`` (·, 128) float32 are
    the packer's leaf rows (variants 1 and 5). ``recs`` (n_leaf·leaf_max,
    12) float32 are the same triangles as aligned 48-byte records [v0.xyz
    e1.x] [e1.yz e2.xy] [e2.z index(int bits) pad pad], ``leaf_max`` to a
    leaf block (variants 2 and 3; None for the dual layout)."""
    wide: int
    leaf_max: int
    cnt_bits: int
    block_rows: int
    tris_per_row: int
    dual: bool
    stack_need: int
    nodes: torch.Tensor
    rows: torch.Tensor
    recs: torch.Tensor | None

    def to(self, device):
        def move(x):
            return None if x is None else x.to(device)
        return dataclasses.replace(self, nodes=move(self.nodes),
                                   rows=move(self.rows), recs=move(self.recs))

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    def table_bytes(self, variant: int) -> int:
        """Bytes of the tables variant ``variant`` reads."""
        leaf = self.recs if variant % 10 in (2, 3) else self.rows
        return 4 * (self.nodes.numel() + leaf.numel())


def make_layout(meta, nbs, blocks, pp, *, dual=False, device="cpu"):
    """Turn the packers' tables into the kernel's layout on ``device``.
    Raises when the tree needs more stack than the kernel has."""
    wide, cnt_bits, leaf_max = pp["wide"], pp["cnt_bits"], pp["leaf_max"]
    need = wide_stack_need(meta, wide, cnt_bits)
    if need > STACK:
        raise ValueError(
            f"the {wide}-wide tree needs a traversal stack of {need} entries "
            f"(> STACK={STACK}); raise ops.bvh.STACK and kStack in "
            "csrc/kexp_traverse.cu for this scene")
    nodes = _bfs_records(meta, nbs, wide, cnt_bits)

    recs = None
    if not dual:
        # leaf block b, slot k → record b·leaf_max + k
        n_blocks = blocks.shape[0] // pp["block_rows"]
        k = np.arange(leaf_max)
        src = blocks.reshape(n_blocks, pp["block_rows"] * LANES)
        fields = src[:, ((k // pp["tris_per_row"]) * LANES
                         + (k % pp["tris_per_row"]) * TRI_F)[:, None]
                     + np.arange(TRI_F)]                    # (n, leaf_max, 10)
        recs = np.zeros((n_blocks, leaf_max, REC_F), np.float32)
        recs[..., :9] = fields[..., :9]
        recs[..., 9] = fields[..., 9].astype(np.int32).view(np.float32)
        recs = torch.tensor(recs.reshape(-1, REC_F), device=device)
    return WideLayout(
        wide=wide, leaf_max=leaf_max, cnt_bits=cnt_bits,
        block_rows=pp["block_rows"], tris_per_row=pp["tris_per_row"],
        dual=dual, stack_need=need, nodes=torch.tensor(nodes, device=device),
        rows=torch.tensor(np.ascontiguousarray(blocks, np.float32),
                          device=device), recs=recs)


def _split_variant(layout, variant):
    """(base variant, count mode); raises on a variant the layout cannot
    serve."""
    count_mode, base = variant >= 10, variant % 10
    if base not in VARIANTS or variant not in (base, base + 10):
        raise ValueError(f"unknown variant {variant}")
    if (base == 5) != layout.dual:
        raise ValueError(f"variant {variant}: the dual-leaf layout of "
                         "pack_dual_leaf is variant 5's, and only its")
    return base, count_mode


# ---------------------------------------------------------------------------
# the plain-torch twin
# ---------------------------------------------------------------------------

def _row_addr(layout, base, target, cnt):
    """(n, L) float offsets in the leaf rows of the triangles of the leaves
    ``target`` (counts ``cnt``) as variant ``base`` (1 or 5) reads them
    (csrc/kexp_traverse.cu::row_offset); variant 5's slots past a leaf's
    count point at 0, which stays in the table."""
    dev = target.device
    if base == 1:
        k = torch.arange(layout.leaf_max, device=dev)
        addr = ((target * layout.block_rows)[:, None] * LANES
                + (k // layout.tris_per_row) * LANES
                + (k % layout.tris_per_row) * TRI_F)
    else:
        k = torch.arange(16, device=dev)
        two = ((k // TRIS_PER_LEAF_ROW) * LANES
               + (k % TRIS_PER_LEAF_ROW) * TRI_F)
        addr = target[:, None] * LANES + torch.where(
            (cnt <= 8)[:, None], k * TRI_F, two)
        addr = torch.where(k < cnt[:, None], addr, 0)
    return addr


def _leaf_fields(layout, base, target, cnt):
    """The (n, L, 10) fields v0 e1 e2 index of the leaves ``target`` as
    variant ``base`` reads them, and the int32 (n, L) triangle indices."""
    dev = target.device
    if base in (2, 3):
        k = torch.arange(layout.leaf_max, device=dev)
        rec = layout.recs[(target * layout.leaf_max)[:, None] + k]
        return rec[..., :9], rec[..., 9].contiguous().view(torch.int32)
    addr = _row_addr(layout, base, target, cnt)
    f = layout.rows.reshape(-1)[addr[:, :, None]
                                + torch.arange(TRI_F, device=dev)]
    return f[..., :9], f[..., 9].to(torch.int32)


def _traverse_wide_reference(layout, o, d, tmax, *, any_hit, variant,
                             stats=None):
    """What the kernel computes: ops/bvh.py's wide twin on ``layout``'s
    nodes, with the leaves read as variant ``variant`` reads them and its
    pruning (variant 3, not in any-hit mode) and count mode (variant ≥ 10).
    Returns t (R,) float32 and idx (R,) int32: the leaf-ordered triangle
    index, or in count mode ``n_int·65536 + n_leaf``. ``stats``, if a dict,
    receives the counts of slab tests (non-empty slots), triangle tests and
    steps."""
    base, count_mode = _split_variant(layout, variant)
    return bvh_ops._traverse_wide_reference(
        layout.nodes, layout.cnt_bits,
        functools.partial(_leaf_fields, layout, base), o, d, tmax,
        any_hit=any_hit, prune=base == 3 and not any_hit,
        count_mode=count_mode, stats=stats)


# ---------------------------------------------------------------------------
# the traversal kernel's wrapper
# ---------------------------------------------------------------------------

def _traverse_lib():
    from pbrt_tpu_torch.ops import _build

    fn = _build.load("kexp_traverse").kexp_traverse_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([vp] * 7 + [i32] * 10 + [ctypes.c_float, i32, i32]
                       + [vp] * 3)
        fn.restype = i32
    return fn


def node_smem_bytes(layout, smem_nodes: int) -> int:
    """Dynamic shared memory the kernel asks for to stage ``smem_nodes``
    wide nodes: 128 or 256 bytes a record, unpadded (``staged_image``)."""
    return smem_nodes * NODE_WORDS[layout.wide] * 4


def max_smem_nodes(layout, limit_kb: int) -> int:
    """The most wide nodes of ``layout`` that fit ``limit_kb`` KB of shared
    memory (what ``smem_limit_kb`` found a launch gets)."""
    return min(layout.n_nodes, limit_kb * 1024 // node_smem_bytes(layout, 1))


def staged_image(layout, smem_nodes: int):
    """The shared memory a staged launch fills (the torch mirror of the
    kernel's copy): (smem_nodes · C, 4) float32, C = the record's 16-byte
    chunks (8 or 16), chunk c of record r in slot r·C + (c ^ (r mod 8)).
    The 8 threads of one 16-byte shared-memory phase that read chunk c of
    8 records whose indices differ mod 8 then touch 8 different bank
    groups (16 bytes each, slot mod 8), with no padding."""
    C = NODE_WORDS[layout.wide] // 4
    r = torch.arange(smem_nodes)[:, None]
    slot = r * C + (torch.arange(C)[None, :] ^ (r % SWIZZLE))
    out = torch.empty(smem_nodes * C, 4, dtype=layout.nodes.dtype)
    out[slot.reshape(-1)] = layout.nodes[:smem_nodes].reshape(-1, 4).cpu()
    return out


def _check_aligned(name, x, align):
    if x.data_ptr() % align:
        raise ValueError(f"{name}: the kernel reads it in {align}-byte loads, "
                         f"but it starts {x.data_ptr() % align} bytes past "
                         "such a boundary")


def traverse(layout, o, d, tmax, *, any_hit, variant, block=128,
             smem_nodes=0):
    """Traverse the wide tree ``layout`` with rays o, d (R,3) within tmax
    (R,). Returns t (R,) float32 and idx (R,) int32 (count mode, variant ≥
    10: the step code). ``smem_nodes`` is how many of the first wide nodes
    the kernel stages in shared memory. ``block`` (64, 128 or 256) is the
    threads per block of an unstaged launch; a staged launch runs one
    block per SM with as many threads as the kernel's registers allow (at
    least ``block``), which ``traverse.last_threads`` records.

    On the CPU this is the twin; on CUDA it launches the kernel (and adds
    one to ``traverse.launches``). Any other device raises, as do a block
    size the kernel does not take and a leaf table that does not start on
    the boundary of the kernel's loads, on every device."""
    base, count_mode = _split_variant(layout, variant)
    leaf = layout.recs if base in (2, 3) else layout.rows
    smem_nodes = int(smem_nodes)
    if (block not in BLOCKS or layout.stack_need > STACK
            or not 0 <= smem_nodes <= layout.n_nodes):
        raise ValueError(f"bad sizes block={block} smem_nodes={smem_nodes} "
                         f"stack_need={layout.stack_need}")
    _check_aligned("nodes", layout.nodes, 16)
    _check_aligned("leaf table", leaf, 16 if base in (2, 3) else 8)
    if o.device.type == "cpu":
        return _traverse_wide_reference(layout, o, d, tmax, any_hit=any_hit,
                                        variant=variant)
    if o.device.type != "cuda":
        raise NotImplementedError(f"kexp traverse on {o.device}")
    dev, R, f32 = o.device, o.shape[0], torch.float32
    leaf_mode = {1: 0, 2: 1, 3: 1, 5: 2}[base]
    if R <= 0:
        raise ValueError(f"bad sizes R={R}")
    _check("nodes", layout.nodes, f32,
           (layout.n_nodes, NODE_WORDS[layout.wide]), dev)
    _check("leaf table", leaf, f32, tuple(leaf.shape), dev)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    # the next ray a persistent warp takes; zeroed on the launch's stream
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    threads = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _traverse_lib()(
        layout.nodes.data_ptr(), leaf.data_ptr(), o.data_ptr(), d.data_ptr(),
        tmax.data_ptr(), t.data_ptr(), idx.data_ptr(), R, layout.n_nodes,
        layout.wide, leaf_mode, int(base == 3), int(bool(any_hit)),
        int(count_mode), layout.leaf_max, layout.block_rows, layout.cnt_bits,
        GSCALE, block, smem_nodes, next_ray.data_ptr(),
        ctypes.addressof(threads), stream)
    if err != 0:
        raise RuntimeError(
            f"kexp_traverse kernel launch failed: "
            f"{'no such instantiation' if err < 0 else f'CUDA error {err}'} "
            f"(wide {layout.wide}, variant {variant}, block {block}, "
            f"{node_smem_bytes(layout, smem_nodes)} bytes of shared memory)")
    traverse.launches += 1
    traverse.last_threads = threads.value
    return t, idx


traverse.launches = 0
traverse.last_threads = None


# ---------------------------------------------------------------------------
# the L2 experiment on the render path's kernel
# ---------------------------------------------------------------------------

def _l2_lib():
    from pbrt_tpu_torch.ops import _build

    fn = _build.load("bvh_traverse").bvh_l2_window
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def l2_window(bvh, on: bool):
    """Inside the block ``bvh``'s node and triangle records (a
    scene/bvh.py::FlatBVH's) are a copy in one buffer, and the work runs on
    a stream of its own. With ``on`` that stream carries an L2
    access-policy window over the buffer, with a persisting carve-out
    (csrc/bvh_traverse.cu::bvh_l2_window), so every launch there keeps the
    tree in L2 however much the eager torch around it reads; without, the
    same stream and copy carry none, so the two differ only by the window.
    On leaving, the window is cleared, the carve-out released and the
    tree's own tables put back. A tree on the CPU changes nothing (the twin
    runs there). Raises with CUDA's error code when the card refuses."""
    if bvh.nodes.device.type != "cuda":
        yield
        return
    dev, nodes, tris = bvh.nodes.device, bvh.nodes, bvh.tris
    buf = torch.cat([nodes.reshape(-1), tris.reshape(-1)])
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    bvh.nodes = buf[:nodes.numel()].view(nodes.shape)
    bvh.tris = buf[nodes.numel():].view(tris.shape)
    try:
        if on:
            with torch.cuda.device(dev):
                err = _l2_lib()(buf.data_ptr(), 4 * buf.numel(),
                                stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f"bvh_l2_window: CUDA error {err}")
        with torch.cuda.stream(stream):
            yield
    finally:
        stream.synchronize()
        bvh.nodes, bvh.tris = nodes, tris
        if on:
            with torch.cuda.device(dev):
                err = _l2_lib()(None, 0, stream.cuda_stream)
            if err != 0:
                raise RuntimeError(f"bvh_l2_window (clear): CUDA error {err}")


# ---------------------------------------------------------------------------
# the shared-memory probe
# ---------------------------------------------------------------------------

def _probe_reference(x):
    """What the probe kernel returns: every element plus x[0, 1]."""
    return x + x[0, 1]


def _probe_lib():
    from pbrt_tpu_torch.ops import _build

    lib = _build.load("smem_probe")
    if lib.smem_probe_launch.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.smem_probe_launch.argtypes = [vp, vp, i32, vp]
        lib.smem_probe_launch.restype = i32
        lib.smem_probe_set_size.argtypes = [i32]
        lib.smem_probe_set_size.restype = i32
        lib.smem_probe_error_string.argtypes = [i32]
        lib.smem_probe_error_string.restype = ctypes.c_char_p
    return lib


class _ProbeSizes:
    """The dynamic shared memory the probe kernel may ask for, as last
    granted on each device (cudaFuncAttributeMaxDynamicSharedMemorySize is
    a per-device attribute of the kernel, so it lives as long as the
    process). ``sets`` counts the attribute calls made."""

    def __init__(self):
        self.granted_kb = {}
        self.sets = 0

    def ensure(self, set_size, device_index: int, kb: int) -> int:
        """Make ``kb`` KB the size granted on ``device_index``, calling
        ``set_size(kb)`` (the CUDA error code, 0 = granted) only when it
        differs from the last size granted there. A refused size leaves
        the last granted one in place. Returns the error code."""
        if self.granted_kb.get(device_index) == kb:
            return 0
        self.sets += 1
        err = set_size(kb)
        if err == 0:
            self.granted_kb[device_index] = kb
        return err


_probe_sizes = _ProbeSizes()


def _probe_launch(x, kb: int):
    """Launch the probe with ``kb`` KB of dynamic shared memory on x's
    card. Returns (CUDA error code of the attribute call or the launch,
    CUDA's string for a failure or "" on success, out)."""
    _check("x", x, torch.float32, (8, LANES), x.device)
    out = torch.empty_like(x)
    lib = _probe_lib()
    with torch.cuda.device(x.device):
        err = _probe_sizes.ensure(lib.smem_probe_set_size, x.device.index,
                                  int(kb))
        if err == 0:
            err = lib.smem_probe_launch(
                x.data_ptr(), out.data_ptr(), int(kb),
                torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        return err, lib.smem_probe_error_string(err).decode(), out
    smem_probe.launches += 1
    return 0, "", out


def smem_probe(kb, device="cuda", x=None):
    """Ask for a ``kb``-KB shared-memory scratch (n = kb·256 floats) in one
    block, write x[0, 0] to its first and x[0, 1] to its last word, and
    return ``{"kb": kb, "ok": ...}``: ok when the result is finite and
    equals the plain version ``x + x[0, 1]`` (x (8,128) float32, ones by
    default). Raises with CUDA's error string when the card refuses the
    size or the launch. On ``device="cpu"`` nothing is probed and ``ok`` is
    None: the CPU says nothing about a card's shared memory."""
    kb = int(kb)
    if kb < 1:
        raise ValueError(f"smem_probe: kb={kb}")
    device = require_device(device)
    if device.type == "cpu":
        return {"kb": kb, "ok": None}
    if x is None:
        x = torch.ones((8, LANES), dtype=torch.float32, device=device)
    want = _probe_reference(x)
    if device.type != "cuda":
        raise NotImplementedError(f"smem_probe on {device}")
    err, msg, out = _probe_launch(x, kb)
    if err != 0:
        raise RuntimeError(f"smem_probe: the card refused {kb} KB of dynamic "
                           f"shared memory: CUDA error {err} ({msg})")
    torch.cuda.synchronize(device)
    return {"kb": kb, "ok": bool(torch.isfinite(out).all()
                                 and torch.equal(out, want))}


smem_probe.launches = 0


@functools.lru_cache(maxsize=None)
def smem_limit_kb(device="cuda") -> int:
    """The largest whole number of KB of dynamic shared memory a launch
    gets on ``device``, found once per device by bisection with the probe
    between 1 KB and 1 MB (a refused size costs no launch)."""
    device = require_device(device)
    if device.type != "cuda":
        raise NotImplementedError("smem_limit_kb needs a CUDA device")
    x = torch.ones((8, LANES), dtype=torch.float32, device=device)
    lo, hi = 0, 1024                  # lo is granted (or 0), hi is refused
    while hi - lo > 1:
        mid = (lo + hi) // 2
        err, _, out = _probe_launch(x, mid)
        if err == 0:
            torch.cuda.synchronize(device)
            if not torch.equal(out, _probe_reference(x)):
                raise RuntimeError(f"smem_probe: wrong result at {mid} KB")
            lo = mid
        else:
            hi = mid
    if lo == 0:
        raise RuntimeError("smem_probe: no size was granted")
    return lo
