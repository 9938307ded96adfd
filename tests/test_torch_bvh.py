"""The port's BVH (build, layouts, traversal twin, scene-level queries and
a whole pass) against pbrt_tpu.

The same triangles and rays (numpy, seeded) go through

- pbrt_tpu's Pallas packet kernel in interpret mode, run as
  tests/test_bvh_pallas.py runs it (``bvh_pallas._impl(..., interpret=
  True)``), on pbrt_tpu's own tree;
- pbrt_tpu's threaded XLA traversal ``scene/bvh.py::_traverse_batch``;
- the port's ``ops/bvh.py::bvh_traverse`` (on CPU tensors: the twin of the
  4-wide kernel, ``traverse_reference``) and the binary kernel's twin
  ``ops/bvh_binary.py::_traverse_reference`` on the same tree, carried
  across by the bridge.

Tolerances. Hit masks equal on every ray. ``t`` of the hit rays agrees
with both JAX traversals to rtol 1e-5 (found: up to 4.9e-6 on half of the
hits). The twins' ``t`` is bit-equal to the Möller–Trumbore formula
evaluated operation by operation in float32 with numpy, which a test below
asserts, and the two twins' ``t`` are bit-equal to each other; XLA's CPU
code contracts multiply-adds inside the fused triangle test, so its last
bits differ, and the two JAX traversals differ from each other the same
way (3.6e-7). The leaf-ordered triangle indices are equal except at
genuine ``t`` ties, the rule of tests/test_bvh_pallas.py:39-45 (the packet
kernel walks a 4-wide tree with collapsed leaves and the wide twin another
4-wide tree, so two coincident-depth surfaces can be met in another order;
one ray in 3,000 here); between the binary twin and the threaded XLA
traversal, which visit the same tree in the same order, they are equal on
every ray. Builder outputs and all traversal layouts are compared exactly.
The whole pass is held per pixel to rtol 1e-4 / atol 1e-5 with the seam
allowance of tests/test_fused_path.py:258-261.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pbrt_tpu.ops import bvh_pallas as bp
from pbrt_tpu.scene import bvh as jbvh
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.ops import bvh as bvh_ops
from pbrt_tpu_torch.ops import bvh_binary
from pbrt_tpu_torch.ops import fused_path
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import bvh as tbvh
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene.types import SceneBuilder
from test_torch_intersect import box_rays, jax_scene
from tests.test_bvh_io import random_tri_scene

jrender = importlib.import_module("pbrt_tpu.integrators.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
SPP = 2
SMALL = (16, 8, 4)     # heightfield n, cone n_phi, n_z: 522 triangles
TREE_FIELDS = ("lo", "hi", "right", "count", "axis", "prim_order", "v0", "v1",
               "v2")


def _soup_rays(n, seed=1, tmax=None):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.full(n, 1e30, np.float32) if tmax is None else \
        rng.uniform(*tmax, n).astype(np.float32)
    return o, d, tm


def _twin(bvh, o, d, tmax, any_hit):
    t, i = bvh_ops.bvh_traverse(bvh, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(tmax), any_hit)
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    return t.numpy(), i.numpy()


@pytest.fixture(scope="module")
def soup():
    """A 500-triangle soup, pbrt_tpu's tree over it (native SBVH build) and
    the same tree in the port."""
    js = random_tri_scene(500, seed=0)
    jb = jbvh.build_bvh(None, js)
    return js, jb, bridge.bvh_from_jax(jb)


# -- (a) the build and both layouts ------------------------------------------

def _assert_same_tree(got, want):
    """The port's tree and the twin's layout of it (made on first use)
    against pbrt_tpu's arrays, exactly."""
    have = {k: getattr(got, k).numpy() for k in TREE_FIELDS}
    have["nodes8"], have["tri9"] = (
        x.numpy() for x in bvh_binary.threaded_layout(got, "cpu"))
    for key, arr in have.items():
        ref = np.asarray(getattr(want, key))
        assert arr.dtype == ref.dtype and arr.shape == ref.shape, key
        np.testing.assert_array_equal(arr, ref, err_msg=key)


@pytest.mark.parametrize("method", ["sah", "middle", "equal", "hlbvh"])
def test_build_bvh_equals_jax(soup, method):
    js = soup[0]
    want = jbvh.build_bvh(None, js, split_method=method)
    ts = bridge.scene_from_jax(js)
    got = tbvh.build_bvh(ts, split_method=method)
    assert got.built_by == ("native-sbvh" if method == "sah"
                            else f"numpy-{method}")
    _assert_same_tree(got, want)
    if method == "sah":     # spatial splits duplicate references
        assert got.prim_order.shape[0] >= js.n_tri
    right, count, axis = (np.asarray(getattr(want, k))
                          for k in ("right", "count", "axis"))
    for have, ref in zip(bvh_binary._octant_links(right, count, axis),
                         jbvh._octant_links(right, count, axis)):
        np.testing.assert_array_equal(have, ref)


def test_numpy_sah_fallback_equals_jax(soup, monkeypatch):
    """Without the native library both packages run the numpy binned-SAH
    loop and get the same tree."""
    js = soup[0]
    monkeypatch.setattr(jbvh, "_build_native", lambda *a, **k: None)
    monkeypatch.setattr(tbvh, "_build_native", lambda *a, **k: None)
    want = jbvh.build_bvh(None, js)
    got = tbvh.build_bvh(bridge.scene_from_jax(js))
    assert got.built_by == "numpy-sah"
    _assert_same_tree(got, want)


def test_native_builder_falls_back_only_without_a_compiler(soup, monkeypatch):
    """No g++ on the machine: a warning and the numpy loop. A compile that
    fails is an error, not a reason to build another tree quietly."""
    from pbrt_tpu_torch.ops import _build

    ts = bridge.scene_from_jax(soup[0])

    def no_compiler(name):
        raise _build.CompilerNotFound("g++ not found")

    monkeypatch.setattr(_build, "load_host", no_compiler)
    with pytest.warns(UserWarning, match="g\\+\\+ not found.*numpy SAH loop"):
        assert tbvh.build_bvh(ts).built_by == "numpy-sah"

    def broken(name):
        raise RuntimeError("g++ failed on bvh_builder.cpp:\nerror: ...")

    monkeypatch.setattr(_build, "load_host", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbvh.build_bvh(ts)
    assert issubclass(_build.CompilerNotFound, RuntimeError)


def test_pack_bvh_layout_and_stack_need(soup):
    """The binary kernel's layout holds the tree's own numbers, and the
    stack need is the tree's depth in nodes (held against a recursive
    walk)."""
    tb = soup[2]
    nodes, tris, need = (x.numpy() if torch.is_tensor(x) else x
                         for x in bvh_binary.binary_layout(tb, "cpu"))
    assert nodes.shape == (tb.lo.shape[0], 8) and tris.shape[1] == 12
    np.testing.assert_array_equal(nodes[:, 0:3], tb.lo.numpy())
    np.testing.assert_array_equal(nodes[:, 3:6], tb.hi.numpy())
    ints = nodes[:, 6:8].copy().view(np.int32)
    np.testing.assert_array_equal(ints[:, 0], tb.right.numpy())
    np.testing.assert_array_equal(ints[:, 1] >> 2, tb.count.numpy())
    np.testing.assert_array_equal(ints[:, 1] & 3, tb.axis.numpy())
    np.testing.assert_array_equal(tris[:, 0:3], tb.v0.numpy())
    np.testing.assert_array_equal(tris[:, 3:6], (tb.v1 - tb.v0).numpy())
    np.testing.assert_array_equal(tris[:, 6:9], (tb.v2 - tb.v0).numpy())
    right, count = tb.right.numpy(), tb.count.numpy()

    def depth(i):
        return 1 if count[i] > 0 else 1 + max(depth(i + 1), depth(right[i]))

    assert need == depth(0) == bvh_binary.stack_need(right, count)
    assert 4 < need <= bvh_binary.STACK


def _wide_walk(tb):
    """The 4-wide records of ``tb`` walked from the root, each slot held
    against the binary node it stands for (two binary levels below the
    parent's node, or fewer where a leaf ends the path); returns the wide
    nodes reached and the stack need of a recursive walk."""
    nodes = tb.nodes.numpy()
    lo, hi = tb.lo.numpy(), tb.hi.numpy()
    right, count, axis = (getattr(tb, k).numpy() for k in
                          ("right", "count", "axis"))
    enc = nodes[:, 24:28].copy().view(np.int32)
    cb, seen = tb.cnt_bits, []

    def grand(b):
        if count[b] > 0:
            return [b]
        kids = [b + 1, int(right[b])]
        return sum(([k] if count[k] > 0 else [k + 1, int(right[k])]
                    for k in kids), [])

    def need(w, b):
        seen.append(w)
        slots = grand(b)
        assert nodes[w, 28].view(np.int32) == axis[b]
        deeper = []
        for k in range(4):
            if k >= len(slots):
                assert enc[w, k] == -1
                continue
            si = slots[k]
            np.testing.assert_array_equal(nodes[w, [k, 4 + k, 8 + k]], lo[si])
            np.testing.assert_array_equal(nodes[w, [12 + k, 16 + k, 20 + k]],
                                          hi[si])
            if count[si] > 0:
                assert enc[w, k] == (right[si] << cb | count[si])
                deeper.append(1)
            else:
                assert enc[w, k] & ((1 << cb) - 1) == 0
                deeper.append(need(enc[w, k] >> cb, si))
        return len(deeper) - 1 + max(deeper)

    return seen, need(0, 0)


def test_binary_layouts_are_packed_once_per_tree(soup):
    """The binary kernel's and its twin's layouts are packed when first
    asked for and kept for that tree and device, also across the copy of
    the scene that a render makes (``to_device`` onto the device the tree
    is on), and dropped with the tree; the render path's tree carries
    neither."""
    import gc

    from pbrt_tpu_torch.scene.types import to_device

    tb = soup[2]
    assert not any(f.name.startswith("_")
                   for f in dataclasses.fields(tbvh.FlatBVH))
    first = bvh_binary.binary_layout(tb, "cpu")
    assert bvh_binary.binary_layout(to_device(tb, "cpu"), "cpu") is first
    assert bvh_binary.threaded_layout(tb, "cpu") is \
        bvh_binary.threaded_layout(to_device(tb, "cpu"), "cpu")
    other_tree = dataclasses.replace(tb, nodes=tb.nodes.clone())
    other = bvh_binary.binary_layout(other_tree, "cpu")
    assert other is not first and other[2] == first[2]
    assert torch.equal(other[0], first[0]) and torch.equal(other[1], first[1])
    key = (id(other_tree.nodes), "binary", "cpu")
    assert key in bvh_binary._LAYOUTS
    del other_tree, other
    gc.collect()
    assert key not in bvh_binary._LAYOUTS


def test_pack_wide_records_and_stack_need(soup):
    """The 4-wide layout (one 128-byte record a node, breadth-first) holds
    the binary tree's own bounds, leaves and axes, every node is reached
    once, the triangle records are the leaf-ordered triangles, and the
    stack need is what a recursive walk needs."""
    tb = soup[2]
    assert tb.nodes.shape[1] == 32 and tb.tris.shape == (tb.v0.shape[0], 12)
    assert tb.cnt_bits == 3 and int(tb.count.max()) <= bvh_ops.LEAF_MAX
    seen, need = _wide_walk(tb)
    assert sorted(seen) == list(range(tb.nodes.shape[0]))
    # breadth-first: the children of a node come after it, in order
    enc = tb.nodes.numpy()[:, 24:28].copy().view(np.int32)
    inner = (enc >= 0) & ((enc & ((1 << tb.cnt_bits) - 1)) == 0)
    kids = (enc >> tb.cnt_bits)[inner]
    np.testing.assert_array_equal(kids, np.arange(1, tb.nodes.shape[0]))
    assert tb.stack_need == need
    assert 4 < need <= bvh_ops.STACK
    tris = tb.tris.numpy()
    np.testing.assert_array_equal(tris[:, 0:3], tb.v0.numpy())
    np.testing.assert_array_equal(tris[:, 3:6], (tb.v1 - tb.v0).numpy())
    np.testing.assert_array_equal(tris[:, 6:9], (tb.v2 - tb.v0).numpy())


# -- (b) the twin against the interpret-mode Pallas kernel -------------------

def _assert_matches(t, i, t_ref, i_ref):
    """Hit masks equal, t within rtol 1e-5 on hits, indices equal except
    at genuine t ties (tests/test_bvh_pallas.py:39-45)."""
    hit = i >= 0
    np.testing.assert_array_equal(hit, i_ref >= 0)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5, atol=0)
    tied = np.isclose(t[hit], t_ref[hit], rtol=1e-5, atol=1e-6)
    assert np.all((i[hit] == i_ref[hit]) | tied)
    return hit


@pytest.mark.parametrize("n_rays", [3000, 777])
def test_twin_matches_pallas_kernel(soup, n_rays):
    _, jb, tb = soup
    o, d, tmax = _soup_rays(n_rays)
    t, i = _twin(tb, o, d, tmax, False)
    t_pk, i_pk = bp._impl(jb.pk_meta, jb.pk_nb, jb.pk_tri, jnp.asarray(o),
                          jnp.asarray(d), jnp.asarray(tmax), any_hit=False,
                          interpret=True)
    hit = _assert_matches(t, i, np.asarray(t_pk), np.asarray(i_pk))
    assert 0.05 < hit.mean() < 0.95
    assert (i[hit] != np.asarray(i_pk)[hit]).mean() < 1e-2   # ties only
    np.testing.assert_array_equal(t[~hit], np.float32(1e30))
    # the twin's t is the strict float32 formula on the triangle it names
    v0, v1, v2 = (x.numpy()[i[hit]] for x in (tb.v0, tb.v1, tb.v2))
    e1, e2, r, dd = v1 - v0, v2 - v0, o[hit] - v0, d[hit]
    px = dd[:, 1] * e2[:, 2] - dd[:, 2] * e2[:, 1]
    py = dd[:, 2] * e2[:, 0] - dd[:, 0] * e2[:, 2]
    pz = dd[:, 0] * e2[:, 1] - dd[:, 1] * e2[:, 0]
    inv_det = np.float32(1.0) / (e1[:, 0] * px + e1[:, 1] * py
                                 + e1[:, 2] * pz)
    qx = r[:, 1] * e1[:, 2] - r[:, 2] * e1[:, 1]
    qy = r[:, 2] * e1[:, 0] - r[:, 0] * e1[:, 2]
    qz = r[:, 0] * e1[:, 1] - r[:, 1] * e1[:, 0]
    np.testing.assert_array_equal(
        t[hit], (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv_det)
    if n_rays == 777:
        # the same rays, any-hit, with a finite tmax that cuts hits off
        _, _, tm = _soup_rays(n_rays, tmax=(0.5, 6.0))
        _, i_any = _twin(tb, o, d, tm, True)
        _, i_pk = bp._impl(jb.pk_meta, jb.pk_nb, jb.pk_tri, jnp.asarray(o),
                           jnp.asarray(d), jnp.asarray(tm), any_hit=True,
                           interpret=True)
        np.testing.assert_array_equal(i_any >= 0, np.asarray(i_pk) >= 0)
        t_c, i_c = _twin(tb, o, d, tm, False)
        np.testing.assert_array_equal(i_any >= 0, i_c >= 0)
        assert 0 < (i_c >= 0).sum() < hit.sum()
        assert (t_c[i_c >= 0] < tm[i_c >= 0]).all()
        np.testing.assert_array_equal(t_c[i_c < 0], tm[i_c < 0])


# -- (c) the twin against the threaded XLA traversal -------------------------

def test_twin_matches_threaded_traversal(soup):
    _, jb, tb = soup
    o, d, tmax = _soup_rays(3000, seed=5)
    stats = {}
    t, i = bvh_binary._traverse_reference(tb, torch.as_tensor(o),
                                       torch.as_tensor(d),
                                       torch.as_tensor(tmax), False,
                                       stats=stats)
    t_x, i_x = jbvh._traverse_batch(jb, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(tmax), False)
    hit = _assert_matches(t.numpy(), i.numpy(), np.asarray(t_x),
                          np.asarray(i_x))
    # the same tree, the same visit order: indices equal, ties included
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_x))
    assert hit.any() and stats["slab_tests"] > stats["tri_tests"] > 3000


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("finite_tmax", [False, True],
                         ids=["tmax_inf", "tmax_finite"])
def test_wide_twin_matches_binary_twin_and_pallas(soup, any_hit, finite_tmax):
    """The 4-wide kernel's twin (the CPU side of ``bvh_traverse``) on the
    production layout against the binary kernel's twin on the same tree:
    ``t`` bit-equal, the triangle equal through ``prim_order`` but for
    exact ties in ``t``, equal hit masks; and against pbrt_tpu's packet
    kernel in interpret mode (the 777-ray programs of
    ``test_twin_matches_pallas_kernel``) within its tolerance. Count mode
    returns each ray's steps, and they add up to the walk's counts."""
    _, jb, tb = soup
    o, d, tmax = _soup_rays(777, tmax=(0.5, 6.0) if finite_tmax else None)
    stats = {}
    t, i = (x.numpy() for x in bvh_ops.traverse_reference(
        tb, *(torch.as_tensor(x) for x in (o, d, tmax)), any_hit,
        stats=stats))
    t_b, i_b = (x.numpy() for x in bvh_binary._traverse_reference(
        tb, *(torch.as_tensor(x) for x in (o, d, tmax)), any_hit))
    hit = i >= 0
    np.testing.assert_array_equal(hit, i_b >= 0)
    assert 0.02 < hit.mean() < 0.95
    t_pk, i_pk = (np.asarray(x) for x in bp._impl(
        jb.pk_meta, jb.pk_nb, jb.pk_tri, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax), any_hit=any_hit, interpret=True))
    np.testing.assert_array_equal(hit, i_pk >= 0)
    if not any_hit:
        np.testing.assert_array_equal(t, t_b)            # bit for bit
        order = tb.prim_order.numpy()
        other = order[i[hit]] != order[i_b[hit]]
        assert other.mean() < 1e-2
        _assert_matches(t, i, t_pk, i_pk)
        np.testing.assert_array_equal(t[~hit], np.minimum(tmax[~hit], 1e30))
    _, code = bvh_ops.traverse_reference(
        tb, *(torch.as_tensor(x) for x in (o, d, tmax)), any_hit,
        count_mode=True)
    code = code.numpy()
    assert (code >> 16).sum() == stats["int_steps"] >= 777
    assert (code & 0xFFFF).sum() == stats["leaf_steps"] > 0
    assert stats["slab_tests"] > stats["int_steps"]


# -- (d) the port alone ------------------------------------------------------

def _small_scene(use_bvh):
    b = SceneBuilder()
    entry._fill_heightfield_cornell(b, *SMALL)
    return b.build("cpu", use_bvh=use_bvh)


@pytest.fixture(scope="module")
def small_pair():
    return _small_scene("always"), _small_scene("never")


@pytest.mark.parametrize("finite_tmax", [False, True],
                         ids=["tmax_inf", "tmax_finite"])
def test_bvh_queries_match_brute_force(small_pair, finite_tmax):
    """``intersect`` / ``intersect_p`` of the scene with a BVH against the
    same scene without one (the brute-force twin): valid and t equal on
    every ray; prim equal except where two primitives tie in t exactly
    (brute force keeps the first in table order, the BVH the first in leaf
    order)."""
    with_bvh, brute = small_pair
    assert with_bvh.bvh is not None and brute.bvh is None
    assert (with_bvh.n_tri, with_bvh.n_sph, with_bvh.n_pln) == (522, 1, 1)
    o, d, tmax = (torch.as_tensor(x) for x in
                  box_rays(21 + finite_tmax, finite_tmax=finite_tmax))
    o[:, 1] = o[:, 1] * 0.8 + 0.15        # start above the floor
    h_b, h_f = (tisect.intersect(s, o, d, tmax) for s in (with_bvh, brute))
    assert torch.equal(h_b.valid, h_f.valid)
    assert torch.equal(h_b.t, h_f.t)
    assert (h_b.prim_id != h_f.prim_id).float().mean() < 1e-3
    for f in ("p", "ng", "ns", "uv"):
        same = h_b.prim_id == h_f.prim_id
        assert torch.equal(getattr(h_b, f)[same], getattr(h_f, f)[same]), f
    nt = with_bvh.n_tri
    for lo, hi in ((0, nt), (nt, nt + 1), (nt + 1, nt + 2)):   # each family
        assert ((h_b.prim_id >= lo) & (h_b.prim_id < hi)).any()
    occ = tisect.intersect_p(with_bvh, o, d, tmax)
    assert torch.equal(occ, tisect.intersect_p(brute, o, d, tmax))
    assert torch.equal(occ, h_f.valid)


def test_ray_sort_changes_nothing(soup):
    """The render path traverses in the callers' order; traversing the same
    rays in octant + Morton order (``_ray_sort_order``, pbrt_tpu's packet
    key) and putting the results back gives the same answers: rays are
    independent in a per-ray walk."""
    tb = soup[2]
    o, d, tmax = (torch.as_tensor(x) for x in _soup_rays(5000, seed=9))
    perm = tbvh._ray_sort_order(o, d)
    assert sorted(perm.tolist()) == list(range(5000))
    assert not torch.equal(perm, torch.arange(5000))
    octant = ((d[perm] < 0).long() * torch.tensor([4, 2, 1])).sum(-1)
    assert (octant[1:] >= octant[:-1]).all()
    t_u, tri_u, hit_u = tbvh.bvh_intersect_tris(tb, o, d, tmax)
    t_s, tri_s, hit_s = tbvh.bvh_intersect_tris(tb, o[perm], d[perm],
                                                tmax[perm])
    assert torch.equal(t_s, t_u[perm]) and torch.equal(tri_s, tri_u[perm])
    assert torch.equal(hit_s, hit_u[perm]) and 0.05 < hit_u.float().mean()
    occ_s = tbvh.bvh_intersect_p_tris(tb, o[perm], d[perm], tmax[perm])
    assert torch.equal(occ_s, tbvh.bvh_intersect_p_tris(tb, o, d, tmax)[perm])
    assert torch.equal(occ_s, hit_s)
    assert not hasattr(tbvh, "_sorted_traverse")


def test_duplicate_references_map_once(soup):
    """Under spatial splits one triangle sits in several leaves: the
    traversal returns leaf-ordered indices (which can exceed n_tri) and
    ``bvh_intersect_tris`` maps them through ``prim_order`` once."""
    js, _, tb = soup
    assert tb.prim_order.shape[0] > js.n_tri
    o, d, tmax = (torch.as_tensor(x) for x in _soup_rays(3000))
    _, leaf_i = bvh_ops.bvh_traverse(tb, o, d, tmax, False)
    t, tri_idx, hit = tbvh.bvh_intersect_tris(tb, o, d, tmax)
    assert torch.equal(hit, leaf_i >= 0)
    assert int(tri_idx.max()) < js.n_tri and int(tri_idx[~hit].max()) == -1
    assert torch.equal(tri_idx[hit],
                       tb.prim_order[leaf_i[hit].long()])


def _chain(levels):
    """A right-leaning binary chain: leaf, interior, leaf, …, ``levels``
    interior nodes; leaf i holds triangle i."""
    n = 2 * levels + 1
    right = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    for i in range(levels):
        right[2 * i] = 2 * i + 2          # interior: left leaf is 2i + 1
        count[2 * i + 1] = 1
        right[2 * i + 1] = i
    count[n - 1] = 1
    right[n - 1] = levels
    lo = np.zeros((n, 3), np.float32)
    v = np.zeros((levels + 1, 3), np.float32)
    return lo, lo + 1, right, count, np.zeros(n, np.int32), v, v, v


def test_deep_tree_raises_at_pack_time():
    """A tree deeper than the binary kernel's stack is refused when it is
    packed, never overflowed silently."""
    deep = _chain(bvh_binary.STACK + 6)
    assert bvh_binary.stack_need(deep[2], deep[3]) == bvh_binary.STACK + 7
    with pytest.raises(ValueError, match="STACK"):
        bvh_binary.pack_bvh(*deep)
    _, _, need = bvh_binary.pack_bvh(*_chain(bvh_binary.STACK - 1))
    assert need == bvh_binary.STACK


def test_deep_wide_tree_raises_at_pack_time():
    """The 4-wide layout of a chain needs two stack entries per wide level
    (three slots, one of them the next wide node): past the kernel's stack
    it is refused when packed; just below it, it packs."""
    deep, fits = bvh_ops.STACK, bvh_ops.STACK - 2
    with pytest.raises(ValueError, match="STACK"):
        bvh_ops.pack_wide(*_chain(deep))
    nodes, tris, cnt_bits, need = bvh_ops.pack_wide(*_chain(fits))
    assert need <= bvh_ops.STACK and cnt_bits == 3
    assert nodes.shape == ((fits + 1) // 2, 32)
    assert tris.shape == (fits + 1, 12)


class KdTree:
    """Stands for an accelerator that is not the port's FlatBVH."""


def test_unported_accelerators_raise(small_pair, soup):
    """Motion blur and the kd-tree raise, naming their ROADMAP item; a
    device that is neither the CPU nor a CUDA card raises; on the CPU no
    kernel is launched."""
    with_bvh, _ = small_pair
    tb = soup[2]
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        bvh_binary._pack_threaded(z[:1], z[:1], np.zeros(1, np.int32),
                               np.ones(1, np.int32), np.zeros(1, np.int32),
                               z, z, z, dv=(z, z, z))
    kd = dataclasses.replace(with_bvh, bvh=KdTree())
    ray = torch.zeros(4, 3)
    for query in (tisect.intersect, tisect.intersect_p):
        with pytest.raises(NotImplementedError,
                           match="KdTree.*ROADMAP queue 1 item 6"):
            query(kd, ray + 0.5, ray + 1.0, torch.ones(4))
    with pytest.raises(NotImplementedError, match="KdTree"):
        bridge.bvh_from_jax(KdTree())
    with pytest.raises(ValueError, match="split method"):
        tbvh.build_bvh(with_bvh, split_method="kdtree")
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(NotImplementedError):
        bvh_ops.bvh_traverse(tb, meta, meta, meta[:, 0], False)
    with pytest.raises(NotImplementedError):
        bvh_binary.bvh_traverse_binary(tb, meta, meta, meta[:, 0], False)
    with pytest.raises(NotImplementedError, match="count mode"):
        bvh_binary.bvh_traverse_binary(tb, ray, ray, ray[:, 0], False,
                                       count_mode=True)
    before = (bvh_ops.bvh_traverse.launches, ik.intersect_brute.launches,
              bvh_binary.bvh_traverse_binary.launches)
    tisect.intersect(with_bvh, ray + 0.5, ray + 1.0, torch.full((4,), np.inf))
    assert before == (bvh_ops.bvh_traverse.launches,
                      ik.intersect_brute.launches,
                      bvh_binary.bvh_traverse_binary.launches)


def test_use_bvh_rule():
    """pbrt_tpu's rule: "auto" builds a BVH for more than 256 triangles;
    "always" and "never" force it; the split method is ``bvh_split``."""
    b = SceneBuilder()
    entry._fill_heightfield_cornell(b, *SMALL)
    assert b.build("cpu").bvh.built_by == "native-sbvh"
    b.bvh_split = "hlbvh"
    assert b.build("cpu").bvh.built_by == "numpy-hlbvh"
    assert b.build("cpu", use_bvh="never").bvh is None
    assert entry._sphere_cornell("cpu").bvh is None       # 12 triangles
    b = SceneBuilder()
    entry._fill_sphere_cornell(b)
    assert b.build("cpu", use_bvh="always").bvh.count.sum() == 12
    with pytest.raises(ValueError):
        b.build("cpu", use_bvh="sometimes")


# -- (e) a whole pass through the BVH ----------------------------------------

def test_render_pass_with_bvh_matches_jax():
    js = jax_scene(entry._fill_heightfield_cornell, *SMALL)
    assert js.bvh is not None and js.n_tri == 522 and js.n_sph == 1
    ts = bridge.scene_from_jax(js)
    assert ts.bvh is not None and ts.fused_profile is None
    t0, b0 = bvh_ops.bvh_traverse.launches, ik.intersect_brute.launches
    want = np.asarray(jrender.render_pass(
        js, ge._camera((RES, RES)), jfilm.make_filter("box"),
        jrender.RenderConfig(integrator="path", max_depth=4), RES, RES, SPP,
        jnp.asarray(0, jnp.uint32)))
    got = trender.render_pass(
        ts, entry._camera((RES, RES), "cpu"), tfilm.make_filter("box"),
        trender.RenderConfig(integrator="path", max_depth=4), RES, RES, SPP,
        0, "cpu").numpy()
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all() and want.mean() > 0.05
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 6e-3, f"{bad.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3
    # the port's own builder gives the bridged scene's image exactly
    own = trender.render_pass(
        _small_scene("auto"), entry._camera((RES, RES), "cpu"),
        tfilm.make_filter("box"),
        trender.RenderConfig(integrator="path", max_depth=4), RES, RES, SPP,
        0, "cpu").numpy()
    np.testing.assert_array_equal(own, got)
    assert (t0, b0) == (bvh_ops.bvh_traverse.launches,
                        ik.intersect_brute.launches)   # CPU: the twins


# -- (f) a BVH does not cost the fused path ----------------------------------

def test_portal_with_bvh_keeps_the_fused_path(monkeypatch):
    scene = entry._tessellated_portal(22, "cpu")
    assert scene.n_tri == 940 and scene.bvh is not None
    assert scene.fused_profile is not None and scene.fused_profile[4] == 1
    cfg = trender.RenderConfig(max_depth=4)
    assert fused_path.eligible(scene, cfg)
    monkeypatch.setattr(fused_path, "li_path_fused",
                        lambda *a, **k: "fused")

    def no_loop(*a, **k):
        raise AssertionError("li_path took the generic loop")

    monkeypatch.setattr(trender, "_li_loop", no_loop)
    z = torch.zeros(4, 3)
    idx = torch.zeros(4, dtype=torch.int64)
    assert trender.li_path(scene, z, z, idx, idx, None, cfg, None) == "fused"


# -- (g) no JAX at run time --------------------------------------------------

def test_bvh_scene_renders_without_jax():
    code = textwrap.dedent("""
        import sys
        before = set(sys.modules)
        sys.modules["jax"] = None
        import torch
        import pbrt_tpu_torch.entry as e
        import pbrt_tpu_torch.integrators.render as r
        scene = e._heightfield_cornell("cpu", n=12)
        assert scene.bvh is not None and scene.bvh.built_by == "native-sbvh"
        for integ in ("path", "ao"):
            img = r.render(scene, e._camera((8, 8), "cpu"), spp=2,
                           integrator=integ, max_depth=3, device="cpu")
            assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())
            assert float(img.mean()) > 0.0
        assert not any(m.startswith(("jax.", "jaxlib", "pbrt_tpu."))
                       for m in set(sys.modules) - before)
        print("ok", float(img.mean()))
    """)
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# -- (h) the native BVH builder's source is pbrt_tpu's ----------------------------------

def _code_of(path):
    """A C++ source without its leading block of comment lines."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    first = next(i for i, ln in enumerate(lines)
                 if ln.strip() and not ln.startswith(b"//"))
    return b"\n".join(lines[first:])


def test_builder_source_is_a_copy():
    """Below its own header comment the port's builder source is
    pbrt_tpu's, byte for byte."""
    want = _code_of(os.path.join(REPO, "pbrt_tpu", "native",
                                 "bvh_builder.cpp"))
    got = _code_of(os.path.join(REPO, "pbrt_tpu_torch", "csrc",
                                "bvh_builder.cpp"))
    assert got == want and len(got) > 15000 and b"bvh_build_sbvh" in got


def test_heightfield_cornell_is_what_the_card_renders():
    """The full-width scene's sizes, from its tessellators (without
    building it): 2·255² floor triangles, 2·64·24 on the cone, 8 on the
    walls; the heights are the closed form, within (0, 0.1)."""
    from pbrt_tpu_torch.scene import tessellate

    h = entry._floor_heights(256)
    assert h.shape == (256, 256) and 0.0 < h.min() < h.max() < 0.1
    n_floor = tessellate.tessellate_heightfield(256, 256, h)[1].shape[0]
    n_cone = tessellate.tessellate_cone(n_phi=64, n_z=24)[1].shape[0]
    assert (n_floor, n_cone) == (130050, 3072)
    assert n_floor + n_cone + 8 == 133130
    small = _small_scene("auto")
    assert small.n_tri == 2 * 15 * 15 + 2 * 8 * 4 + 8


def reference_means():
    """pbrt_tpu's float32 image mean on the CPU backend for the render of
    ``_heightfield_cornell()`` that chip_smoke.py checks on the card (same
    scene, same sample streams). 64² × 4 spp: pbrt_tpu's CPU traversal of
    133,130 triangles is too slow for 256² × 64 spp. Run this file as a
    script from the root of the checkout, ``PYTHONPATH=. python
    tests/test_torch_bvh.py``, to print it."""
    js = jax_scene(entry._fill_heightfield_cornell)
    out = {"n_tri": js.n_tri}
    for res, spp in ((64, 4),):
        img = jrender.render(js, ge._camera((res, res)), spp=spp,
                             integrator="path", max_depth=4)
        out[f"heightfield_cornell/path/{res}x{res}/{spp}spp"] = float(
            np.asarray(img, np.float64).mean())
    return out


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins JAX to the CPU backend)
    for key, mean in reference_means().items():
        print(key, repr(mean))
