"""The kd-tree and the brute-force path past 4,096 primitives against
pbrt_tpu.

(a) The build: the port's ``scene/kdtree.py::build_kdtree`` on the
    scene the port's builder makes from the same builder calls equals
    pbrt_tpu's ``build_kdtree`` array for array (split_pos, axis,
    above_child, n_prims, prim_ids, the world box) and in ``max_leaf``,
    on tests/test_bvh_io.py's ``random_tri_scene(300, seed=5)`` and on a
    seeded 4,050-triangle heightfield; the kernel's 8-byte nodes and
    leaf-ordered triangle records hold those arrays and the vertices,
    node for node and record for record; ``bridge.bvh_from_jax`` carries
    pbrt_tpu's tree over to the same arrays and the same kernel layout.
(b) The walk: the twin of csrc/kd_traverse.cu
    (``ops/kdtree.py::traverse_reference``) against pbrt_tpu's
    ``kdtree_intersect_tris`` on seeded rays, as tests/test_kdtree.py
    holds pbrt_tpu's against brute force: hit mask and prim equal, t
    within rtol 1e-5 (XLA may contract the leaf test's multiply-adds);
    against the port's brute-force twin on the same triangles, prim
    equal and the hits' t bit for bit (the same test in the same order).
    The any-hit twin's boolean equals the closest-hit twin's ``prim >=
    0`` and pbrt_tpu's ``intersect_p_kd`` on rays with finite and
    infinite ``tmax``.
(c) Scenes: a file with ``Accelerator "kdtree"`` over a 722-triangle
    heightfield, two spheres, an aaplane light and a disk through the
    port's ``intersect`` (every Hit field), ``intersect_p`` (the any-hit
    walk, then the other families; pbrt_tpu's answer, the closest hit's
    ``valid``, also below finite ``tmax``) and a `path` pass against
    pbrt_tpu's.
(d) The brute-force path past 4,096 primitives: a 5,000-triangle scene
    with spheres and an aaplane, ``use_bvh="never"``, through the port's
    ``intersect`` against pbrt_tpu's ``_intersect_brute`` (pbrt_tpu's
    CPU path); the twin's chunked fold equals a one-row-at-a-time fold
    bit for bit, static and moving.

Every pbrt_tpu program runs on the CPU, eagerly or once jitted, and is
shared by the file's tests through module-scoped fixtures.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.frontend import parse_pbrt_string as jparse
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import intersect as jisect
from pbrt_tpu.scene import kdtree as jkd
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.frontend import parse_pbrt_string
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.ops import kdtree as kops
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import intersect as tisect
from pbrt_tpu_torch.scene import kdtree as tkd
from pbrt_tpu_torch.scene.types import SceneBuilder

# each xdist worker's share of the cores
import test_torch_intersect  # noqa: F401

jrender = importlib.import_module("pbrt_tpu.integrators.render")

ARRAYS = ("split_pos", "axis", "above_child", "n_prims", "prim_ids",
          "world_lo", "world_hi")
HIT_FIELDS = ("t", "p", "ng", "ns", "uv", "dpdu", "dpdv")
ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "oracle")


def _fill_soup(b, n_tris=300, seed=5):
    """tests/test_bvh_io.py ``random_tri_scene``'s builder calls."""
    rs = np.random.RandomState(seed)
    m = b.add_material(type=0, kd=0.5)
    centers = rs.uniform(-5, 5, (n_tris, 3)).astype(np.float32)
    offs = rs.uniform(-0.4, 0.4, (n_tris, 2, 3)).astype(np.float32)
    for i in range(n_tris):
        b.add_triangle(centers[i], centers[i] + offs[i, 0],
                       centers[i] + offs[i, 1], mat=m)


def _fill_heightfield(b, n=46, seed=3):
    """An n × n grid of seeded heights over [−4, 4]²: 2 (n − 1)² = 4,050
    triangles at n = 46, many of them sharing a split plane's edges."""
    rs = np.random.RandomState(seed)
    m = b.add_material(type=0, kd=0.5)
    g = np.linspace(-4.0, 4.0, n)
    x, z = np.meshgrid(g, g, indexing="xy")
    y = rs.uniform(0.0, 0.6, (n, n))
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    idx = []
    for r in range(n - 1):
        for c in range(n - 1):
            a = r * n + c
            idx += [(a, a + 1, a + n + 1), (a, a + n + 1, a + n)]
    b.add_mesh([tuple(v) for v in verts], idx, mat=m)


FILLS = {"soup300": _fill_soup, "heightfield4050": _fill_heightfield}


def _rays(n, seed, lo=-8.0, hi=8.0, aim=None):
    """Seeded rays from the box [lo, hi]³, in random directions or, with
    ``aim``, toward random points of the box [−aim, aim]³."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = (rs.randn(n, 3) if aim is None
         else rs.uniform(-aim, aim, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.fixture(scope="module")
def trees():
    """{name: (pbrt_tpu's scene, its KdTree, the port's scene, its
    KdTree)}, both scenes from the same builder calls without a BVH."""
    out = {}
    for name, fill in FILLS.items():
        jb, tb = JaxBuilder(RGB), SceneBuilder()
        fill(jb)
        fill(tb)
        js, ts = jb.build(use_bvh="never"), tb.build("cpu", use_bvh="never")
        out[name] = (js, jkd.build_kdtree(js), ts, tkd.build_kdtree(ts))
    return out


@pytest.mark.parametrize("name", sorted(FILLS))
def test_build_equals_jax(trees, name):
    _, jk, ts, tk = trees[name]
    assert tk.n_prims.shape[0] > 100
    for k in ARRAYS:
        want, got = np.asarray(getattr(jk, k)), getattr(tk, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert tk.max_leaf == jk.max_leaf
    assert 0 < tk.depth < kops.MAX_DEPTH
    # the kernel's layout: every 8-byte node holds its arrays, every
    # leaf-ordered record v0, e1, e2 and the index of its prim_ids entry
    leaf = tk.axis == kops.LEAF
    x, y = tk.nodes[:, 0], tk.nodes[:, 1]
    assert tk.nodes.shape == (tk.axis.shape[0], 2)
    assert torch.equal(y & 3, torch.where(leaf, kops.LEAF, tk.axis))
    assert torch.equal(y >> 2, torch.where(leaf, tk.n_prims,
                                           tk.above_child))
    assert torch.equal(x[leaf], tk.above_child[leaf])
    assert torch.equal(x[~leaf], tk.split_pos[~leaf].view(torch.int32))
    assert bool((tk.n_prims[~leaf] == 0).all())
    ids = tk.prim_ids.long()
    assert tk.tris.shape == (ids.shape[0], 12)
    assert torch.equal(tk.tris[:, 9].view(torch.int32), tk.prim_ids)
    assert torch.equal(tk.tris[:, 0:3], tk.v0[ids])
    assert torch.equal(tk.tris[:, 3:6], tk.v1[ids] - tk.v0[ids])
    assert torch.equal(tk.tris[:, 6:9], tk.v2[ids] - tk.v0[ids])
    assert not tk.tris[:, 10:].any()


@pytest.mark.parametrize("name", sorted(FILLS))
def test_walk_twin_matches_jax(trees, name):
    js, jk, ts, tk = trees[name]
    o, d = _rays(3000, 6, aim=4.0)
    if name.startswith("height"):     # from above the floor, downward
        o[:, 1] = np.abs(o[:, 1]) + 1.0
        d[:, 1] = -np.abs(d[:, 1])
    tmax = np.full(len(o), np.inf, np.float32)
    t_j, i_j, h_j = (np.asarray(x) for x in jkd.kdtree_intersect_tris(
        jk, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))
    t_t, i_t, counts = kops.traverse_reference(
        tk, torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(tmax),
        counts=True)
    t_t, i_t = t_t.numpy(), i_t.numpy()
    assert h_j.mean() > 0.05 and counts["tri_tests"] > 0
    np.testing.assert_array_equal(i_t >= 0, h_j)
    np.testing.assert_array_equal(i_t, i_j)
    np.testing.assert_allclose(t_t[h_j], t_j[h_j], rtol=1e-5)
    np.testing.assert_array_equal(t_t[~h_j], tmax[~h_j])
    # against the port's brute-force twin over the same triangles
    t_b, i_b = ik.intersect_brute(*ik.pack_scene(ts), torch.as_tensor(o),
                                  torch.as_tensor(d), torch.as_tensor(tmax),
                                  ts.n_tri, 0, 0)
    np.testing.assert_array_equal(i_t, i_b.numpy())
    np.testing.assert_array_equal(t_t[h_j], t_b.numpy()[h_j])


def _rows(tk, prim):
    """Triangle rows v0, e1, e2 of the scene's triangles ``prim``."""
    v0 = tk.v0[prim]
    return torch.cat([v0, tk.v1[prim] - v0, tk.v2[prim] - v0], -1)


@pytest.mark.parametrize("name", sorted(FILLS))
def test_any_hit_twin_matches_closest_and_jax(trees, name):
    """The any-hit twin (the walk that ends at its first hit) on rays
    with finite and infinite tmax: its boolean equals the closest-hit
    twin's ``prim >= 0`` and pbrt_tpu's ``intersect_p_kd``; its hit is a
    hit of its triangle below tmax, no nearer than the closest; it tests
    fewer triangles; the CPU wrapper is the twin."""
    js, jk, ts, tk = trees[name]
    o, d = _rays(2000, 16, aim=4.0)
    if name.startswith("height"):
        o[:, 1] = np.abs(o[:, 1]) + 1.0
        d[:, 1] = -np.abs(d[:, 1])
    tmax = np.random.RandomState(17).uniform(0.5, 14.0, len(o)).astype(
        np.float32)
    tmax[::3] = np.inf
    occ_j = np.asarray(jkd.intersect_p_kd(
        dataclasses.replace(js, bvh=jk), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tmax)))
    args = [torch.as_tensor(x) for x in (o, d, tmax)]
    t_c, i_c, n_c = kops.traverse_reference(tk, *args, counts=True)
    t_a, i_a, n_a = kops.traverse_reference(tk, *args, any_hit=True,
                                            counts=True)
    hit = i_c >= 0
    inf = torch.isinf(args[2])
    assert 0.05 < float(hit.float().mean()) < 0.9
    assert bool((hit & inf).any() and (hit & ~inf).any())
    assert torch.equal(i_a >= 0, hit)
    np.testing.assert_array_equal(hit.numpy(), occ_j)
    assert torch.equal(t_a[~hit], args[2][~hit])
    assert bool((t_a[hit] >= t_c[hit]).all() and (t_a[hit] < args[2][hit])
                .all())
    t_r, h_r = ik.ray_tri_reference(args[0][hit], args[1][hit],
                                    _rows(tk, i_a[hit].long()),
                                    args[2][hit])
    assert bool(h_r.all()) and torch.equal(t_r, t_a[hit])
    assert n_a["tri_tests"] < n_c["tri_tests"]
    assert n_a["node_steps"] < n_c["node_steps"]
    t_w, i_w = kops.kd_traverse(tk, *(a[:64] for a in args), any_hit=True)
    assert torch.equal(t_w, t_a[:64]) and torch.equal(i_w, i_a[:64])


def test_bridge_carries_a_kdtree(trees):
    _, jk, _, tk = trees["heightfield4050"]
    bk = bridge.bvh_from_jax(jk)
    assert isinstance(bk, tkd.KdTree)
    for k in ARRAYS + ("v0", "v1", "v2", "nodes", "tris"):
        assert torch.equal(getattr(bk, k), getattr(tk, k)), k
    assert (bk.max_leaf, bk.depth) == (tk.max_leaf, tk.depth)


def test_walk_dispatch_and_bounds(trees):
    """The wrapper takes the twin on the CPU (no launch), raises on a
    device that is neither the CPU nor a card, and a tree deeper than the
    kernel's stack is refused before a launch."""
    _, _, _, tk = trees["soup300"]
    o, d = _rays(64, 2)
    before = (kops.kd_traverse.launches, kops.kd_traverse.any_hit_launches)
    t, i = kops.kd_traverse(tk, torch.as_tensor(o), torch.as_tensor(d),
                            torch.full((64,), np.inf))
    assert kops.kd_traverse.launches == before[0]
    assert t.dtype == torch.float32 and i.dtype == torch.int32
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(NotImplementedError):
        kops.kd_traverse(tk, meta, meta, meta[:, 0])
    t, i = kops.kd_traverse(tk, torch.as_tensor(o), torch.as_tensor(d),
                            torch.full((64,), np.inf), any_hit=True)
    assert (kops.kd_traverse.launches,
            kops.kd_traverse.any_hit_launches) == before
    # the kernel's stack holds this tree's far children, none past 64 levels
    kops.check_depth(dataclasses.replace(tk, depth=kops.MAX_DEPTH))
    with pytest.raises(ValueError):
        kops.check_depth(dataclasses.replace(tk, depth=kops.MAX_DEPTH + 1))


KD_FILE = """LookAt 0 3 -6  0 0.4 0  0 1 0
Camera "perspective" "float fov" [40]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" 3
Accelerator "kdtree"
WorldBegin
AttributeBegin
Material "matte" "rgb Kd" [0.6 0.55 0.5]
Translate -3 0 3
Scale 6 1 6
Rotate -90 1 0 0
Shape "heightfield" "integer nu" [20] "integer nv" [20] "float Pz" [{pz}]
AttributeEnd
AttributeBegin
Material "plastic" "rgb Kd" [0.2 0.3 0.6] "rgb Ks" [0.3 0.3 0.3]
Translate 0.6 0.7 0
Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
Material "matte" "rgb Kd" [0.7 0.2 0.2]
Translate -0.8 0.45 0.3
Shape "sphere" "float radius" [0.35]
Translate 0 0.5 0
Rotate 90 1 0 0
Shape "disk" "float radius" [0.3]
AttributeEnd
AttributeBegin
AreaLightSource "diffuse" "rgb L" [9 9 9]
Translate 0 3 0
Rotate 90 1 0 0
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-0.5 -0.5 0  0.5 -0.5 0  0.5 0.5 0  -0.5 0.5 0]
AttributeEnd
WorldEnd
"""


@pytest.fixture(scope="module")
def kd_file():
    rs = np.random.RandomState(4)
    text = KD_FILE.format(pz=" ".join(f"{z:.4f}"
                                      for z in rs.uniform(0, 0.3, 400)))
    js, jc, jo = jparse(text, base_dir=ORACLE)
    ts, tc, to = parse_pbrt_string(text, base_dir=ORACLE, device="cpu")
    assert isinstance(js.bvh, jkd.KdTree) and isinstance(ts.bvh, tkd.KdTree)
    assert ts.n_tri == js.n_tri > 256 and ts.n_sph == 2 and ts.n_dsk == 1
    return js, jc, jo, ts, tc, to


def test_kd_scene_file_builds_pbrt_tpus_tree(kd_file):
    js, _, _, ts, _, _ = kd_file
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(ts.bvh, k).numpy(),
                                      np.asarray(getattr(js.bvh, k)), k)


def test_kd_scene_queries_match_jax(kd_file):
    """Closest hits of the walk, the spheres through the brute-force
    twin and the disk in plain torch: prim equal, every Hit field at
    atol 1e-4 on hits (rtol 1e-5 for t); any-hit equals the closest
    hit's validity, in both packages."""
    js, _, _, ts, _, _ = kd_file
    o, d = _rays(4000, 7, -3.0, 3.0)
    o[:, 1] = np.abs(o[:, 1]) + 1.5
    d[:, 1] = -np.abs(d[:, 1])
    tmax = np.full(len(o), 1e30, np.float32)
    jh = jisect.intersect(js, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(tmax))
    th = tisect.intersect(ts, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(tmax))
    prim = np.asarray(jh.prim_id)
    np.testing.assert_array_equal(th.prim_id.numpy(), prim)
    hit = prim >= 0
    fams = np.digitize(prim[hit], [ts.n_tri, ts.n_tri + ts.n_sph,
                                   ts.n_tri + ts.n_sph + ts.n_pln])
    assert set(fams.tolist()) >= {0, 1, 3}      # triangles, spheres, disk
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit],
                               rtol=1e-5)
    for k in HIT_FIELDS[1:]:
        np.testing.assert_allclose(getattr(th, k).numpy()[hit],
                                   np.asarray(getattr(jh, k))[hit],
                                   atol=1e-4, err_msg=k)
    occ = tisect.intersect_p(ts, torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(tmax))
    np.testing.assert_array_equal(occ.numpy(), hit)
    np.testing.assert_array_equal(np.asarray(jisect.intersect_p(
        js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))), hit)


def test_kd_scene_any_hit_matches_jax(kd_file):
    """``intersect_p`` on the kd file below finite tmax (a third
    infinite, the rest around the closest hit's t, so that the segment
    ends before or after it): the port's any-hit walk, then the spheres,
    the aaplane and the disk, against pbrt_tpu's ``intersect_p_kd``
    (the closest hit's ``valid``); some segments are blocked by a sphere
    or the disk and by no triangle."""
    js, _, _, ts, _, _ = kd_file
    o, d = _rays(3000, 18, -3.0, 3.0)
    o[:, 1] = np.abs(o[:, 1]) + 1.5
    d[:, 1] = -np.abs(d[:, 1])
    big = torch.full((len(o),), 1e30)
    t_hit = tisect.intersect(ts, torch.as_tensor(o), torch.as_tensor(d),
                             big).t.numpy()
    rs = np.random.RandomState(19)
    tmax = (np.minimum(t_hit, 20.0) * rs.uniform(0.6, 1.4, len(o))).astype(
        np.float32)
    tmax[::3] = np.inf
    want = np.asarray(jisect.intersect_p(js, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(tmax)))
    args = [torch.as_tensor(x) for x in (o, d, tmax)]
    got = tisect.intersect_p(ts, *args)
    assert 0.1 < want.mean() < 0.9
    np.testing.assert_array_equal(got.numpy(), want)
    _, walk_hit, _ = tkd.kdtree_intersect_tris(
        ts.bvh, *args[:2], torch.clamp_max(args[2], ik.BIG), any_hit=True)
    assert bool((got & ~walk_hit).any() and walk_hit.any())


def test_kd_scene_pass_matches_jax(kd_file):
    """A `path` pass of the file (its halton sampler, depth, 16² × 4
    spp) through both packages' ``render_pass``: per pixel rtol 1e-4 /
    atol 1e-5 with at most 2% of the pixels outside, the mean to 1e-4."""
    js, jc, jo, ts, tc, to = kd_file
    cfg = dict(integrator="path", sampler=jo["sampler"],
               max_depth=jo["max_depth"])
    want = np.asarray(jax.jit(
        lambda s: jrender.render_pass(
            s, jc, jfilm.make_filter("box"), jrender.RenderConfig(**cfg),
            16, 16, 4, jnp.asarray(0, jnp.uint32)))(js)) / 4
    got = trender.render_pass(ts, tc, tfilm.make_filter("box"),
                              trender.RenderConfig(**cfg), 16, 16, 4, 0,
                              "cpu").numpy() / 4
    assert want.mean() > 1e-3
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert off.mean() <= 0.02, off.mean()
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-4)


def _fill_big_brute(b, n_tris=5000, seed=9):
    """5,000 seeded triangles, 40 spheres and an aaplane light under
    them: 5,041 primitives, past pbrt_tpu's 4,096."""
    _fill_soup(b, n_tris, seed)
    m = b.add_material(type=0, kd=0.3)
    rs = np.random.RandomState(seed + 1)
    for c in rs.uniform(-5, 5, (40, 3)):
        b.add_sphere(tuple(c), 0.3, mat=m)
    li = b.add_light(type="area", L=5.0, prim=-1)
    pid = b.add_aaplane((-6, 6, -6), (6, 6, 6), axis=1, facing_fw=False,
                        mat=m, light=li)
    b.light_rows[li]["prim"] = b.prim_index("pln", pid)


def test_brute_force_past_4096_matches_jax():
    """The port's brute-force path (no BVH) on 5,041 primitives against
    pbrt_tpu's ``_intersect_brute``: prim equal, t rtol 2e-5 (XLA's
    all-pairs expressions, tests/test_torch_intersect.py), any-hit equal."""
    jb, tb = JaxBuilder(RGB), SceneBuilder()
    _fill_big_brute(jb)
    _fill_big_brute(tb)
    js, ts = jb.build(use_bvh="never"), tb.build("cpu", use_bvh="never")
    assert ts.bvh is None and ts.n_prims == 5041
    o, d = _rays(2048, 12, -6.0, 6.0, aim=4.0)
    tmax = np.full(len(o), np.inf, np.float32)
    jh = jisect._intersect_brute(js, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tmax))
    th = tisect.intersect(ts, torch.as_tensor(o), torch.as_tensor(d),
                          torch.as_tensor(tmax))
    prim = np.asarray(jh.prim_id)
    np.testing.assert_array_equal(th.prim_id.numpy(), prim)
    hit = prim >= 0
    assert hit.mean() > 0.3 and (prim >= ts.n_tri).any()
    np.testing.assert_allclose(th.t.numpy()[hit], np.asarray(jh.t)[hit],
                               rtol=2e-5)
    occ = tisect.intersect_p(ts, torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(tmax))
    np.testing.assert_array_equal(occ.numpy(), hit)


@pytest.mark.parametrize("motion", (False, True))
def test_chunked_twin_equals_row_by_row(monkeypatch, motion):
    """The twin's fold over chunks of rows equals its fold one row at a
    time (chunks of 1) bit for bit, ties included: 350 triangles, each
    twice (static: equal rows; moving: each copy its own motion), and 30
    spheres."""
    b = SceneBuilder()
    _fill_soup(b, 350, 21)
    m = b.add_material(type=0, kd=0.5)
    rs = np.random.RandomState(22)
    for c in rs.uniform(-5, 5, (30, 3)):
        b.add_sphere(tuple(c), 0.4, mat=m)
    ts = b.build("cpu", use_bvh="never")
    tri, sph, pln = ik.pack_scene(ts)
    tri = torch.cat([tri, tri])                  # every triangle twice
    o, d = (torch.as_tensor(x) for x in _rays(1000, 23, aim=4.0))
    tmax = torch.full((1000,), np.inf)
    args = [sph, pln, o, d, tmax, tri.shape[0], ts.n_sph, 0]
    if motion:
        tri = torch.cat([tri[:, :3], tri[:, :3] + tri[:, 3:6],
                         tri[:, :3] + tri[:, 6:9],
                         torch.as_tensor(rs.uniform(-0.2, 0.2, (
                             tri.shape[0], 9)).astype(np.float32))], -1)
        args.append(torch.as_tensor(rs.uniform(0, 1, 1000)
                                    .astype(np.float32)))
    chunked = ik._intersect_reference(tri, *args)
    monkeypatch.setattr(ik, "CHUNK_ELEMS", 1)
    one_by_one = ik._intersect_reference(tri, *args)
    assert (chunked[1] >= 0).float().mean() > 0.05
    n = tri.shape[0]
    on_tri = (chunked[1] >= 0) & (chunked[1] < n)
    if not motion:                  # the first of two equal rows wins
        assert bool((chunked[1][on_tri] < n // 2).all())
    for a, w in zip(chunked, one_by_one):
        assert torch.equal(a, w)


def test_kd_scene_keeps_motion_and_curves_out():
    """As pbrt_tpu's kd path: the kd query takes no shutter time (the
    port's ``intersect`` ignores ``time`` there) and a kd scene is a
    scene with a KdTree aggregate whatever else it carries."""
    b = SceneBuilder()
    _fill_soup(b, 300, 5)
    ts = b.build("cpu", use_bvh="never")
    ts = dataclasses.replace(ts, bvh=tkd.build_kdtree(ts))
    o, d = (torch.as_tensor(x) for x in _rays(256, 30, aim=4.0))
    tmax = torch.full((256,), 1e30)
    h0 = tisect.intersect(ts, o, d, tmax)
    h1 = tisect.intersect(ts, o, d, tmax, time=torch.rand(256))
    assert torch.equal(h0.prim_id, h1.prim_id) and torch.equal(h0.t, h1.t)
