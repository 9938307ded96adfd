"""The early reject of csrc/tri_sweep.cuh, the brute-force kernel's lane
map and the fused kernel's sweep counts, on the CPU.

``ops/intersect.py::tri_reject_reference`` mirrors the kernels' early
reject operation for operation. It must be conservative: it may reject a
ray-triangle pair only where the exact test of the brute-force twin
(``_intersect_reference``, one triangle at a time, with the largest best
t) misses. That is checked on 1,024,000 pairs made from a numpy seed,
aimed so that about a quarter hit, and on hand-made pairs at the edges of
each clause of the proof in the header. The reject must also do some
work: it rejects at least half of the random pairs that miss. No JAX
program is traced here.
"""

import math

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.ops import fused_path as fp
from pbrt_tpu_torch.ops import intersect as ik

F32 = np.float32


def exact_hits(tri, o, d):
    """(n,) bool: the brute-force twin's hit of ray i against triangle i,
    with no other primitive and tmax = inf (best t = 1e30). Pairs that
    share a triangle row go through one call of the twin."""
    tri, o, d = (torch.as_tensor(np.ascontiguousarray(x, F32))
                 for x in (tri, o, d))
    n = o.shape[0]
    empty_s, empty_p = torch.zeros((1, 4)), torch.zeros((1, 8))
    tmax = torch.full((n,), math.inf)
    _, inv = torch.unique(tri, dim=0, return_inverse=True)
    hit = torch.zeros(n, dtype=torch.bool)
    for g in torch.unique(inv):
        sel = (inv == g).nonzero()[:, 0]
        _, prim = ik._intersect_reference(
            tri[sel[0]][None].contiguous(), empty_s, empty_p,
            o[sel].contiguous(), d[sel].contiguous(), tmax[sel], 1, 0, 0)
        hit[sel] = prim == 0
    return hit


def reject(tri, o, d):
    return ik.tri_reject_reference(
        *(torch.as_tensor(np.ascontiguousarray(x, F32)) for x in (tri, o, d))
    )[0]


def random_pairs(n_tri=1000, per_tri=1024, seed=0):
    """Triangles with vertices in [-1, 1]^3 (edges down to 1e-3 of the
    box), rays from [-3, 3]^3 aimed at points spread around each
    triangle, so that hits, grazing misses and far misses all occur."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-1, 1, (n_tri, 3))
    scale = 10.0 ** rng.uniform(-3, 0, (n_tri, 1))
    e1 = rng.normal(size=(n_tri, 3)) * scale
    e2 = rng.normal(size=(n_tri, 3)) * scale
    tri = np.concatenate([v0, e1, e2], -1).astype(F32)
    tri = np.repeat(tri, per_tri, axis=0)
    n = tri.shape[0]
    # barycentric aim points, a third of them outside the triangle
    bu = rng.uniform(-0.3, 1.1, n)
    bv = rng.uniform(-0.3, 1.1, n)
    aim = tri[:, 0:3] + bu[:, None] * tri[:, 3:6] + bv[:, None] * tri[:, 6:9]
    o = rng.uniform(-3, 3, (n, 3))
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return tri, o.astype(F32), d.astype(F32)


def test_reject_is_conservative_on_random_pairs():
    tri, o, d = random_pairs()
    assert o.shape[0] >= 1_000_000
    hit = exact_hits(tri, o, d)
    rej = reject(tri, o, d)
    assert 0.2 < float(hit.float().mean()) < 0.6
    assert not bool((rej & hit).any()), f"{int((rej & hit).sum())} hits " \
        "rejected"
    miss_rejected = float(rej[~hit].float().mean())
    assert miss_rejected >= 0.5, f"rejects {miss_rejected:.3f} of misses"


def _flat_pairs(ox, oy, oz, e1x=1.0, dz=1.0, e2y=1.0):
    """The triangle v0 = 0, e1 = (e1x, 0, 0), e2 = (0, e2y, 0) and rays
    from (ox, oy, oz) along (0, 0, dz): det = -e1x·e2y·dz, and u = ox / e1x,
    v = oy / e2y, t = -oz / dz up to rounding."""
    ox, oy, oz = np.broadcast_arrays(*(np.asarray(x, F32) for x in
                                       (ox, oy, oz)))
    n = ox.size
    tri = np.tile(np.array([0, 0, 0, e1x, 0, 0, 0, e2y, 0], F32), (n, 1))
    o = np.stack([ox.ravel(), oy.ravel(), oz.ravel()], -1)
    d = np.tile(np.array([0, 0, dz], F32), (n, 1))
    return tri, o, d


def _ulps(x, k=2):
    """x and its k nearest float32 neighbours on each side."""
    out = [F32(x)]
    lo = hi = F32(x)
    for _ in range(k):
        lo, hi = np.nextafter(lo, F32(-np.inf)), np.nextafter(hi, F32(np.inf))
        out += [lo, hi]
    return np.array(out, F32)


def _edge_pairs():
    """Hand-made pairs at the edges of each clause."""
    tiny = np.array([0.0, -0.0, 2.0 ** -149, -(2.0 ** -149), 2.0 ** -130,
                     -(2.0 ** -130), 2.0 ** -126, -(2.0 ** -126)], F32)
    sets = []
    # |det| one ulp either side of 1e-12: e1 = (-D, 0, 0), e2 = (0, 1, 0),
    # d = (0, 0, 1) gives det = D, u = v = 0.25 and t = 2
    for D in _ulps(1e-12, 3):
        tri = np.array([[0, 0, 0, -D, 0, 0, 0, 1, 0]], F32)
        o = np.array([[-0.25 * D, 0.25, -2.0]], F32)
        sets.append((tri, o, np.array([[0, 0, 1]], F32)))
    # nu and nv at +-0 and the smallest subnormals, and u = ox / e1x,
    # v = oy / e2y at values whose product with 1/det rounds to -0 (e1x =
    # 2^20 and ox = -2^-149: u = -2^-169 rounds to -0, which passes u >= 0)
    for e1x, e2y in ((1.0, 1.0), (3.0, 1.0), (2.0 ** 20, 1.0),
                     (-(2.0 ** 20), 1.0), (1.0, 2.0 ** 20),
                     (1.0, -(2.0 ** 20))):
        for dz in (1.0, -1.0):
            ox, oy = np.meshgrid(
                np.concatenate([tiny, tiny * e1x, [0.25 * e1x]]),
                np.concatenate([tiny, tiny * e2y, [0.25 * e2y]]))
            sets.append(_flat_pairs(ox, oy, -2.0 * dz, e1x, dz, e2y))
    # u + v at 1 +- a few ulps, with an inexact 1/det (e1x = 3)
    for e1x in (1.0, 3.0, -3.0):
        for u in (0.25, 0.5, 0.75, 1.0 / 3.0):
            ox = _ulps(F32(u) * F32(e1x), 3)
            oy = _ulps(1.0 - u, 3)
            gx, gy = np.meshgrid(ox, oy)
            sets.append(_flat_pairs(gx, gy, -2.0, e1x))
    # t at 1e-4 +- a few ulps (t = -oz)
    for dz in (1.0, -1.0):
        sets.append(_flat_pairs(0.25, 0.25, -_ulps(1e-4, 3) * dz, 1.0, dz))
    # degenerate triangles: e1 = 0, e2 = 0, e1 parallel to e2, a point
    rng = np.random.default_rng(5)
    o = rng.uniform(-1, 1, (64, 3)).astype(F32)
    d = np.tile(np.array([0.1, 0.2, 1.0], F32), (64, 1))
    for e1, e2 in (((0, 0, 0), (0, 1, 0)), ((1, 0, 0), (0, 0, 0)),
                   ((1, 1, 0), (2, 2, 0)), ((0, 0, 0), (0, 0, 0))):
        tri = np.tile(np.array([0, 0, 0, *e1, *e2], F32), (64, 1))
        sets.append((tri, o, d))
    tri, o, d = (np.concatenate(x) for x in zip(*sets))
    return tri, o, d


def test_reject_is_conservative_on_edges():
    tri, o, d = _edge_pairs()
    hit = exact_hits(tri, o, d)
    rej = reject(tri, o, d)
    assert not bool((rej & hit).any()), f"{int((rej & hit).sum())} hits " \
        "rejected"
    # the edges are real edges: some of these pairs hit, some miss
    assert 0.05 < float(hit.float().mean()) < 0.95
    # the ulp either side of 1e-12 (first seven pairs: det = D)
    dets = ik.tri_reject_reference(*(torch.as_tensor(x[:7])
                                     for x in (tri, o, d)))[1]
    assert bool((dets > 1e-12).any()) and bool((dets <= 1e-12).any())
    assert torch.equal(hit[:7], dets > 1e-12)


def test_reject_is_conservative_with_nan_and_inf():
    tri, o, d = random_pairs(n_tri=64, per_tri=64, seed=3)
    rng = np.random.default_rng(4)
    for arr in (tri, o, d):
        rows = rng.integers(0, arr.shape[0], arr.shape[0] // 8)
        cols = rng.integers(0, arr.shape[1], rows.shape[0])
        arr[rows, cols] = rng.choice(
            np.array([np.nan, np.inf, -np.inf], F32), rows.shape[0])
    hit = exact_hits(tri, o, d)
    rej = reject(tri, o, d)
    assert not bool((rej & hit).any())
    assert bool(hit.any())


def test_mirror_follows_the_exact_test_operation_for_operation():
    """det, nu, nv and nt are the twin's own numerators: the exact test
    rebuilt from them (u = nu · inv_det, ...) gives the twin's hits."""
    tri, o, d = random_pairs(n_tri=50, per_tri=200, seed=1)
    _, det, nu, nv, nt = ik.tri_reject_reference(
        *(torch.as_tensor(x) for x in (tri, o, d)))
    okd = det.abs() > 1e-12
    inv = torch.where(okd, 1.0 / det, torch.zeros_like(det))
    u, v, t = nu * inv, nv * inv, nt * inv
    rebuilt = (okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
               & (t < 1e30))
    assert torch.equal(rebuilt, exact_hits(tri, o, d))


def test_reject_skips_most_divisions_of_coherent_warps():
    """Why the reject pays on coherent rays and not on spread ones: over the
    first 16 triangles of the portal scene, warps of 32 neighbouring camera
    rays would skip at least 3/4 of the divisions, warps of 32 rays with
    random origins and directions inside the box (as bounce rays) fewer
    than half."""
    from pbrt_tpu_torch import entry
    from pbrt_tpu_torch.integrators import render as render_mod
    from pbrt_tpu_torch.scene import film as film_mod

    res = 64
    rays, _, _, _ = render_mod.camera_rays(
        entry._camera((res, res), "cpu"),
        film_mod.make_filter("box", device="cpu"),
        render_mod.RenderConfig(max_depth=4), res, res, 1, 0, "cpu")
    n = rays.o.shape[0]
    rng = np.random.default_rng(2)
    o_r = torch.as_tensor(rng.uniform(0.05, 0.95, (n, 3)), dtype=torch.float32)
    d_r = torch.nn.functional.normalize(
        torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32), dim=-1)
    tri = ik.pack_scene(entry._portal_scene("cpu", "portal"))[0][:16]
    share = {}
    for name, (o, d) in (("camera", (rays.o, rays.d)), ("random", (o_r, d_r))):
        rej = torch.stack([ik.tri_reject_reference(t.expand(n, 9), o, d)[0]
                           for t in tri])
        share[name] = float(rej.reshape(16, -1, 32).all(-1).float().mean())
    assert share["camera"] >= 0.75 > 0.5 > share["random"], share


def test_lane_rays_map():
    for p in (1, 2):
        n_threads = 32 * 5
        lanes = ik.lane_rays(n_threads, p)
        assert lanes.shape == (n_threads, p)
        # every path once
        assert torch.equal(lanes.flatten().sort().values,
                           torch.arange(n_threads * p))
        for w in range(5):
            warp = lanes[32 * w:32 * (w + 1)]
            # a warp covers 32·p consecutive rays
            assert int(warp.min()) == 32 * p * w
            assert int(warp.max()) == 32 * p * (w + 1) - 1
            # each of its stores is 32 consecutive lanes
            for k in range(p):
                assert torch.equal(warp[:, k], torch.arange(32) + int(
                    warp[0, k]))
    assert torch.equal(ik.lane_rays(64, 1)[:, 0], torch.arange(64))


def test_sweep_counts_from_code():
    """Four bounces (max_depth 3) of 128 lanes: the alive bit (8) of bounce
    b decides who is live at b + 1."""
    R, n_b = 128, 4
    code = torch.zeros((n_b, R), dtype=torch.int32)
    code[0, :100] = 8 + 1          # lanes 0..99 survive bounce 0
    code[1, 0:3] = 8               # lanes 0..2 survive bounce 1
    code[1, 70] = 8 + 2            # and lane 70
    code[2, 1] = 8                 # lane 1 survives bounce 2
    for mode, per in ((1, 2), (0, 3)):
        live, ex64 = fp.sweep_counts(code, mode, 64)
        _, ex32 = fp.sweep_counts(code, mode, 32)
        # live paths entering each bounce: 128, 100, 4, 1
        assert live.tolist() == [128 * per, 100 * per, 4 * per, 1]
        # 64-path warps: both run bounce 1; only [0, 64) and [64, 128)
        # hold lanes 0..2 and 70 at bounce 2; lane 1 at bounce 3
        assert ex64.tolist() == [128 * per, 128 * per, 128 * per, 64]
        # 32-path warps: 4, 4 (lanes 96..99 keep the last one busy), 2, 1
        assert ex32.tolist() == [128 * per, 128 * per, 64 * per, 32]
    # R not a multiple of the warp: the last, partial warp counts whole
    live, ex = fp.sweep_counts(code[:, :100], 1, 64)
    assert live.tolist()[0] == 200 and ex.tolist()[0] == 256


def test_design_launchers_want_cuda():
    tabs = (torch.zeros((1, 9)), torch.zeros((1, 4)), torch.zeros((1, 8)))
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        ik._launch_design(*tabs, o, o, torch.ones(4), 1, 0, 0, ik.DESIGNS[-1])
    # on the CPU the public wrapper is the twin
    t, prim = ik.intersect_brute(*tabs, o, o + 1.0, torch.ones(4), 1, 0, 0)
    assert prim.tolist() == [-1] * 4
