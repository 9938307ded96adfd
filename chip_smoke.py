"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Builds the three kernels (csrc/fused_path.cu, csrc/intersect.cu,
   csrc/bvh_traverse.cu) with nvcc and the host BVH builder
   (csrc/bvh_builder.cpp) with g++, all at once, into build/kernels/ and
   prints the card, its power limit and the build times.
2. Holds the kernel against its plain-torch twin on the card on three
   scenes built by the port (portal mode 1 flat, mode-0 cornell, 940-tri
   clustered portal), at 64² × 2 spp, max_depth 4 and 6; checks that the
   cluster-culled sweep equals the flat sweep bit for bit.
3. Renders the main path, ``render(_portal_scene(), _camera((256, 256)),
   spp=64, max_depth=4, chunk_spp=32, device="cuda")``, checks that it
   launched the kernel once per chunk and that the image mean matches
   pbrt_tpu's on the same sample streams to rel 1e-3.
4. Times one 32-spp chunk (camera rays / kernel / replay), the 64-spp
   render and the twin, with CUDA events.
5. Holds the brute-force intersection kernel against its plain-torch twin
   on three primitive tables (the portal scene, the sphere cornell, a
   4,001-primitive table near the 4,096 cap that spans eight shared-memory
   tiles), for camera rays and for random rays with infinite and finite
   tmax: prim equal and t bit-equal.
6. Holds the generic wavefront loop against the fused kernel on the two
   scenes inside the fused profile (same lanes, seam allowance of
   tests/test_fused_path.py:258-261).
7. Renders the generic loop's path at full width through ``render``:
   ``_portal_scene(strategy="portal")`` and ``_sphere_cornell()``, 256² ×
   64 spp, and `direct`, `whitted`, `ao`, `mypath` at 64²; checks the
   launch counts the loop implies, that the fused kernel is not launched,
   and pbrt_tpu's image means to rel 1e-3.
8. Times the intersection kernel and its twin on 2,097,152-ray launches
   and the new scenes' passes and renders, and prints a JSON line of the
   kernels (with each kernel's roofline bound computed from this run's
   inputs), then {"ok": true, "device": {...}} as the last line.
9. Holds the BVH traversal kernel against its plain-torch twin on three
   trees (a 600-triangle soup, the 133,130-triangle heightfield cornell
   built by the native SBVH builder, a 7,498-triangle tree built with
   `hlbvh`), for camera rays and random rays with infinite and finite
   tmax: closest hit with the index equal and t bit-equal, any-hit with
   equal masks; and a scene of 2,188 primitives built with and without a
   BVH through ``intersect`` (valid and t equal, prim equal but for exact
   ties in t). Holds the brute-force kernel against its twin at the call
   shape a BVH scene gives it (no triangles, the scene's one sphere and one
   aaplane, tmax the traversal's closest hit): prim equal and t bit-equal.
10. Renders the BVH slice at full width through ``render``:
   ``_heightfield_cornell()``, 256² × 64 spp, `path`; checks the launch
   counts the loop implies (traversal and brute-force kernels), that the
   fused kernel is not launched, and, at 64² × 4 spp, pbrt_tpu's image
   mean to rel 1e-3 (pbrt_tpu's CPU traversal is too slow for the full
   size).
11. Times 2,097,152-ray closest-hit and any-hit launches of the traversal
   kernel on the big tree (camera rays, bounce rays and shadow rays with
   finite tmax, in the callers' order and in the ray sort's), the sort,
   the twin, the brute-force kernel and its twin at the BVH path's shape
   on the same 2,097,152 rays, a 32-spp pass and the 64-spp render, the
   tree build, and reads the kernels' share of a pass from torch.profiler.
   (The JSON lines come after this.)

Any failed check raises, so the script exits non-zero and prints no
result. It needs a CUDA device and never falls back to the CPU.
"""

import json
import math
import subprocess
import sys
import time

import torch

from pbrt_tpu_torch import entry
from pbrt_tpu_torch.integrators import render as render_mod
from pbrt_tpu_torch.ops import _build
from pbrt_tpu_torch.ops import bvh as bk
from pbrt_tpu_torch.ops import fused_path as fp
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import bvh as bvh_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene.types import SceneBuilder

W = H = 256
SPP = 64
CHUNK = 32
MAX_DEPTH = 4
# pbrt_tpu's render of the same main path (256², 64 spp, max_depth 4;
# samples are keyed by absolute index, so chunking only reorders the sum)
# on the CPU backend in float32. BENCH_r05.json's TPU figure,
# 0.11655332893133163, is 2.5% lower: the TPU's default matmul precision
# rounds the camera's float32 3×3 product to bf16.
REF_IMAGE_MEAN = 0.11957985907793045
TPU_IMAGE_MEAN = 0.11655332893133163
# pbrt_tpu's float32 image means on the CPU backend for the generic loop's
# renders below (max_depth 4, independent sampler, box filter), printed by
# ``PYTHONPATH=. python tests/test_torch_li_loop.py``: scene, integrator,
# resolution, spp -> mean.
REF_LOOP_MEANS = {
    ("portal_portal", "path", 256, 64): 0.11963030876927395,
    ("sphere_cornell", "path", 256, 64): 0.5771794151666872,
    ("sphere_cornell", "direct", 64, 4): 0.4631363573859672,
    ("sphere_cornell", "whitted", 64, 4): 0.4631363573859672,
    ("sphere_cornell", "ao", 64, 4): 0.8542355703393696,
    ("sphere_cornell", "mypath", 64, 4): 0.5735151737091652,
}
# pbrt_tpu's float32 image mean on the CPU backend for _heightfield_cornell()
# (133,130 triangles), `path`, max_depth 4, at 64² × 4 spp, printed by
# ``PYTHONPATH=. python tests/test_torch_bvh.py``. pbrt_tpu's CPU traversal
# is too slow for 256² × 64 spp, so the mean is held at this size and the
# full-width render is checked for its launches, shape and finiteness.
REF_BVH_MEAN = {("heightfield_cornell", "path", 64, 4): 0.3574122070165071}
# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate and float32 rate outside the tensor cores (a multiply-add counts as
# two, so code built without multiply-add contraction can reach half).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float arithmetic operations of one ray-primitive test in intersect.cu /
# fused_path.cu (multiplies, adds, subtracts, divides, sqrt, min/max;
# compares and selects not counted)
OPS_TRI, OPS_SPH, OPS_PLN = 46, 31, 8
# one slab test of bvh_traverse.cu: 6 subtracts, 6 multiplies, 10 min/max,
# the conservative scale
OPS_SLAB = 23


def check(ok, what):
    """Fail the run (also under ``python -O``, which drops asserts)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bounce_args(scene, max_depth, n_clu=None):
    ax, plf, pof, n_mat, mode = scene.fused_profile
    tri, msc, clu, nc = fp.pack_fused(scene, mode)
    kw = dict(n_tri=scene.n_tri, n_b=max_depth + 1, ax=ax, pl_facing=plf,
              portal_facing=pof, n_mat=n_mat, seed=0, rr_threshold=1.0,
              mode=mode, n_clu=nc if n_clu is None else n_clu)
    return (tri, msc, scene.materials.kd.contiguous(), clu), kw


def lanes(res, chunk, dev):
    cfg = render_mod.RenderConfig(max_depth=MAX_DEPTH)
    rays, pid, sidx, _ = render_mod.camera_rays(
        entry._camera((res, res), dev), film_mod.make_filter("box",
                                                             device=dev),
        cfg, res, res, chunk, 0, dev)
    return (rays.o.contiguous(), rays.d.contiguous(), pid.to(torch.int32),
            sidx.to(torch.int32))


def live_mask(code):
    live = torch.ones_like(code, dtype=torch.bool)
    live[1:] = (code[:-1] & 8) > 0
    return live


def replay_of(scene, res):
    return fp.replay(scene.materials.kd, scene.lights.emit[0], *res)


def check_kernel(name, scene, max_depth, dev):
    """Kernel vs twin on 64² × 2 spp. Returns max |L_kernel − L_twin|."""
    tables, kw = bounce_args(scene, max_depth)
    rays = lanes(64, 2, dev)
    got = fp.fused_bounce(*tables, *rays, **kw)
    want = fp._kernel_reference(*tables, *rays, **kw)
    torch.cuda.synchronize()
    L, L_ref = replay_of(scene, got), replay_of(scene, want)
    live = live_mask(want[0])
    err = float((L - L_ref).abs().max())
    if name == "portal":
        # the CPU test's tolerances: codes identical, knee/kc rtol 1e-5
        # atol 1e-6 on live lanes, L atol 5e-6 on all lanes
        check(torch.equal(got[0][live], want[0][live]), "code mismatch")
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g[live], w[live], rtol=1e-5,
                                       atol=1e-6)
        check(err <= 5e-6, f"L max err {err}")
    else:
        # seam allowance (tests/test_fused_path.py:258-261)
        bad = (L - L_ref).abs().amax(-1) > 1e-4
        check(float(bad.float().mean()) < 6e-3, f"{int(bad.sum())} lanes")
        torch.testing.assert_close(L[~bad], L_ref[~bad], atol=1.1e-4,
                                   rtol=0)
        rel = abs(float(L.mean() - L_ref.mean())) / float(L_ref.mean())
        check(rel < 0.01, f"image means differ by rel {rel}")
    check(float(L_ref.mean()) > 0.01, "the scene does not light up")
    check(bool(torch.isfinite(L).all()), "non-finite radiance")
    same = float((got[0][live] == want[0][live]).float().mean())
    print(f"kernel vs twin {name} depth {max_depth}: L max err {err:.3g}, "
          f"codes equal on {same:.6f} of live lanes, mean "
          f"{float(L.mean()):.6f} vs {float(L_ref.mean()):.6f}")
    if kw["n_clu"]:
        tables_f, kw_f = bounce_args(scene, max_depth, n_clu=0)
        flat = fp.fused_bounce(*tables_f, *rays, **kw_f)
        diff = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(got, flat))
        check(diff == 0.0, f"culled vs flat diff {diff}")
        print(f"culled vs flat {name} depth {max_depth} "
              f"(n_clu={kw['n_clu']}): diff == {diff}")
    return err


def bound_ms(n_bytes, n_ops):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def intersect_bound(scene, n_rays, tris=True):
    """Each ray read once (o, d, tmax: 28 B) and written once (t, prim:
    8 B), the tables read once; every ray tests every primitive of the
    tables (``tris=False``: the spheres and aaplanes only, as under a
    BVH)."""
    tabs = ik.pack_scene(scene, tris=tris)
    n_bytes = 36 * n_rays + sum(t.numel() * 4 for t in tabs)
    n_ops = n_rays * (OPS_TRI * scene.n_tri * tris + OPS_SPH * scene.n_sph
                      + OPS_PLN * scene.n_pln)
    return bound_ms(n_bytes, n_ops)


def fused_bound(scene, code, n_b):
    """From this run's residuals: a lane alive entering bounce b sweeps
    the table once for its closest hit and, unless b is the emission-only
    last bounce, once (mode 1) or twice (mode 0) more for next-event
    estimation; ended lanes are not counted."""
    n_rays = code.shape[1]
    live = live_mask(code).sum(dim=1).tolist()
    shadow = 1 if scene.fused_profile[4] == 1 else 2
    sweeps = sum(n * (1 + (shadow if b < n_b - 1 else 0))
                 for b, n in enumerate(live))
    n_ops = sweeps * (OPS_TRI * scene.n_tri + OPS_PLN)
    n_bytes = n_rays * (24 + 8 + 12 * n_b) + 64 * scene.n_tri
    return bound_ms(n_bytes, n_ops)


def cap_table(dev):
    """A table near the intersection gate's cap of 4,096 primitives: the
    portal box, a 3,776-triangle tessellated sphere, 200 small spheres
    and the light's aaplane (4,001 primitives; the triangles span eight
    512-row shared-memory tiles)."""
    b = SceneBuilder()
    white, black = entry._box_with_opening(b)
    entry._add_sphere_mesh(b, (0.35, 0.22, 0.45), 0.22, white, 44)
    for i in range(200):
        b.add_sphere((0.55 + 0.04 * (i % 10), 0.03 + 0.045 * (i // 10), 0.8),
                     0.02, mat=white)
    entry._portal_light(b, black, "portal")
    return b.build(dev, use_bvh="never")   # the brute-force kernel's table


def ray_sets(dev, n=8192):
    """Camera rays (64² × 2 spp) and random rays from inside the box with
    infinite and with finite tmax, made from a seed."""
    o_c, d_c, _, _ = lanes(64, 2, dev)
    gen = torch.Generator(device="cpu").manual_seed(1)
    o_r = (torch.rand(n, 3, generator=gen) * 0.9 + 0.05).to(dev)
    d_r = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=gen), dim=-1).to(dev)
    inf = torch.full((n,), math.inf, device=dev)
    fin = (torch.rand(n, generator=gen) * 0.7 + 0.1).to(dev)
    return {"camera": (o_c, d_c, torch.full_like(o_c[:, 0], math.inf)),
            "random": (o_r, d_r, inf),
            "random_tmax": (o_r, d_r, fin)}


def check_intersect(name, scene, dev):
    """Kernel vs twin on the three ray sets: prim equal on every ray and
    t equal bit for bit. Returns the largest |t_kernel − t_twin|."""
    tabs = ik.pack_scene(scene)
    counts = (scene.n_tri, scene.n_sph, scene.n_pln)
    worst = 0.0
    for rname, (o, d, tmax) in ray_sets(dev).items():
        t, prim = ik.intersect_brute(*tabs, o, d, tmax, *counts)
        torch.cuda.synchronize()
        t_ref, prim_ref = ik._intersect_reference(*tabs, o, d, tmax, *counts)
        check(prim.dtype == torch.int32 and t.dtype == torch.float32,
              "output types")
        n_prim = int((prim != prim_ref).sum())
        err = float((t - t_ref).abs().max())
        worst = max(worst, err)
        hit = float((prim >= 0).float().mean())
        print(f"intersect kernel vs twin {name} {counts} {rname}: "
              f"{n_prim} prim mismatches, t max err {err:.3g}, hit share "
              f"{hit:.3f}")
        check(n_prim == 0, f"{n_prim} prim mismatches")
        check(torch.equal(t, t_ref), f"t differs from the twin by {err}")
        check(hit > 0.05, f"hit share {hit}")
    return worst


def check_loop_vs_fused(name, scene, max_depth, dev):
    """The generic loop against the fused kernel on the same lanes."""
    cfg = render_mod.RenderConfig(max_depth=max_depth)
    o, d, pid, sidx = lanes(64, 2, dev)
    sfn = render_mod.make_sampler("independent")
    check(fp.eligible(scene, cfg), f"{name} is outside the fused profile")
    k0, i0 = fp.fused_bounce.launches, ik.intersect_brute.launches
    L_fused = render_mod.li_path(scene, o, d, pid.long(), sidx.long(), sfn,
                                 cfg, None)
    check(fp.fused_bounce.launches == k0 + 1
          and ik.intersect_brute.launches == i0, "li_path took the loop")
    L_loop = render_mod._li_loop(scene, o, d, pid.long(), sidx.long(), sfn,
                                 cfg, None)
    torch.cuda.synchronize()
    check(ik.intersect_brute.launches > i0
          and fp.fused_bounce.launches == k0 + 1, "_li_loop's launches")
    bad = (L_loop - L_fused).abs().amax(-1) > 1e-4
    rel = abs(float(L_loop.mean() - L_fused.mean())) / float(L_fused.mean())
    print(f"loop vs fused kernel {name} depth {max_depth}: max diff "
          f"{float((L_loop - L_fused).abs().max()):.3g}, lanes over 1e-4: "
          f"{int(bad.sum())} of {bad.numel()}, means rel {rel:.3g}")
    check(float(bad.float().mean()) < 6e-3, f"{int(bad.sum())} lanes")
    torch.testing.assert_close(L_loop[~bad], L_fused[~bad], atol=1.1e-4,
                               rtol=0)
    check(rel < 0.01, f"means differ by rel {rel}")


def render_loop(key, scene, integrator, res, spp, want_launches):
    """One render of the generic loop through ``render``; checks the
    image, the launch counts and pbrt_tpu's mean. Returns the launches."""
    cam = entry._camera((res, res))
    k0 = fp.fused_bounce.launches
    i0 = ik.intersect_brute.launches
    img = render_mod.render(scene, cam, spp=spp, integrator=integrator,
                            max_depth=MAX_DEPTH, chunk_spp=CHUNK,
                            device="cuda")
    torch.cuda.synchronize()
    n_k = fp.fused_bounce.launches - k0
    n_i = ik.intersect_brute.launches - i0
    ref = REF_LOOP_MEANS[(key, integrator, res, spp)]
    mean = float(img.double().mean())
    rel = abs(mean - ref) / ref
    print(f"generic loop {key} {integrator} {res}² × {spp} spp: mean "
          f"{mean!r} vs pbrt_tpu {ref!r} (rel {rel:.3g}), {n_i} intersect "
          f"launches, {n_k} fused launches")
    check(img.shape == (res, res, 3) and img.device.type == "cuda",
          f"image {tuple(img.shape)} on {img.device}")
    check(bool(torch.isfinite(img).all()), "non-finite image")
    check(float(img.mean()) > 0.05, "the scene does not light up")
    check(n_k == 0, f"the fused kernel was launched {n_k} times")
    check(n_i == want_launches, f"{n_i} intersect launches, the loop "
          f"implies {want_launches}")
    check(rel < 1e-3, f"image mean off by rel {rel}")
    return n_i


def soup_scene(dev, n_tri=600):
    """A random soup of small triangles inside the unit box (seeded), with
    a BVH from the native builder."""
    gen = torch.Generator(device="cpu").manual_seed(7)
    c = torch.rand(n_tri, 3, generator=gen) * 0.8 + 0.1
    offs = (torch.rand(n_tri, 2, 3, generator=gen) - 0.5) * 0.16
    b = SceneBuilder()
    m = b.add_material(type=0, kd=0.5)
    for i in range(n_tri):
        b.add_triangle(c[i].numpy(), (c[i] + offs[i, 0]).numpy(),
                       (c[i] + offs[i, 1]).numpy(), mat=m)
    return b.build(dev, use_bvh="always")


def heightfield_scene(dev, n, n_phi=64, n_z=24, use_bvh="auto", split="sah"):
    b = SceneBuilder()
    b.bvh_split = split
    entry._fill_heightfield_cornell(b, n, n_phi, n_z)
    return b.build(dev, use_bvh=use_bvh)


def check_traverse(name, bvh, dev):
    """Traversal kernel vs twin on the three ray sets: closest hit with
    the leaf index equal on every ray and t equal bit for bit; any-hit
    with equal masks. Returns the largest |t_kernel − t_twin|."""
    worst = 0.0
    for rname, (o, d, tmax) in ray_sets(dev).items():
        t, leaf = bk.bvh_traverse(bvh, o, d, tmax, False)
        _, leaf_any = bk.bvh_traverse(bvh, o, d, tmax, True)
        torch.cuda.synchronize()
        t_ref, leaf_ref = bk._traverse_reference(bvh, o, d, tmax, False)
        _, any_ref = bk._traverse_reference(bvh, o, d, tmax, True)
        check(leaf.dtype == torch.int32 and t.dtype == torch.float32,
              "output types")
        n_leaf = int((leaf != leaf_ref).sum())
        n_any = int(((leaf_any >= 0) != (any_ref >= 0)).sum())
        err = float((t - t_ref).abs().max())
        worst = max(worst, err)
        hit = float((leaf >= 0).float().mean())
        print(f"bvh_traverse kernel vs twin {name} ({bvh.lo.shape[0]} nodes, "
              f"{bvh.prim_order.shape[0]} leaf triangles, {bvh.built_by}) "
              f"{rname}: {n_leaf} index mismatches, t max err {err:.3g}, "
              f"{n_any} any-hit mismatches, hit share {hit:.3f}")
        check(n_leaf == 0, f"{n_leaf} index mismatches")
        check(torch.equal(t, t_ref), f"t differs from the twin by {err}")
        check(n_any == 0, f"{n_any} any-hit mismatches")
        check(torch.equal(leaf_any >= 0, leaf >= 0),
              "any-hit disagrees with closest hit")
        check(hit > 0.05, f"hit share {hit}")
    return worst


def check_bvh_vs_brute(dev):
    """One scene under the brute-force gate, built with and without a BVH,
    the same rays through ``intersect``: valid and t equal on every ray;
    prim equal except where two primitives tie in t exactly (brute force
    keeps the first in table order, the BVH the first in leaf order)."""
    with_bvh = heightfield_scene(dev, 32, 16, 8, use_bvh="always")
    brute = heightfield_scene(dev, 32, 16, 8, use_bvh="never")
    check(with_bvh.n_prims == brute.n_prims == 2188 and brute.bvh is None
          and with_bvh.bvh is not None, "the 2,188-primitive pair")
    for rname, (o, d, tmax) in ray_sets(dev).items():
        h_b = isect_mod.intersect(with_bvh, o, d, tmax)
        h_f = isect_mod.intersect(brute, o, d, tmax)
        occ_b = isect_mod.intersect_p(with_bvh, o, d, tmax)
        occ_f = isect_mod.intersect_p(brute, o, d, tmax)
        torch.cuda.synchronize()
        n_prim = int((h_b.prim_id != h_f.prim_id).sum())
        print(f"BVH vs brute force (2,188 primitives) {rname}: valid equal "
              f"{torch.equal(h_b.valid, h_f.valid)}, t equal "
              f"{torch.equal(h_b.t, h_f.t)}, {n_prim} prim ties of "
              f"{o.shape[0]}, any-hit equal {torch.equal(occ_b, occ_f)}")
        check(torch.equal(h_b.valid, h_f.valid), "valid differs")
        check(torch.equal(h_b.t, h_f.t), "t differs")
        check(n_prim <= 1e-3 * o.shape[0], f"{n_prim} prim mismatches")
        check(torch.equal(occ_b, occ_f), "any-hit differs")


def check_brute_under_bvh(scene, rname, o, d, tmax, reps=0):
    """The brute-force kernel against its twin at the call shape a scene
    with a BVH gives it (scene/bvh.py::intersect_bvh): tables without
    triangles, n_tri = 0, the scene's spheres and aaplanes, and as tmax
    the per-ray closest triangle hit that the traversal kernel returned.
    prim equal on every ray and t equal bit for bit. Returns
    {err, ms, plain_ms} (times only with ``reps``)."""
    tabs = ik.pack_scene(scene, tris=False)
    counts = (0, scene.n_sph, scene.n_pln)
    best_t, leaf = bk.bvh_traverse(scene.bvh, o, d,
                                   torch.clamp_max(tmax, bk.BIG), False)

    def kern_fn():
        return ik.intersect_brute(*tabs, o, d, best_t, *counts)

    def twin_fn():
        return ik._intersect_reference(*tabs, o, d, best_t, *counts)

    t, prim = kern_fn()
    torch.cuda.synchronize()
    t_ref, prim_ref = twin_fn()
    n_prim = int((prim != prim_ref).sum())
    err = float((t - t_ref).abs().max())
    nearer = float((prim >= 0).float().mean())
    print(f"intersect kernel vs twin under the BVH {counts} {rname} "
          f"({o.shape[0]} rays, tmax = the traversal's t, finite on "
          f"{float((leaf >= 0).float().mean()):.3f} of them): {n_prim} prim "
          f"mismatches, t max err {err:.3g}, a sphere or aaplane is nearer "
          f"on {nearer:.3f}")
    check(prim.dtype == torch.int32 and t.dtype == torch.float32,
          "output types")
    check(n_prim == 0, f"{n_prim} prim mismatches")
    check(torch.equal(t, t_ref), f"t differs from the twin by {err}")
    check(torch.equal(t[prim < 0], best_t[prim < 0]),
          "a ray with no nearer sphere or aaplane lost the traversal's t")
    check(bool((t[prim >= 0] < best_t[prim >= 0]).all()), "t not below tmax")
    check(0.0 < nearer < 1.0, f"share with a nearer sphere or aaplane "
          f"{nearer}")
    out = {"err": err}
    if reps:
        out["ms"] = sync_ms(kern_fn, reps)
        out["plain_ms"] = sync_ms(twin_fn, 2)
    return out


def shadow_rays(o, dev):
    """Shadow rays as next-event estimation sends them: from the origins
    ``o`` to seeded uniform points on the heightfield cornell's light (the
    aaplane y = 0.99, x in [0.3, 0.7], z in [0.35, 0.65]), tmax just short
    of the light."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    u = torch.rand(o.shape[0], 2, generator=gen).to(dev)
    target = torch.stack([0.3 + 0.4 * u[:, 0], torch.full_like(u[:, 0], 0.99),
                          0.35 + 0.3 * u[:, 1]], dim=-1)
    w = target - o
    dist = w.norm(dim=-1)
    return (w / dist[:, None]).contiguous(), (dist * (1.0 - 1e-3)).contiguous()


def bounce_rays(scene, o, d, dev):
    """Rays as a path's second bounce sends them: from the camera rays'
    hit points (offset along the normal), in seeded random directions of
    the normal's hemisphere. Lanes that missed keep their camera ray."""
    inf = torch.full((o.shape[0],), math.inf, device=dev)
    hit = isect_mod.intersect(scene, o, d, inf)
    gen = torch.Generator(device="cpu").manual_seed(3)
    w = torch.nn.functional.normalize(
        torch.randn(o.shape[0], 3, generator=gen), dim=-1).to(dev)
    n = torch.where((hit.ng * d).sum(-1, keepdim=True) > 0, -hit.ng, hit.ng)
    w = torch.where((w * n).sum(-1, keepdim=True) < 0, -w, w)
    o2 = torch.where(hit.valid[:, None], hit.p + 1e-3 * n, o)
    d2 = torch.where(hit.valid[:, None], w, d)
    return o2.contiguous(), d2.contiguous()


def traverse_bound(bvh, n_rays, stats):
    """Each ray read once (28 B) and written once (8 B), the packed tree
    once; the slab and triangle tests this run's rays needed (counted by
    the twin on the same rays)."""
    n_bytes = 36 * n_rays + 4 * (bvh.pk_nodes.numel() + bvh.pk_tris.numel())
    n_ops = OPS_SLAB * stats["slab_tests"] + OPS_TRI * stats["tri_tests"]
    return bound_ms(n_bytes, n_ops)


def kernel_share_of_pass(pass_fn):
    """Device time by kernel over one pass, from torch.profiler: (total
    ms, {kernel-name fragment: ms})."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pass_fn()
        torch.cuda.synchronize()
    total, by_name = 0.0, {"bvh_traverse_kernel": 0.0, "intersect_kernel": 0.0}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        total += us / 1e3
        for frag in by_name:
            if frag in evt.key:
                by_name[frag] += us / 1e3
    return total, by_name


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load_all()
    print(f"kernel and host-builder builds (in parallel) "
          f"{ {k: round(v, 1) for k, v in _build.load.build_seconds.items()} }"
          f" s (wall {time.perf_counter() - t0:.1f} s)")
    for name in _build.KERNELS:
        print(_build.load.ptxas_log.get(name, "").strip()[-1500:])

    # ---- 2. kernel vs twin on the card
    scenes = {"portal": entry._portal_scene(dev),
              "cornell_mode0": entry._plain_cornell(dev),
              "tessellated_portal_940": entry._tessellated_portal(22, dev)}
    check(scenes["tessellated_portal_940"].n_tri == 940, "940-tri scene")
    before = fp.fused_bounce.launches
    for name, scene in scenes.items():
        for md in (4, 6):
            check_kernel(name, scene, md, dev)
    check(fp.fused_bounce.launches > before, "the kernel was not launched")

    # ---- 3. the main path at full width
    scene, cam = entry._portal_scene(), entry._camera((W, H))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    bk.bvh_traverse.launches = 0
    t0 = time.perf_counter()
    img = render_mod.render(scene, cam, spp=SPP, integrator="path",
                            max_depth=MAX_DEPTH, chunk_spp=CHUNK,
                            device="cuda")
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = fp.fused_bounce.launches
    check(launches == SPP // CHUNK, f"{launches} kernel launches")
    check(ik.intersect_brute.launches == 0 and bk.bvh_traverse.launches == 0,
          "the main path launched an intersection kernel")
    check(img.shape == (H, W, 3) and img.device.type == "cuda",
          f"image {tuple(img.shape)} on {img.device}")
    check(bool(torch.isfinite(img).all()), "non-finite image")
    mean = float(img.mean())
    rel = abs(mean - REF_IMAGE_MEAN) / REF_IMAGE_MEAN
    print(f"main path: image mean {mean!r} vs {REF_IMAGE_MEAN!r} "
          f"(rel {rel:.3g}; TPU bench figure {TPU_IMAGE_MEAN!r}), "
          f"{launches} launches, first call {t_first:.3f} s")
    check(rel < 1e-3, f"image mean off by rel {rel}")
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20

    # ---- 4. timings (CUDA events, after warm-up)
    scene_d = entry._portal_scene(dev)
    cam_d = entry._camera((W, H), dev)
    filt = film_mod.make_filter("box", device=dev)
    cfg = render_mod.RenderConfig(max_depth=MAX_DEPTH)
    tables, kw = bounce_args(scene_d, MAX_DEPTH)
    rays = lanes(W, CHUNK, dev)

    def cam_fn():
        return render_mod.camera_rays(cam_d, filt, cfg, W, H, CHUNK, 0, dev)

    res_k = fp.fused_bounce(*tables, *rays, **kw)

    def kern_fn():
        return fp.fused_bounce(*tables, *rays, **kw)

    def replay_fn():
        return replay_of(scene_d, res_k)

    def twin_fn():
        return fp._kernel_reference(*tables, *rays, **kw)

    def pass_fn():
        return render_mod.render_pass(scene_d, cam_d, filt, cfg, W, H,
                                      CHUNK, 0, dev)

    def render_fn():
        return render_mod.render(scene_d, cam_d, spp=SPP, max_depth=MAX_DEPTH,
                                 chunk_spp=CHUNK, device=dev)

    for fn in (cam_fn, kern_fn, replay_fn, pass_fn, render_fn):
        fn()
    ms = {"camera_rays": sync_ms(cam_fn, 5), "kernel": sync_ms(kern_fn, 5),
          "replay": sync_ms(replay_fn, 5), "pass_32spp": sync_ms(pass_fn, 5),
          "render_64spp": sync_ms(render_fn, 3)}
    res_t = twin_fn()
    ms["twin"] = sync_ms(twin_fn, 2)
    ms["kernel_again"] = sync_ms(kern_fn, 5)

    # the kernel against the twin at the main path's own shape
    L_k, L_t = replay_of(scene_d, res_k), replay_of(scene_d, res_t)
    max_err = float((L_k - L_t).abs().max())
    bad = (L_k - L_t).abs().amax(-1) > 1e-4
    print(f"main-path chunk ({rays[0].shape[0]} rays): L max err "
          f"{max_err:.3g}, lanes over 1e-4: {int(bad.sum())}")
    check(float(bad.float().mean()) < 6e-3, f"{int(bad.sum())} lanes")
    torch.testing.assert_close(L_k[~bad], L_t[~bad], atol=1.1e-4, rtol=0)

    sweeps = (MAX_DEPTH + 1) + MAX_DEPTH          # mode 1: bench.py:173
    mrays = W * H * SPP * sweeps / (ms["render_64spp"] / 1e3) / 1e6
    timing = {k: round(v, 4) for k, v in ms.items()}
    print("times (ms, CUDA events): " + json.dumps(timing))
    print(f"forward Mrays/s (sweeps/sample {sweeps}, forward only): "
          f"{mrays:.1f}; peak memory of the main-path render "
          f"{peak_mb:.1f} MiB")

    check(math.isfinite(mrays), f"rate {mrays}")
    fused_bound_ms, fused_bound_by = fused_bound(scene_d, res_k[0],
                                                 MAX_DEPTH + 1)

    # ---- 5. the intersection kernel vs its twin on three tables
    loop_scenes = {"portal_portal": entry._portal_scene(dev, "portal"),
                   "sphere_cornell": entry._sphere_cornell(dev)}
    tables = dict(loop_scenes, cap_table=cap_table(dev))
    check(tables["cap_table"].n_prims == 4001, "the 4,001-primitive table")
    for name, sc in tables.items():
        check_intersect(name, sc, dev)

    # ---- 6. the generic loop against the fused kernel
    for name in ("portal", "cornell_mode0"):
        for md in (4, 6):
            check_loop_vs_fused(name, scenes[name], md, dev)

    # ---- 7. the generic loop's path at full width, through render
    # launches per pass: per full bounce one closest hit, one NEE trace
    # and, where a light without portals exists, one BSDF-half trace;
    # then the emission-only last bounce's closest hit
    per_pass = {"portal_portal": MAX_DEPTH * 2 + 1,
                "sphere_cornell": MAX_DEPTH * 3 + 1}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    bk.bvh_traverse.launches = 0
    for key, sc in (("portal_portal", entry._portal_scene(strategy="portal")),
                    ("sphere_cornell", entry._sphere_cornell())):
        render_loop(key, sc, "path", W, SPP, per_pass[key] * (SPP // CHUNK))
    loop_launches = ik.intersect_brute.launches
    check(fp.fused_bounce.launches == 0 and bk.bvh_traverse.launches == 0,
          "fused or traversal launches on the small scenes' loop path")
    loop_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    # one pass each: direct and whitted end after the first bounce (no
    # ported material has a specular lobe), ao traces a hit and a probe,
    # mypath has no BSDF half
    for integ, want in (("direct", 3), ("whitted", 3), ("ao", 2),
                        ("mypath", MAX_DEPTH * 2 + 1)):
        render_loop("sphere_cornell", loop_scenes["sphere_cornell"], integ,
                    64, 4, want)

    # ---- 8. timings of the intersection kernel and the generic loop
    o_m, d_m, _, _ = rays
    inf_m = torch.full((o_m.shape[0],), math.inf, device=dev)
    ims, ibound = {}, {}
    for name, sc in tables.items():
        tabs = ik.pack_scene(sc)
        counts = (sc.n_tri, sc.n_sph, sc.n_pln)

        def ikern_fn():
            return ik.intersect_brute(*tabs, o_m, d_m, inf_m, *counts)

        def itwin_fn():
            return ik._intersect_reference(*tabs, o_m, d_m, inf_m, *counts)

        got = ikern_fn()
        ims[f"kernel_{name}"] = sync_ms(ikern_fn, 5)
        ibound[name] = intersect_bound(sc, o_m.shape[0])
        if name == "cap_table":
            continue    # its twin is ~180,000 launches on 8 MB tensors
        want = itwin_fn()
        ims[f"twin_{name}"] = sync_ms(itwin_fn, 2)
        ims[f"kernel_again_{name}"] = sync_ms(ikern_fn, 5)
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"kernel differs from the twin at {o_m.shape[0]} rays")
        if name == "sphere_cornell":
            intersect_err = float((got[0] - want[0]).abs().max())
    for key, sc in loop_scenes.items():
        cfg_l = render_mod.RenderConfig(max_depth=MAX_DEPTH)

        def lpass_fn():
            return render_mod.render_pass(sc, cam_d, filt, cfg_l, W, H, CHUNK,
                                          0, dev)

        def lrender_fn():
            return render_mod.render(sc, cam_d, spp=SPP, max_depth=MAX_DEPTH,
                                     chunk_spp=CHUNK, device=dev)

        lpass_fn()
        ims[f"pass_32spp_{key}"] = sync_ms(lpass_fn, 3)
        ims[f"render_64spp_{key}"] = sync_ms(lrender_fn, 2)
    print("intersect and generic-loop times (ms, CUDA events, "
          f"{o_m.shape[0]} rays per launch): "
          + json.dumps({k: round(v, 4) for k, v in ims.items()}))
    print("intersect bounds (ms, by): " + json.dumps(
        {k: [round(v[0], 5), v[1]] for k, v in ibound.items()}))
    print(f"peak memory of the generic loop's 64-spp renders "
          f"{loop_peak_mb:.1f} MiB")

    # ---- 9. the BVH traversal kernel vs its twin, and BVH vs brute force
    t0 = time.perf_counter()
    hf = entry._heightfield_cornell(dev)
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    rebuilt = bvh_mod.build_bvh(hf)
    t_tree = time.perf_counter() - t0
    check(hf.n_tri == 133130 and hf.n_sph == 1 and hf.n_pln == 1,
          f"heightfield cornell has {hf.n_tri} triangles")
    check(hf.bvh.built_by == "native-sbvh" == rebuilt.built_by,
          f"the tree was built by {hf.bvh.built_by}, not the native builder")
    check(torch.equal(rebuilt.pk_nodes, hf.bvh.pk_nodes), "rebuild differs")
    check(hf.fused_profile is None, "the BVH scene is in the fused profile")
    print(f"heightfield cornell: {hf.n_tri} triangles, {hf.bvh.lo.shape[0]} "
          f"nodes, {hf.bvh.prim_order.shape[0]} leaf triangles, stack need "
          f"{hf.bvh.stack_need} of {bk.STACK}; scene build {t_scene:.2f} s, "
          f"of it tree build + pack {t_tree:.2f} s ({hf.bvh.built_by})")
    hl = heightfield_scene(dev, 48, split="hlbvh")
    check(hl.bvh.built_by == "numpy-hlbvh" and hl.n_tri == 7498, "hlbvh tree")
    trees = {"soup_600": soup_scene(dev).bvh, "heightfield_cornell": hf.bvh,
             "hlbvh_7498": hl.bvh}
    before = bk.bvh_traverse.launches
    for name, tree in trees.items():
        check_traverse(name, tree, dev)
    check(bk.bvh_traverse.launches == before + 18, "traversal launches")
    check_bvh_vs_brute(dev)
    for rname, (o, d, tmax) in ray_sets(dev).items():
        check_brute_under_bvh(hf, rname, o, d, tmax)

    # ---- 10. the BVH slice at full width, through render
    per_pass_bvh = MAX_DEPTH * 3 + 1     # as the sphere cornell: 13 queries
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    bk.bvh_traverse.launches = 0
    t0 = time.perf_counter()
    img = render_mod.render(entry._heightfield_cornell(), entry._camera((W, H)),
                            spp=SPP, integrator="path", max_depth=MAX_DEPTH,
                            chunk_spp=CHUNK, device="cuda")
    torch.cuda.synchronize()
    t_bvh_first = time.perf_counter() - t0
    bvh_launches = bk.bvh_traverse.launches
    bvh_brute_launches = ik.intersect_brute.launches
    bvh_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    mean_full = float(img.double().mean())
    print(f"BVH slice heightfield_cornell path {W}² × {SPP} spp: mean "
          f"{mean_full!r}, {bvh_launches} traversal launches, "
          f"{bvh_brute_launches} brute-force launches, "
          f"{fp.fused_bounce.launches} fused launches, scene build + render "
          f"{t_bvh_first:.2f} s, peak memory {bvh_peak_mb:.1f} MiB")
    check(img.shape == (H, W, 3) and img.device.type == "cuda",
          f"image {tuple(img.shape)} on {img.device}")
    check(bool(torch.isfinite(img).all()), "non-finite image")
    check(mean_full > 0.05, "the scene does not light up")
    want = per_pass_bvh * (SPP // CHUNK)
    check(bvh_launches == want and bvh_brute_launches == want,
          f"{bvh_launches} traversal and {bvh_brute_launches} brute-force "
          f"launches, the loop implies {want} each")
    check(fp.fused_bounce.launches == 0, "fused launches on the BVH path")
    key = ("heightfield_cornell", "path", 64, 4)
    img_s = render_mod.render(hf, entry._camera((64, 64)), spp=4,
                              integrator="path", max_depth=MAX_DEPTH,
                              chunk_spp=CHUNK, device="cuda")
    mean_s = float(img_s.double().mean())
    rel = abs(mean_s - REF_BVH_MEAN[key]) / REF_BVH_MEAN[key]
    print(f"BVH slice heightfield_cornell path 64² × 4 spp: mean {mean_s!r} "
          f"vs pbrt_tpu {REF_BVH_MEAN[key]!r} (rel {rel:.3g}); the 256² × 64 "
          f"spp mean differs from it by rel "
          f"{abs(mean_full - mean_s) / mean_s:.3g}")
    check(rel < 1e-3, f"image mean off by rel {rel}")

    # ---- 11. timings of the traversal kernel and the BVH pass
    tree = hf.bvh
    n_m = o_m.shape[0]
    o_b, d_b = bounce_rays(hf, o_m, d_m, dev)
    d_sh, tmax_sh = shadow_rays(o_b, dev)
    tms, tstats, under = {}, {}, {}
    for rname, (o_r, d_r, tmax_r) in (("camera", (o_m, d_m, inf_m)),
                                      ("bounce", (o_b, d_b, inf_m)),
                                      ("shadow", (o_b, d_sh, tmax_sh))):
        perm = bvh_mod._ray_sort_order(o_r, d_r)
        o_s, d_s, tmax_s = (x[perm].contiguous() for x in (o_r, d_r, tmax_r))

        def sort_fn():
            p = bvh_mod._ray_sort_order(o_r, d_r)
            return o_r[p], d_r[p], tmax_r[p]

        sort_fn()
        tms[f"sort_{rname}"] = sync_ms(sort_fn, 3)
        for order, (oo, dd, tt) in (("unsorted", (o_r, d_r, tmax_r)),
                                    ("sorted", (o_s, d_s, tmax_s))):
            for mode, any_hit in (("closest", False), ("any", True)):
                def tk_fn():
                    return bk.bvh_traverse(tree, oo, dd, tt, any_hit)

                tk_fn()
                tms[f"kernel_{mode}_{rname}_{order}"] = sync_ms(tk_fn, 5)
        # the twin, on every lane for the camera rays (in the ray sort's
        # order, as the render hands them over) and on every 16th lane for
        # the bounce and shadow rays; shadow rays as the any-hit query
        step = 1 if rname == "camera" else 16
        any_hit = rname == "shadow"
        o_t, d_t, tmax_t = (x[::step].contiguous()
                            for x in (o_s, d_s, tmax_s))
        got = bk.bvh_traverse(tree, o_t, d_t, tmax_t, any_hit)
        torch.cuda.synchronize()
        stats = {}
        t0 = time.perf_counter()
        want = bk._traverse_reference(tree, o_t, d_t, tmax_t, any_hit,
                                      stats=stats)
        torch.cuda.synchronize()
        mode = "any" if any_hit else "closest"
        tms[f"twin_{mode}_{rname}_{o_t.shape[0]}_lanes"] = \
            1e3 * (time.perf_counter() - t0)
        check(torch.equal(got[1] >= 0, want[1] >= 0)
              and (any_hit or (torch.equal(got[1], want[1])
                               and torch.equal(got[0], want[0]))),
              f"traversal kernel differs from the twin at {o_t.shape[0]} "
              f"{rname} rays")
        tstats[rname] = {k: v * step for k, v in stats.items()}
        if rname == "camera":
            traverse_err = float((got[0] - want[0]).abs().max())
            twin_ms = tms[f"twin_closest_camera_{n_m}_lanes"]
        if rname != "shadow":
            # the brute-force kernel as the BVH path calls it on these rays
            under[rname] = check_brute_under_bvh(hf, rname, o_r, d_r, tmax_r,
                                                 reps=5)
    under_bound = intersect_bound(hf, n_m, tris=False)
    tbound = {r: traverse_bound(tree, n_m, st) for r, st in tstats.items()}
    cfg_b = render_mod.RenderConfig(max_depth=MAX_DEPTH)

    def bpass_fn():
        return render_mod.render_pass(hf, cam_d, filt, cfg_b, W, H, CHUNK, 0,
                                      dev)

    def brender_fn():
        return render_mod.render(hf, cam_d, spp=SPP, max_depth=MAX_DEPTH,
                                 chunk_spp=CHUNK, device=dev)

    bpass_fn()
    tms["pass_32spp_heightfield_cornell"] = sync_ms(bpass_fn, 3)
    tms["render_64spp_heightfield_cornell"] = sync_ms(brender_fn, 2)
    dev_ms, by_kernel = kernel_share_of_pass(bpass_fn)
    print(f"traversal and BVH-pass times (ms, CUDA events; twin: host clock "
          f"around one run; {n_m} rays per launch, {tree.lo.shape[0]} nodes): "
          + json.dumps({k: round(v, 4) for k, v in tms.items()}))
    print("traversal tests per launch (counted by the twin; bounce rays: "
          "every 16th lane, scaled): " + json.dumps(tstats))
    print("traversal bounds (ms, by): " + json.dumps(
        {k: [round(v[0], 5), v[1]] for k, v in tbound.items()}))
    print(f"intersect kernel under the BVH (0 triangles, {hf.n_sph} sphere, "
          f"{hf.n_pln} aaplane; {n_m} rays per launch; ms, CUDA events): "
          + json.dumps({k: {m: round(v[m], 4) for m in ("ms", "plain_ms")}
                        for k, v in under.items()})
          + f", bound {under_bound[0]:.5f} ms by {under_bound[1]}")
    print(f"one 32-spp BVH pass under torch.profiler: device time "
          f"{dev_ms:.3f} ms, of it " + json.dumps(
              {k: round(v, 4) for k, v in by_kernel.items()}))
    check(dev_ms > 0.0 and by_kernel["bvh_traverse_kernel"] > 0.0,
          "the profiler saw no traversal kernel in the pass")

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "fused_path", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/fused_path.cu",
        "replaces": "pbrt_tpu/ops/fused_path.py:107",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms["kernel"], "plain_ms": ms["twin"],
        "bound_ms": fused_bound_ms, "bound_by": fused_bound_by,
        "library_ms": None}, {
        "name": "intersect", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/intersect.cu",
        "replaces": "pbrt_tpu/ops/intersect_pallas.py:34",
        "launches": loop_launches, "max_abs_err": intersect_err,
        "ms": ims["kernel_sphere_cornell"],
        "plain_ms": ims["twin_sphere_cornell"],
        "bound_ms": ibound["sphere_cornell"][0],
        "bound_by": ibound["sphere_cornell"][1], "library_ms": None,
        # the same kernel at the BVH path's call shape (no triangles, one
        # sphere, one aaplane, tmax from the traversal; bounce rays)
        "bvh_path": {"launches": bvh_brute_launches,
                     "max_abs_err": under["bounce"]["err"],
                     "ms": under["bounce"]["ms"],
                     "plain_ms": under["bounce"]["plain_ms"],
                     "bound_ms": under_bound[0],
                     "bound_by": under_bound[1]}}, {
        "name": "bvh_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": "pbrt_tpu/ops/bvh_pallas.py:98",
        "launches": bvh_launches, "max_abs_err": traverse_err,
        "ms": tms["kernel_closest_camera_sorted"], "plain_ms": twin_ms,
        "bound_ms": tbound["camera"][0], "bound_by": tbound["camera"][1],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
