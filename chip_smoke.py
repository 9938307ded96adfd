"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Builds the six kernels (csrc/fused_path.cu, csrc/intersect.cu,
   csrc/bvh_traverse.cu, csrc/bvh_binary.cu, csrc/kexp_traverse.cu,
   csrc/smem_probe.cu) with nvcc and the host BVH builder
   (csrc/bvh_builder.cpp) with g++, all at once, into build/kernels/ and
   prints the card, its power limit, the build times and, from ptxas, the
   registers and spills of every instantiation of the fused, the
   brute-force and the wide-BVH experiment kernel (which must not spill).
2. Holds the kernel against its plain-torch twin on the card on three
   scenes built by the port (portal mode 1 flat, mode-0 cornell, 940-tri
   clustered portal), at 64² × 2 spp, max_depth 4 and 6; checks that the
   cluster-culled sweep equals the flat sweep bit for bit.
3. Renders the main path, ``render(_portal_scene(), _camera((256, 256)),
   spp=64, max_depth=4, chunk_spp=32, device="cuda")``, checks that it
   launched the kernel once per chunk and that the image mean matches
   pbrt_tpu's on the same sample streams to rel 1e-3.
4. Times one 32-spp chunk (camera rays / kernel / replay), the 64-spp
   render and the twin, with CUDA events; and, from the residuals, the
   sweeps of live paths and the sweeps that warps of 32 and of 64 paths
   execute, per bounce, with the share that falls on ended paths.
5. Holds the brute-force intersection kernel against its plain-torch twin
   on three primitive tables (the portal scene, the sphere cornell, a
   4,001-primitive table near the 4,096 cap that spans several
   shared-memory tiles), for camera rays and for random rays with infinite
   and finite tmax: prim equal and t bit-equal, for every design
   (INTERSECT_DESIGNS: neither step, two rays per thread, the early
   reject, both) at R, at R not a multiple of 64 and at R < 64.
6. Holds the generic wavefront loop against the fused kernel on the two
   scenes inside the fused profile (same lanes, seam allowance of
   tests/test_fused_path.py:258-261).
7. Renders the generic loop's path at full width through ``render``:
   ``_portal_scene(strategy="portal")`` and ``_sphere_cornell()``, 256² ×
   64 spp, and `direct`, `whitted`, `ao`, `mypath` at 64²; checks the
   launch counts the loop implies, that the fused kernel is not launched,
   and pbrt_tpu's image means to rel 1e-3.
8. Times the intersection kernel and its twin on 2,097,152-ray launches,
   its designs in turns on the three tables for camera rays and for random
   rays from inside the box, the new scenes' passes and renders, and by
   torch.profiler the kernel's device time inside a pass for each design.
9. Holds the BVH traversal kernels against their plain-torch twins on
   three trees (a 600-triangle soup, the 133,130-triangle heightfield
   cornell built by the native SBVH builder, a 7,498-triangle tree built
   with `hlbvh`), for camera rays and random rays with infinite and finite
   tmax: the 4-wide kernel (csrc/bvh_traverse.cu) on its plain grid, its
   persistent grid and under the harness's L2 window, closest hit and
   any-hit, index and t bit-equal, count mode's step codes equal; the
   binary kernel (csrc/bvh_binary.cu) index and t bit-equal, any-hit masks
   equal, its count mode's pops equal to the twin's slab tests; for both,
   the any-hit mask equal to the closest hit's and more than 5% of the rays
   hitting; against each other t bit-equal and the triangle equal through
   ``prim_order`` but for exact ties. Then a scene of 2,188 primitives built with and without a BVH
   through ``intersect`` (valid and t equal, prim equal but for exact ties
   in t), and the brute-force kernel against its twin at the call shape a
   BVH scene gives it (no triangles, the scene's one sphere and one
   aaplane, tmax the traversal's closest hit): prim equal and t bit-equal.
10. Renders the BVH slice at full width through ``render``:
   ``_heightfield_cornell()``, 256² × 64 spp, `path`; checks the launch
   counts the loop implies (13 of the 4-wide kernel and of the brute-force
   kernel per pass), that no ray sort ran and neither the binary nor the
   fused kernel was launched, and, at 64² × 4 spp, pbrt_tpu's image mean
   to rel 1e-3 (pbrt_tpu's CPU traversal is too slow for the full size).
11. Times 2,097,152-ray closest-hit and any-hit launches on the big tree
   (camera rays, bounce rays and shadow rays with finite tmax): the binary
   kernel and the 4-wide kernel's plain and persistent grids in turns, in
   the callers' order, the binary kernel in the ray sort's order, and the
   sort; the twins (whose test counts give the bounds); the brute-force
   kernel, its designs in turns and its twin at the BVH path's shape
   (camera and bounce rays), and its device time inside a pass for each
   design; the 32-spp pass and the
   64-spp render against the path before the 4-wide kernel (sort + binary
   kernel), in turns; and, by torch.profiler, the 4-wide kernel's device
   time per launch inside a pass for both grids with the harness's L2
   window on and off, and the old path's device time by kernel.
12. Probes the shared memory a launch gets (csrc/smem_probe.cu): 48, 100,
   164 and 227 KB are granted and the result equals the plain version,
   228 KB raises; checks that repeated launches at one size set no
   attribute; times the probe and torch.add, the library call that
   computes the same function, by CUDA events around back-to-back calls
   and by the profiler's device time per launch.
13. Holds the wide-BVH experiment kernel (csrc/kexp_traverse.cu) against
   its plain-torch twin on the three trees of phase 9 × the three ray sets
   × {variant 1, 2, 3 on wide 4 / leaf 16, variant 2 on wide 8 / leaf 8,
   variant 5 on the dual-leaf layout} × {closest, any-hit}: index equal
   and t bit-equal; count mode's step codes equal; staging none or as many
   nodes as fit in shared memory (1,816 wide-4 records of the heightfield
   tree) gives identical results; against the binary kernel valid and t
   equal, index equal but for ties. Once more at 2,097,152 camera rays, where
   kernel and twin are timed and the twin's counts give the bound.
14. Drives the kernel-experiment harness at full width through
   pbrt_tpu_torch.tools.kexp_prep and kexp_run: the 133,130-triangle
   heightfield tree and a 100,000-triangle irregular soup, 2,097,152 rays
   per set (primary, random, sorted random, bounce, shadow), experiments
   `binary`, `baseline`, `grid plain|persistent` (in turns), `variant
   1|2|3` (1 and 2 also with 256 nodes staged, 2 with as many as fit),
   `pack` 4 8 and 4 4, `count`, `smem_probe`, and the warp efficiency of
   the 4-wide and the binary kernel from count mode; prints the matrix in
   ms (with the threads per block each staged launch chose), the steps per
   ray and the agreement with the binary twin, and checks that each kernel
   was launched exactly as often as the experiments imply.
15. Scene files. (a) Runs the CLI, ``python -m pbrt_tpu_torch.utils.cli``,
   as a subprocess on tests/oracle/{ao,deltalights,filter}_oracle.pbrt,
   scenes/cornell_portal.pbrt and the zoo's oracle files
   tests/oracle/{whitted,caustic,disney,envcavity,envcam}_oracle.pbrt
   (mirror, glass, Disney, the infinite light, the environment camera) at
   their own resolution, spp, sampler (halton), integrator and filter,
   each writing a PFM into a temporary directory; reads it back, prints
   the parse / build / render (by CUDA events) / write times and the
   kernel launches the CLI reports, checks the launches the loop implies
   and holds each oracle image to the reference binary's *_ref.pfm with
   tests/test_oracle.py's limits on the mean delta and the block relative
   L1. (b) Renders the three oracle files in-process (``load_pbrt`` +
   ``render``) at 16 spp, halton, seed 0, and the zoo's five at 8 spp in
   one pass under torch.profiler (device time in all and in the
   brute-force kernel, and its launches), and holds each image mean to
   pbrt_tpu's (REF_FILE_MEANS, REF_ZOO_MEANS) to rel 1e-3. (c)
   Parses the demo file and renders it with the independent sampler at the
   main path's settings (256² × 64 spp, chunk 32, max_depth 4): two fused
   launches, the mean within rel 1e-3 of REF_IMAGE_MEAN. (d) Writes a scene
   file of phase 10's heightfield cornell (a 256×256 ``heightfield`` under
   a y↔z transform, the cone as a ``trianglemesh`` with its normals, a
   sphere, the area light on an ``aaplane``) and renders it through the CLI
   at 256² × 64 spp: more than 256 triangles, so a BVH; 26 launches each of
   the traversal and the brute-force kernel; its mean equal to phase 10's
   render of ``_heightfield_cornell()`` to rel 1e-3. (e) Renders a small
   scene of disks (intersected outside the kernels) with `path` and `ao`
   on the card and on the CPU twins: means to rel 1e-4.
16. Hero-wavelength spectral rendering (60-bin spectra) of
   tests/oracle/cornell_dielectric_oracle.pbrt (96², 128 spp, halton,
   gaussian filter, maxdepth 5, 32 triangles: every ray on the
   brute-force kernel). (a) The CLI as a subprocess with the file's
   ``hero_path_mis`` and with ``--integrator hero_path``: one pass each,
   11 and 6 brute-force launches (a closest hit per bounce, a shadow ray
   per bounce but the last), each image against cornell_dielectric_ref.pfm
   with tests/test_oracle.py's limits (md < 0.05 and block rel-L1 < 0.20;
   md < 0.012). (b) In process, the file at 128 spp with
   ``hero_path_mis``: every brute-force launch of the pass recorded and
   its (t, prim) held against the twin on the same rays, bit for bit;
   then the render timed by CUDA events with its launches (counts set to
   0 just before) and peak memory, and once more under torch.profiler
   (device time, the brute-force kernel's share); the film's
   spectrum_to_rgb against a float64 product. (c) Both integrators at 8
   spp against pbrt_tpu's image means (REF_HERO_MEANS) to rel 1e-4.
   Then prints a JSON line of the kernels (with each kernel's roofline
   bound computed from this run's inputs, the scene files' numbers
   under "scene_files" and the hero phase's under "hero") and {"ok": true,
   "device": {...}} as the last line.

Any failed check raises, so the script exits non-zero and prints no
result. It needs a CUDA device and never falls back to the CPU.
"""

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pbrt_tpu_torch import entry
from pbrt_tpu_torch.frontend import load_pbrt
from pbrt_tpu_torch.integrators import render as render_mod
from pbrt_tpu_torch.ops import _build
from pbrt_tpu_torch.ops import bvh as bk
from pbrt_tpu_torch.ops import bvh_binary as bb
from pbrt_tpu_torch.ops import fused_path as fp
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import bvh as bvh_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene.types import SceneBuilder
from pbrt_tpu_torch.tools import kexp_kernels as kk
from pbrt_tpu_torch.tools import kexp_prep, kexp_run
from pbrt_tpu_torch.utils import imageio

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
# pbrt_tpu's float32 image means on the CPU backend for three scene files
# at their own resolution, integrator, max depth and filter, 16 spp, the
# halton sampler, seed 0, printed by ``PYTHONPATH=. python
# tests/test_torch_oracle.py``.
REF_FILE_MEANS = {"ao": 1.4939268395117122,
                  "deltalights": 0.44327428357883036,
                  "filter": 0.04002022001221612}
# pbrt_tpu's float32 image means on the CPU backend for the zoo's five
# oracle files at their own resolution, integrator and max depth, 8 spp,
# the halton sampler, seed 0, with the port's one deviation from it (a
# microfacet reflection under the surface, ROADMAP queue 3) patched in,
# printed by ``PYTHONPATH=. python tests/test_torch_zoo_oracle.py``.
ZOO_MEAN_SPP = 8
REF_ZOO_MEANS = {"caustic": 0.043504613591096586,
                 "disney": 0.24653613609634248,
                 "envcam": 0.08074431071022066,
                 "envcavity": 0.43414789720059666,
                 "whitted": 0.06863066850038464}
# pbrt_tpu's float32 image means (RGB, after spectrum_to_rgb) on the CPU
# backend of cornell_dielectric_oracle.pbrt built with 60-bin spectra, at
# its own resolution, max depth and filter, 8 spp, the halton sampler,
# seed 0, printed by ``PYTHONPATH=. python tests/test_torch_hero.py``.
HERO_MEAN_SPP = 8
REF_HERO_MEANS = {"hero_path_mis": 0.3784221561585667,
                  "hero_path": 0.3784904484525031}
# The hero phase: the file, and per integrator the CLI's extra arguments,
# its brute-force launches per pass (a closest hit on each of the
# max_depth + 1 bounces and, with next event estimation, a shadow ray on
# each but the last; 96² × 128 spp is one pass of 1,179,648 lanes) and
# tests/test_oracle.py's limits (mean delta, block rel-L1 or None).
HERO_FILE = "tests/oracle/cornell_dielectric_oracle.pbrt"
HERO_REF = "tests/oracle/cornell_dielectric_ref.pfm"
HERO_RUNS = {"hero_path_mis": ([], 6 + 5, 0.05, 0.20),
             "hero_path": (["--integrator", "hero_path"], 6, 0.012, None)}
# The scene-file phase: (file, the CLI's expected launches of the
# brute-force kernel as (queries per pass, passes), the reference binary's
# image with tests/test_oracle.py's limits for the file as (image,
# mean-delta limit, block rel-L1 limit or None, block size), or None where
# there is no reference image). Per pass, ao traces a closest hit and a
# probe; path traces per full bounce a closest hit, the NEE ray and, with
# an area light without portals or an infinite light, the BSDF half's
# ray, then the emission-only last bounce's closest hit; whitted traces a
# closest hit and the NEE ray per full bounce, and runs all max_depth + 1
# bounces where a row has a delta lobe. The CLI's passes hold at most
# 2^21 lanes: 2,097,152 // (width × height) spp each.
SCENE_FILES = {
    "ao": ("tests/oracle/ao_oracle.pbrt", (2, 1),
           ("ao_ref.pfm", 0.01, 0.05, 16)),
    "deltalights": ("tests/oracle/deltalights_oracle.pbrt", (4 * 2 + 1, 2),
                    ("deltalights_ref.pfm", 0.01, 0.03, 16)),
    "filter": ("tests/oracle/filter_oracle.pbrt", (3 * 3 + 1, 1),
               ("filter_ref.pfm", 0.025, 0.04, 16)),
    "cornell_portal": ("scenes/cornell_portal.pbrt", (4 * 2 + 1, 1), None),
    # the zoo (96², 128 spp, whitted, maxdepth 5, a point light)
    "whitted": ("tests/oracle/whitted_oracle.pbrt", (5 * 2 + 1, 1),
                ("whitted_ref.pfm", 0.03, 0.05, 16)),
    # 96², 512 spp in passes of 227, 227, 58; maxdepth 6, a sphere light
    "caustic": ("tests/oracle/caustic_oracle.pbrt", (6 * 3 + 1, 3),
                ("caustic_ref.pfm", 0.035, 0.20, 16)),
    # 96², 128 spp, maxdepth 5, two area lights
    "disney": ("tests/oracle/disney_oracle.pbrt", (5 * 3 + 1, 1),
               ("disney_ref.pfm", 0.006, 0.095, 8)),
    # 48², 1,024 spp in passes of 910 and 114, maxdepth 4, an infinite light
    "envcavity": ("tests/oracle/envcavity_oracle.pbrt", (4 * 3 + 1, 2),
                  ("envcavity_path_ref.pfm", 0.02, None, 16)),
    # 128 × 64, 64 spp, maxdepth 2, a point light
    "envcam": ("tests/oracle/envcam_oracle.pbrt", (2 * 2 + 1, 1),
               ("envcam_ref.pfm", 0.02, 0.04, 16)),
}
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
# the brute-force kernel's designs timed in turns (bits of
# ops/intersect.py); 0 has neither step
INTERSECT_DESIGNS = ik.DESIGNS


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


def turns(run, designs, reps):
    """run(design) -> tuple of tensors, for each design: checks that every
    design's result equals the first's bit for bit, runs each reps times
    more (the card's clocks ramp up), then times them by CUDA events in
    turns (a, b, ..., b, a). Returns {design: mean ms of its two turns}."""
    outs = {dsg: run(dsg) for dsg in designs}
    torch.cuda.synchronize()
    for dsg in designs[1:]:
        check(all(torch.equal(a, b) for a, b in zip(outs[dsg],
                                                    outs[designs[0]])),
              f"design {dsg} differs from design {designs[0]}")
    for dsg in designs:
        for _ in range(reps):
            run(dsg)
    ms = {}
    for dsg in list(designs) + list(reversed(designs)):
        ms[dsg] = ms.get(dsg, 0.0) + sync_ms(lambda: run(dsg), reps) / 2
    return {dsg: round(v, 4) for dsg, v in ms.items()}


def kernel_name(mangled):
    """'fused_path_kernel<1,1,1>' from the Itanium name of a kernel (a
    nested name whose template arguments are integers and bools)."""
    pos, name = 3 if mangled.startswith("_ZN") else 0, mangled
    while pos < len(mangled) and mangled[pos].isdigit():
        m = re.match(r"\d+", mangled[pos:])
        n = int(m.group(0))
        name = mangled[pos + m.end():pos + m.end() + n]
        pos += m.end() + n
    args = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[pos:])
    if args:
        name += "<" + ",".join(re.findall(r"L[a-z](\d+)E", args.group(1))) \
            + ">"
    return name


def ptxas_summary(log):
    """Registers and spills of each kernel in an nvcc -Xptxas -v log:
    {kernel: [registers, spill store bytes, spill load bytes]}."""
    out, entry_fn, current, spills = {}, None, None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry_fn = m.group(1)
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills[current] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry_fn:
            out[kernel_name(entry_fn)] = [int(m.group(1)),
                                          *spills.get(entry_fn, [0, 0])]
            entry_fn = None
    return out


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
    live = fp.live_mask(want[0])
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


def fused_bound(scene, code):
    """From this run's residuals: a lane alive entering bounce b sweeps
    the table once for its closest hit and, unless b is the emission-only
    last bounce, once (mode 1) or twice (mode 0) more for next-event
    estimation; ended lanes are not counted."""
    n_rays = code.shape[1]
    live, _ = fp.sweep_counts(code, scene.fused_profile[4], 32)
    n_ops = int(live.sum()) * (OPS_TRI * scene.n_tri + OPS_PLN)
    n_bytes = n_rays * (24 + 8 + 12 * code.shape[0]) + 64 * scene.n_tri
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
    t equal bit for bit, for every design of INTERSECT_DESIGNS at R, at R
    not a multiple of 64 and at R < 64. Returns the largest
    |t_kernel − t_twin|."""
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
        check(n_prim == 0, f"{n_prim} prim mismatches")
        check(torch.equal(t, t_ref), f"t differs from the twin by {err}")
        check(hit > 0.05, f"hit share {hit}")
        sizes = (o.shape[0], o.shape[0] - 37, 45)
        for R in sizes:
            for design in INTERSECT_DESIGNS:
                t_d, prim_d = ik._launch_design(
                    *tabs, o[:R].contiguous(), d[:R].contiguous(),
                    tmax[:R].contiguous(), *counts, design)
                check(torch.equal(t_d, t_ref[:R])
                      and torch.equal(prim_d, prim_ref[:R]),
                      f"{name} {rname} R {R}: design {design} differs from "
                      "the twin")
        print(f"intersect kernel vs twin {name} {counts} {rname}: "
              f"{n_prim} prim mismatches, t max err {err:.3g}, hit share "
              f"{hit:.3f}; designs {INTERSECT_DESIGNS} equal to the twin at "
              f"R = {sizes}")
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


def check_binary(name, bvh, dev):
    """The binary kernel (the harness's yardstick) vs its twin on the three
    ray sets: closest hit with the leaf index equal on every ray and t
    equal bit for bit; any-hit with equal masks, and equal to the closest
    hit's; count mode's nodes popped add up to the twin's slab tests; more
    than 5% of the rays hit. Returns the largest |t_kernel − t_twin|."""
    worst = 0.0
    for rname, (o, d, tmax) in ray_sets(dev).items():
        t, leaf = bb.bvh_traverse_binary(bvh, o, d, tmax, False)
        _, leaf_any = bb.bvh_traverse_binary(bvh, o, d, tmax, True)
        _, code = bb.bvh_traverse_binary(bvh, o, d, tmax, False,
                                         count_mode=True)
        torch.cuda.synchronize()
        stats = {}
        t_ref, leaf_ref = bb._traverse_reference(bvh, o, d, tmax, False,
                                                 stats=stats)
        _, any_ref = bb._traverse_reference(bvh, o, d, tmax, True)
        check(leaf.dtype == torch.int32 and t.dtype == torch.float32,
              "output types")
        n_leaf = int((leaf != leaf_ref).sum())
        n_any = int(((leaf_any >= 0) != (any_ref >= 0)).sum())
        n_pop = int((code.long() >> 16).sum())
        hit = float((leaf >= 0).float().mean())
        print(f"bvh_binary kernel vs twin {name} ({bvh.lo.shape[0]} nodes) "
              f"{rname}: {n_leaf} index mismatches, t max err "
              f"{float((t - t_ref).abs().max()):.3g}, {n_any} any-hit "
              f"mismatches, {n_pop} nodes popped (twin: "
              f"{stats['slab_tests']} slab tests), hit share {hit:.3f}")
        check(n_leaf == 0 and torch.equal(t, t_ref) and n_any == 0,
              f"{name} {rname}: the binary kernel differs from its twin")
        check(torch.equal(leaf_any >= 0, leaf >= 0),
              f"{name} {rname}: the binary kernel's any-hit disagrees with "
              "its closest hit")
        check(n_pop == stats["slab_tests"], "count mode's pops")
        check(hit > 0.05, f"{name} {rname}: hit share {hit}")
        worst = max(worst, float((t - t_ref).abs().max()))
    return worst


def check_traverse(name, bvh, dev):
    """The 4-wide traversal kernel vs its twin on the three ray sets,
    closest hit and any-hit, on the plain grid, the persistent grid (the
    render path's) and the persistent grid under the harness's L2 window:
    index and t equal bit for bit, count mode's step codes equal, the
    any-hit mask equal to the closest hit's, more than 5% of the rays hit.
    Against the binary kernel: t bit-equal, hit masks equal, the triangle
    equal through ``prim_order`` but for exact ties in t. Returns (largest
    |t_kernel − t_twin|, rays that name another triangle than the binary
    kernel, rays compared)."""
    worst, ties, n_cmp = 0.0, 0, 0
    order = bvh.prim_order.long()
    for rname, (o, d, tmax) in ray_sets(dev).items():
        masks = []
        for any_hit in (False, True):
            runs = [bk.bvh_traverse(bvh, o, d, tmax, any_hit,
                                    persistent=False),
                    bk.bvh_traverse(bvh, o, d, tmax, any_hit)]
            with kk.l2_window(bvh, True):
                runs.append(bk.bvh_traverse(bvh, o, d, tmax, any_hit))
            t, i = runs[1]
            masks.append(i >= 0)
            t_b, i_b = bb.bvh_traverse_binary(bvh, o, d, tmax, any_hit)
            torch.cuda.synchronize()
            t_ref, i_ref = bk.traverse_reference(bvh, o, d, tmax, any_hit)
            check(i.dtype == torch.int32 and t.dtype == torch.float32,
                  "output types")
            mode = "any" if any_hit else "closest"
            check(all(torch.equal(tt, t_ref) and torch.equal(ii, i_ref)
                      for tt, ii in runs),
                  f"{name} {rname} {mode}: the kernel (plain grid, "
                  "persistent grid or L2 window) differs from its twin")
            worst = max(worst, float((t - t_ref).abs().max()))
            check(torch.equal(i >= 0, i_b >= 0),
                  f"{name} {rname} {mode}: hit masks differ from the binary "
                  "kernel")
            if any_hit:
                continue
            check(torch.equal(t, t_b), f"{name} {rname}: t differs from the "
                  "binary kernel")
            hit = i >= 0
            ties += int((order[i[hit].long()] != order[i_b[hit].long()]).sum())
            n_cmp += o.shape[0]
        _, code = bk.bvh_traverse(bvh, o, d, tmax, False, count_mode=True)
        torch.cuda.synchronize()
        _, code_ref = bk.traverse_reference(bvh, o, d, tmax, False,
                                            count_mode=True)
        check(torch.equal(code, code_ref), f"{name} {rname}: step codes")
        check(torch.equal(masks[0], masks[1]), f"{name} {rname}: any-hit "
              "disagrees with closest hit")
        hit = float(masks[0].float().mean())
        print(f"bvh_traverse kernel vs twin {name} ({bvh.nodes.shape[0]} "
              f"wide nodes, {bvh.prim_order.shape[0]} leaf triangles, stack "
              f"need {bvh.stack_need}, {bvh.built_by}) {rname}: equal (plain "
              "grid, persistent grid, L2 window; closest, any-hit, count "
              f"mode); t equal to the binary kernel; hit share {hit:.3f}")
        check(hit > 0.05, f"{name} {rname}: hit share {hit}")
    check(ties <= 1e-3 * n_cmp, f"{ties} rays name another triangle than "
          "the binary kernel")
    return worst, ties, n_cmp


@contextlib.contextmanager
def counting_sorts(calls):
    """Appends the batch size of every ray sort made inside the block."""
    real = bvh_mod._ray_sort_order

    def counted(o, d):
        calls.append(o.shape[0])
        return real(o, d)

    bvh_mod._ray_sort_order = counted
    try:
        yield
    finally:
        bvh_mod._ray_sort_order = real


@contextlib.contextmanager
def old_bvh_path():
    """Inside the block the BVH queries run as the render path ran them
    before the 4-wide kernel: every batch (of 4,096 rays or more, as every
    batch of a 256² pass) in the ray sort's order through the binary
    kernel, the results put back in the callers' order."""
    def sorted_binary(bvh, o, d, tmax, any_hit):
        perm = bvh_mod._ray_sort_order(o, d)
        t_s, i_s = bb.bvh_traverse_binary(bvh, o[perm], d[perm], tmax[perm],
                                          any_hit)
        t, leaf_i = torch.empty_like(t_s), torch.empty_like(i_s)
        t[perm] = t_s
        leaf_i[perm] = i_s
        return t, leaf_i

    def tris(bvh, o, d, tmax):
        t, leaf_i = sorted_binary(bvh, o, d, tmax, False)
        hit = leaf_i >= 0
        return t, torch.where(hit, bvh.prim_order[leaf_i.long().clamp_min(0)],
                              -1), hit

    def p_tris(bvh, o, d, tmax):
        return sorted_binary(bvh, o, d, tmax, True)[1] >= 0

    saved = bvh_mod.bvh_intersect_tris, bvh_mod.bvh_intersect_p_tris
    bvh_mod.bvh_intersect_tris, bvh_mod.bvh_intersect_p_tris = tris, p_tris
    try:
        yield
    finally:
        bvh_mod.bvh_intersect_tris, bvh_mod.bvh_intersect_p_tris = saved


@contextlib.contextmanager
def plain_grid():
    """Inside the block the render path's BVH queries launch the 4-wide
    kernel on its plain grid (one thread per ray) in place of the
    persistent one."""
    def tris(bvh, o, d, tmax):
        t, leaf_i = bk.bvh_traverse(bvh, o, d, tmax, False, persistent=False)
        hit = leaf_i >= 0
        return t, torch.where(hit, bvh.prim_order[leaf_i.long().clamp_min(0)],
                              -1), hit

    def p_tris(bvh, o, d, tmax):
        return bk.bvh_traverse(bvh, o, d, tmax, True, persistent=False)[1] >= 0

    saved = bvh_mod.bvh_intersect_tris, bvh_mod.bvh_intersect_p_tris
    bvh_mod.bvh_intersect_tris, bvh_mod.bvh_intersect_p_tris = tris, p_tris
    try:
        yield
    finally:
        bvh_mod.bvh_intersect_tris, bvh_mod.bvh_intersect_p_tris = saved


@contextlib.contextmanager
def intersect_design(design):
    """Inside the block the render path's brute-force queries launch the
    kernel of ``design`` in place of the render path's (their launches
    still count in ``ik.intersect_brute.launches``)."""
    real = ik.intersect_brute

    def launch(tri, sph, pln, o, d, tmax, n_tri, n_sph, n_pln):
        return ik._launch_design(tri, sph, pln, o, d, tmax, n_tri, n_sph,
                                 n_pln, design)

    launch.launches = 0
    ik.intersect_brute = launch
    try:
        yield
    finally:
        ik.intersect_brute = real
        real.launches += launch.launches


def intersect_in_pass(pass_fn, n_launches):
    """The brute-force kernel's device time inside one pass of pass_fn, by
    torch.profiler, for each design of INTERSECT_DESIGNS in turns (a, b,
    ..., b, a): {design: ms per pass, mean of the two turns}."""
    out = {}
    for dsg in list(INTERSECT_DESIGNS) + list(reversed(INTERSECT_DESIGNS)):
        with intersect_design(dsg):
            _, by = device_ms_by_kernel(pass_fn, ["intersect_kernel"])
        ms_k, n_k = by["intersect_kernel"]
        check(n_k == n_launches, f"{n_k} brute-force launches in a pass")
        out[dsg] = out.get(dsg, 0.0) + ms_k / 2
    return {dsg: round(v, 4) for dsg, v in out.items()}


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
        out["designs"] = turns(
            lambda dsg: ik._launch_design(*tabs, o, d, best_t, *counts, dsg),
            INTERSECT_DESIGNS, reps)
    return out


def traverse_bound(table_bytes, n_rays, *stats):
    """Each ray read once (28 B) and written once (8 B), the tree's tables
    once; the slab and triangle tests this run's rays needed: of the walks
    counted on the same rays (the 4-wide and the binary twin's, which give
    the same answers), the one with fewer operations."""
    n_bytes = 36 * n_rays + table_bytes
    n_ops = min(OPS_SLAB * st["slab_tests"] + OPS_TRI * st["tri_tests"]
                for st in stats)
    return bound_ms(n_bytes, n_ops)


def device_ms_by_kernel(fn, frags):
    """Device time by kernel over one run of ``fn``, from torch.profiler:
    (total ms, {kernel-name fragment: [ms, launches]}). Only the device's
    own rows count: a CPU op's row carries the device time of the kernels
    it launched again, so summing every row counts each kernel twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, by_name = 0.0, {frag: [0.0, 0] for frag in frags}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CPU:
            continue
        us = evt.self_device_time_total
        total += us / 1e3
        for frag in frags:
            if frag in evt.key and us > 0:
                by_name[frag][0] += us / 1e3
                by_name[frag][1] += evt.count
    return total, by_name


def check_probe(dev):
    """The shared-memory probe against its plain version at four sizes a
    block may ask for (one launch each); one KB past the documented limit
    must raise. The size is set only when it changes: the timed launches
    at one size make no attribute call. Times the probe and torch.add, the
    library call that computes the same function, by CUDA events around
    back-to-back calls and by the profiler's kernel time per launch.
    Returns {err, ms, plain_ms, library_ms, device_ms, library_device_ms,
    limit_kb, sets}."""
    gen = torch.Generator(device="cpu").manual_seed(9)
    x = torch.randn(8, kk.LANES, generator=gen).to(dev)
    want = kk._probe_reference(x)
    worst = 0.0
    for kb in (48, 100, 164, kk.SMEM_DOCUMENTED_KB):
        err, msg, out = kk._probe_launch(x, kb)
        torch.cuda.synchronize()
        check(err == 0, f"smem_probe at {kb} KB: CUDA error {err} ({msg})")
        worst = max(worst, float((out - want).abs().max()))
        check(bool(torch.isfinite(out).all()) and torch.equal(out, want),
              f"smem_probe at {kb} KB differs from the plain version")
    refused = None
    try:
        kk.smem_probe(kk.SMEM_DOCUMENTED_KB + 1, dev, x)
    except RuntimeError as exc:
        refused = str(exc)
    check(refused is not None and "CUDA error" in refused,
          f"{kk.SMEM_DOCUMENTED_KB + 1} KB was not refused")
    limit_kb = kk.smem_limit_kb(dev)
    check(limit_kb >= 48, f"largest size granted {limit_kb} KB")
    top = min(limit_kb, kk.SMEM_DOCUMENTED_KB)
    kk._probe_launch(x, top)
    sets = kk._probe_sizes.sets
    ms = sync_ms(lambda: kk._probe_launch(x, top), 20)
    check(kk._probe_sizes.sets == sets, "the timed launches set the size")
    plain_ms = sync_ms(lambda: kk._probe_reference(x), 20)
    # the one library call that computes the same function
    check(torch.equal(torch.add(x, x[0, 1]), want), "torch.add differs")
    library_ms = sync_ms(lambda: torch.add(x, x[0, 1]), 20)

    def twenty(fn):
        return lambda: [fn() for _ in range(20)]

    _, k_dev = device_ms_by_kernel(twenty(lambda: kk._probe_launch(x, top)),
                                   ["smem_probe_kernel"])
    _, a_dev = device_ms_by_kernel(twenty(lambda: torch.add(x, x[0, 1])),
                                   ["add"])
    device_ms = k_dev["smem_probe_kernel"][0] / max(
        k_dev["smem_probe_kernel"][1], 1)
    library_device_ms = a_dev["add"][0] / max(a_dev["add"][1], 1)
    check(kk._probe_sizes.sets == sets, "the profiled launches set the size")
    print(f"smem_probe: 48, 100, 164, {kk.SMEM_DOCUMENTED_KB} KB granted and "
          f"equal to the plain version (max err {worst:.3g}); "
          f"{kk.SMEM_DOCUMENTED_KB + 1} KB raised: {refused}; largest size a "
          f"launch got: {limit_kb} KB; {kk._probe_sizes.sets} attribute "
          f"calls in all, none in the 60 launches at {top} KB; per launch "
          f"(CUDA events, back to back) {ms:.4f} ms, plain version "
          f"{plain_ms:.4f} ms, torch.add {library_ms:.4f} ms; device time "
          f"per launch (torch.profiler) {device_ms:.5f} ms, torch.add "
          f"{library_device_ms:.5f} ms")
    return {"err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms, "limit_kb": limit_kb,
            "sets": kk._probe_sizes.sets}


# name -> (wide, leaf_max, dual, variant)
WIDE_CONFIGS = {"v1_w4_l16": (4, 16, False, 1), "v2_w4_l16": (4, 16, False, 2),
                "v3_w4_l16": (4, 16, False, 3), "v2_w8_l8": (8, 8, False, 2),
                "v5_dual": (4, 16, True, 5)}


def check_wide(name, bvh, dev, limit_kb):
    """The wide-BVH kernel against its twin, and against the binary kernel,
    on the three ray sets, for every configuration. Returns the largest
    |t_kernel - t_twin| and the staged launches' threads per block."""
    z = kexp_prep.tree_arrays(bvh)
    worst, threads = 0.0, {}
    for cname, (wide, leaf_max, dual, variant) in WIDE_CONFIGS.items():
        lay = kexp_run.layout_of(z, dev, wide, leaf_max, dual)
        n_smem = kk.max_smem_nodes(lay, limit_kb)
        n_idx = n_any = n_cnt = n_smem_diff = ties = 0
        for rname, (o, d, tmax) in ray_sets(dev).items():
            for any_hit in (False, True):
                t, i = kk.traverse(lay, o, d, tmax, any_hit=any_hit,
                                   variant=variant)
                t_s, i_s = kk.traverse(lay, o, d, tmax, any_hit=any_hit,
                                       variant=variant, smem_nodes=n_smem,
                                       block=256 if any_hit else 64)
                threads[cname] = kk.traverse.last_threads
                torch.cuda.synchronize()
                t_ref, i_ref = kk._traverse_wide_reference(
                    lay, o, d, tmax, any_hit=any_hit, variant=variant)
                check(i.dtype == torch.int32 and t.dtype == torch.float32,
                      "output types")
                n_smem_diff += int((i_s != i).sum()) + int((t_s != t).sum())
                if any_hit:
                    n_any += int(((i >= 0) != (i_ref >= 0)).sum())
                    continue
                n_idx += int((i != i_ref).sum())
                worst = max(worst, float((t - t_ref).abs().max()))
                check(torch.equal(t, t_ref), f"{name} {cname} {rname}: t "
                      "differs from the twin")
                t_b, i_b = bb.bvh_traverse_binary(bvh, o, d, tmax, False)
                check(torch.equal(t_b, t) and torch.equal(i_b >= 0, i >= 0),
                      f"{name} {cname} {rname}: differs from the binary "
                      "kernel")
                # one triangle sits in several leaves under spatial splits:
                # compare the triangles the leaf slots stand for
                order = bvh.prim_order.long()
                hit = i >= 0
                ties += int((order[i_b[hit].long()]
                             != order[i[hit].long()]).sum())
            if rname == "camera":
                _, code = kk.traverse(lay, o, d, tmax, any_hit=False,
                                      variant=variant + 10)
                _, code_ref = kk._traverse_wide_reference(
                    lay, o, d, tmax, any_hit=False, variant=variant + 10)
                n_cnt += int((code != code_ref).sum())
        print(f"kexp_traverse kernel vs twin {name} {cname} ({lay.n_nodes} "
              f"wide nodes, stack need {lay.stack_need}): {n_idx} index "
              f"mismatches, {n_any} any-hit mismatches, {n_cnt} count-code "
              f"mismatches, {n_smem_diff} differences with {n_smem} nodes in "
              f"shared memory ({threads[cname]} threads per block); vs the "
              f"binary kernel t and valid equal, {ties} rays name another "
              "triangle (ties)")
        check(n_idx == 0 and n_any == 0 and n_cnt == 0 and n_smem_diff == 0,
              f"{name} {cname}: kernel and twin disagree")
        check(ties <= 1e-3 * 3 * 8192, f"{ties} rays name another triangle")
    return worst, threads


# launches of check_wide per tree and configuration: per ray set and mode
# one unstaged and one staged, then count mode
WIDE_CHECK_LAUNCHES = 3 * 2 * 2 + 1


def wide_bound(layout, variant, n_rays, stats):
    """As ``traverse_bound``: each ray read and written once, the tables the
    variant reads once; the slab tests (non-empty slots) and triangle tests
    this run's rays needed, counted by the twin."""
    n_bytes = 36 * n_rays + layout.table_bytes(variant)
    n_ops = OPS_SLAB * stats["slab_tests"] + OPS_TRI * stats["tri_tests"]
    return bound_ms(n_bytes, n_ops)


# label -> (experiment, arguments, smem_nodes); the 4-wide kernel's two
# grids and the binary kernel run in turns (a, b, b, a) around the rest
HARNESS = {
    "binary": ("binary", [], 0), "baseline": ("baseline", [], 0),
    "grid_plain": ("grid", ["plain"], 0),
    "grid_persistent": ("grid", ["persistent"], 0),
    "v1": ("variant", ["1"], 0), "v1_smem256": ("variant", ["1"], 256),
    "v2": ("variant", ["2"], 0), "v2_smem256": ("variant", ["2"], 256),
    "v2_smem_max": ("variant", ["2"], "max"),
    "v3": ("variant", ["3"], 0),
    "pack_4_8": ("pack", ["4", "8"], 0), "pack_4_4": ("pack", ["4", "4"], 0),
    "grid_persistent_again": ("grid", ["persistent"], 0),
    "grid_plain_again": ("grid", ["plain"], 0),
    "binary_again": ("binary", [], 0)}
HARNESS_SETS = ("primary", "random", "sorted", "bounce", "shadow")
# ray sets of the harness file: origins, directions, tmax, any-hit
RAY_KEYS = {name: (ok, dk, tk, any_hit)
            for name, ok, dk, tk, any_hit in kexp_run.RAY_SETS}


def warp_efficiencies(z, dev):
    """Count mode of the 4-wide and the binary kernel on every ray set of
    the harness file: {kernel: {set: warp efficiency}}."""
    tree = kexp_run.tree_of(z, dev)
    out = {"bvh_traverse": {}, "bvh_binary": {}}
    for name in HARNESS_SETS:
        ok, dk, tk, any_hit = RAY_KEYS[name]
        o, d, tmax = (kexp_run._dev(z, k, dev) for k in (ok, dk, tk))
        for kname, fn in (("bvh_traverse", bk.bvh_traverse),
                          ("bvh_binary", bb.bvh_traverse_binary)):
            _, code = fn(tree, o, d, tmax, any_hit, count_mode=True)
            out[kname][name] = round(kexp_run.warp_efficiency(code), 4)
    return out


def run_harness(scenes, n_rays, res, dev):
    """kexp_prep, then every experiment of HARNESS through kexp_run, on
    each scene, and the two production kernels' warp efficiency. Returns
    (matrix of ms, steps per ray, agreement, warp efficiency, the launches
    of the kexp kernel, the 4-wide kernel, the binary kernel and the probe
    that this implies)."""
    matrix, steps, agree, warp = {}, {}, {}, {}
    # an experiment: one launch for the agreement, then a warm-up and REPS
    # timed launches per ray set; count mode: one launch per ray set
    per_exp = 1 + len(HARNESS_SETS) * (kexp_run.REPS + 1)
    n_kexp = n_new = n_binary = 0
    for name, scene in scenes.items():
        path = f"{kexp_prep.OUT_DIR}/{name}.npz"
        t0 = time.perf_counter()
        kexp_prep.prep(scene, n_rays=n_rays, res=res, device=dev, out=path)
        n_new += 1                  # prep's bounce rays: one intersection
        z = kexp_run.load(path)
        t_prep = time.perf_counter() - t0
        check(z["o_p"].shape == (n_rays, 3) and z["t_x"].shape == (16384,),
              "the harness file's shapes")
        matrix[name], agree[name] = {}, {}
        t0 = time.perf_counter()
        for label, (exp, args, smem) in HARNESS.items():
            out = kexp_run.run(exp, args, z, dev, smem)
            matrix[name][label] = {k: out[k + "_ms"] for k in HARNESS_SETS}
            if exp == "binary":
                n_binary += per_exp
            elif exp in ("baseline", "grid"):
                n_new += per_exp
            else:
                n_kexp += per_exp
            if out.get("smem_nodes"):
                matrix[name][label]["smem_nodes"] = out["smem_nodes"]
                matrix[name][label]["threads"] = out["threads"]
            agree[name][label] = [out["prim_agreement"], out["max_abs_dt"]]
            # the same triangles through the same formula as the binary
            # twin: t bit-equal, the triangle equal but for exact ties
            check(out["max_abs_dt"] == 0.0 and out["prim_agreement"] > 0.999,
                  f"{name} {label}: {agree[name][label]}")
        steps[name] = {
            "v2_w4_l16": kexp_run.exp_count(z, 2, dev),
            "v3_w4_l16": kexp_run.exp_count(z, 3, dev),
            "v2_w8_l8": kexp_run.exp_count(z, 2, dev, wide=8, leaf_max=8),
            "v2_w4_l4": kexp_run.exp_count(z, 2, dev, wide=4, leaf_max=4)}
        n_kexp += len(steps[name]) * len(HARNESS_SETS)
        warp[name] = warp_efficiencies(z, dev)
        n_new += len(HARNESS_SETS)
        n_binary += len(HARNESS_SETS)
        print(f"harness {name}: {z['v0'].shape[0]} leaf triangles, "
              f"{z['lo'].shape[0]} binary nodes, prep + load {t_prep:.1f} s, "
              f"experiments {time.perf_counter() - t0:.1f} s")
    probe = kexp_run.run("smem_probe", [str(kk.SMEM_DOCUMENTED_KB)], {}, dev)
    check(probe == {"kb": kk.SMEM_DOCUMENTED_KB, "ok": True}, f"{probe}")
    return matrix, steps, agree, warp, (n_kexp, n_new, n_binary, 1)


# ---------------------------------------------------------------------------
# 15. scene files
# ---------------------------------------------------------------------------

def _block_rel_l1(a, b, k=16):
    """tests/test_oracle.py's blockwise relative L1."""
    h, w = a.shape[0] // k * k, a.shape[1] // k * k
    da = a[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    db = b[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    return float(np.abs(da - db).sum() / max(db.sum(), 1e-9))


def _mean_delta(a, b):
    """imgtool diff's avgDelta (imgtool.cpp:418-420)."""
    ma, mb = float(a.mean()), float(b.mean())
    return abs(ma - mb) / max(min(ma, mb), 1e-9)


def run_cli(scene_file, out, *args):
    """The CLI in a subprocess on the card; returns its summary line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pbrt_tpu_torch.utils.cli", scene_file, "-o",
         out, *args], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI on {scene_file}:\n{proc.stderr}")
    lines = [ln for ln in proc.stderr.splitlines()
             if ln.startswith("pbrt_tpu_torch: summary ")]
    check(len(lines) == 1, f"no summary from the CLI on {scene_file}")
    summary = json.loads(lines[0][len("pbrt_tpu_torch: summary "):])
    summary["process_s"] = wall
    return summary


def _floats(a):
    return " ".join(f"{float(v):.9g}" for v in np.asarray(a).reshape(-1))


def write_heightfield_file(path):
    """Phase 10's scene, ``entry._heightfield_cornell()``, as a .pbrt
    file: its triangles in the builder's order, the heightfield as a
    256×256 ``heightfield`` under the y↔z swap the builder applies, the
    cone as a ``trianglemesh`` of the same vertices and normals (the
    parser's cone has fewer rings), then the sphere and the light."""
    from pbrt_tpu_torch.scene import tessellate
    quad = "[0 1 2 0 2 3]"
    lines = ['Film "image" "integer xresolution" [256] '
             '"integer yresolution" [256]',
             'Sampler "independent" "integer pixelsamples" [64]',
             'Integrator "path" "integer maxdepth" [4]',
             "LookAt 0.5 0.5 -1.4  0.5 0.5 1.0  0 1 0",
             'Camera "perspective" "float fov" [40]', "WorldBegin"]

    def mesh(kd, verts, idx="[0 1 2 0 2 3]", extra=""):
        lines.extend(["AttributeBegin",
                      f'Material "matte" "rgb Kd" [{_floats(kd)}]',
                      f'Shape "trianglemesh" "integer indices" {idx}',
                      f'  "point P" [{_floats(verts)}]{extra}',
                      "AttributeEnd"])
    for verts, kd in zip(entry._WALLS[1:], (entry._WHITE, entry._RED,
                                            entry._GREEN)):
        mesh(kd, verts)
    mesh(entry._WHITE, [(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)])
    n = 256
    z = entry._floor_heights(n).astype(np.float32)
    lines.extend(["AttributeBegin",
                  'Material "matte" "rgb Kd" [0.55 0.5 0.35]',
                  "Transform [1 0 0 0  0 0 1 0  0 1 0 0  0 0 0 1]",
                  f'Shape "heightfield" "integer nu" [{n}] '
                  f'"integer nv" [{n}]',
                  f'  "float Pz" [{_floats(z)}]', "AttributeEnd"])
    verts, faces, norms = tessellate.tessellate_cone(
        radius=0.12, height=0.35, n_phi=64, n_z=24)
    base = np.asarray([0.68, 0.03, 0.55], np.float32)
    mesh((0.3, 0.4, 0.7), verts[:, [0, 2, 1]] + base,
         idx=f"[{' '.join(str(int(i)) for i in faces.reshape(-1))}]",
         extra=f'\n  "normal N" [{_floats(norms[:, [0, 2, 1]])}]')
    lines.extend(["AttributeBegin", 'Material "matte" "rgb Kd" [0 0 0]',
                  'AreaLightSource "diffuse" "rgb L" [15 13 9]',
                  'Shape "aaplane" "point lo" [0.3 0.99 0.35] '
                  '"point hi" [0.7 0.99 0.65] "integer axis" [1] '
                  '"bool facingFw" "false"', "AttributeEnd",
                  "AttributeBegin",
                  f'Material "matte" "rgb Kd" [{_floats(entry._WHITE)}]',
                  "Translate 0.32 0.25 0.45",
                  'Shape "sphere" "float radius" [0.13]', "AttributeEnd",
                  "WorldEnd"])
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# a small scene of disks (one a ring) over a floor, with a sphere and a
# point light: disks are intersected outside the kernels, in plain torch
DISK_SCENE = """
Film "image" "integer xresolution" [64] "integer yresolution" [64]
Sampler "halton" "integer pixelsamples" [4]
Integrator "path" "integer maxdepth" [3]
LookAt 0.3 2.2 -3  0 0.4 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [8 8 8] "point from" [0.5 3 -0.5]
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-2 0 -2  2 0 -2  2 0 2  -2 0 2]
Translate 0 0.5 0
Shape "sphere" "float radius" [0.3]
Rotate 70 1 0.2 0
Shape "disk" "float radius" [0.9] "float innerradius" [0.35]
Translate 0.4 0 0.1
Shape "disk" "float radius" [0.5] "float height" [0.2]
WorldEnd
"""


def disks_on_the_card(dev):
    """The disk scene through ``path`` and ``ao`` on the card against the
    port's CPU twins in the same call: image means to rel 1e-4."""
    from pbrt_tpu_torch.frontend import parse_pbrt_string
    out = {}
    for integrator in ("path", "ao"):
        means = {}
        for d in (dev, torch.device("cpu")):
            scene, cam, opts = parse_pbrt_string(DISK_SCENE, device=d)
            check(scene.n_dsk == 2, "the disk scene")
            ik.intersect_brute.launches = 0
            img = render_mod.render(scene, cam, spp=4, integrator=integrator,
                                    sampler="halton", max_depth=3, device=d)
            check(bool(torch.isfinite(img).all()), "non-finite disk image")
            means[d.type] = float(img.double().mean())
            if d.type == "cuda":
                launches = ik.intersect_brute.launches
        rel = abs(means["cuda"] - means["cpu"]) / means["cpu"]
        out[integrator] = {"mean": means["cuda"], "cpu_mean": means["cpu"],
                           "rel": rel, "launches": launches}
        print(f"disk scene {integrator} 64² × 4 spp: " + json.dumps(
            out[integrator]))
        check(launches > 0 and rel < 1e-4,
              f"disk scene {integrator}: {out[integrator]}")
    return out


def scene_files(dev, hf_mean, hf_tris):
    """Phase 15: the CLI on the scene files, in-process halton renders of
    the oracle files, the demo file on the fused kernel and a written
    BVH-scale file. Returns the numbers for the JSON line."""
    out = {"cli": {}, "in_process": {}}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the CLI on each file at full width
        for name, (path, (per_pass, passes), limits) in SCENE_FILES.items():
            pfm = os.path.join(tmp, f"{name}.pfm")
            sm = run_cli(path, pfm)
            img = imageio.read_pfm(pfm)
            check(list(img.shape) == sm["shape"] and np.isfinite(img).all(),
                  f"{name}: image {img.shape}")
            want = per_pass * passes
            lc = sm["launches"]
            check(lc["intersect_brute"] == want and lc["fused_bounce"] == 0
                  and lc["bvh_traverse"] == 0,
                  f"{name}: launches {lc}, the loop implies {want} "
                  "brute-force launches")
            row = {k: sm[k] for k in ("parse_s", "build_s", "render_s",
                                      "render_cuda_ms", "write_s",
                                      "process_s", "launches", "spp",
                                      "mean", "prims")}
            if limits is not None:
                ref_file, md_lim, bl_lim, k = limits
                ref = imageio.read_pfm(os.path.join(os.path.dirname(path),
                                                    ref_file))
                row["md"] = _mean_delta(img, ref)
                row["bl"] = _block_rel_l1(img, ref, k=k)
                check(row["md"] < md_lim
                      and (bl_lim is None or row["bl"] < bl_lim),
                      f"{name}: md {row['md']:.4f} bl {row['bl']:.4f} vs "
                      f"the limits {limits}")
            print(f"scene file {name} (CLI): " + json.dumps(row))
            out["cli"][name] = row
        # (d) a BVH-scale file the script writes
        hpath = os.path.join(tmp, "heightfield_cornell.pbrt")
        t0 = time.perf_counter()
        write_heightfield_file(hpath)
        t_write_file = time.perf_counter() - t0
        sm = run_cli(hpath, os.path.join(tmp, "heightfield_cornell.pfm"))
        lc = sm["launches"]
        want = (MAX_DEPTH * 3 + 1) * (SPP // CHUNK)
        rel = abs(sm["mean"] - hf_mean) / hf_mean
        row = {k: sm[k] for k in ("parse_s", "build_s", "render_s",
                                  "render_cuda_ms", "write_s", "process_s",
                                  "launches", "spp", "mean", "prims")}
        row.update(file_mb=os.path.getsize(hpath) / 2**20,
                   file_write_s=t_write_file, ref_mean=hf_mean, rel=rel)
        print("scene file heightfield_cornell (written, CLI): "
              + json.dumps(row))
        check(sm["prims"]["tri"] == hf_tris and sm["prims"]["bvh"],
              f"the written scene: {sm['prims']}, phase 10 has {hf_tris} "
              "triangles")
        check(lc["bvh_traverse"] == want and lc["intersect_brute"] == want
              and lc["fused_bounce"] == 0,
              f"written heightfield: launches {lc}, the loop implies {want}")
        check(rel < 1e-3, f"written heightfield mean {sm['mean']!r} vs "
              f"_heightfield_cornell()'s {hf_mean!r}: rel {rel}")
        out["cli"]["heightfield_cornell"] = row
    # (b) in-process halton renders against pbrt_tpu's means; the zoo's
    # files in one pass, profiled: device time in all and in kernel 2
    for name, (path, (per_pass, _), _) in SCENE_FILES.items():
        if name in REF_FILE_MEANS:
            spp, ref_mean, zoo = 16, REF_FILE_MEANS[name], False
        elif name in REF_ZOO_MEANS:
            spp, ref_mean, zoo = ZOO_MEAN_SPP, REF_ZOO_MEANS[name], True
        else:
            continue
        t0 = time.perf_counter()
        scene, cam, opts = load_pbrt(path, device=dev)
        fname, fkw = opts["filter"]
        ik.intersect_brute.launches = 0
        fp.fused_bounce.launches = 0
        images = []

        def run():
            images.append(render_mod.render(
                scene, cam, spp=spp, integrator=opts["integrator"],
                sampler="halton", max_depth=opts["max_depth"],
                filter_name=fname, filter_kwargs=fkw, seed=0, device=dev))
        if zoo:
            dev_ms, by = device_ms_by_kernel(run, ["intersect_kernel"])
        else:
            run()
        torch.cuda.synchronize()
        mean = float(images[0].double().mean())
        rel = abs(mean - ref_mean) / ref_mean
        row = {"mean": mean, "ref": ref_mean, "rel": rel,
               "launches": ik.intersect_brute.launches,
               "s": time.perf_counter() - t0}
        if zoo:
            row.update(device_ms=dev_ms, intersect_device_ms=by[
                "intersect_kernel"][0], intersect_in_profile=by[
                "intersect_kernel"][1])
            check(ik.intersect_brute.launches == per_pass
                  and by["intersect_kernel"][1] == per_pass
                  and fp.fused_bounce.launches == 0,
                  f"{name}: {row}, the loop implies {per_pass} launches")
        print(f"scene file {name} in process, {spp} spp halton: "
              + json.dumps(row))
        check(bool(torch.isfinite(images[0]).all()), f"{name}: not finite")
        check(ik.intersect_brute.launches > 0, f"{name}: no launch")
        check(rel < 1e-3, f"{name}: mean off pbrt_tpu's by rel {rel}")
        out["in_process"][name] = row
    # (c) the demo file on the fused kernel at the main path's settings
    scene, cam, opts = load_pbrt("scenes/cornell_portal.pbrt", device=dev)
    cam = dataclasses.replace(cam, resolution=(W, H))
    check(scene.fused_profile is not None, "the demo file is not fused")
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    img = render_mod.render(scene, cam, spp=SPP, integrator="path",
                            sampler="independent", max_depth=MAX_DEPTH,
                            chunk_spp=CHUNK, seed=0, device=dev)
    mean = float(img.mean())
    rel = abs(mean - REF_IMAGE_MEAN) / REF_IMAGE_MEAN
    row = {"mean": mean, "ref": REF_IMAGE_MEAN, "rel": rel,
           "launches": fp.fused_bounce.launches}
    print("scene file cornell_portal, independent sampler, the main path's "
          "settings: " + json.dumps(row))
    check(fp.fused_bounce.launches == SPP // CHUNK
          and ik.intersect_brute.launches == 0,
          f"demo file: {fp.fused_bounce.launches} fused launches")
    check(rel < 1e-3, f"demo file mean off REF_IMAGE_MEAN by rel {rel}")
    out["demo_fused"] = row
    out["disks"] = disks_on_the_card(dev)
    return out


# ---------------------------------------------------------------------------
# 16. hero-wavelength spectral rendering
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_brute_force():
    """Record every brute-force query of scene/intersect.py as (the
    kernel's arguments, its outputs); the kernel's wrapper still counts
    its launches."""
    calls = []
    inner = isect_mod._closest

    def record(scene, o, d, tmax):
        out = inner(scene, o, d, tmax)
        calls.append((ik.pack_scene(scene) + (
            o.detach().contiguous(), d.detach().contiguous(),
            tmax.detach().contiguous(), scene.n_tri, scene.n_sph,
            scene.n_pln), out))
        return out
    isect_mod._closest = record
    try:
        yield calls
    finally:
        isect_mod._closest = inner


def hero_files(dev):
    """Phase 16: the CLI on the spectral oracle file with both hero
    integrators, the kernel against its twin on the hero pass's own rays,
    the pass's time, launches, device time and memory, and the 8-spp
    means against pbrt_tpu's. Returns the numbers for the JSON line."""
    from pbrt_tpu_torch.core import spectrum as spec_mod
    out = {"cli": {}}
    ref = imageio.read_pfm(HERO_REF)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (args, want, md_lim, bl_lim) in HERO_RUNS.items():
            pfm = os.path.join(tmp, f"{name}.pfm")
            sm = run_cli(HERO_FILE, pfm, *args)
            img = imageio.read_pfm(pfm)
            lc = sm["launches"]
            row = {k: sm[k] for k in ("parse_s", "build_s", "render_s",
                                      "render_cuda_ms", "write_s",
                                      "process_s", "launches", "spp",
                                      "mean", "prims", "integrator",
                                      "channels")}
            row["md"] = _mean_delta(img, ref)
            row["bl"] = _block_rel_l1(img, ref, k=16)
            print(f"hero file {name} (CLI): " + json.dumps(row))
            check(img.shape == ref.shape and np.isfinite(img).all()
                  and sm["channels"] == 60 and sm["integrator"] == name,
                  f"{name}: image {img.shape}, {sm}")
            check(lc["intersect_brute"] == want and lc["fused_bounce"] == 0
                  and lc["bvh_traverse"] == 0,
                  f"{name}: launches {lc}, the loop implies {want}")
            check(row["md"] < md_lim
                  and (bl_lim is None or row["bl"] < bl_lim),
                  f"{name}: md {row['md']:.4f} bl {row['bl']:.4f} vs the "
                  f"limits {md_lim}, {bl_lim}")
            out["cli"][name] = row

    scene, cam, opts = load_pbrt(HERO_FILE, spectrum_cfg=spec_mod.SAMPLED,
                                 device=dev)
    check(scene.n_channels == 60 and scene.bvh is None
          and scene.fused_profile is None, "the hero file's scene")
    fname, fkw = opts["filter"]
    spp = 128

    def render(integrator="hero_path_mis", spp=spp):
        return render_mod.render(
            scene, cam, spp=spp, integrator=integrator, sampler="halton",
            max_depth=opts["max_depth"], filter_name=fname,
            filter_kwargs=fkw, seed=0, device=dev)
    # (b) the kernel against its twin on every query of the pass
    with recording_brute_force() as calls:
        img = render()
        torch.cuda.synchronize()
    check(len(calls) == HERO_RUNS["hero_path_mis"][1],
          f"{len(calls)} brute-force queries in the hero pass")
    worst = 0.0
    for args, (t, prim) in calls:
        t_ref, prim_ref = ik._intersect_reference(*args)
        worst = max(worst, float((t - t_ref).abs().max()))
        check(torch.equal(prim, prim_ref) and torch.equal(t, t_ref),
              f"the kernel differs from its twin on the hero pass's rays "
              f"({args[3].shape[0]} rays, t err {worst})")
    cam_args = calls[0][0]
    n_rays = cam_args[3].shape[0]
    k_ms = sync_ms(lambda: ik.intersect_brute(*cam_args), 20)
    twin_ms = sync_ms(lambda: ik._intersect_reference(*cam_args), 3)
    bound = intersect_bound(scene, n_rays)
    del calls, cam_args
    # the render timed, its launches counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    ik.intersect_brute.launches = 0
    fp.fused_bounce.launches = 0
    bk.bvh_traverse.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    img2 = render()
    stop.record()
    torch.cuda.synchronize()
    render_ms = start.elapsed_time(stop)
    launches = ik.intersect_brute.launches
    # the pass's own peak, over what earlier phases left allocated
    peak_mb = (torch.cuda.max_memory_allocated(dev) - resident) / 2**20
    check(launches == HERO_RUNS["hero_path_mis"][1]
          and fp.fused_bounce.launches == 0
          and bk.bvh_traverse.launches == 0,
          f"hero render: {launches} brute-force launches")
    check(torch.equal(img, img2), "two renders of the hero pass differ")
    dev_ms, by = device_ms_by_kernel(render, ["intersect_kernel"])
    check(by["intersect_kernel"][1] == launches,
          f"the profiler saw {by['intersect_kernel'][1]} kernel launches")
    # the film's conversion: no TF32 (a float64 product for reference)
    rgb = spec_mod.spectrum_to_rgb(img)
    rgb64 = img.double() @ torch.as_tensor(spec_mod._tables()[1].T,
                                           dtype=torch.float64, device=dev)
    conv_err = float((rgb.double() - rgb64).abs().max()
                     / rgb64.abs().max())
    check(rgb.shape == (96, 96, 3) and conv_err < 1e-6
          and torch.equal(rgb.cpu(), spec_mod.spectrum_to_rgb(img.cpu())),
          f"spectrum_to_rgb on the card: rel err {conv_err}")
    pass_row = {
        "spp": spp, "lanes": n_rays,
        "render_cuda_ms": render_ms,
        "samples_per_s": 96 * 96 * spp / (render_ms / 1e3),
        "device_ms": dev_ms, "intersect_device_ms": by["intersect_kernel"][0],
        "intersect_share": by["intersect_kernel"][0] / dev_ms,
        "idle_share": 1.0 - dev_ms / render_ms, "peak_mib": peak_mb,
        "peak_bytes_per_lane": peak_mb * 2**20 / n_rays,
        "launches": launches,
        "kernel_vs_twin_max_abs_err": worst, "spectrum_to_rgb_rel_err":
        conv_err}
    print("hero pass in process, 128 spp halton, hero_path_mis: "
          + json.dumps(pass_row))
    out["pass"] = pass_row
    out["kernel"] = {"launches": launches, "max_abs_err": worst,
                     "ms": k_ms, "plain_ms": twin_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "rays": n_rays}
    # (c) 8-spp means against pbrt_tpu's
    out["means"] = {}
    for integrator, ref_mean in REF_HERO_MEANS.items():
        m = float(spec_mod.spectrum_to_rgb(
            render(integrator, HERO_MEAN_SPP)).double().mean())
        rel = abs(m - ref_mean) / ref_mean
        out["means"][integrator] = {"mean": m, "ref": ref_mean, "rel": rel}
        print(f"hero file {integrator} in process, {HERO_MEAN_SPP} spp: "
              + json.dumps(out["means"][integrator]))
        check(rel < 1e-4, f"{integrator}: mean off pbrt_tpu's by rel {rel}")
    return out


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load_all()
    print(f"kernel and host-builder builds (in parallel) "
          f"{ {k: round(v, 1) for k, v in _build.load.build_seconds.items()} }"
          f" s (wall {time.perf_counter() - t0:.1f} s)")
    ptxas = {}
    for name in _build.KERNELS:
        log = _build.load.ptxas_log.get(name, "")
        if name in ("fused_path", "intersect", "kexp_traverse"):
            ptxas[name] = ptxas_summary(log)
            check(ptxas[name], f"no ptxas report for {name}")
            print(f"{name} kernels [registers, spill store bytes, spill load "
                  f"bytes]: " + json.dumps(ptxas[name]))
        else:
            print(log.strip()[-1500:])
    check(all(v[1] == 0 for v in ptxas["kexp_traverse"].values()),
          "an instantiation of the wide-BVH kernel spills")

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
    bb.bvh_traverse_binary.launches = 0
    t0 = time.perf_counter()
    img = render_mod.render(scene, cam, spp=SPP, integrator="path",
                            max_depth=MAX_DEPTH, chunk_spp=CHUNK,
                            device="cuda")
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = fp.fused_bounce.launches
    check(launches == SPP // CHUNK, f"{launches} kernel launches")
    check(ik.intersect_brute.launches == 0 and bk.bvh_traverse.launches == 0
          and bb.bvh_traverse_binary.launches == 0,
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

    # the sweeps the kernel's warps (32 paths) execute on ended paths, and
    # what warps of 64 paths (two per thread) would, from the residuals
    dead = {}
    for per_warp in (32, 64):
        live_s, exec_s = fp.sweep_counts(res_k[0], kw["mode"], per_warp)
        dead[per_warp] = {
            "live_sweeps": live_s.tolist(), "executed_sweeps": exec_s.tolist(),
            "dead_share": round(1.0 - float(live_s.sum() / exec_s.sum()), 5)}
    print("fused kernel sweeps per bounce on the main path (live paths, "
          "executed by warps of 32 and of 64 paths, share on ended paths): "
          + json.dumps(dead))
    sweeps = (MAX_DEPTH + 1) + MAX_DEPTH          # mode 1: bench.py:173
    mrays = W * H * SPP * sweeps / (ms["render_64spp"] / 1e3) / 1e6
    timing = {k: round(v, 4) for k, v in ms.items()}
    print("times (ms, CUDA events): " + json.dumps(timing))
    print(f"forward Mrays/s (sweeps/sample {sweeps}, forward only): "
          f"{mrays:.1f}; peak memory of the main-path render "
          f"{peak_mb:.1f} MiB")

    check(math.isfinite(mrays), f"rate {mrays}")
    fused_bound_ms, fused_bound_by = fused_bound(scene_d, res_k[0])

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
    bb.bvh_traverse_binary.launches = 0
    for key, sc in (("portal_portal", entry._portal_scene(strategy="portal")),
                    ("sphere_cornell", entry._sphere_cornell())):
        render_loop(key, sc, "path", W, SPP, per_pass[key] * (SPP // CHUNK))
    loop_launches = ik.intersect_brute.launches
    check(fp.fused_bounce.launches == 0 and bk.bvh_traverse.launches == 0
          and bb.bvh_traverse_binary.launches == 0,
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
    n_m = o_m.shape[0]
    inf_m = torch.full((n_m,), math.inf, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(2)
    o_rand = (torch.rand(n_m, 3, generator=gen) * 0.9 + 0.05).to(dev)
    d_rand = torch.nn.functional.normalize(
        torch.randn(n_m, 3, generator=gen), dim=-1).to(dev)
    check(ik._lib().intersect_render_design() in INTERSECT_DESIGNS,
          "the render path's design")
    ims, ibound, iturns, in_pass_i = {}, {}, {}, {}
    for name, sc in tables.items():
        tabs = ik.pack_scene(sc)
        counts = (sc.n_tri, sc.n_sph, sc.n_pln)

        def ikern_fn():
            return ik.intersect_brute(*tabs, o_m, d_m, inf_m, *counts)

        def itwin_fn():
            return ik._intersect_reference(*tabs, o_m, d_m, inf_m, *counts)

        got = ikern_fn()
        ims[f"kernel_{name}"] = sync_ms(ikern_fn, 5)
        ibound[name] = intersect_bound(sc, n_m)
        # the designs in turns, camera rays (coherent warps) and random
        # rays from inside the box (incoherent)
        for rname, o_t, d_t in (("camera", o_m, d_m),
                                ("random", o_rand, d_rand)):
            iturns[f"{name}_{rname}"] = turns(
                lambda dsg: ik._launch_design(*tabs, o_t, d_t, inf_m,
                                              *counts, dsg),
                INTERSECT_DESIGNS, 5)
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
        in_pass_i[key] = intersect_in_pass(lpass_fn, per_pass[key])
    print("intersect and generic-loop times (ms, CUDA events, "
          f"{o_m.shape[0]} rays per launch): "
          + json.dumps({k: round(v, 4) for k, v in ims.items()}))
    print("intersect bounds (ms, by): " + json.dumps(
        {k: [round(v[0], 5), v[1]] for k, v in ibound.items()}))
    print(f"intersect designs in turns (ms, CUDA events, {n_m} rays, tmax "
          "inf; bits 1 two rays per thread, 2 early reject): "
          + json.dumps(iturns))
    print("intersect kernel's device ms in one 32-spp pass of the generic "
          "loop by design, in turns (torch.profiler): "
          + json.dumps(in_pass_i))
    print(f"peak memory of the generic loop's 64-spp renders "
          f"{loop_peak_mb:.1f} MiB")

    # ---- 9. the traversal kernels vs their twins, and BVH vs brute force
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
    # bit for bit: an empty slot of a 4-wide record holds −1, a NaN's bits
    check(torch.equal(rebuilt.nodes.view(torch.int32),
                      hf.bvh.nodes.view(torch.int32))
          and torch.equal(rebuilt.tris, hf.bvh.tris), "rebuild differs")
    check(hf.fused_profile is None, "the BVH scene is in the fused profile")
    print(f"heightfield cornell: {hf.n_tri} triangles, {hf.bvh.lo.shape[0]} "
          f"binary nodes, {hf.bvh.nodes.shape[0]} 4-wide nodes, "
          f"{hf.bvh.prim_order.shape[0]} leaf triangles, stack need "
          f"{hf.bvh.stack_need} of {bk.STACK} (binary walk "
          f"{bb.binary_layout(hf.bvh, dev)[2]} of {bb.STACK}); scene build "
          f"{t_scene:.2f} s, of it tree build + pack {t_tree:.2f} s "
          f"({hf.bvh.built_by})")
    hl = heightfield_scene(dev, 48, split="hlbvh")
    check(hl.bvh.built_by == "numpy-hlbvh" and hl.n_tri == 7498, "hlbvh tree")
    trees = {"soup_600": soup_scene(dev).bvh, "heightfield_cornell": hf.bvh,
             "hlbvh_7498": hl.bvh}
    before = (bk.bvh_traverse.launches, bb.bvh_traverse_binary.launches)
    traverse_err = binary_err = 0.0
    ties = n_cmp = 0
    for name, tree in trees.items():
        binary_err = max(binary_err, check_binary(name, tree, dev))
        err, tie, n = check_traverse(name, tree, dev)
        traverse_err, ties, n_cmp = max(traverse_err, err), ties + tie, \
            n_cmp + n
    # per tree and ray set: the binary check 3 launches of the binary
    # kernel; the 4-wide check 2 × 3 + 1 of the 4-wide kernel, 2 binary
    check((bk.bvh_traverse.launches, bb.bvh_traverse_binary.launches)
          == (before[0] + 3 * 3 * 7, before[1] + 3 * 3 * 5),
          "traversal launches")
    print(f"4-wide kernel against the binary kernel on {n_cmp} closest-hit "
          f"rays: t bit-equal, {ties} rays name another triangle (exact "
          "ties)")
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
    bb.bvh_traverse_binary.launches = 0
    sort_calls = []
    t0 = time.perf_counter()
    with counting_sorts(sort_calls):
        img = render_mod.render(entry._heightfield_cornell(),
                                entry._camera((W, H)), spp=SPP,
                                integrator="path", max_depth=MAX_DEPTH,
                                chunk_spp=CHUNK, device="cuda")
        torch.cuda.synchronize()
    t_bvh_first = time.perf_counter() - t0
    bvh_launches = bk.bvh_traverse.launches
    bvh_brute_launches = ik.intersect_brute.launches
    bvh_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    mean_full = float(img.double().mean())
    print(f"BVH slice heightfield_cornell path {W}² × {SPP} spp: mean "
          f"{mean_full!r}, {bvh_launches} launches of the 4-wide kernel, "
          f"{bb.bvh_traverse_binary.launches} of the binary kernel, "
          f"{len(sort_calls)} ray sorts, {bvh_brute_launches} brute-force "
          f"launches, {fp.fused_bounce.launches} fused launches, scene build "
          f"+ render {t_bvh_first:.2f} s, peak memory {bvh_peak_mb:.1f} MiB")
    check(img.shape == (H, W, 3) and img.device.type == "cuda",
          f"image {tuple(img.shape)} on {img.device}")
    check(bool(torch.isfinite(img).all()), "non-finite image")
    check(mean_full > 0.05, "the scene does not light up")
    want = per_pass_bvh * (SPP // CHUNK)
    check(bvh_launches == want and bvh_brute_launches == want,
          f"{bvh_launches} traversal and {bvh_brute_launches} brute-force "
          f"launches, the loop implies {want} each")
    check(bb.bvh_traverse_binary.launches == 0 and not sort_calls,
          "the render sorted rays or launched the binary kernel")
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

    # ---- 11. timings of the traversal kernels and the BVH pass
    tree = hf.bvh
    n_m = o_m.shape[0]
    o_b, d_b = kexp_prep.bounce_rays(hf, o_m, d_m)
    d_sh, tmax_sh = kexp_prep.shadow_rays(hf, o_b)
    tms, tstats, bstats, under = {}, {}, {}, {}
    kernels = {
        "binary": lambda *a: bb.bvh_traverse_binary(tree, *a),
        "plain": lambda *a: bk.bvh_traverse(tree, *a, persistent=False),
        "persistent": lambda *a: bk.bvh_traverse(tree, *a)}
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
        for mode, any_hit in (("closest", False), ("any", True)):
            # in turns: binary, plain, persistent, persistent, plain, binary
            for kname in ("binary", "plain", "persistent", "persistent",
                          "plain", "binary"):
                def tk_fn(fn=kernels[kname]):
                    return fn(o_r, d_r, tmax_r, any_hit)

                tk_fn()
                key_ms = f"{kname}_{mode}_{rname}"
                tms[key_ms] = tms.get(key_ms, 0.0) + sync_ms(tk_fn, 5) / 2

            def sorted_fn():
                return bb.bvh_traverse_binary(tree, o_s, d_s, tmax_s, any_hit)

            sorted_fn()
            tms[f"binary_{mode}_{rname}_sorted"] = sync_ms(sorted_fn, 5)
        # the twins, in the callers' order, on every lane for the camera
        # rays and on every 16th lane for the bounce and shadow rays;
        # shadow rays as the any-hit query
        step = 1 if rname == "camera" else 16
        any_hit = rname == "shadow"
        mode = "any" if any_hit else "closest"
        o_t, d_t, tmax_t = (x[::step].contiguous()
                            for x in (o_r, d_r, tmax_r))
        for kname, kern_fn, twin_fn, st in (
                ("bvh_traverse", bk.bvh_traverse, bk.traverse_reference,
                 tstats),
                ("bvh_binary", bb.bvh_traverse_binary, bb._traverse_reference,
                 bstats)):
            got = kern_fn(tree, o_t, d_t, tmax_t, any_hit)
            torch.cuda.synchronize()
            stats = {}
            t0 = time.perf_counter()
            want_t = twin_fn(tree, o_t, d_t, tmax_t, any_hit, stats=stats)
            torch.cuda.synchronize()
            tms[f"twin_{kname}_{mode}_{rname}_{o_t.shape[0]}_lanes"] = \
                1e3 * (time.perf_counter() - t0)
            check(torch.equal(got[1] >= 0, want_t[1] >= 0)
                  and (any_hit or (torch.equal(got[1], want_t[1])
                                   and torch.equal(got[0], want_t[0]))),
                  f"{kname} differs from its twin at {o_t.shape[0]} {rname} "
                  "rays")
            st[rname] = {k: v * step for k, v in stats.items()}
            if rname == "camera":
                err = float((got[0] - want_t[0]).abs().max())
                if kname == "bvh_traverse":
                    traverse_err = max(traverse_err, err)
                else:
                    binary_err = max(binary_err, err)
        if rname != "shadow":
            # the brute-force kernel as the BVH path calls it on these rays
            under[rname] = check_brute_under_bvh(hf, rname, o_r, d_r, tmax_r,
                                                 reps=5)
    twin_ms = tms[f"twin_bvh_traverse_closest_camera_{n_m}_lanes"]
    binary_twin_ms = tms[f"twin_bvh_binary_closest_camera_{n_m}_lanes"]
    under_bound = intersect_bound(hf, n_m, tris=False)
    wide_bytes = 4 * (tree.nodes.numel() + tree.tris.numel())
    bin_nodes, bin_tris, _ = bb.binary_layout(tree, dev)
    bin_bytes = 4 * (bin_nodes.numel() + bin_tris.numel())
    tbound = {r: traverse_bound(wide_bytes, n_m, tstats[r], bstats[r])
              for r in tstats}
    bbound = {r: traverse_bound(bin_bytes, n_m, tstats[r], bstats[r])
              for r in bstats}
    cfg_b = render_mod.RenderConfig(max_depth=MAX_DEPTH)

    def bpass_fn():
        return render_mod.render_pass(hf, cam_d, filt, cfg_b, W, H, CHUNK, 0,
                                      dev)

    def brender_fn():
        return render_mod.render(hf, cam_d, spp=SPP, max_depth=MAX_DEPTH,
                                 chunk_spp=CHUNK, device=dev)

    # the render path as it is against the one before the 4-wide kernel
    # (the ray sort, then the binary kernel), in turns: old, new, new, old
    img_new = bpass_fn()
    with old_bvh_path():
        img_old = bpass_fn()
    n_diff = int(((img_new - img_old).abs().amax(-1) > 1e-4).sum())
    rel_old = abs(float(img_new.mean() - img_old.mean())) / float(
        img_old.mean())
    check(rel_old < 1e-4, f"old and new BVH paths differ by rel {rel_old}")
    for label, reps_p, reps_r in (("old", 3, 2), ("new", 3, 2),
                                  ("new", 3, 2), ("old", 3, 2)):
        with old_bvh_path() if label == "old" else contextlib.nullcontext():
            for key_ms, fn, reps in (
                    (f"pass_32spp_{label}", bpass_fn, reps_p),
                    (f"render_64spp_{label}", brender_fn, reps_r)):
                tms[key_ms] = tms.get(key_ms, 0.0) + sync_ms(fn, reps) / 2
    # the kernel's device time per launch inside a pass, by torch.profiler:
    # the grid and the harness's L2 window each way (on a stream of its own
    # either way), in turns, then the old path
    frags = ["bvh_traverse_kernel", "bvh_binary_kernel", "intersect_kernel"]
    in_pass = {}
    for persistent, window in ((False, False), (False, True),
                               (True, False), (True, True), (True, True),
                               (True, False), (False, True), (False, False)):
        with contextlib.ExitStack() as stack:
            stack.enter_context(kk.l2_window(hf.bvh, window))
            if not persistent:
                stack.enter_context(plain_grid())
            dev_ms, by_kernel = device_ms_by_kernel(bpass_fn, frags)
        ms_k, n_k = by_kernel["bvh_traverse_kernel"]
        check(n_k == per_pass_bvh, f"{n_k} traversal launches in a pass")
        label = (f"{'persistent' if persistent else 'plain'}_"
                 f"l2_{'on' if window else 'off'}")
        in_pass.setdefault(label, []).append(
            {"pass_device_ms": round(dev_ms, 3),
             "traverse_ms_per_launch": round(ms_k / n_k, 5)})
    in_pass_i["heightfield_cornell"] = intersect_in_pass(bpass_fn,
                                                          per_pass_bvh)
    print("intersect kernel's device ms in one 32-spp BVH pass by design, "
          "in turns (torch.profiler): "
          + json.dumps(in_pass_i["heightfield_cornell"]))
    with old_bvh_path():
        dev_old, by_old = device_ms_by_kernel(bpass_fn, frags)
    in_pass["old_path"] = {"pass_device_ms": round(dev_old, 3), **{
        k: [round(v[0], 4), v[1]] for k, v in by_old.items()}}
    print(f"traversal and BVH-pass times (ms, CUDA events; twins: host clock "
          f"around one run; {n_m} rays per launch, {tree.nodes.shape[0]} "
          f"4-wide nodes, {tree.lo.shape[0]} binary nodes): "
          + json.dumps({k: round(v, 4) for k, v in tms.items()}))
    print(f"old (ray sort + binary kernel) vs new BVH pass: {n_diff} pixels "
          f"differ by more than 1e-4, means rel {rel_old:.3g}")
    print("traversal tests per launch (counted by the twins; bounce and "
          "shadow rays: every 16th lane, scaled): " + json.dumps(
              {"bvh_traverse": tstats, "bvh_binary": bstats}))
    print("traversal bounds (ms, by): " + json.dumps(
        {"bvh_traverse": {k: [round(v[0], 5), v[1]] for k, v in
                          tbound.items()},
         "bvh_binary": {k: [round(v[0], 5), v[1]] for k, v in
                        bbound.items()}}))
    print(f"intersect kernel under the BVH (0 triangles, {hf.n_sph} sphere, "
          f"{hf.n_pln} aaplane; {n_m} rays per launch; ms, CUDA events): "
          + json.dumps({k: {m: v[m] if m == "designs" else round(v[m], 4)
                            for m in ("ms", "plain_ms", "designs")}
                        for k, v in under.items()})
          + f", bound {under_bound[0]:.5f} ms by {under_bound[1]}")
    print("one 32-spp BVH pass under torch.profiler (device ms; 4-wide "
          "kernel per launch), by launch choice, in the order run; then the "
          "old path's device ms and [ms, launches] by kernel: "
          + json.dumps(in_pass))

    # ---- 12. the shared-memory probe
    probe = check_probe(dev)

    # ---- 13. the wide-BVH kernel vs its twin and vs the binary kernel
    before = kk.traverse.launches
    kexp_err, kexp_threads = 0.0, {}
    for name, tree_n in trees.items():
        err_n, kexp_threads[name] = check_wide(name, tree_n, dev,
                                               probe["limit_kb"])
        kexp_err = max(kexp_err, err_n)
    check(kk.traverse.launches == before + len(trees) * len(WIDE_CONFIGS)
          * WIDE_CHECK_LAUNCHES, "wide-kernel launches")
    lay_full = kexp_run.layout_of(kexp_prep.tree_arrays(tree), dev)

    def wide_fn():
        return kk.traverse(lay_full, o_m, d_m, inf_m, any_hit=False,
                           variant=2)

    got = wide_fn()
    kexp_ms = sync_ms(wide_fn, 5)
    wstats, want = {}, []
    kexp_twin_ms = sync_ms(lambda: want.extend(kk._traverse_wide_reference(
        lay_full, o_m, d_m, inf_m, any_hit=False, variant=2, stats=wstats)),
        1)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"wide kernel differs from the twin at {n_m} camera rays")
    kexp_err = max(kexp_err, float((got[0] - want[0]).abs().max()))
    kexp_bound = wide_bound(lay_full, 2, n_m, wstats)
    print(f"kexp_traverse variant 2, wide 4 / leaf 16, {n_m} camera rays of "
          f"the heightfield tree: equal to the twin; kernel {kexp_ms:.4f} ms "
          f"(CUDA events, 5 launches), twin {kexp_twin_ms:.1f} ms (CUDA "
          f"events, one run); tests counted by the twin "
          + json.dumps(wstats)
          + f"; bound {kexp_bound[0]:.5f} ms by {kexp_bound[1]}")

    # ---- 14. the kernel-experiment harness at full width
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    bk.bvh_traverse.launches = 0
    bb.bvh_traverse_binary.launches = 0
    kk.traverse.launches = 0
    kk.smem_probe.launches = 0
    check(kk.smem_limit_kb(dev) == probe["limit_kb"], "the cached limit")
    check(kk.smem_probe.launches == 0, "the limit was probed again")
    t0 = time.perf_counter()
    soup = entry._triangle_soup()
    check(soup.n_tri == 100000 and soup.bvh.built_by.startswith("native-"),
          f"the soup: {soup.n_tri} triangles, {soup.bvh.built_by}")
    print(f"triangle soup: {soup.n_tri} triangles, {soup.bvh.lo.shape[0]} "
          f"binary nodes, {soup.bvh.nodes.shape[0]} 4-wide nodes, "
          f"{soup.bvh.prim_order.shape[0]} leaf triangles, stack need "
          f"{soup.bvh.stack_need}, {soup.bvh.built_by}, scene build "
          f"{time.perf_counter() - t0:.2f} s")
    matrix, steps, agree, warp, expected = run_harness(
        {"heightfield": hf, "soup": soup}, W * H * CHUNK, W, dev)
    torch.cuda.synchronize()
    harness_launches = (kk.traverse.launches, bk.bvh_traverse.launches,
                        bb.bvh_traverse_binary.launches,
                        kk.smem_probe.launches)
    harness_peak_mb = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"harness ms per {W * H * CHUNK}-ray launch (CUDA events; closest "
          "hit, shadow rays any-hit): " + json.dumps(matrix))
    print("harness Mrays/s: " + json.dumps(
        {sc: {lab: {k: round(W * H * CHUNK / v / 1e3, 1)
                    for k, v in row.items() if k in HARNESS_SETS}
              for lab, row in rows.items()} for sc, rows in matrix.items()}))
    print("harness steps per ray (count mode): " + json.dumps(steps))
    print("harness warp efficiency (count mode; steps over 32 × the longest "
          "walk of each 32 consecutive rays): " + json.dumps(warp))
    print("harness [prim_agreement, max_abs_dt] against the binary twin: "
          + json.dumps(agree))
    print(f"harness launches: {harness_launches[0]} of the kexp kernel, "
          f"{harness_launches[1]} of the 4-wide kernel, "
          f"{harness_launches[2]} of the binary kernel, "
          f"{harness_launches[3]} of the probe; peak memory "
          f"{harness_peak_mb:.1f} MiB; builds "
          f"{ {k: round(v, 1) for k, v in _build.load.build_seconds.items()} }"
          " s")
    check(harness_launches == expected, f"harness launches, expected "
          f"{expected}")
    check(fp.fused_bounce.launches == 0, "fused launches in the harness")

    # ---- 15. scene files
    t0 = time.perf_counter()
    files = scene_files(dev, mean_full, hf.n_tri)
    files["phase_s"] = time.perf_counter() - t0
    print(f"scene-file phase {files['phase_s']:.1f} s")

    # ---- 16. hero-wavelength spectral rendering
    t0 = time.perf_counter()
    hero = hero_files(dev)
    hero["phase_s"] = time.perf_counter() - t0
    print(f"hero phase {hero['phase_s']:.1f} s")

    print(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "fused_path", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/fused_path.cu",
        "replaces": "pbrt_tpu/ops/fused_path.py:107",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms["kernel"], "plain_ms": ms["twin"],
        "bound_ms": fused_bound_ms, "bound_by": fused_bound_by,
        "library_ms": None,
        # the share of executed sweeps that fall on ended paths (warps of
        # 32 paths, and of 64 as two per thread would run), registers and
        # spills of every instantiation
        "dead_share": {k: v["dead_share"] for k, v in dead.items()},
        "ptxas": ptxas["fused_path"]}, {
        "name": "intersect", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/intersect.cu",
        "replaces": "pbrt_tpu/ops/intersect_pallas.py:34",
        "launches": loop_launches, "max_abs_err": intersect_err,
        "ms": ims["kernel_sphere_cornell"],
        "plain_ms": ims["twin_sphere_cornell"],
        "bound_ms": ibound["sphere_cornell"][0],
        "bound_by": ibound["sphere_cornell"][1], "library_ms": None,
        "design_ms": iturns["sphere_cornell_camera"],
        "design_in_pass_ms": in_pass_i,
        "ptxas": ptxas["intersect"],
        # the same kernel at the BVH path's call shape (no triangles, one
        # sphere, one aaplane, tmax from the traversal; bounce rays)
        "bvh_path": {"launches": bvh_brute_launches,
                     "max_abs_err": under["bounce"]["err"],
                     "ms": under["bounce"]["ms"],
                     "plain_ms": under["bounce"]["plain_ms"],
                     "bound_ms": under_bound[0],
                     "bound_by": under_bound[1]},
        # the hero pass (phase 16): launches of its timed 128-spp render,
        # the largest error over all its queries, times and bound on its
        # camera rays
        "hero_path": hero["kernel"]}, {
        # the render path's kernel as the render launches it; camera rays
        # of the heightfield tree in the callers' order (bounce and shadow
        # rays, the other grid and the L2 window in the lines above)
        "name": "bvh_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": "pbrt_tpu/ops/bvh_pallas.py:98",
        "launches": bvh_launches, "max_abs_err": traverse_err,
        "ms": tms["persistent_closest_camera"],
        "plain_ms": twin_ms, "bound_ms": tbound["camera"][0],
        "bound_by": tbound["camera"][1], "library_ms": None}, {
        # the render path's kernel before the 4-wide one, now the harness's
        # yardstick
        # (its launches: the harness run's); the same camera rays
        "name": "bvh_binary", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh_binary.cu",
        "replaces": "pbrt_tpu/ops/bvh_pallas.py:98",
        "launches": harness_launches[2], "max_abs_err": binary_err,
        "ms": tms["binary_closest_camera"], "plain_ms": binary_twin_ms,
        "bound_ms": bbound["camera"][0], "bound_by": bbound["camera"][1],
        "library_ms": None}, {
        # variant 2 on wide 4 / leaf 16, no nodes staged: kernel, twin and
        # bound all on the 2,097,152 camera rays of the heightfield tree
        # (phase 13, whose largest error this is); the other variants are
        # in the matrix
        "name": "kexp_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/kexp_traverse.cu",
        "replaces": "tools/kexp_kernels.py:207",
        "launches": harness_launches[0], "max_abs_err": kexp_err,
        "ms": kexp_ms, "plain_ms": kexp_twin_ms, "bound_ms": kexp_bound[0],
        "bound_by": kexp_bound[1], "library_ms": None,
        "redesigned": True,
        # [registers, spill store bytes, spill load bytes] of the timed
        # instantiation (wide 4, triangle records, closest hit, unstaged)
        # and of every instantiation; the threads per block of phase 13's
        # staged launches
        "registers": ptxas["kexp_traverse"][
            "kexp_traverse_kernel<4,1,0,0,0,0>"],
        "ptxas": ptxas["kexp_traverse"], "staged_threads": kexp_threads}, {
        # ms and library_ms: CUDA events around 20 back-to-back calls;
        # device_ms and library_device_ms: the profiler's kernel time
        "name": "smem_probe", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/smem_probe.cu",
        "replaces": "tools/kexp_run.py:88",
        "launches": harness_launches[3], "max_abs_err": probe["err"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        # one (8,128) float32 read and one written
        "bound_ms": bound_ms(2 * 4 * 8 * kk.LANES, 8 * kk.LANES)[0],
        "bound_by": "bytes", "library_ms": probe["library_ms"],
        "device_ms": probe["device_ms"],
        "library_device_ms": probe["library_device_ms"]}],
        "scene_files": files, "hero": hero}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
