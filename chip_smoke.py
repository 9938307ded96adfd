"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Builds the seven kernels (csrc/fused_path.cu, csrc/intersect.cu,
   csrc/bvh_traverse.cu, csrc/bvh_binary.cu, csrc/kexp_traverse.cu,
   csrc/smem_probe.cu, csrc/kd_traverse.cu) with nvcc and the host BVH
   builder (csrc/bvh_builder.cpp) with g++, all at once, into
   build/kernels/ and prints the card, its power limit, the build times
   and, from ptxas, the registers and spills of every instantiation of the
   fused, the brute-force, the wide-BVH experiment and the kd kernel (the
   wide-BVH kernel must not spill).
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
   4,001-primitive table near pbrt_tpu's Pallas cap of 4,096 that spans
   several shared-memory tiles), for camera rays and for random rays with infinite
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
   to rel 1e-3 (pbrt_tpu's CPU traversal is too slow for the full size);
   the full-width render's sample index 0 (one 256² × 1-spp pass) against
   pbrt_tpu's CPU pass (tests/torch_bvh_full_width.json): the mean and
   the 16 × 16 block means to rel 1e-3, a block off on at most 1% of them.
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
   as subprocesses, three at once, on
   tests/oracle/{ao,deltalights,filter}_oracle.pbrt,
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
17. Textures, object instancing and participating media: the files
   tests/oracle/{texinst,volpath,gridvol}_oracle.pbrt (96², halton; an
   EWA-filtered imagemap floor and two instances of a mesh under `path`;
   a homogeneous and a grid medium in a null sphere under `volpath`; every
   query on the brute-force kernel). (a) The CLI as three subprocesses at
   once, at the files' own spp (128, 256, 256): 10, 92 and 92
   brute-force launches (MEDIA_FILES), each image against its reference
   with tests/test_oracle.py's limits. (b) In process, each file at 128
   spp (one pass of 1,179,648 lanes): every brute-force launch recorded
   and held against the twin bit for bit; the pass timed by CUDA events
   with its launches (counts set to 0 just before) and peak memory, and
   under torch.profiler (device time, the kernel's share). (c) Each file
   at 8 spp against pbrt_tpu's image mean (REF_MEDIA_MEANS) to rel 1e-4,
   and the gradient scene's (entry._fill_portal_grad_scene) image mean and
   gradients with respect to kd, emit and the portal's corners through
   the generic loop on the card against the CPU twins' within
   tests/test_torch_grad.py's tolerance.
18. Subsurface scattering: the CLI on sss and disney_sss against their
   reference images, every brute-force query of an in-process pass of
   each and every traversal query of a subsurface heightfield pass held to
   the twins, the 8-spp means against pbrt_tpu's, and the hero and
   volpath gradients on the card against the CPU's.
19. Bidirectional path tracing, the spatial light strategy and MLT. (a)
   The CLI with ``--integrator bdpt`` on caustic (96², 512 spp),
   deltalights (96², 256) and envcavity (48², 1024), three processes at
   once, against their reference images with tests/test_oracle.py's
   limits, with the launches ``bdpt.queries_per_chunk`` gives. (b) In
   process, ``render_bdpt`` of each file at 8 spp at pbrt_tpu's CPU chunk:
   every brute-force query held to the twin bit for bit, the mean against
   pbrt_tpu's op-by-op mean (REF_BDPT_MEANS) to rel 1e-4; envcavity's
   whole mean, which a few seam-flipped lanes move, to 1e-3, its pass lane
   for lane against the CPU twins (at most 2% of the lanes off) and its
   image pixel for pixel against the CPU twins' and theirs against
   pbrt_tpu's op-by-op image, the mean over the pixels where all three
   agree to rel 1e-4; one chunk timed (CUDA events, the device-only
   profiler, idle share, peak bytes a lane). (c) One
   256² × 32-spp chunk of ``_sphere_cornell()`` (2,097,152 camera lanes
   and as many light paths) with its peak, and a bdpt chunk of a
   heightfield with a BVH, every traversal and brute-force query held to
   the twins. (d) MLT on caustic with tests/test_oracle.py's budget
   against the reference image, its launches against the count from the
   code, its chain steps a second and the share of the steps spent in the
   splats; four steps of the same shapes with every query held to the
   twin; and MLT on the portal scene, every launch of the fused kernel
   held to its twin. (e) A 256² × 32-spp `path` pass under the spatial
   strategy of tests/test_lightdistrib.py's two-light scene against
   pbrt_tpu's mean (REF_SPATIAL_MEAN), its launches against the loop's
   count, and a second render with every query held to the twin.
20. SPPM and two-keyframe motion blur. (a) The CLI as two subprocesses
   at once: caustic with ``--integrator sppm`` at pbrt's defaults (64
   iterations of the pixel count of photons, radius 1.0), its launches
   ``sppm.queries_per_iteration`` an iteration, its image mean against
   pbrt_tpu's at the same call to rel 1e-4 (REF_SPPM_CLI_MEAN) and its md
   against the reference image recorded (pbrt_tpu's own is 0.2724 at that
   radius); dofmotion at the file's 256 spp against its reference image
   with tests/test_oracle.py's limits, every launch on the brute-force
   kernel's motion variant, as many as the loop implies. (b) caustic with
   tests/test_oracle.py's call (12 iterations of 65,536 photons, seed 1):
   every query of one iteration held to the twin bit for bit, the launches
   of the twelve, the time an iteration and the deposits' share (CUDA
   events), md < 0.04. (c) The full-width cell: ``_sphere_cornell()`` at
   256², 2^20 photons an iteration, 4 iterations: ms an iteration, peak
   MiB, launches, one iteration's device time (device-only profiler),
   idle share, and the deposit's device share (the same iteration
   profiled with the deposit left out). (d) A 96² × 64-spp `path` pass
   of dofmotion in process: every query on the motion variant held to its
   twin bit for bit, its launches (counts set to 0 just before), the
   camera rays' query timed against the twin and, in turns, against the
   static kernel on the same rays. (e) Phase 10's heightfield file with
   its cone moving (``ActiveTransform``; pbrt_tpu moves only
   ``trianglemesh`` shapes): a BVH over both keyframes without spatial
   splits, and a 256² × 32-spp `path` pass whose every traversal runs the
   traversal kernel's motion variant, each held to its twin bit for bit,
   the camera rays' query timed against the twin and, in turns, the
   static kernel.
21. Curves, the hair and Fourier materials and the other samplers. (a)
   tests/oracle/curves_oracle.pbrt (96², two cylinder curves, every query
   on the brute-force kernel, the curves folded in after it in plain
   torch): the CLI at the file's 256 spp (halton) in a subprocess, and in
   process at tests/test_oracle.py's call (64 spp, seed 2, `path`, the
   file's max_depth 3), each against curves_ref.pfm with that test's
   limits (md < 0.08, block rel-L1 < 0.08) and the launches the loop
   implies; every brute-force query of the in-process pass held to the
   twin bit for bit, and the curve fold's (t, prim, u, v) on 65,536 of the
   pass's camera rays against the same fold on the CPU (prims equal, t
   within rtol 1e-6 on all but 0.1% of the curve hits, u within 1e-5 and
   v within 1e-4, as tests/test_torch_curves.py holds the port to
   pbrt_tpu; the lanes off rtol 1e-6 counted for each). (b) The fur cell
   (entry._fur_scene: the file's ground, light and camera with 128 seeded
   hair strands), one 256² × 32-spp `path` pass of 2,097,152 lanes at
   max_depth 3: ms by CUDA events, kernel 2's launches by the wrapper's
   count, peak MiB and bytes a lane, the fold's tile; one query of the
   pass (the closest hit of its camera rays) under the device-only
   profiler: its device ms and the curve fold's share (the query profiled
   once more with the fold left out), kernel 2's one launch in it by the
   wrapper's count and its time on the query's inputs by CUDA events;
   the whole
   pass is not profiled, so its idle share is not measured; a 32 × 32
   crop of the pass's
   lanes at its first sample against the CPU twins, mean rel 1e-3. (c) Phase 10's
   heightfield file with curves_oracle's two curves (a BVH scene): one
   256² × 32-spp `path` pass, every traversal and every brute-force query
   held to the twins bit for bit, with their launches. (d) The Fourier
   furnace (tests/test_fourier.py's Lambertian table, rho 0.5, written by
   the port, on a sphere under a constant environment, 256² × 32 spp):
   the mean within 0.005 of 0.5; the hair's white furnace (tests/
   test_hair.py: sampled with sigma_a 0) over 2^20 samples within 0.01 of
   1. (e) Every sampler name on 2^20 seeded (pixel, sample, dim) triples
   (indices past 2^16, dims past 64): the card's values equal the CPU's
   bit for bit; a 256² × 4-spp `path` pass of _sphere_cornell() with each
   sampler a render takes against pbrt_tpu's CPU means
   (tests/torch_sampler_means.json), rel 1e-3.
22. The remaining paths. (a) The kd-tree cell: phase 10's heightfield
   cornell (133,130 triangles) with its triangles in a kd-tree
   (scene/kdtree.py, the host build timed), one 256² × 32-spp `path`
   pass at max_depth 4 (13 closest-hit launches of csrc/kd_traverse.cu,
   timed by CUDA events) and one `ao` pass (the integrator's default
   radius: a closest-hit walk and an any-hit walk): every walk of the two passes, closest-hit
   and any-hit, held to the twin bit for bit on 65,536 of its rays, the
   whole camera-ray and occlusion-ray walks too, the any-hit boolean
   against the closest-hit walk's on every occlusion ray, each image
   mean against the same pass on the BVH (the same samples, rel 1e-3),
   the camera rays' query (its launches by the wrappers' counts, its
   torch kernels' device time by the device-only profiler, the walk's
   and kernel 2's times on its inputs by CUDA events: the walk's share),
   the walk against kernel 3 on the camera, shadow (NEE), bounce and
   occlusion rays in turns (the occlusion rays through the any-hit walk
   and the closest-hit walk), and each instantiation's bound from the twin's node steps and
   triangle tests. (b) Kernel 2 past 4,096 primitives: one such pass on an
   8,204-primitive heightfield cornell without a BVH, timed, every query
   held to the twin on 65,536 rays. (c) The sharded path at world size 1
   over NCCL on the main path's scene: render_sharded at 256² × 64 spp
   against render() (rtol 2e-3, atol 3e-4), three training steps on kd
   and emit (ms a step, kernel 1's launches a step, the loss falls, the
   first step's gradients against single-process autograd of render(),
   rtol 2e-3, atol 1e-6), one step under the profiler (its device ms, top
   kernels, none of them torch's ``indexing_backward``, and the share of
   replay's material gather backward), dryrun_multichip(1); before them
   ``ops/fastgather.gather_rows`` on 4,194,304 lanes of tables of 5, 256
   and 4,096 rows (the forward equal to ``table[idx]``, the backward
   within rtol 1e-4 of a float64 ``index_add_``, both timed beside
   ``index_add_``, the one-hot product's backward at 256 rows and
   advanced indexing's at 5). (d) A render stopped after
   one pass and resumed equals the uninterrupted one; bsdftest on the
   card; imgtool makesky against tests/oracle/sky_ref.pfm.
23. The renderer's statistics (``RenderConfig.collect_stats``: the
   per-bounce counts of live lanes, which send the `path` pass through
   the wavefront loop, every closest hit on the brute-force kernel). (a)
   bench.py's own stats call (the portal scene at 256² × 1 spp, seed 0,
   max_depth 4, 65,536 lanes): its counts against pbrt_tpu's on the CPU
   (REF_LIVE_COUNTS), equal but for at most 7 lanes a bounce, each
   difference printed with the CPU twins' counts and the lanes whose
   radiance the card and the CPU disagree on. (b) The main path at full
   width with the stats (256² × 64 spp, two 2,097,152-lane passes through
   ``render_pass``): kernel 2's launches by the wrapper (the loop's
   static count), none of kernel 1 and no query on the CPU; every lane's
   radiance against the fused kernel's on the same lanes with phase 6's
   limits, the counts pass by pass against ``fused_path.live_mask`` of the
   fused launch's residual codes (at most 6e-3 of the lanes off), the
   render's ``live_per_bounce`` and ``dead_lane_frac``, the stats pass's
   time beside the fused pass's (CUDA events). (c)
   ``utils.stats.device_trace`` around one 1-spp stats pass writes a
   Chrome trace: its size and kernel records printed, nothing held on
   them. (d) ``entry.entry()`` on the card: one fused launch, the image
   mean against pbrt_tpu's ``__graft_entry__.entry()`` on the CPU
   (REF_ENTRY_MEAN) to rel 1e-3.
   Then prints a JSON line of the kernels (with each kernel's roofline
   bound computed from this run's inputs, the scene files' numbers
   under "scene_files" and the hero phase's under "hero") and {"ok": true,
   "device": {...}} as the last line.

Any failed check raises, so the script exits non-zero and prints no
result. It needs a CUDA device and never falls back to the CPU.
"""

import contextlib
import dataclasses
import io
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
from pbrt_tpu_torch.core import transform
from pbrt_tpu_torch.frontend import load_pbrt
from pbrt_tpu_torch.integrators import bdpt as bdpt_mod
from pbrt_tpu_torch.integrators import mlt as mlt_mod
from pbrt_tpu_torch.integrators import render as render_mod
from pbrt_tpu_torch.integrators import sppm as sppm_mod
from pbrt_tpu_torch.ops import _build
from pbrt_tpu_torch.ops import bvh as bk
from pbrt_tpu_torch.ops import bvh_binary as bb
from pbrt_tpu_torch.ops import fastgather
from pbrt_tpu_torch.ops import fused_path as fp
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.ops import kdtree as kd_ops
from pbrt_tpu_torch.parallel import multihost
from pbrt_tpu_torch.parallel import render as par_render
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene import bvh as bvh_mod
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import fourier as fourier_mod
from pbrt_tpu_torch.scene import hair as hair_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import kdtree as kd_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import shapes as shapes_mod
from pbrt_tpu_torch.scene.types import SceneBuilder, to_device
from pbrt_tpu_torch.tools import kexp_kernels as kk
from pbrt_tpu_torch.tools import bsdftest, imgtool, kexp_prep, kexp_run
from pbrt_tpu_torch.utils import checkpoint, imageio

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
# pbrt_tpu's live-lane counts of bench.py's stats call (render_pass with
# collect_stats on the portal scene, 256² × 1 spp, seed 0, max_depth 4)
# and the mean of __graft_entry__.entry()'s image (32² × 2 spp, the film's
# sum), on the CPU backend: ``PYTHONPATH=. python tests/test_torch_stats.py``
REF_LIVE_COUNTS = [65536, 62248, 45553, 36573, 29650]
REF_ENTRY_MEAN = 0.18277400063415797
LIVE_TIE_LANES = 7        # lanes a bounce that a float seam tie may flip
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
# sample index 0 of the 256² × 64-spp render (one 256² × 1-spp pass):
# pbrt_tpu's CPU mean and 16 × 16 block means, written by ``PYTHONPATH=.
# python tests/test_torch_bvh.py``
BVH_FULL_WIDTH = "tests/torch_bvh_full_width.json"
# phase 19: bdpt through the CLI at each file's own spp (--integrator bdpt)
# and the limits of tests/test_oracle.py (caustic and deltalights: md, bl;
# envcavity: the gap rule against its path and bdpt reference images)
BDPT_FILES = {"caustic": (512, 0.05, 0.30), "deltalights": (256, 0.02, 0.03),
              "envcavity": (1024, None, None)}
BDPT_MEAN_SPP = 8
# pbrt_tpu's float32 means on the CPU backend of render_bdpt of the three
# files at 8 spp, seed 0, the file's depth, its CPU chunk, printed by
# ``PYTHONPATH=. python tests/test_torch_bdpt_oracle.py``: evaluated op by
# op (``jax.disable_jit``), which rounds every operation as the port does;
# pbrt_tpu's jitted chunk contracts multiply-adds and so moves its hit
# points in the last bits. A bdpt lane whose ray grazes an edge flips on
# such bits, and envcavity's mean moves with a few flipped lanes: on an
# H100 the mean read rel 3.8e-4 from the op-by-op mean and 1.09e-3 from
# the jitted one (0.42151010650074267), the CPU twins' 2.3e-4 and 9.4e-4. So
# envcavity's whole mean is held to 1e-3, and rel 1e-4 holds pixel for
# pixel: the card's image against the CPU twins' and the twins' against
# pbrt_tpu's op-by-op image (BDPT_ENV_REF, written by the same script),
# rtol 2e-5 / atol 1e-6, the mean over the pixels where all three agree
# to rel 1e-4 and at most BDPT_PIXELS_OFF_SHARE of the pixels off (a
# pixel sums 2 × 8 lanes, its camera samples and about as many light
# paths; a seam tie may send 2% of the lanes elsewhere,
# tests/test_torch_bdpt.py)
REF_BDPT_MEANS = {"caustic": 0.04212470132969691,
                  "deltalights": 0.4407145513244575,
                  "envcavity": 0.42180969940252705}
BDPT_MEAN_REL = {"caustic": 1e-4, "deltalights": 1e-4, "envcavity": 1e-3}
BDPT_ENV_REF = "tests/torch_bdpt_envcavity_ref.npy"
BDPT_PIXELS_OFF_SHARE = 2 * BDPT_MEAN_SPP * 0.02
# phase 19's MLT runs: brute-force queries of one `path` pass on caustic
# (max_depth 6, a sphere light: a closest hit, the NEE ray and the BSDF
# half's ray per full bounce, then the last bounce's closest hit), and
# fused launches of one pass on the portal scene. A render evaluates its
# target once a bootstrap block of at most MLT_BOOT_BLOCK lanes on the
# card (integrators/mlt.py::bootstrap), once for the start states and
# once a step.
MLT_CAUSTIC_PER_PASS = 6 * 3 + 1
MLT_PORTAL_PER_PASS = 1
MLT_BOOT_BLOCK = 1 << 21
# the spatial pass: two point lights, so a closest hit and the NEE ray a
# full bounce, then the last bounce's closest hit
SPATIAL_PER_PASS = MAX_DEPTH * 2 + 1
# phase 20: SPPM on caustic at tests/test_oracle.py's call (iterations,
# photons an iteration, seed) and its limit; the CLI at pbrt's defaults
# (64 iterations, the pixel count of photons, radius 1.0, seed 0), held to
# pbrt_tpu's image mean at the same call (`PYTHONPATH=.:tests python
# tests/test_torch_sppm.py`, its jitted render_sppm on the CPU; its md
# against the reference is 0.2724: the wide radius's estimate, not the
# port's); the full-width cell (iterations,
# photons an iteration on _sphere_cornell() at 256²)
SPPM_ORACLE, SPPM_ORACLE_MD = (12, 1 << 16, 1), 0.04
REF_SPPM_CLI_MEAN, SPPM_CLI_MEAN_REL = 0.05425266715198202, 1e-4
SPPM_FULL = (4, 1 << 20)
# dofmotion through the CLI at the file's 256 spp, tests/test_oracle.py's
# limits (md, block rel-L1); the in-process pass of every query held
DOFMOTION_SPP, DOFMOTION_LIMITS = 256, (0.01, 0.03)
DOF_PASS_SPP = 64
# phase 21: curves_oracle through the CLI at the file's 256 spp (halton)
# and in process at tests/test_oracle.py's call (64 spp, seed 2, the
# render's independent sampler), both to that test's limits (md, block
# rel-L1); the card's curve fold against the CPU's on this many of the
# pass's camera rays
CURVES_FILE, CURVES_REF = ("tests/oracle/curves_oracle.pbrt",
                           "tests/oracle/curves_ref.pfm")
CURVES_SPP, CURVES_CLI_SPP, CURVES_LIMITS = 64, 256, (0.08, 0.08)
CURVE_FOLD_RAYS = 1 << 16
# the fur cell: 128 strands (entry._fur_scene), 256² × 32 spp, max_depth
# 3; a crop of its lanes held to the CPU twins, (px0, py0, width,
# height) at its first sample (1,024 lanes: the twins' fold over 128
# curves is slow on the card's host CPU)
FUR_STRANDS, FUR_SPP, FUR_DEPTH = 128, 32, 3
FUR_CROP, FUR_CROP_SPP = (112, 112, 32, 32), 1
# the Fourier furnace (tests/test_fourier.py: a Lambertian table of rho
# 0.5 on a sphere under a constant environment, max_depth 2) at 256² ×
# 32 spp, and the hair's white furnace (tests/test_hair.py) over 2^20
# samples, to these limits
FOURIER_FURNACE = (0.5, 0.005)
HAIR_FURNACE_N, HAIR_FURNACE_ATOL = 1 << 20, 0.01
# the samplers: 2^20 seeded (pixel, sample, dim) triples each, on the
# card and on its CPU; then a 256² × 4-spp `path` pass of
# _sphere_cornell() with each sampler a render takes, against pbrt_tpu's
# CPU means (``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
# tests/test_torch_samplers.py`` writes them), rel 1e-3
SAMPLER_NAMES = (("sobol", (256, 256)), ("sobol", None),
                 ("zerotwosequence", None), ("lowdiscrepancy", None),
                 ("02sequence", None), ("halton", None),
                 ("halton_cp", None), ("stratified", None),
                 ("maxmindist", None))
SAMPLER_DIMS = (0, 1, 2, 3, 7, 64, 65, 130, 300)
SAMPLER_MEANS = "tests/torch_sampler_means.json"
# phase 22: the kd-tree cell (phase 10's heightfield cornell with its
# triangles in a kd-tree), one 256² × 32-spp `path` pass at max_depth 4;
# the walk held to its twin on this many rays of each query (every
# R / 65,536-th); the float operations of a node step (the min of its
# tmax, the split plane's subtract and multiply)
KD_SPP, KD_DEPTH, KD_SUBSET, OPS_NODE = 32, 4, 1 << 16, 3
# kernel 2 past 4,096 primitives: _fill_heightfield_cornell at (n, n_phi,
# n_z) = 8,202 triangles, a sphere and the light's aaplane, no BVH
BRUTE_BIG_HF = (64, 16, 8)
# the sharded path at world size 1 on the main path's scene: bench.py's
# workload (256², 64 spp, max_depth 4); three SGD steps on kd and emit
# against a black target at this rate
SHARD_SPP, TRAIN_STEPS, TRAIN_LR = 64, 3, 1.0
# pbrt_tpu's float32 CPU mean of a 256² × 32-spp `path` render of
# tests/test_lightdistrib.py's two-light scene under the spatial strategy
# (max_depth 4, seed 0), printed by ``PYTHONPATH=. python
# tests/test_torch_lightdistrib_mlt.py``
REF_SPATIAL_MEAN = 0.0034579210927496717
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
# The media phase (17): per file, the CLI's spp (the file's own), the
# brute-force queries a pass makes (path: a closest hit, the NEE ray and
# the BSDF half's ray on each full bounce, then the last bounce's closest
# hit; volpath: the bounce's ray, four shadow segments and four segments
# of the scattering-strategy walk on each full bounce, then the last
# bounce's ray), the passes of 2^21 lanes the CLI cuts its spp into, and
# tests/test_oracle.py's limits (mean delta, block rel-L1).
MEDIA_FILES = {"texinst": (128, 3 * 3 + 1, 1, 0.01, 0.03),
               "volpath": (256, 5 * 9 + 1, 2, 0.02, 0.06),
               "gridvol": (256, 5 * 9 + 1, 2, 0.05, 0.08)}
MEDIA_PASS_SPP = 128     # the in-process pass: 96² × 128 = 1,179,648 lanes
# pbrt_tpu's float32 image means on the CPU backend of the three files at
# their own resolution, integrator and max depth, 8 spp, the halton
# sampler, seed 0, printed by ``PYTHONPATH=. python
# tests/test_torch_texinst.py`` and ``... tests/test_torch_volpath.py``.
MEDIA_MEAN_SPP = 8
REF_MEDIA_MEANS = {"texinst": 0.03901138345819349,
                   "volpath": 0.04115201333742233,
                   "gridvol": 0.044565141245070834}
# The subsurface phase (18): per file, the CLI's spp (the file's own), the
# brute-force queries a pass makes (path with an area light on a sphere:
# on each full bounce the closest hit, the probe chain's 8 segment
# queries, the NEE ray and the BSDF half's ray; then the last bounce's
# closest hit), the passes of at most 2^21 lanes the CLI cuts its spp into
# (227 + 29 spp) and tests/test_oracle.py's limits (mean delta, block
# rel-L1).
SSS_FILES = {"sss": (256, 5 * 11 + 1, 2, 0.008, 0.05),
             "disney_sss": (256, 5 * 11 + 1, 2, 0.05, 0.06)}
SSS_PASS_SPP = 128       # the in-process pass: 96² × 128 = 1,179,648 lanes
SSS_MEAN_SPP = 8
# entry._fill_sss_heightfield's (n, n_phi, n_z) for the BVH probe pass
SSS_HF = (64, 16, 8)
# pbrt_tpu's float32 image means on the CPU backend with `path`, the
# halton sampler, seed 0, 8 spp: the two files at their own resolution and
# max depth, and the subsurface heightfield (SSS_HF, no fog) at 64² with
# entry._camera, max_depth 5; printed by ``PYTHONPATH=. python
# tests/test_torch_sss.py``.
REF_SSS_MEANS = {"sss": 0.020924266349196165,
                 "disney_sss": 0.025893649941324308,
                 "heightfield": 0.353471971180386}
# tests/test_torch_grad.py's hero and volpath scenes: (file, 60-bin
# spectra, the parameters differentiated)
SSS_GRADS = (("cornell_dielectric", True, ("kd", "emit")),
             ("volpath", False, ("kd", "emit", "sigma_a", "sigma_s")))
# the gradient scene (entry._fill_portal_grad_scene): 16² × 4 spp, `path`
# through the generic loop at max_depth 3, the parameters differentiated
# and tests/test_torch_grad.py's tolerance (atol 1e-6 + 1e-4 × max |g|)
GRAD_PARAMS = ("kd", "emit", "portal_lo", "portal_hi")
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
# the motion variants' triangle test: OPS_TRI on the edges of the moved
# vertices, plus the lerp v + time·dv (9 multiplies, 9 adds) and the
# edges (6 subtracts)
OPS_TRI_MOTION = OPS_TRI + 24
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
    """A table near pbrt_tpu's Pallas cap of 4,096 primitives: the
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

    # (static scenes only: ``time`` is None)
    def tris(bvh, o, d, tmax, time=None):
        t, leaf_i = sorted_binary(bvh, o, d, tmax, False)
        hit = leaf_i >= 0
        return t, torch.where(hit, bvh.prim_order[leaf_i.long().clamp_min(0)],
                              -1), hit

    def p_tris(bvh, o, d, tmax, time=None):
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
    # (static scenes only: ``time`` is None)
    def tris(bvh, o, d, tmax, time=None):
        t, leaf_i = bk.bvh_traverse(bvh, o, d, tmax, False, persistent=False)
        hit = leaf_i >= 0
        return t, torch.where(hit, bvh.prim_order[leaf_i.long().clamp_min(0)],
                              -1), hit

    def p_tris(bvh, o, d, tmax, time=None):
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
    ..., b, a): {design: ms per pass, mean of the two turns, and
    "profile_traces": the traces taken in all}."""
    out, n_traces = {}, 0
    for dsg in list(INTERSECT_DESIGNS) + list(reversed(INTERSECT_DESIGNS)):
        with intersect_design(dsg):
            _, by, traces = device_ms_by_kernel(
                pass_fn, ["intersect_kernel"], cpu=False, want=n_launches)
        ms_k, n_k = by["intersect_kernel"]
        check(n_k == n_launches, f"{n_k} brute-force launches in a pass")
        out[dsg] = out.get(dsg, 0.0) + ms_k / 2
        n_traces += traces
    return {**{dsg: round(v, 4) for dsg, v in out.items()},
            "profile_traces": n_traces}


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


def device_ms_by_kernel(fn, frags, cpu=True, want=None):
    """Device time by kernel over one run of ``fn``, from torch.profiler:
    (total ms, {kernel-name fragment: [ms, launches]}, traces taken).
    Only the device's own rows count: a CPU op's row carries the device
    time of the kernels it launched again, so summing every row counts
    each kernel twice.
    ``cpu=False`` traces the device alone (no CPU op rows, a fraction of
    the overhead on a pass of many small launches). With ``want``, the
    launches each fragment's kernel must show: a trace of a pass of
    thousands of launches now and then lacks one record (seen: 9 of 10,
    33 of 34, 55 of 56, while the wrappers counted every launch), so such
    a trace is said and taken again, up to three times in all; the caller
    checks the last one's counts and keeps the number of traces in its
    row."""
    for traces in range(1, 4):
        total, by_name = _profile_once(fn, frags, cpu)
        seen = [by_name[frag][1] for frag in frags]
        if want is None or seen == [want] * len(frags):
            break
        print(f"the profiler saw {seen} launches of {frags}, not {want} "
              f"each (trace {traces} of at most 3)")
    return total, by_name, traces


def _profile_once(fn, frags, cpu):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]
                 + [ProfilerActivity.CPU] * cpu) as prof:
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


def top_kernels(fn, op, n=5):
    """One run of ``fn`` under the profiler, host and device: (device ms,
    the n kernels of most device time as [name, ms, launches], every
    kernel's name, the device ms of the host op named ``op`` with the
    kernels it launched, or None where no such op ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    rows = [(evt.key, evt.self_device_time_total / 1e3, evt.count)
            for evt in avgs if evt.device_type != DeviceType.CPU]
    rows.sort(key=lambda r: -r[1])
    op_ms = [evt.device_time_total / 1e3 for evt in avgs
             if evt.device_type == DeviceType.CPU and evt.key == op]
    return (sum(r[1] for r in rows), [[k[:90], ms, c] for k, ms, c in
                                      rows[:n]], [r[0] for r in rows],
            max(op_ms, default=None))


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

    _, k_dev, _ = device_ms_by_kernel(
        twenty(lambda: kk._probe_launch(x, top)), ["smem_probe_kernel"])
    _, a_dev, _ = device_ms_by_kernel(
        twenty(lambda: torch.add(x, x[0, 1])), ["add"])
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


def start_cli(scene_file, out, *args):
    """The CLI in a subprocess on the card, started; finish_cli waits."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pbrt_tpu_torch.utils.cli", scene_file, "-o",
         out, *args], cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return scene_file, proc, time.perf_counter()


def finish_cli(started):
    """Wait for a CLI started by start_cli; returns its summary line."""
    scene_file, proc, t0 = started
    try:
        _, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI on {scene_file}:\n{stderr}")
    lines = [ln for ln in stderr.splitlines()
             if ln.startswith("pbrt_tpu_torch: summary ")]
    check(len(lines) == 1, f"no summary from the CLI on {scene_file}")
    summary = json.loads(lines[0][len("pbrt_tpu_torch: summary "):])
    summary["process_s"] = wall
    return summary


def run_cli(scene_file, out, *args):
    """The CLI in a subprocess on the card; returns its summary line."""
    return finish_cli(start_cli(scene_file, out, *args))


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
        # (a) the CLI on each file at full width, three processes at once
        names = list(SCENE_FILES)
        started = {}
        for i, name in enumerate(names):
            if i % 3 == 0:
                started.update(
                    (n, start_cli(SCENE_FILES[n][0],
                                  os.path.join(tmp, f"{n}.pfm")))
                    for n in names[i:i + 3])
            path, (per_pass, passes), limits = SCENE_FILES[name]
            pfm = os.path.join(tmp, f"{name}.pfm")
            sm = finish_cli(started.pop(name))
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
            print(f"scene file {name} (CLI, three at once): "
                  + json.dumps(row))
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
            # a profile taken again counts its own run's launches
            ik.intersect_brute.launches = 0
            fp.fused_bounce.launches = 0
            images.clear()
            images.append(render_mod.render(
                scene, cam, spp=spp, integrator=opts["integrator"],
                sampler="halton", max_depth=opts["max_depth"],
                filter_name=fname, filter_kwargs=fkw, seed=0, device=dev))
        if zoo:
            dev_ms, by, traces = device_ms_by_kernel(
                run, ["intersect_kernel"], cpu=False, want=per_pass)
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
                "intersect_kernel"][1], profile_traces=traces)
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

    def record(scene, o, d, tmax, time=None):
        out = inner(scene, o, d, tmax, time)
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
    dev_ms, by, traces = device_ms_by_kernel(render, ["intersect_kernel"],
                                             cpu=False, want=launches)
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
        "profile_traces": traces,
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


# ---------------------------------------------------------------------------
# 17. textures, object instancing and participating media
# ---------------------------------------------------------------------------

def _grad_pass(dev):
    """The gradient scene's image mean and its gradients with respect to
    GRAD_PARAMS through the generic loop on ``dev``."""
    b = SceneBuilder()
    entry._fill_portal_grad_scene(b)
    scene = dataclasses.replace(b.build(dev), fused_profile=None)
    tables = {"kd": scene.materials}
    leaves = {n: getattr(tables.get(n, scene.lights), n).clone()
              .requires_grad_() for n in GRAD_PARAMS}
    scene = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials,
                                             kd=leaves["kd"]),
        lights=dataclasses.replace(scene.lights, **{
            n: v for n, v in leaves.items() if n != "kd"}))
    cfg = render_mod.RenderConfig(integrator="path", max_depth=3)
    img = render_mod.render_pass(
        scene, entry._grad_camera((16, 16), dev), film_mod.make_filter(
            "box", device=dev), cfg, 16, 16, 4, 0, dev) / 4
    loss = img.mean()
    loss.backward()
    return float(loss.detach()), {n: v.grad.cpu() for n, v in
                                  leaves.items()}


def media_files(dev):
    """Phase 17: (a) the CLI on texinst, volpath and gridvol at their own
    spp against the reference images; (b) one in-process pass of each,
    every brute-force query held to the twin bit for bit, the launches
    counted, the pass timed with its device time, the kernel's share and
    its peak memory; (c) the 8-spp means against pbrt_tpu's and the
    gradient scene's gradients on the card against the CPU's. Returns the
    numbers for the JSON lines."""
    out = {"cli": {}, "pass": {}, "means": {}, "file_s": {}}
    t_phase = time.perf_counter()
    # (a) the three CLIs run at once (their times overlap: the in-process
    # passes below are the timed ones)
    with tempfile.TemporaryDirectory() as tmp:
        started = {name: start_cli(f"tests/oracle/{name}_oracle.pbrt",
                                   os.path.join(tmp, f"{name}.pfm"))
                   for name in MEDIA_FILES}
        for name, (spp, per_pass, n_pass, md_lim, bl_lim) in \
                MEDIA_FILES.items():
            sm = finish_cli(started[name])
            img = imageio.read_pfm(os.path.join(tmp, f"{name}.pfm"))
            ref = imageio.read_pfm(f"tests/oracle/{name}_ref.pfm")
            row = {k: sm[k] for k in ("render_s", "render_cuda_ms",
                                      "process_s", "launches", "spp",
                                      "mean", "prims", "media", "textures",
                                      "integrator")}
            row["md"] = _mean_delta(img, ref)
            row["bl"] = _block_rel_l1(img, ref, k=16)
            print(f"media file {name} (CLI, three at once): "
                  + json.dumps(row))
            lc = sm["launches"]
            check(img.shape == ref.shape and np.isfinite(img).all()
                  and sm["spp"] == spp, f"{name}: {img.shape}, {sm}")
            check(lc["intersect_brute"] == per_pass * n_pass
                  and lc["fused_bounce"] == 0 and lc["bvh_traverse"] == 0,
                  f"{name}: launches {lc}, expected {per_pass * n_pass}")
            check(row["md"] < md_lim and row["bl"] < bl_lim,
                  f"{name}: md {row['md']:.4f} bl {row['bl']:.4f} vs the "
                  f"limits {md_lim}, {bl_lim}")
            out["cli"][name] = row

    out["cli_s"] = time.perf_counter() - t_phase
    # (b) one pass of each file in process
    for name, (_, per_pass, _, _, _) in MEDIA_FILES.items():
        t_file = time.perf_counter()
        scene, cam, opts = load_pbrt(f"tests/oracle/{name}_oracle.pbrt",
                                     device=dev)
        check(scene.bvh is None and scene.fused_profile is None,
              f"{name}: the scene")

        def render(spp=MEDIA_PASS_SPP, seed=0):
            return render_mod.render(
                scene, cam, spp=spp, integrator=opts["integrator"],
                sampler="halton", max_depth=opts["max_depth"], seed=seed,
                device=dev)
        with recording_brute_force() as calls:
            img = render()
            torch.cuda.synchronize()
        check(len(calls) == per_pass,
              f"{name}: {len(calls)} brute-force queries in the pass")
        worst = 0.0
        for args, (t, prim) in calls:
            t_ref, prim_ref = ik._intersect_reference(*args)
            worst = max(worst, float((t - t_ref).abs().max()))
            check(torch.equal(prim, prim_ref) and torch.equal(t, t_ref),
                  f"{name}: the kernel differs from its twin on the pass's "
                  f"rays ({args[3].shape[0]} rays, t err {worst})")
        n_rays = calls[0][0][3].shape[0]
        del calls
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
        launches = (ik.intersect_brute.launches, fp.fused_bounce.launches,
                    bk.bvh_traverse.launches)
        peak_mb = (torch.cuda.max_memory_allocated(dev) - resident) / 2**20
        check(launches == (per_pass, 0, 0),
              f"{name}: launches {launches} in the timed pass")
        check(torch.equal(img, img2), f"{name}: two renders differ")
        dev_ms, by, traces = device_ms_by_kernel(
            render, ["intersect_kernel"], cpu=False, want=per_pass)
        check(by["intersect_kernel"][1] == per_pass,
              f"{name}: the profiler saw {by['intersect_kernel'][1]} "
              "kernel launches")
        row = {"spp": MEDIA_PASS_SPP, "lanes": n_rays,
               "render_cuda_ms": render_ms,
               "samples_per_s": 96 * 96 * MEDIA_PASS_SPP / (render_ms / 1e3),
               "device_ms": dev_ms,
               "intersect_device_ms": by["intersect_kernel"][0],
               "intersect_share": by["intersect_kernel"][0] / dev_ms,
               "profile_traces": traces,
               "idle_share": 1.0 - dev_ms / render_ms, "peak_mib": peak_mb,
               "peak_bytes_per_lane": peak_mb * 2**20 / n_rays,
               "launches": launches[0], "kernel_vs_twin_max_abs_err": worst}
        print(f"media pass {name} in process, {MEDIA_PASS_SPP} spp halton: "
              + json.dumps(row))
        out["pass"][name] = row

        # (c) the 8-spp mean against pbrt_tpu's
        m = float(render(MEDIA_MEAN_SPP).double().mean())
        ref_mean = REF_MEDIA_MEANS[name]
        rel = abs(m - ref_mean) / ref_mean
        out["means"][name] = {"mean": m, "ref": ref_mean, "rel": rel}
        print(f"media file {name} in process, {MEDIA_MEAN_SPP} spp: "
              + json.dumps(out["means"][name]))
        check(rel < 1e-4, f"{name}: mean off pbrt_tpu's by rel {rel}")
        del scene, img, img2
        out["file_s"][name] = time.perf_counter() - t_file
        print(f"media file {name}: in-process checks "
              f"{out['file_s'][name]:.1f} s")

    # (c) the gradient scene's gradients, card against CPU
    t0 = time.perf_counter()
    loss_cpu, g_cpu = _grad_pass(torch.device("cpu"))
    loss_card, g_card = _grad_pass(dev)
    grads = {"loss_cpu": loss_cpu, "loss_card": loss_card,
             "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu)}
    check(grads["loss_rel"] < 1e-5, f"gradient scene loss {grads}")
    for n in GRAD_PARAMS:
        scale = float(g_cpu[n].abs().max())
        err = float((g_card[n] - g_cpu[n]).abs().max())
        grads[n] = {"max_abs": scale, "max_abs_err": err}
        check(scale > 1e-3 and err <= 1e-6 + 1e-4 * scale,
              f"gradient {n} on the card: {grads[n]}")
    grads["seconds"] = time.perf_counter() - t0
    print("gradient scene, card against CPU: " + json.dumps(grads))
    out["grads"] = grads
    return out


# ---------------------------------------------------------------------------
# 18. subsurface scattering
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_traversal():
    """Record every traversal query the render makes (scene/bvh.py calls
    ``bk.bvh_traverse``) as (its arguments, its outputs); the wrapper
    still counts its launches."""
    calls = []
    inner = bk.bvh_traverse

    def record(bvh, o, d, tmax, any_hit, **kw):
        out = inner(bvh, o, d, tmax, any_hit, **kw)
        calls.append(((o.detach().clone(), d.detach().clone(),
                       tmax.detach().clone(), any_hit), out))
        return out
    # the wrapper counts through its module's name, which now names the
    # recorder: the count is carried over and back
    record.launches = inner.launches
    bk.bvh_traverse = record
    try:
        yield calls
    finally:
        inner.launches = record.launches
        bk.bvh_traverse = inner


@contextlib.contextmanager
def recording_brute_families():
    """Record every brute-force query of a scene with a BVH (its spheres
    and aaplanes after the traversal, scene/bvh.py::_brute_families) as
    (the kernel's arguments, its outputs)."""
    calls = []
    inner = bvh_mod._brute_families

    def record(scene, o, d, tmax):
        out = inner(scene, o, d, tmax)
        calls.append((ik.pack_scene(scene, tris=False) + (
            o.contiguous(), d.contiguous(), tmax.contiguous(), 0,
            scene.n_sph, scene.n_pln), out))
        return out
    bvh_mod._brute_families = record
    try:
        yield calls
    finally:
        bvh_mod._brute_families = inner


def _hold_brute(name, calls):
    """Every recorded brute-force query against the twin, bit for bit;
    returns the largest |t − t_twin|."""
    worst = 0.0
    for args, (t, prim) in calls:
        t_ref, prim_ref = ik._intersect_reference(*args)
        worst = max(worst, float((t - t_ref).abs().max()))
        check(torch.equal(prim, prim_ref) and torch.equal(t, t_ref),
              f"{name}: the kernel differs from its twin on the pass's "
              f"rays ({args[3].shape[0]} rays, t err {worst})")
    return worst


def _file_grad_pass(dev, name, params, spectral):
    """The image mean of a 16² window × 4 spp of an oracle file with its
    own integrator (hero_path_mis for the spectral file) and the gradients
    with respect to ``params`` (kd, emit, the first medium's sigma_a and
    sigma_s) on ``dev``: tests/test_torch_grad.py's hero and volpath
    scenes, built by the port's parser."""
    from pbrt_tpu_torch.core import spectrum as spec_mod
    scene, cam, opts = load_pbrt(
        f"tests/oracle/{name}_oracle.pbrt", device=dev,
        spectrum_cfg=spec_mod.SAMPLED if spectral else spec_mod.RGB)
    leaves = {}
    for n in params:
        if n in ("sigma_a", "sigma_s"):
            leaves[n] = getattr(scene.media[0], n).clone().requires_grad_()
        else:
            tab = scene.materials if n == "kd" else scene.lights
            leaves[n] = getattr(tab, n).clone().requires_grad_()
    med = {n: v for n, v in leaves.items() if n in ("sigma_a", "sigma_s")}
    scene = dataclasses.replace(
        scene, materials=dataclasses.replace(scene.materials,
                                             kd=leaves["kd"]),
        lights=dataclasses.replace(scene.lights, emit=leaves["emit"]))
    if med:
        scene = dataclasses.replace(scene, media=(dataclasses.replace(
            scene.media[0], **med),) + tuple(scene.media[1:]))
    cfg = render_mod.RenderConfig(
        integrator="hero_path_mis" if spectral else opts["integrator"],
        sampler=opts["sampler"], max_depth=opts["max_depth"])
    img = render_mod.render_pass(
        scene, cam, film_mod.make_filter("box", device=dev), cfg, 96, 96,
        4, 0, dev, crop=(40, 40, 16, 16)) / 4
    loss = img.mean()
    loss.backward()
    return float(loss.detach()), {n: v.grad.cpu() for n, v in
                                  leaves.items()}


def sss_files(dev):
    """Phase 18: (a) the CLI on sss and disney_sss at their own spp against
    the reference images, with the brute-force launches of the loop's
    static rule; (b) one in-process pass of each, every brute-force query
    (the probe chain's among them) held to the twin bit for bit, the
    launches counted, the pass timed with its device time, the kernel's
    share and its peak memory; (c) the 8-spp means against pbrt_tpu's, and
    a `path` pass of the subsurface heightfield scene with a BVH, every
    traversal and brute-force query held to the twins; (d) the hero and
    volpath gradients on the card against the CPU's. Returns the numbers
    for the JSON lines."""
    out = {"cli": {}, "pass": {}, "means": {}, "file_s": {}}
    t_phase = time.perf_counter()
    # (a) the two CLIs at once
    with tempfile.TemporaryDirectory() as tmp:
        started = {name: start_cli(f"tests/oracle/{name}_oracle.pbrt",
                                   os.path.join(tmp, f"{name}.pfm"))
                   for name in SSS_FILES}
        for name, (spp, per_pass, n_pass, md_lim, bl_lim) in \
                SSS_FILES.items():
            sm = finish_cli(started[name])
            img = imageio.read_pfm(os.path.join(tmp, f"{name}.pfm"))
            ref = imageio.read_pfm(f"tests/oracle/{name}_ref.pfm")
            row = {k: sm[k] for k in ("render_s", "render_cuda_ms",
                                      "process_s", "launches", "spp",
                                      "mean", "prims", "sss_rows",
                                      "integrator")}
            row["md"] = _mean_delta(img, ref)
            row["bl"] = _block_rel_l1(img, ref, k=16)
            print(f"subsurface file {name} (CLI, two at once): "
                  + json.dumps(row))
            lc = sm["launches"]
            check(img.shape == ref.shape and np.isfinite(img).all()
                  and sm["spp"] == spp and sm["sss_rows"],
                  f"{name}: {img.shape}, {sm}")
            check(lc["intersect_brute"] == per_pass * n_pass
                  and lc["fused_bounce"] == 0 and lc["bvh_traverse"] == 0,
                  f"{name}: launches {lc}, expected {per_pass * n_pass}")
            check(row["md"] < md_lim and row["bl"] < bl_lim,
                  f"{name}: md {row['md']:.4f} bl {row['bl']:.4f} vs the "
                  f"limits {md_lim}, {bl_lim}")
            out["cli"][name] = row
    out["cli_s"] = time.perf_counter() - t_phase

    # (b) one pass of each file in process
    kernel = {}
    for name, (_, per_pass, _, _, _) in SSS_FILES.items():
        t_file = time.perf_counter()
        scene, cam, opts = load_pbrt(f"tests/oracle/{name}_oracle.pbrt",
                                     device=dev)
        check(scene.has_sss and scene.bvh is None
              and scene.fused_profile is None, f"{name}: the scene")

        def render(spp=SSS_PASS_SPP):
            return render_mod.render(
                scene, cam, spp=spp, integrator="path", sampler="halton",
                max_depth=opts["max_depth"], seed=0, device=dev)
        with recording_brute_force() as calls:
            img = render()
            torch.cuda.synchronize()
        check(len(calls) == per_pass,
              f"{name}: {len(calls)} brute-force queries in the pass")
        worst = _hold_brute(name, calls)
        # a probe query (the first bounce's first) timed against its twin
        probe_args = calls[2][0]
        n_rays = probe_args[3].shape[0]
        k_ms = sync_ms(lambda: ik.intersect_brute(*probe_args), 20)
        twin_ms = sync_ms(lambda: ik._intersect_reference(*probe_args), 3)
        bound = intersect_bound(scene, n_rays)
        del calls, probe_args
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
        launches = (ik.intersect_brute.launches, fp.fused_bounce.launches,
                    bk.bvh_traverse.launches)
        peak_mb = (torch.cuda.max_memory_allocated(dev) - resident) / 2**20
        check(launches == (per_pass, 0, 0),
              f"{name}: launches {launches} in the timed pass")
        check(torch.equal(img, img2), f"{name}: two renders differ")
        dev_ms, by, traces = device_ms_by_kernel(
            render, ["intersect_kernel"], cpu=False, want=per_pass)
        check(by["intersect_kernel"][1] == per_pass,
              f"{name}: the profiler saw {by['intersect_kernel'][1]} "
              "kernel launches")
        row = {"spp": SSS_PASS_SPP, "lanes": n_rays,
               "render_cuda_ms": render_ms,
               "samples_per_s": 96 * 96 * SSS_PASS_SPP / (render_ms / 1e3),
               "device_ms": dev_ms,
               "intersect_device_ms": by["intersect_kernel"][0],
               "intersect_share": by["intersect_kernel"][0] / dev_ms,
               "profile_traces": traces,
               "idle_share": 1.0 - dev_ms / render_ms, "peak_mib": peak_mb,
               "peak_bytes_per_lane": peak_mb * 2**20 / n_rays,
               "launches": launches[0], "kernel_vs_twin_max_abs_err": worst,
               "probe_kernel_ms": k_ms, "probe_twin_ms": twin_ms,
               "probe_bound_ms": bound[0], "probe_bound_by": bound[1]}
        print(f"subsurface pass {name} in process, {SSS_PASS_SPP} spp "
              "halton: " + json.dumps(row))
        out["pass"][name] = row
        kernel[name] = {"launches": launches[0], "max_abs_err": worst,
                        "ms": k_ms, "plain_ms": twin_ms,
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "rays": n_rays, "device_ms": by["intersect_kernel"][0]}

        # (c) the 8-spp mean against pbrt_tpu's
        m = float(render(SSS_MEAN_SPP).double().mean())
        ref_mean = REF_SSS_MEANS[name]
        rel = abs(m - ref_mean) / ref_mean
        out["means"][name] = {"mean": m, "ref": ref_mean, "rel": rel}
        print(f"subsurface file {name} in process, {SSS_MEAN_SPP} spp: "
              + json.dumps(out["means"][name]))
        check(rel < 1e-4, f"{name}: mean off pbrt_tpu's by rel {rel}")
        del scene, img, img2
        out["file_s"][name] = time.perf_counter() - t_file
    out["kernel"] = kernel

    # (c) the subsurface heightfield scene with a BVH: every traversal and
    # brute-force query of a `path` pass held to the twins, the mean
    # against pbrt_tpu's
    t0 = time.perf_counter()
    b = SceneBuilder()
    entry._fill_sss_heightfield(b, *SSS_HF)
    scene = b.build(dev, use_bvh="always")
    check(scene.has_sss and scene.bvh is not None
          and scene.fused_profile is None, "the subsurface heightfield")
    ik.intersect_brute.launches = 0
    bk.bvh_traverse.launches = 0

    def render_hf():
        return render_mod.render(
            scene, entry._camera((64, 64), dev), spp=SSS_MEAN_SPP,
            integrator="path", sampler="halton", max_depth=5, seed=0,
            device=dev)
    with recording_traversal() as tcalls, \
            recording_brute_families() as bcalls:
        img = render_hf()
        torch.cuda.synchronize()
    t_launches = bk.bvh_traverse.launches
    check(len(tcalls) == t_launches == 5 * 11 + 1
          and len(bcalls) == ik.intersect_brute.launches == t_launches,
          f"heightfield: {len(tcalls)} traversal queries, "
          f"{len(bcalls)} brute-force, launches {t_launches}")
    t_worst = 0.0
    for (o, d, tmax, any_hit), (t, i) in tcalls:
        t_ref, i_ref = bk.traverse_reference(scene.bvh, o, d, tmax, any_hit)
        t_worst = max(t_worst, float((t - t_ref).abs().max()))
        check(torch.equal(t, t_ref) and torch.equal(i, i_ref),
              f"heightfield: the traversal kernel differs from its twin on "
              f"the pass's rays (t err {t_worst})")
    b_worst = _hold_brute("heightfield", bcalls)
    del tcalls, bcalls
    # the pass's device time and the two kernels' shares of it
    dev_ms, by, traces = device_ms_by_kernel(
        render_hf, ["bvh_traverse_kernel", "intersect_kernel"], cpu=False,
        want=t_launches)
    check(by["bvh_traverse_kernel"][1] == t_launches
          and by["intersect_kernel"][1] == t_launches,
          f"heightfield: the profiler saw {by} kernel launches")
    m = float(img.double().mean())
    ref_mean = REF_SSS_MEANS["heightfield"]
    rel = abs(m - ref_mean) / ref_mean
    out["heightfield"] = {
        "tris": scene.n_tri, "traverse_launches": t_launches,
        "traverse_max_abs_err": t_worst, "brute_max_abs_err": b_worst,
        "device_ms": dev_ms,
        "traverse_device_ms": by["bvh_traverse_kernel"][0],
        "traverse_share": by["bvh_traverse_kernel"][0] / dev_ms,
        "intersect_device_ms": by["intersect_kernel"][0],
        "intersect_share": by["intersect_kernel"][0] / dev_ms,
        "profile_traces": traces, "mean": m, "ref": ref_mean, "rel": rel,
        "seconds": time.perf_counter() - t0}
    print("subsurface heightfield with a BVH, 64² × 8 spp `path`: "
          + json.dumps(out["heightfield"]))
    check(rel < 1e-4, f"heightfield: mean off pbrt_tpu's by rel {rel}")
    del scene, img

    # (d) the hero and volpath gradients, card against CPU
    t0 = time.perf_counter()
    grads = {}
    for name, spectral, params in SSS_GRADS:
        loss_cpu, g_cpu = _file_grad_pass(torch.device("cpu"), name, params,
                                          spectral)
        loss_card, g_card = _file_grad_pass(dev, name, params, spectral)
        row = {"loss_cpu": loss_cpu, "loss_card": loss_card,
               "loss_rel": abs(loss_card - loss_cpu) / abs(loss_cpu)}
        check(row["loss_rel"] < 1e-5, f"{name} gradient loss {row}")
        for n in params:
            scale = float(g_cpu[n].abs().max())
            err = float((g_card[n] - g_cpu[n]).abs().max())
            row[n] = {"max_abs": scale, "max_abs_err": err}
            check(scale > 1e-3 and err <= 1e-6 + 1e-4 * scale,
                  f"{name} gradient {n} on the card: {row[n]}")
        grads[name] = row
        print(f"{name} gradients, card against CPU: " + json.dumps(row))
    grads["seconds"] = time.perf_counter() - t0
    out["grads"] = grads
    return out


def full_width_sample0(hf):
    """Sample index 0 of the 256² × 64-spp BVH render (one 256² × 1-spp
    pass) against pbrt_tpu's CPU pass: the mean and the 16 × 16 block
    means (blocks of 16² pixels) to rel 1e-3, a block off on at most 1%
    of them (a seam tie sends a lane elsewhere)."""
    with open(BVH_FULL_WIDTH) as f:
        ref = json.load(f)
    img = render_mod.render(hf, entry._camera((W, H)), spp=1,
                            integrator="path", max_depth=MAX_DEPTH,
                            device="cuda").double().cpu().numpy()
    mean = float(img.mean())
    rel = abs(mean - ref["mean"]) / ref["mean"]
    blocks = img.reshape(16, 16, 16, 16, 3).mean((1, 3, 4))
    want = np.asarray(ref["blocks"])
    rel_b = np.abs(blocks - want) / np.maximum(np.abs(want), 1e-12)
    out = {"mean": mean, "rel": rel,
           "blocks_off": int((rel_b > 1e-3).sum()), "blocks": rel_b.size,
           "block_rel_max": float(rel_b.max()),
           "block_rel_median": float(np.median(rel_b))}
    # the reference's mean and its CPU seconds come from the data file,
    # not this run: printed, not returned
    print("BVH slice heightfield_cornell path 256², sample index 0, against "
          "pbrt_tpu's CPU pass: " + json.dumps(dict(
              out, ref=ref["mean"],
              pbrt_tpu_cpu_seconds=ref["pbrt_tpu_cpu_seconds"])))
    check(rel < 1e-3, f"full-width sample 0: mean off by rel {rel}")
    check(out["blocks_off"] <= 0.01 * rel_b.size,
          f"full-width sample 0: {out['blocks_off']} blocks off by over "
          "1e-3")
    return out


@contextlib.contextmanager
def timing_mlt():
    """CUDA events at the start of every MLT chain step (its ``_mutate``)
    and around every ``film.splat`` call: (steps [(event, splats made
    before it)], splats [(start, stop)]); both still run."""
    steps, splats = [], []
    splat, mutate = mlt_mod.film_mod.splat, mlt_mod._mutate

    def timed_splat(*a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = splat(*a)
        ev[1].record()
        splats.append(ev)
        return out

    def timed_mutate(*a):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        steps.append((ev, len(splats)))
        return mutate(*a)
    mlt_mod.film_mod.splat, mlt_mod._mutate = timed_splat, timed_mutate
    try:
        yield steps, splats
    finally:
        mlt_mod.film_mod.splat, mlt_mod._mutate = splat, mutate


@contextlib.contextmanager
def recording_fused():
    """Record every launch of the fused kernel as (its arguments, its
    keywords, its outputs); the wrapper still counts its launches."""
    calls = []
    inner = fp.fused_bounce

    def record(*args, **kw):
        out = inner(*args, **kw)
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                            for a in args), kw, out))
        return out
    # the wrapper counts through its module's name, which now names the
    # recorder: the count is carried over and back
    record.launches = inner.launches
    fp.fused_bounce = record
    try:
        yield calls
    finally:
        inner.launches = record.launches
        fp.fused_bounce = inner


def _hold_fused(name, scene, calls):
    """Every recorded fused launch on the portal scene against the twin
    with phase 3's bounds for it: codes equal and knee / kc to rtol 1e-5
    / atol 1e-6 on live lanes, the replayed radiance to atol 5e-6.
    Returns the largest |L − L_twin|."""
    worst = 0.0
    for args, kw, got in calls:
        want = fp._kernel_reference(*args, **kw)
        live = fp.live_mask(want[0])
        check(torch.equal(got[0][live], want[0][live]),
              f"{name}: the fused kernel's codes differ from its twin's")
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g[live], w[live], rtol=1e-5,
                                       atol=1e-6)
        worst = max(worst, float((replay_of(scene, got)
                                  - replay_of(scene, want)).abs().max()))
        check(worst <= 5e-6, f"{name}: fused L err {worst}")
    return worst


def _mlt_launches(width, height, mpp, n_chains, n_bootstrap, per_pass):
    """Kernel launches of render_mlt: one target pass a bootstrap block,
    one for the start states, one a chain step."""
    n_steps = max(1, width * height * mpp // n_chains)
    return (-(-n_bootstrap // MLT_BOOT_BLOCK) + 1 + n_steps) * per_pass


def bdpt_env_pixels(scene, cam, depth, chunk, img):
    """envcavity's 8-spp ``render_bdpt`` image pixel for pixel: the
    card's against the CPU twins' and the twins' against pbrt_tpu's
    op-by-op image (BDPT_ENV_REF), rtol 2e-5 / atol 1e-6; the mean over
    the pixels where all three agree to rel 1e-4, with at most
    BDPT_PIXELS_OFF_SHARE of the pixels off."""
    cpu = torch.device("cpu")
    twin = bdpt_mod.render_bdpt(to_device(scene, cpu), to_device(cam, cpu),
                                spp=BDPT_MEAN_SPP, max_depth=depth, seed=0,
                                chunk_spp=chunk, device=cpu).numpy()
    card = img.cpu().numpy()
    ref = np.load(BDPT_ENV_REF)
    check(card.shape == twin.shape == ref.shape,
          f"envcavity images {card.shape}, {twin.shape}, {ref.shape}")
    off_card = ~np.isclose(card, twin, rtol=2e-5, atol=1e-6).all(-1)
    off_twin = ~np.isclose(twin, ref, rtol=2e-5, atol=1e-6).all(-1)
    agree = ~(off_card | off_twin)
    m, m_ref = (float(a[agree].astype(np.float64).mean())
                for a in (card, ref))
    row = {"pixels": int(agree.size),
           "pixels_off_card_vs_cpu": int(off_card.sum()),
           "pixels_off_cpu_vs_pbrt_tpu": int(off_twin.sum()),
           "agreeing_mean": m, "agreeing_rel": abs(m - m_ref) / m_ref,
           "cpu_mean": float(twin.astype(np.float64).mean())}
    check(int((~agree).sum()) <= BDPT_PIXELS_OFF_SHARE * agree.size
          and row["agreeing_rel"] < 1e-4,
          f"envcavity pixels against the CPU twins and pbrt_tpu: {row}")
    return row


def bdpt_lanes_vs_cpu(scene, cam, depth, spp):
    """A `bdpt_t1` pass's radiance, lane for lane, on the card and on the
    CPU twins: the share of lanes off (rtol 2e-5 / atol 1e-5) must stay
    within tests/test_torch_bdpt.py's 2%. Returns [lanes off, lanes]."""
    cpu = torch.device("cpu")
    w, h = cam.resolution
    L = []
    for sc, cm, d in ((scene, cam, scene.world_lo.device),
                      (to_device(scene, cpu), to_device(cam, cpu), cpu)):
        cfg = render_mod.RenderConfig(integrator="bdpt_t1", max_depth=depth)
        rays, pid, sidx, _ = render_mod.camera_rays(
            cm, film_mod.make_filter("box", device=d), cfg, w, h, spp, 0, d)
        L.append(bdpt_mod.li_bdpt_t1(
            sc, rays.o, rays.d, pid, sidx, make_sampler("independent"), cfg,
            None, cam=cm).cpu())
    off = int((~torch.isclose(L[0], L[1], rtol=2e-5, atol=1e-5)).any(-1)
              .sum())
    check(off <= 0.02 * L[0].shape[0],
          f"bdpt lanes: {off} of {L[0].shape[0]} off the CPU twins")
    return [off, L[0].shape[0]]


def _bdpt_launches(scene, depth, spp, chunk):
    """Brute-force launches of render_bdpt: per chunk the queries
    ``bdpt.queries_per_chunk`` counts from the loops."""
    return -(-spp // chunk) * bdpt_mod.queries_per_chunk(scene, depth)


def bdpt_files(dev):
    """Phase 19: bdpt, the spatial strategy and MLT (see the module's
    docstring). Returns the numbers for the JSON lines."""
    out = {"cli": {}, "pass": {}, "means": {}}
    t_phase = time.perf_counter()
    # (a) the three CLIs at once
    with tempfile.TemporaryDirectory() as tmp:
        started = {name: start_cli(f"tests/oracle/{name}_oracle.pbrt",
                                   os.path.join(tmp, f"{name}.pfm"),
                                   "--integrator", "bdpt", "--spp", str(spp))
                   for name, (spp, _, _) in BDPT_FILES.items()}
        for name, (spp, md_lim, bl_lim) in BDPT_FILES.items():
            sm = finish_cli(started[name])
            img = imageio.read_pfm(os.path.join(tmp, f"{name}.pfm"))
            ref = imageio.read_pfm(f"tests/oracle/{name}_ref.pfm"
                                   if name != "envcavity" else
                                   "tests/oracle/envcavity_path_ref.pfm")
            scene, cam, opts = load_pbrt(f"tests/oracle/{name}_oracle.pbrt",
                                         device=dev)
            w, h = cam.resolution
            want = _bdpt_launches(scene, opts["max_depth"], spp,
                                  bdpt_mod.default_chunk_spp(dev, w, h, spp))
            row = {k: sm[k] for k in ("render_s", "render_cuda_ms",
                                      "process_s", "launches", "spp",
                                      "mean", "integrator")}
            row["md"] = _mean_delta(img, ref)
            row["bl"] = _block_rel_l1(img, ref, k=16)
            row["launches_expected"] = want
            if name == "envcavity":
                ref_b = imageio.read_pfm(
                    "tests/oracle/envcavity_bdpt_ref.pfm")
                row["gap"] = float(abs(img.mean() - ref.mean()) / ref.mean())
                row["pbrt_gap"] = float(abs(ref_b.mean() - ref.mean())
                                        / ref.mean())
            print(f"bdpt file {name} (CLI, three at once): "
                  + json.dumps(row))
            lc = sm["launches"]
            check(img.shape == ref.shape and np.isfinite(img).all()
                  and sm["spp"] == spp and sm["integrator"] == "bdpt",
                  f"{name}: {img.shape}, {sm}")
            check(lc["intersect_brute"] == want and lc["fused_bounce"] == 0
                  and lc["bvh_traverse"] == 0,
                  f"{name}: launches {lc}, expected {want}")
            if name == "envcavity":
                check(row["pbrt_gap"] > 0.08
                      and row["gap"] < 0.6 * row["pbrt_gap"],
                      f"envcavity: gap {row['gap']:.4f}, the reference "
                      f"binary's {row['pbrt_gap']:.4f}")
            else:
                check(row["md"] < md_lim and row["bl"] < bl_lim,
                      f"{name}: md {row['md']:.4f} bl {row['bl']:.4f} vs "
                      f"the limits {md_lim}, {bl_lim}")
            out["cli"][name] = row
    out["cli_s"] = time.perf_counter() - t_phase

    # (b) each file in process at pbrt_tpu's CPU chunk
    kernel = {"launches": 0, "max_abs_err": 0.0}
    for name in BDPT_FILES:
        scene, cam, opts = load_pbrt(f"tests/oracle/{name}_oracle.pbrt",
                                     device=dev)
        depth = opts["max_depth"]
        w, h = cam.resolution
        chunk = bdpt_mod.default_chunk_spp("cpu", w, h, BDPT_MEAN_SPP)

        def render(spp=BDPT_MEAN_SPP):
            return bdpt_mod.render_bdpt(scene, cam, spp=spp, max_depth=depth,
                                        seed=0, chunk_spp=chunk, device=dev)
        with recording_brute_force() as calls:
            img = render()
            torch.cuda.synchronize()
        check(len(calls) == _bdpt_launches(scene, depth, BDPT_MEAN_SPP,
                                           chunk),
              f"{name}: {len(calls)} brute-force queries")
        worst = _hold_brute(f"bdpt {name}", calls)
        n_rays = calls[0][0][3].shape[0]
        del calls
        m = float(img.double().mean())
        rel = abs(m - REF_BDPT_MEANS[name]) / REF_BDPT_MEANS[name]
        out["means"][name] = {
            "mean": m, "ref": REF_BDPT_MEANS[name], "rel": rel,
            "chunk_spp": chunk}
        if name == "envcavity":
            out["means"][name]["lanes_off_cpu"] = bdpt_lanes_vs_cpu(
                scene, cam, depth, BDPT_MEAN_SPP)
            out["means"][name].update(bdpt_env_pixels(scene, cam, depth,
                                                      chunk, img))
        print(f"bdpt file {name} in process, {BDPT_MEAN_SPP} spp at chunk "
              f"{chunk}: " + json.dumps(out["means"][name]))
        check(rel < BDPT_MEAN_REL[name],
              f"{name}: bdpt mean off pbrt_tpu's by rel {rel}")
        # one chunk timed, its launches counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        resident = torch.cuda.memory_allocated(dev)
        ik.intersect_brute.launches = 0
        fp.fused_bounce.launches = 0
        bk.bvh_traverse.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        render(chunk)
        stop.record()
        torch.cuda.synchronize()
        render_ms = start.elapsed_time(stop)
        launches = (ik.intersect_brute.launches, fp.fused_bounce.launches,
                    bk.bvh_traverse.launches)
        per = bdpt_mod.queries_per_chunk(scene, depth)
        check(launches == (per, 0, 0), f"{name}: launches {launches}")
        peak_mb = (torch.cuda.max_memory_allocated(dev) - resident) / 2**20
        dev_ms, by, traces = device_ms_by_kernel(
            lambda: render(chunk), ["intersect_kernel"], cpu=False, want=per)
        check(by["intersect_kernel"][1] == per,
              f"{name}: the profiler saw {by['intersect_kernel'][1]} "
              "kernel launches")
        row = {"chunk_spp": chunk, "camera_lanes": n_rays,
               "render_cuda_ms": render_ms, "device_ms": dev_ms,
               "intersect_device_ms": by["intersect_kernel"][0],
               "intersect_share": by["intersect_kernel"][0] / dev_ms,
               "profile_traces": traces,
               "idle_share": 1.0 - dev_ms / render_ms, "peak_mib": peak_mb,
               "peak_bytes_per_lane": peak_mb * 2**20 / n_rays,
               "launches": per, "kernel_vs_twin_max_abs_err": worst}
        print(f"bdpt chunk {name} in process: " + json.dumps(row))
        out["pass"][name] = row
        kernel["launches"] += per
        kernel["max_abs_err"] = max(kernel["max_abs_err"], worst)
        del scene, img

    # (c) full width: one 256² × 32-spp chunk of the sphere cornell
    scene = entry._sphere_cornell(dev)
    cam = entry._camera((W, H), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    ik.intersect_brute.launches = 0
    fp.fused_bounce.launches = 0
    bk.bvh_traverse.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    img = bdpt_mod.render_bdpt(scene, cam, spp=CHUNK, max_depth=MAX_DEPTH,
                               seed=0, chunk_spp=CHUNK, device=dev)
    stop.record()
    torch.cuda.synchronize()
    per = bdpt_mod.queries_per_chunk(scene, MAX_DEPTH)
    launches = (ik.intersect_brute.launches, fp.fused_bounce.launches,
                bk.bvh_traverse.launches)
    peak_mb = (torch.cuda.max_memory_allocated(dev) - resident) / 2**20
    full = {"lanes": W * H * CHUNK, "render_cuda_ms": start.elapsed_time(stop),
            "peak_mib": peak_mb,
            "peak_bytes_per_lane": peak_mb * 2**20 / (W * H * CHUNK),
            "launches": launches[0], "mean": float(img.double().mean())}
    print(f"bdpt sphere_cornell {W}² × {CHUNK} spp, one chunk: "
          + json.dumps(full))
    check(launches == (per, 0, 0), f"full-width bdpt launches {launches}")
    check(img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
          and full["mean"] > 0.05, "the full-width bdpt image")
    kernel["full_width_launches"] = launches[0]
    out["full_width"] = full
    del scene, img

    # a bdpt chunk of a heightfield with a BVH: every traversal and
    # brute-force query held to the twins
    b = SceneBuilder()
    entry._fill_heightfield_cornell(b, *SSS_HF)
    scene = b.build(dev, use_bvh="always")
    check(scene.bvh is not None, "the heightfield has no BVH")
    ik.intersect_brute.launches = 0
    bk.bvh_traverse.launches = 0
    with recording_traversal() as tcalls, \
            recording_brute_families() as bcalls:
        img = bdpt_mod.render_bdpt(scene, entry._camera((64, 64), dev),
                                   spp=4, max_depth=MAX_DEPTH, seed=0,
                                   chunk_spp=4, device=dev)
        torch.cuda.synchronize()
    per = bdpt_mod.queries_per_chunk(scene, MAX_DEPTH)
    check(len(tcalls) == bk.bvh_traverse.launches == per
          and len(bcalls) == ik.intersect_brute.launches == per,
          f"bdpt heightfield: {len(tcalls)} traversal queries, "
          f"{len(bcalls)} brute-force, launches {bk.bvh_traverse.launches}")
    t_worst = 0.0
    for (o, d, tmax, any_hit), (t, i) in tcalls:
        t_ref, i_ref = bk.traverse_reference(scene.bvh, o, d, tmax, any_hit)
        t_worst = max(t_worst, float((t - t_ref).abs().max()))
        check(torch.equal(t, t_ref) and torch.equal(i, i_ref),
              f"bdpt heightfield: the traversal kernel differs from its "
              f"twin (t err {t_worst})")
    b_worst = _hold_brute("bdpt heightfield", bcalls)
    out["bvh"] = {"tris": scene.n_tri, "traverse_launches": per,
                  "traverse_max_abs_err": t_worst,
                  "brute_max_abs_err": b_worst,
                  "mean": float(img.double().mean())}
    print("bdpt heightfield with a BVH, 64² × 4 spp: "
          + json.dumps(out["bvh"]))
    check(bool(torch.isfinite(img).all()) and out["bvh"]["mean"] > 0.05,
          "the BVH bdpt image")
    del tcalls, bcalls, scene, img

    # (d) MLT on caustic with tests/test_oracle.py's budget
    scene, cam, opts = load_pbrt("tests/oracle/caustic_oracle.pbrt",
                                 device=dev)
    w, h = cam.resolution
    mlt_args = dict(n_bootstrap=1 << 18, n_chains=8192,
                    max_depth=opts["max_depth"], seed=5, device=dev)
    want = _mlt_launches(w, h, 64, 8192, 1 << 18, MLT_CAUSTIC_PER_PASS)
    ik.intersect_brute.launches = 0
    t0 = time.perf_counter()
    with timing_mlt() as (steps, splats):
        img = mlt_mod.render_mlt(scene, cam, mutations_per_pixel=64,
                                 **mlt_args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # from the first step's start to the last one's: their time and their
    # splats' share
    chain_ms = steps[0][0].elapsed_time(steps[-1][0])
    splat_ms = sum(a.elapsed_time(z)
                   for a, z in splats[steps[0][1]:steps[-1][1]])
    ref = imageio.read_pfm("tests/oracle/caustic_ref.pfm")
    img = img.cpu().numpy()
    mlt = {"steps": len(steps), "chains": 8192,
           "steps_per_s": (len(steps) - 1) / (chain_ms / 1e3),
           "mutations_per_s": 8192 * (len(steps) - 1) / (chain_ms / 1e3),
           "splat_share": splat_ms / chain_ms, "wall_s": wall,
           "intersect_launches": ik.intersect_brute.launches,
           "launches_expected": want, "md": _mean_delta(img, ref)}
    print("mlt caustic, 64 mutations a pixel, 2^18 bootstrap samples, 8,192 "
          "chains: " + json.dumps(mlt))
    check(ik.intersect_brute.launches == want,
          f"mlt caustic: {ik.intersect_brute.launches} launches, the code "
          f"implies {want}")
    check(np.isfinite(img).all() and mlt["md"] < 0.05,
          f"mlt caustic md {mlt['md']:.4f}")
    kernel["mlt_launches"] = ik.intersect_brute.launches
    # the same shapes for four steps: every query held to the twin
    with recording_brute_force() as calls:
        mlt_mod.render_mlt(scene, cam, mutations_per_pixel=4, **mlt_args)
        torch.cuda.synchronize()
    want = _mlt_launches(w, h, 4, 8192, 1 << 18, MLT_CAUSTIC_PER_PASS)
    check(len(calls) == want, f"mlt caustic, four steps: {len(calls)} "
          f"brute-force queries, the code implies {want}")
    mlt["held_queries"] = len(calls)
    mlt["kernel_vs_twin_max_abs_err"] = _hold_brute("mlt caustic", calls)
    kernel["max_abs_err"] = max(kernel["max_abs_err"],
                                mlt["kernel_vs_twin_max_abs_err"])
    print(f"mlt caustic, four steps: {len(calls)} brute-force queries, each "
          "bit-equal to the twin")
    out["mlt"] = mlt
    del calls
    # MLT on a scene of the fused profile runs the fused kernel: every
    # launch held to its twin
    portal = entry._portal_scene(dev)
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    with recording_fused() as fcalls:
        img = mlt_mod.render_mlt(portal, entry._camera((64, 64), dev),
                                 mutations_per_pixel=1, n_chains=4096,
                                 n_bootstrap=16384, max_depth=MAX_DEPTH,
                                 seed=1, device=dev)
        torch.cuda.synchronize()
    want = _mlt_launches(64, 64, 1, 4096, 16384, MLT_PORTAL_PER_PASS)
    check(fp.fused_bounce.launches == len(fcalls) == want
          and ik.intersect_brute.launches == 0
          and bool(torch.isfinite(img).all()),
          f"MLT on the portal scene: {fp.fused_bounce.launches} fused "
          f"launches, the code implies {want}")
    out["mlt_fused"] = {"launches": want, "kernel_vs_twin_max_abs_err":
                        _hold_fused("mlt portal", portal, fcalls)}
    print("mlt portal scene, fused kernel: " + json.dumps(out["mlt_fused"]))
    del scene, img, fcalls, portal

    # (e) a 256² × 32-spp `path` pass under the spatial strategy
    b = SceneBuilder()
    m = b.add_material(type=0, kd=0.6)
    b.add_mesh([(-10, 0, -2), (10, 0, -2), (10, 0, 2), (-10, 0, 2)],
               [(0, 1, 2), (0, 2, 3)], mat=m)
    b.add_light(type="point", I=10.0, pos=(-8, 1, 0))
    b.add_light(type="point", I=10.0, pos=(8, 1, 0))
    scene = b.build(dev)
    cam = cam_mod.make_perspective(
        transform.look_at((0, 4, -6), (0, 0, 0), (0, 1, 0), device=dev), 50.0,
        (W, H), device=dev)
    def render_spatial():
        return render_mod.render(scene, cam, spp=CHUNK, integrator="path",
                                 max_depth=MAX_DEPTH,
                                 light_strategy="spatial", chunk_spp=CHUNK,
                                 device=dev)
    ik.intersect_brute.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    img = render_spatial()
    stop.record()
    torch.cuda.synchronize()
    m = float(img.double().mean())
    rel = abs(m - REF_SPATIAL_MEAN) / REF_SPATIAL_MEAN
    out["spatial"] = {"mean": m, "ref": REF_SPATIAL_MEAN, "rel": rel,
                      "render_cuda_ms": start.elapsed_time(stop),
                      "launches": ik.intersect_brute.launches}
    check(ik.intersect_brute.launches == SPATIAL_PER_PASS,
          f"spatial pass: {ik.intersect_brute.launches} launches, the loop "
          f"implies {SPATIAL_PER_PASS}")
    # a second render, every query held to the twin
    with recording_brute_force() as calls:
        render_spatial()
        torch.cuda.synchronize()
    check(len(calls) == SPATIAL_PER_PASS,
          f"spatial pass: {len(calls)} brute-force queries")
    out["spatial"]["kernel_vs_twin_max_abs_err"] = _hold_brute(
        "spatial pass", calls)
    kernel["max_abs_err"] = max(kernel["max_abs_err"],
                                out["spatial"]["kernel_vs_twin_max_abs_err"])
    kernel["spatial_launches"] = SPATIAL_PER_PASS
    del calls
    print(f"spatial strategy, two lights, `path` {W}² × {CHUNK} spp: "
          + json.dumps(out["spatial"]))
    check(rel < 1e-4, f"spatial pass mean off pbrt_tpu's by rel {rel}")
    out["kernel"] = kernel
    return out


# ---------------------------------------------------------------------------
# phase 20: SPPM and two-keyframe motion blur
# ---------------------------------------------------------------------------

def _loop_queries(scene, max_depth):
    """Closest-hit queries of one generic-loop `path` pass (``_li_loop``):
    a trace each bounce, NEE's trace each bounce but the last, and its
    BSDF-strategy trace where a light takes it."""
    half = int(render_mod.lights_mod.takes_bsdf_half(scene.lights))
    return (max_depth + 1) + max_depth * (1 + half)


def _cli_passes(width, height, spp):
    """The passes of ``render`` on the card (its chunk of ≤ 2^21 lanes)."""
    max_chunk = max(1, min(spp, 2_097_152 // (width * height) or 1))
    chunk = -(-spp // -(-spp // max_chunk))
    return -(-spp // chunk)


@contextlib.contextmanager
def recording_brute_motion():
    """Record every query of the brute-force kernel's motion variant
    (scene/intersect.py::_closest with shutter times on a scene with
    motion) as (the twin's arguments, the kernel's outputs); the wrapper
    still counts its launches."""
    calls = []
    inner = isect_mod._closest

    def record(scene, o, d, tmax, time=None):
        out = inner(scene, o, d, tmax, time)
        if time is not None and scene.has_motion:
            calls.append((ik.pack_scene(scene, motion=True) + (
                o.detach().contiguous(), d.detach().contiguous(),
                tmax.detach().contiguous(), scene.n_tri, scene.n_sph,
                scene.n_pln, time.detach().contiguous()), out))
        return out
    isect_mod._closest = record
    try:
        yield calls
    finally:
        isect_mod._closest = inner


def _hold_brute_motion(name, calls):
    """Every recorded motion query against the motion twin, bit for bit;
    returns the largest |t − t_twin|."""
    worst = 0.0
    for args, (t, prim) in calls:
        t_ref, prim_ref = ik._intersect_reference(*args[:-1], time=args[-1])
        worst = max(worst, float((t - t_ref).abs().max()))
        check(torch.equal(prim, prim_ref) and torch.equal(t, t_ref),
              f"{name}: the motion variant differs from its twin "
              f"({args[3].shape[0]} rays, t err {worst})")
    return worst


@contextlib.contextmanager
def recording_traversal_motion():
    """Record every query of the traversal kernel's motion variant as (its
    arguments, its outputs); the wrapper still counts its launches."""
    calls = []
    inner = bk.bvh_traverse_motion

    def record(bvh, o, d, tmax, time, any_hit):
        out = inner(bvh, o, d, tmax, time, any_hit)
        calls.append(((o.detach().clone(), d.detach().clone(),
                       tmax.detach().clone(), time.detach().clone(),
                       any_hit), out))
        return out
    record.launches = inner.launches
    bk.bvh_traverse_motion = record
    try:
        yield calls
    finally:
        inner.launches = record.launches
        bk.bvh_traverse_motion = inner


def motion_intersect_bound(scene, n_rays):
    """The motion variant: each ray read once (o, d, tmax, time: 32 B) and
    written once (8 B), the 72-byte triangle rows and the other tables
    once; every ray tests every primitive, a triangle test OPS_TRI_MOTION
    operations."""
    tabs = ik.pack_scene(scene, motion=True)
    n_bytes = 40 * n_rays + sum(t.numel() * 4 for t in tabs)
    n_ops = n_rays * (OPS_TRI_MOTION * scene.n_tri + OPS_SPH * scene.n_sph
                      + OPS_PLN * scene.n_pln)
    return bound_ms(n_bytes, n_ops)


def motion_traverse_bound(bvh, n_rays, stats):
    """The motion variant: each ray read once (32 B) and written once
    (8 B), the nodes and the 80-byte motion records once; the slab and
    triangle tests the twin counted on this run's rays."""
    n_bytes = (40 * n_rays + bvh.nodes.numel() * 4
               + bvh.tris_motion.numel() * 4)
    n_ops = (OPS_SLAB * stats["slab_tests"]
             + OPS_TRI_MOTION * stats["tri_tests"])
    return bound_ms(n_bytes, n_ops)


@contextlib.contextmanager
def timing_deposits():
    """CUDA events around every SPPM deposit (``sppm._deposit``) and the
    (photon, entry) pairs it scanned; the deposit still runs."""
    events = []
    inner = sppm_mod._deposit

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        inner(*a, **kw)
        ev[1].record()
        events.append((ev, a[8]))
    sppm_mod._deposit = timed
    try:
        yield events
    finally:
        sppm_mod._deposit = inner


def write_moving_heightfield_file(path):
    """Phase 10's heightfield file with its cone moving over the shutter
    (``ActiveTransform EndTime`` + ``Translate``): pbrt_tpu moves only
    ``trianglemesh`` shapes, so the cone moves and the heightfield stays;
    the scene has motion, so its BVH is built over both keyframes and
    every traversal with the rays' times runs the motion variant."""
    write_heightfield_file(path)
    with open(path) as f:
        text = f.read()
    cone = 'Material "matte" "rgb Kd" [0.3 0.4 0.7]\n'
    check(text.count(cone) == 1, "the cone's block in the written file")
    text = text.replace(cone, cone + "ActiveTransform EndTime\n"
                        "Translate -0.08 0.02 0.04\nActiveTransform All\n")
    with open(path, "w") as f:
        f.write(text)


def sppm_motion_files(dev):
    """Phase 20: SPPM and two-keyframe motion blur (see the module's
    docstring). Returns the numbers for the JSON lines."""
    out = {}
    sppm_k = {"launches": 0, "max_abs_err": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the two CLIs at once
        t0 = time.perf_counter()
        started = {
            "sppm": start_cli("tests/oracle/caustic_oracle.pbrt",
                              os.path.join(tmp, "s.pfm"), "--integrator",
                              "sppm"),
            "dofmotion": start_cli("tests/oracle/dofmotion_oracle.pbrt",
                                   os.path.join(tmp, "d.pfm"), "--spp",
                                   str(DOFMOTION_SPP))}
        for name, pfm, ref_name in (("sppm", "s.pfm", "caustic_ref.pfm"),
                                    ("dofmotion", "d.pfm",
                                     "dofmotion_ref.pfm")):
            sm = finish_cli(started[name])
            img = imageio.read_pfm(os.path.join(tmp, pfm))
            ref = imageio.read_pfm(f"tests/oracle/{ref_name}")
            row = {k: sm[k] for k in ("render_s", "render_cuda_ms",
                                      "process_s", "launches", "spp",
                                      "mean", "integrator")}
            row["md"] = _mean_delta(img, ref)
            row["bl"] = _block_rel_l1(img, ref, k=16)
            scene, cam, opts = load_pbrt(
                "tests/oracle/" + ref_name.replace("_ref.pfm",
                                                   "_oracle.pbrt"),
                device=dev)
            w, h = cam.resolution
            lc = sm["launches"]
            if name == "sppm":
                want = 64 * sppm_mod.queries_per_iteration(
                    opts["max_depth"], scene.lights)
                got = lc["intersect_brute"]
                check(lc["intersect_brute_motion"] == 0, f"sppm CLI {lc}")
            else:
                want = _cli_passes(w, h, DOFMOTION_SPP) * _loop_queries(
                    scene, opts["max_depth"])
                got = lc["intersect_brute_motion"]
                check(lc["intersect_brute"] == 0, f"dofmotion CLI {lc}")
            row["launches_expected"] = want
            print(f"phase 20 CLI {name} (two at once): " + json.dumps(row))
            check(img.shape == ref.shape and np.isfinite(img).all()
                  and got == want and lc["fused_bounce"] == 0
                  and lc["bvh_traverse"] == 0,
                  f"{name} CLI: {img.shape}, launches {lc}, expected {want}")
            if name == "dofmotion":
                check(row["md"] < DOFMOTION_LIMITS[0]
                      and row["bl"] < DOFMOTION_LIMITS[1],
                      f"dofmotion md {row['md']:.4f} bl {row['bl']:.4f}")
            else:
                row["mean_rel"] = abs(row["mean"] / REF_SPPM_CLI_MEAN - 1.0)
                check(row["mean_rel"] < SPPM_CLI_MEAN_REL,
                      f"sppm CLI mean {row['mean']!r} against pbrt_tpu's "
                      f"{REF_SPPM_CLI_MEAN!r}")
            out[f"cli_{name}"] = row
        out["cli_s"] = time.perf_counter() - t0

    # (b) caustic with tests/test_oracle.py's call
    scene, cam, opts = load_pbrt("tests/oracle/caustic_oracle.pbrt",
                                 device=dev)
    depth = opts["max_depth"]
    per_it = sppm_mod.queries_per_iteration(depth, scene.lights)
    with recording_brute_force() as calls:
        sppm_mod.render_sppm(scene, cam, n_iterations=1,
                             photons_per_iter=SPPM_ORACLE[1], max_depth=depth,
                             seed=SPPM_ORACLE[2], device=dev)
        torch.cuda.synchronize()
    check(len(calls) == per_it, f"sppm: {len(calls)} queries an iteration, "
          f"the code implies {per_it}")
    held = _hold_brute("sppm caustic", calls)
    del calls
    ik.intersect_brute.launches = 0
    ik.intersect_brute_motion.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with timing_deposits() as deps:
        start.record()
        img = sppm_mod.render_sppm(scene, cam, n_iterations=SPPM_ORACLE[0],
                                   photons_per_iter=SPPM_ORACLE[1],
                                   max_depth=depth, seed=SPPM_ORACLE[2],
                                   device=dev)
        stop.record()
        torch.cuda.synchronize()
    ref = imageio.read_pfm("tests/oracle/caustic_ref.pfm")
    render_ms = start.elapsed_time(stop)
    row = {"iterations": SPPM_ORACLE[0], "photons": SPPM_ORACLE[1],
           "render_cuda_ms": render_ms,
           "ms_per_iteration": render_ms / SPPM_ORACLE[0],
           "launches": ik.intersect_brute.launches,
           "launches_expected": SPPM_ORACLE[0] * per_it,
           "held_queries": per_it, "kernel_vs_twin_max_abs_err": held,
           "deposit_event_share": sum(a.elapsed_time(z) for (a, z), _ in deps)
           / render_ms,
           "pairs_per_iteration": sum(int(s.sum()) for _, s in deps)
           / SPPM_ORACLE[0],
           "md": _mean_delta(img.cpu().numpy(), ref)}
    print("phase 20 sppm caustic (tests/test_oracle.py's call): "
          + json.dumps(row))
    check(row["launches"] == row["launches_expected"]
          and ik.intersect_brute_motion.launches == 0,
          f"sppm caustic launches {row['launches']}")
    check(bool(torch.isfinite(img).all()) and row["md"] < SPPM_ORACLE_MD,
          f"sppm caustic md {row['md']:.4f}")
    out["caustic"] = row
    sppm_k["launches"] += row["launches"]
    sppm_k["max_abs_err"] = held
    del scene, img

    # (c) the full-width cell: _sphere_cornell() at 256², 2^20 photons
    scene = entry._sphere_cornell(dev)
    cam = entry._camera((W, H), dev)
    n_it, n_ph = SPPM_FULL
    per_it = sppm_mod.queries_per_iteration(MAX_DEPTH, scene.lights)

    def full(n=n_it):
        return sppm_mod.render_sppm(scene, cam, n_iterations=n,
                                    photons_per_iter=n_ph,
                                    max_depth=MAX_DEPTH, device=dev)
    full(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    ik.intersect_brute.launches = 0
    start.record()
    with timing_deposits() as deps:
        img = full()
        stop.record()
        torch.cuda.synchronize()
    render_ms = start.elapsed_time(stop)
    launches = ik.intersect_brute.launches
    peak_mb = (torch.cuda.max_memory_allocated(dev) - resident) / 2**20
    one_ms = sync_ms(lambda: full(1), 1)
    dev_ms, _, traces = device_ms_by_kernel(lambda: full(1), [], cpu=False)
    inner = sppm_mod._deposit
    sppm_mod._deposit = lambda *a, **kw: None
    try:
        dev_ms_nodep, _, _ = device_ms_by_kernel(lambda: full(1), [],
                                                 cpu=False)
    finally:
        sppm_mod._deposit = inner
    row = {"lanes": W * H, "photons": n_ph, "iterations": n_it,
           "render_cuda_ms": render_ms, "ms_per_iteration": render_ms / n_it,
           "launches": launches, "launches_expected": n_it * per_it,
           "peak_mib": peak_mb, "one_iteration_ms": one_ms,
           "one_iteration_device_ms": dev_ms,
           "idle_share": 1.0 - dev_ms / one_ms,
           "deposit_device_ms": dev_ms - dev_ms_nodep,
           "deposit_device_share": (dev_ms - dev_ms_nodep) / dev_ms,
           "deposit_event_share": sum(a.elapsed_time(z) for (a, z), _ in deps)
           / render_ms,
           "pairs_per_iteration": sum(int(s.sum()) for _, s in deps) / n_it,
           "profile_traces": traces, "mean": float(img.double().mean())}
    print(f"phase 20 sppm sphere_cornell {W}² × {n_ph} photons × {n_it} "
          "iterations: " + json.dumps(row))
    check(launches == n_it * per_it, f"full-width sppm launches {launches}")
    check(img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
          and row["mean"] > 0.05, "the full-width sppm image")
    out["full_width"] = row
    sppm_k["full_width_launches"] = launches
    del scene, img

    # (d) dofmotion: one in-process 64-spp pass, every query held
    scene, cam, opts = load_pbrt("tests/oracle/dofmotion_oracle.pbrt",
                                 device=dev)
    check(scene.has_motion and scene.bvh is None, "dofmotion's tables")
    w, h = cam.resolution
    filt = film_mod.make_filter("box", device=dev)
    cfg = render_mod.RenderConfig(integrator="path", sampler="halton",
                                  max_depth=opts["max_depth"])
    per_pass = _loop_queries(scene, opts["max_depth"])

    def dof_pass():
        return render_mod.render_pass(scene, cam, filt, cfg, w, h,
                                      DOF_PASS_SPP, 0, dev)
    dof_pass()
    ik.intersect_brute.launches = 0
    ik.intersect_brute_motion.launches = 0
    with recording_brute_motion() as calls:
        start.record()
        img = dof_pass()
        stop.record()
        torch.cuda.synchronize()
    dof_launches = ik.intersect_brute_motion.launches
    check(len(calls) == dof_launches == per_pass
          and ik.intersect_brute.launches == 0,
          f"dofmotion pass: {len(calls)} motion queries, launches "
          f"{dof_launches} / {ik.intersect_brute.launches}, the loop "
          f"implies {per_pass}")
    dof_err = _hold_brute_motion("dofmotion pass", calls)
    args = calls[0][0]
    n_rays = args[3].shape[0]

    def kern():
        return ik.intersect_brute_motion(*args[:6], args[-1], *args[6:9])

    def twin():
        return ik._intersect_reference(*args[:-1], time=args[-1])
    kern()
    ms_k = sync_ms(kern, 5)
    ms_t = sync_ms(twin, 1)
    # the static kernel on the same rays (shutter time 0's rows), in turns
    st = ik.pack_scene(scene)

    def static():
        return ik.intersect_brute(*st, *args[3:6], *args[6:9])
    static()
    turn = {"static": 0.0, "motion": 0.0}
    for name, fn in (("static", static), ("motion", kern), ("motion", kern),
                     ("static", static)):
        turn[name] += sync_ms(fn, 5) / 2
    ibound = motion_intersect_bound(scene, n_rays)
    dof = {"spp": DOF_PASS_SPP, "lanes": n_rays, "launches": dof_launches,
           "render_pass_cuda_ms": start.elapsed_time(stop),
           "kernel_vs_twin_max_abs_err": dof_err, "kernel_ms": ms_k,
           "twin_ms": ms_t, "turns_ms": turn, "bound_ms": ibound[0],
           "bound_by": ibound[1], "mean": float(img.double().mean())
           / DOF_PASS_SPP}
    print(f"phase 20 dofmotion pass {w}² × {DOF_PASS_SPP} spp (every query "
          "on the motion variant, each held to its twin; the camera rays' "
          "query timed): " + json.dumps(dof))
    check(bool(torch.isfinite(img).all()) and dof["mean"] > 0.01,
          "the dofmotion pass")
    out["dofmotion"] = dof
    del calls, scene, img

    # (e) a BVH scene with motion: the heightfield with a moving cone
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "moving_heightfield.pbrt")
        write_moving_heightfield_file(path)
        scene, cam, opts = load_pbrt(path, device=dev)
    check(scene.has_motion and scene.bvh is not None
          and scene.bvh.built_by == "native-sah"
          and scene.bvh.tris_motion is not None,
          f"the moving heightfield: {scene.bvh.built_by}")
    cfg = render_mod.RenderConfig(integrator="path", max_depth=MAX_DEPTH)

    def hf_pass():
        return render_mod.render_pass(scene, cam, filt, cfg, W, H, CHUNK, 0,
                                      dev)
    hf_pass()
    per = _loop_queries(scene, MAX_DEPTH)
    bk.bvh_traverse.launches = 0
    bk.bvh_traverse_motion.launches = 0
    with recording_traversal_motion() as tcalls:
        start.record()
        img = hf_pass()
        stop.record()
        torch.cuda.synchronize()
    hf_launches = bk.bvh_traverse_motion.launches
    check(len(tcalls) == hf_launches == per
          and bk.bvh_traverse.launches == 0,
          f"moving heightfield: {len(tcalls)} motion traversals, "
          f"{bk.bvh_traverse.launches} static, the loop implies {per}")
    t_err, stats = 0.0, {}
    for k, ((o, d, tmax, tm, any_hit), (t, i)) in enumerate(tcalls):
        # the twin's test counts on the camera rays give the bound
        t_ref, i_ref = bk.traverse_reference(scene.bvh, o, d, tmax, any_hit,
                                             time=tm,
                                             stats=stats if k == 0 else None)
        t_err = max(t_err, float((t - t_ref).abs().max()))
        check(torch.equal(t, t_ref) and torch.equal(i, i_ref),
              f"moving heightfield: the motion variant differs from its "
              f"twin (t err {t_err})")
    (o, d, tmax, tm, _), _ = tcalls[0]
    bvh = scene.bvh

    def tkern():
        return bk.bvh_traverse_motion(bvh, o, d, tmax, tm, False)

    def ttwin():
        return bk.traverse_reference(bvh, o, d, tmax, False, time=tm)

    def tstatic():
        return bk.bvh_traverse(bvh, o, d, tmax, False)
    tkern()
    tstatic()
    tms_k = sync_ms(tkern, 5)
    tms_t = sync_ms(ttwin, 1)
    tturn = {"static": 0.0, "motion": 0.0}
    for name, fn in (("static", tstatic), ("motion", tkern),
                     ("motion", tkern), ("static", tstatic)):
        tturn[name] += sync_ms(fn, 5) / 2
    tbound = motion_traverse_bound(bvh, o.shape[0], stats)
    hf = {"tris": scene.n_tri, "moving_tris": int(
        (scene.geom.tri_dv0.abs().amax(-1) > 0).sum()), "lanes": W * H * CHUNK,
        "launches": hf_launches, "render_pass_cuda_ms": start.elapsed_time(
            stop), "kernel_vs_twin_max_abs_err": t_err,
        "camera_kernel_ms": tms_k, "camera_twin_ms": tms_t,
        "turns_ms": tturn, "bound_ms": tbound[0], "bound_by": tbound[1],
        "twin_counts": stats, "mean": float(img.double().mean()) / CHUNK}
    print(f"phase 20 moving heightfield, `path` {W}² × {CHUNK} spp (every "
          "traversal on the motion variant, each held to its twin; the "
          "camera rays' query timed): " + json.dumps(hf))
    check(bool(torch.isfinite(img).all()) and hf["mean"] > 0.05,
          "the moving heightfield pass")
    out["bvh"] = hf
    out["kernel"] = {"sppm": sppm_k}
    return out


# ---------------------------------------------------------------------------
# phase 21: curves, the hair and Fourier materials, the other samplers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_curve_fold():
    """Record every curve fold (scene/intersect.py::closest_curve) as (its
    arguments, its outputs); the fold still runs."""
    calls = []
    inner = isect_mod.closest_curve

    def record(scene, o, d, best_t, prim_id):
        out = inner(scene, o, d, best_t, prim_id)
        calls.append(((o.detach().clone(), d.detach().clone(),
                       best_t.detach().clone(), prim_id.clone()), out))
        return out
    isect_mod.closest_curve = record
    try:
        yield calls
    finally:
        isect_mod.closest_curve = inner


def curve_fold_vs_cpu(scene, call, n):
    """The card's curve fold on the first ``n`` rays of one recorded call
    against the same fold on the CPU: the rays, the curve hits, the prims
    off, and for t, u and v on the hits of the same curve the lanes off
    by more than rtol 1e-6 and the largest absolute and relative
    errors."""
    (o, d, best_t, prim), (t, pr, (u, v)) = call
    cpu = to_device(scene, "cpu")
    t_c, pr_c, (u_c, v_c) = isect_mod.closest_curve(
        cpu, *(x[:n].cpu() for x in (o, d, best_t, prim)))
    t, pr, u, v = (x[:n].cpu() for x in (t, pr, u, v))
    base = scene.n_tri + scene.n_sph + scene.n_pln + scene.n_dsk
    same = pr == pr_c
    crv = same & (pr >= base)
    out = {"rays": n, "curve_hits": int(crv.sum()),
           "prim_off": int((~same).sum())}
    for k, a, b in (("t", t, t_c), ("u", u, u_c), ("v", v, v_c)):
        err = torch.where(crv, (a - b).abs(), 0.0)
        rel = err / b.abs().clamp_min(1e-30)
        out[k] = {"off_rtol_1e-6": int((rel > 1e-6).sum()),
                  "max_abs_err": float(err.max()),
                  "max_rel_err": float(rel.max())}
    return out


def write_curves_heightfield_file(path):
    """Phase 10's heightfield file with curves_oracle.pbrt's two curves
    added, moved and scaled into the box (Translate 0.4 0.25 0.45, Scale
    0.3): a BVH scene whose every query folds the curves in after the
    traversal and the brute-force kernel."""
    write_heightfield_file(path)
    with open(CURVES_FILE) as f:
        text = f.read()
    i = text.index('Material "matte" "rgb Kd" [0.2 0.5 0.3]')
    block = text[i:text.index("AttributeEnd", i)]
    check(block.count('Shape "curve"') == 2, "curves_oracle's two curves")
    with open(path) as f:
        hf = f.read()
    check(hf.count("WorldEnd") == 1, "the heightfield file's WorldEnd")
    hf = hf.replace("WorldEnd", "AttributeBegin\nTranslate 0.4 0.25 0.45\n"
                    "Scale 0.3 0.3 0.3\n" + block + "AttributeEnd\nWorldEnd")
    with open(path, "w") as f:
        f.write(hf)


def _lambertian_bsdf(path, rho, n_mu=64):
    """tests/test_fourier.py's table: f = rho/π, the k = 0 term only, in
    the reflection quadrants."""
    mu = np.linspace(-1.0, 1.0, n_mu)
    fourier_mod.write_bsdf(path, mu, [
        [np.float32([[rho / np.pi * abs(a) if a * b < 0 else 0.0]])
         for b in mu] for a in mu], eta=1.0)


def _curves_oracle_in_process(dev, card, start, stop):
    """Phase 21 (a)'s in-process render of curves_oracle at
    tests/test_oracle.py's call: every query held to the twin, the curve
    fold against the CPU's. Returns (its row, the kernel rows)."""
    scene, cam, opts = load_pbrt(CURVES_FILE, device=dev)
    check(scene.n_crv == 2 and scene.bvh is None, "curves_oracle's tables")
    depth = opts["max_depth"]
    per_pass = _loop_queries(scene, depth)
    ref = imageio.read_pfm(CURVES_REF)
    # one pass at the call (96² × 64 spp); the render warmed up first
    render_mod.render(scene, cam, spp=1, integrator="path", max_depth=depth,
                      device=dev)
    ik.intersect_brute.launches = 0
    with recording_brute_force() as calls, recording_curve_fold() as folds:
        start.record()
        img = render_mod.render(scene, cam, spp=CURVES_SPP,
                                integrator="path", max_depth=depth, seed=2,
                                device=dev)
        stop.record()
        torch.cuda.synchronize()
    launches = ik.intersect_brute.launches
    w, h = cam.resolution
    check(len(calls) == launches == per_pass * _cli_passes(w, h, CURVES_SPP),
          f"curves_oracle: {len(calls)} queries, {launches} launches, the "
          f"loop implies {per_pass} a pass")
    held = _hold_brute("curves_oracle", calls)
    fold = curve_fold_vs_cpu(scene, folds[0], CURVE_FOLD_RAYS)
    img = img.cpu().numpy()
    row = {"card": card, "spp": CURVES_SPP, "lanes": w * h * CURVES_SPP,
           "render_cuda_ms": start.elapsed_time(stop), "launches": launches,
           "launches_expected": per_pass, "held_queries": len(calls),
           "kernel_vs_twin_max_abs_err": held,
           "curve_fold_tile": shapes_mod.curve_tile(w * h * CURVES_SPP,
                                                    scene.n_crv),
           "curve_fold_vs_cpu": fold, "md": _mean_delta(img, ref),
           "bl": _block_rel_l1(img, ref, k=16)}
    print("phase 21 curves_oracle in process (tests/test_oracle.py's "
          "call): " + json.dumps(row))
    check(np.isfinite(img).all() and row["md"] < CURVES_LIMITS[0]
          and row["bl"] < CURVES_LIMITS[1],
          f"curves_oracle md {row['md']:.4f} bl {row['bl']:.4f}")
    # CUDA's rsqrt, sqrt and division are not the CPU's to the last bit:
    # the frame and the chord's closest point move by an ulp, and v
    # divides the distance to the chord by the half width (u and v are
    # held as tests/test_torch_curves.py holds the port to pbrt_tpu)
    check(fold["prim_off"] <= fold["rays"] // 1000
          and fold["t"]["off_rtol_1e-6"] <= fold["curve_hits"] // 1000
          and fold["u"]["max_abs_err"] <= 1e-5
          and fold["v"]["max_abs_err"] <= 1e-4
          and fold["curve_hits"] > fold["rays"] // 50,
          f"the curve fold on the card against the CPU's: {fold}")
    return row, {"curves_oracle": {"launches": launches,
                                   "held_queries": len(calls),
                                   "max_abs_err": held}}


def curves_files(dev):
    """Phase 21: curves, hair, Fourier and the samplers (see the module's
    docstring). Returns the numbers for the JSON lines."""
    card = card_line()
    out = {"card": card}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    filt = film_mod.make_filter("box", device=dev)

    t_item = time.perf_counter()
    secs = {}
    # (a) curves_oracle: the CLI at the file's own spp, started first
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    cli = start_cli(CURVES_FILE, os.path.join(tmp, "c.pfm"))
    try:
        row, kern = _curves_oracle_in_process(dev, card, start, stop)
    except BaseException:
        cli[1].kill()
        cli[1].wait()
        raise
    out["oracle"] = row
    ref = imageio.read_pfm(CURVES_REF)
    per_pass, w, h = row["launches_expected"], ref.shape[1], ref.shape[0]
    sm = finish_cli(cli)
    cli_img = imageio.read_pfm(os.path.join(tmp, "c.pfm"))
    crow = {k: sm[k] for k in ("render_s", "render_cuda_ms", "process_s",
                               "launches", "spp", "mean")}
    crow.update(card=card, md=_mean_delta(cli_img, ref),
                bl=_block_rel_l1(cli_img, ref, k=16),
                launches_expected=per_pass * _cli_passes(w, h,
                                                         CURVES_CLI_SPP))
    print("phase 21 curves_oracle CLI (the file's 256 spp, halton): "
          + json.dumps(crow))
    check(sm["spp"] == CURVES_CLI_SPP and cli_img.shape == ref.shape
          and sm["launches"]["intersect_brute"] == crow["launches_expected"]
          and crow["md"] < CURVES_LIMITS[0]
          and crow["bl"] < CURVES_LIMITS[1], f"curves CLI: {crow}")
    out["cli"] = crow
    kern["curves_cli"] = crow["launches"]["intersect_brute"]

    secs["a"] = time.perf_counter() - t_item
    t_item = time.perf_counter()
    # (b) the fur cell: 128 strands at full width
    scene = entry._fur_scene(dev, n_strands=FUR_STRANDS)
    cam = entry._fur_camera((W, H), dev)
    cfg = render_mod.RenderConfig(integrator="path", max_depth=FUR_DEPTH)
    per_pass = _loop_queries(scene, FUR_DEPTH)

    def fur_pass(crop=None, spp=FUR_SPP, device=dev, sc=scene, cm=cam,
                 fl=filt):
        return render_mod.render_pass(sc, cm, fl, cfg, W, H, spp, 0,
                                      device, crop=crop)
    fur_pass(crop=FUR_CROP, spp=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    # the whole pass by CUDA events, its launches by the wrapper's count
    ik.intersect_brute.launches = 0
    start.record()
    img = fur_pass()
    stop.record()
    torch.cuda.synchronize()
    pass_ms = start.elapsed_time(stop)
    launches = ik.intersect_brute.launches
    peak = torch.cuda.max_memory_allocated(dev) - resident
    tile = shapes_mod.curve_tile(W * H * FUR_SPP, scene.n_crv)
    mean = float(img.double().mean()) / FUR_SPP
    # one query under the device-only profiler: the closest hit of the
    # pass's camera rays (one brute-force launch, then the curve fold),
    # and the same query with the fold left out (its rays then see no
    # curve); a whole pass is some 320,000 kernel records, which the
    # profiler reads back for minutes
    rays = render_mod.camera_rays(cam, filt, cfg, W, H, FUR_SPP, 0, dev)[0]
    inf = torch.full((rays.o.shape[0],), float("inf"), device=dev)

    def fur_query():
        return isect_mod.intersect(scene, rays.o, rays.d, inf)
    q0 = ik.intersect_brute.launches
    fur_query()
    q_launches = ik.intersect_brute.launches - q0
    dev_ms, _, traces = device_ms_by_kernel(fur_query, [], cpu=False)
    inner = isect_mod.closest_curve
    isect_mod.closest_curve = lambda sc, o, d, t, prim: (t, prim, None)
    try:
        dev_ms_nofold, _, _ = device_ms_by_kernel(fur_query, [], cpu=False)
    finally:
        isect_mod.closest_curve = inner
    fold_ms = dev_ms - dev_ms_nofold
    # kernel 2's time on the query's own inputs by CUDA events: the
    # profiler's traces of this query lost kernel 2's one record three
    # times in a row (the wrapper's count says it launched)
    with recording_brute_force() as calls:
        fur_query()
    k2_args = calls[0][0]
    k2_ms = sync_ms(lambda: ik.intersect_brute(*k2_args), 5)
    del calls, k2_args
    del rays, inf
    crop_card = fur_pass(crop=FUR_CROP, spp=FUR_CROP_SPP)
    cpu_scene = to_device(scene, "cpu")
    crop_cpu = fur_pass(crop=FUR_CROP, spp=FUR_CROP_SPP, device="cpu",
                        sc=cpu_scene, cm=entry._fur_camera((W, H), "cpu"),
                        fl=film_mod.make_filter("box"))
    crop_rel = abs(float(crop_card.double().mean())
                   / float(crop_cpu.double().mean()) - 1.0)
    lanes = W * H * FUR_SPP
    row = {"card": card, "strands": scene.n_crv, "lanes": lanes,
           "spp": FUR_SPP, "max_depth": FUR_DEPTH, "render_pass_cuda_ms":
           pass_ms, "launches": launches, "launches_expected": per_pass,
           # the camera rays' closest-hit query, profiled alone; kernel
           # 2's time on its inputs by CUDA events
           "query_device_ms": dev_ms, "query_launches": q_launches,
           "intersect_ms": k2_ms, "intersect_share": k2_ms / dev_ms,
           "curve_fold_device_ms": fold_ms,
           "curve_fold_share": fold_ms / dev_ms, "profile_traces": traces,
           "peak_mib": peak / 2**20, "bytes_per_lane": peak / lanes,
           "curve_fold_tile": tile, "mean": mean,
           "crop": {"window": FUR_CROP, "spp": FUR_CROP_SPP,
                    "card_mean": float(crop_card.double().mean()),
                    "cpu_mean": float(crop_cpu.double().mean()),
                    "rel": crop_rel}}
    print(f"phase 21 fur cell, {FUR_STRANDS} strands, `path` {W}² × "
          f"{FUR_SPP} spp: " + json.dumps(row))
    check(launches == per_pass and q_launches == 1,
          f"fur launches {launches} (the loop implies {per_pass}), the "
          f"profiled query's {q_launches}")
    check(bool(torch.isfinite(img).all()) and mean > 0.001,
          "the fur cell's image")
    check(crop_rel < 1e-3, f"the fur crop on the card against the CPU "
          f"twins: {row['crop']}")
    out["fur"] = row
    kern["fur"] = launches
    del scene, img, cpu_scene

    secs["b"] = time.perf_counter() - t_item
    t_item = time.perf_counter()
    # (c) a BVH scene with curves: phase 10's heightfield file + 2 curves
    path = os.path.join(tmp, "hf_curves.pbrt")
    write_curves_heightfield_file(path)
    scene, cam, opts = load_pbrt(path, device=dev)
    check(scene.bvh is not None and scene.n_crv == 2,
          "the heightfield with curves: a BVH and two curves")
    cfg = render_mod.RenderConfig(integrator="path", max_depth=MAX_DEPTH)
    per = _loop_queries(scene, MAX_DEPTH)

    def hf_pass():
        return render_mod.render_pass(scene, cam, filt, cfg, W, H, CHUNK, 0,
                                      dev)
    hf_pass()
    bk.bvh_traverse.launches = 0
    ik.intersect_brute.launches = 0
    with recording_traversal() as tcalls, \
            recording_brute_families() as bcalls:
        start.record()
        img = hf_pass()
        stop.record()
        torch.cuda.synchronize()
    t_launches = bk.bvh_traverse.launches
    b_launches = ik.intersect_brute.launches
    check(len(tcalls) == t_launches == per and len(bcalls) == b_launches
          == per, f"heightfield with curves: {t_launches} traversals, "
          f"{b_launches} brute-force, the loop implies {per} each")
    t_err = 0.0
    for (o, d, tmax, any_hit), (t, i) in tcalls:
        t_ref, i_ref = bk.traverse_reference(scene.bvh, o, d, tmax, any_hit)
        t_err = max(t_err, float((t - t_ref).abs().max()))
        check(torch.equal(t, t_ref) and torch.equal(i, i_ref),
              f"heightfield with curves: traversal differs from its twin "
              f"(t err {t_err})")
    b_err = _hold_brute("heightfield with curves", bcalls)
    row = {"card": card, "tris": scene.n_tri, "curves": scene.n_crv,
           "lanes": W * H * CHUNK, "render_pass_cuda_ms":
           start.elapsed_time(stop), "traverse_launches": t_launches,
           "brute_launches": b_launches, "launches_expected": per,
           "traverse_max_abs_err": t_err, "brute_max_abs_err": b_err,
           "mean": float(img.double().mean()) / CHUNK}
    print(f"phase 21 heightfield with curves, `path` {W}² × {CHUNK} spp "
          "(every query held to the twins): " + json.dumps(row))
    check(bool(torch.isfinite(img).all()) and row["mean"] > 0.05,
          "the heightfield-with-curves pass")
    out["bvh"] = row
    kern["bvh"] = {"traverse": t_launches, "brute": b_launches,
                   "traverse_max_abs_err": t_err, "brute_max_abs_err": b_err}
    del tcalls, bcalls, scene, img

    secs["c"] = time.perf_counter() - t_item
    t_item = time.perf_counter()
    # (d) the Fourier and hair furnaces
    bsdf = os.path.join(tmp, "lambertian.bsdf")
    _lambertian_bsdf(bsdf, FOURIER_FURNACE[0])
    b = SceneBuilder()
    fid = b.add_fourier_table(bsdf)
    m = b.add_material(type=mat_mod.FOURIER, fourier_id=fid)
    b.add_sphere((0, 0, 3), 1.0, mat=m)
    b.add_light(type="infinite", L=1.0, env_map=np.ones((1, 1, 3),
                                                        np.float32))
    scene = b.build(dev)
    cam = cam_mod.make_perspective(transform.look_at(
        (0, 0, 0), (0, 0, 3), (0, 1, 0), device=dev), 20.0, (W, H),
        device=dev)
    cfg = render_mod.RenderConfig(integrator="path", max_depth=2)
    ik.intersect_brute.launches = 0
    start.record()
    img = render_mod.render_pass(scene, cam, filt, cfg, W, H, CHUNK, 0, dev)
    stop.record()
    torch.cuda.synchronize()
    four = {"card": card, "lanes": W * H * CHUNK,
            "render_pass_cuda_ms": start.elapsed_time(stop),
            "launches": ik.intersect_brute.launches,
            "mean": float(img.double().mean()) / CHUNK}
    n = HAIR_FURNACE_N
    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.rand(3, n, device=dev, generator=g)
    wo = torch.tensor([0.3, 0.5, 0.81], device=dev)
    wi, f, pdf = hair_mod.hair_sample(
        (wo / wo.norm()).expand(n, 3), torch.full((n,), 0.3, device=dev),
        torch.zeros(n, 3, device=dev), u[0], u[1], u[2], beta_m=0.25,
        beta_n=0.3, alpha=2.0)
    est = (f * wi[:, 2:3].abs() / pdf.clamp_min(1e-12)[:, None]).mean(0)
    four["hair_white_furnace"] = est.tolist()
    print("phase 21 furnaces (a Lambertian Fourier sphere under a constant "
          f"environment, {W}² × {CHUNK} spp; hair sampled with sigma_a 0 "
          f"over {n} samples): " + json.dumps(four))
    check(abs(four["mean"] - FOURIER_FURNACE[0]) < FOURIER_FURNACE[1],
          f"the Fourier furnace's mean {four['mean']}")
    check(float((est - 1.0).abs().max()) < HAIR_FURNACE_ATOL,
          f"the hair furnace {est.tolist()}")
    out["furnaces"] = four
    kern["fourier"] = four["launches"]
    del scene, img
    tmp_dir.cleanup()

    secs["d"] = time.perf_counter() - t_item
    t_item = time.perf_counter()
    # (e) the samplers: the card's values against the CPU's, then passes
    rs = np.random.RandomState(21)
    n = 1 << 20
    pid = rs.randint(0, W * H, n)
    sidx = rs.randint(0, 512, n)
    sidx[: n // 4] = rs.randint(1 << 16, 1 << 31, n // 4)
    dims = rs.randint(0, len(SAMPLER_DIMS), n)
    samp = {}
    for name, res in SAMPLER_NAMES:
        sf = make_sampler(name, resolution=res)
        same = 0
        for k, dim in enumerate(SAMPLER_DIMS):
            on = dims == k
            p_, s_ = (torch.as_tensor(x[on]) for x in (pid, sidx))
            card_v = sf(p_.to(dev), s_.to(dev), dim, 3).cpu()
            cpu_v = sf(p_, s_, dim, 3)
            check(torch.equal(card_v, cpu_v), f"sampler {name} {res} dim "
                  f"{dim}: the card's values differ from the CPU's")
            same += int(on.sum())
        samp[f"{name}{'' if res is None else '@%dx%d' % res}"] = same
    with open(SAMPLER_MEANS) as fh:
        ref_means = json.load(fh)
    scene = entry._sphere_cornell(dev)
    res = ref_means["res"]
    cam = entry._camera((res, res), dev)
    passes = {}
    for name, want in ref_means["means"].items():
        cfg = render_mod.RenderConfig(integrator="path", sampler=name,
                                      max_depth=ref_means["max_depth"])
        ik.intersect_brute.launches = 0
        start.record()
        img = render_mod.render_pass(scene, cam, filt, cfg, res, res,
                                     ref_means["spp"], 0, dev)
        stop.record()
        torch.cuda.synchronize()
        got = float(img.double().mean())
        passes[name] = {"mean": got, "ref": want,
                        "rel": abs(got / want - 1.0),
                        "render_pass_cuda_ms": start.elapsed_time(stop),
                        "launches": ik.intersect_brute.launches}
        check(passes[name]["rel"] < 1e-3, f"the {name} pass: "
              f"{passes[name]}")
    row = {"card": card, "triples_bit_equal": samp, "passes": passes}
    print(f"phase 21 samplers (2^20 seeded triples each, card against CPU; "
          f"{res}² × {ref_means['spp']}-spp `path` passes of "
          "_sphere_cornell against pbrt_tpu's means): " + json.dumps(row))
    out["samplers"] = row
    kern["sampler_passes"] = sum(v["launches"] for v in passes.values())
    out["kernel"] = kern
    secs["e"] = time.perf_counter() - t_item
    out["item_s"] = secs
    print(f"phase 21 seconds by item: {json.dumps(secs)}")
    return out


# ---------------------------------------------------------------------------
# phase 22: the kd-tree, kernel 2 past 4,096 primitives, the sharded path
# and the training step over NCCL, checkpoints and the tools
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording_kd_walk(keep_full=()):
    """Record every kd walk of scene/kdtree.py: a KD_SUBSET-ray subset of
    its rays (every R / KD_SUBSET-th) with the kernel's (t, prim) there
    and whether it was the any-hit walk, the whole rays of the walks whose
    ordinals are in ``keep_full``, and the whole rays and prims of every
    any-hit walk. Yields (subsets, {ordinal: (o, d, tmax)}, [(o, d, tmax,
    prim)]); the kernel's wrapper still counts its launches."""
    calls, full, shadows = [], {}, []
    inner = kd_mod.kdtree_intersect_tris

    def record(kd, o, d, tmax, any_hit=False):
        t, prim, hit = inner(kd, o, d, tmax, any_hit)
        n = o.shape[0]
        idx = torch.arange(0, n, max(1, n // KD_SUBSET),
                           device=o.device)[:KD_SUBSET]
        calls.append((o[idx], d[idx], tmax[idx], t[idx], prim[idx],
                      any_hit))
        if len(calls) - 1 in keep_full:
            full[len(calls) - 1] = (o.clone(), d.clone(), tmax.clone())
        if any_hit:
            shadows.append((o.clone(), d.clone(), tmax.clone(),
                            prim.clone()))
        return t, prim, hit
    kd_mod.kdtree_intersect_tris = record
    try:
        yield calls, full, shadows
    finally:
        kd_mod.kdtree_intersect_tris = inner


def kd_bound(kd, n_rays, counts):
    """Each ray read once (28 B) and written once (8 B), the kernel's
    tables (8-byte nodes, 48-byte leaf-ordered records) once; the node
    steps and triangle tests the twin counted on these rays."""
    table = sum(t.numel() * t.element_size() for t in (kd.nodes, kd.tris))
    return bound_ms(36 * n_rays + table, OPS_NODE * counts["node_steps"]
                    + OPS_TRI * counts["tri_tests"])


def kd_cell(dev, card, start, stop, filt):
    """(a) The kd-tree at full width; returns the phase's row for it."""
    cfg = render_mod.RenderConfig(integrator="path", max_depth=KD_DEPTH)
    cam = entry._camera((W, H), dev)
    b = SceneBuilder()
    entry._fill_heightfield_cornell(b)
    base = b.build(dev, use_bvh="never")
    t0 = time.perf_counter()
    kd = kd_mod.build_kdtree(base)
    build_s = time.perf_counter() - t0
    scene = dataclasses.replace(base, bvh=kd)
    hf = b.build(dev)                  # the same scene on its BVH
    check(scene.n_tri == 133130 and isinstance(hf.bvh, bvh_mod.FlatBVH)
          and scene.fused_profile is None, "the kd cell's scene")
    per_pass = _loop_queries(scene, KD_DEPTH)
    marks = [time.perf_counter()]     # the seconds of each item below

    def kd_pass(sc=scene, c=cfg):
        return render_mod.render_pass(sc, cam, filt, c, W, H, KD_SPP, 0,
                                      dev)
    cfg_ao = render_mod.RenderConfig(integrator="ao")  # default radius
    walk = kd_ops.kd_traverse
    walk.launches = walk.any_hit_launches = 0
    # the queries of a `path` bounce, all closest-hit walks: 0 the camera
    # rays', 1 NEE's shadow ray (its trace takes the emission of what it
    # hits, so the walk finds the closest hit), 2 the BSDF half's ray, 3
    # the next bounce's; then the `ao` pass: its camera rays' walk and its
    # occlusion rays' any-hit walk (per_pass + 1)
    with recording_kd_walk(keep_full=(0, 1, 3, per_pass + 1)) as (
            calls, full, shadows):
        img = kd_pass()
        img_ao = kd_pass(c=cfg_ao)
        torch.cuda.synchronize()
    launches, any_launches = walk.launches, walk.any_hit_launches
    modes = [c[5] for c in calls]
    check(launches == per_pass + 2 == len(calls),
          f"kd walks {launches}, recorded {len(calls)}, the loop implies "
          f"{per_pass} + the ao pass's 2")
    check(any_launches == sum(modes) == len(shadows) == 1 and modes[-1],
          f"kd any-hit walks {any_launches}, recorded modes {modes}")
    start.record()
    img_again = kd_pass()
    stop.record()
    torch.cuda.synchronize()
    pass_ms = start.elapsed_time(stop)
    check(torch.equal(img, img_again), "two kd passes differ")
    marks.append(time.perf_counter())
    worst = {False: 0.0, True: 0.0}
    for k, (o, d, tmax, t, prim, any_hit) in enumerate(calls):
        t_ref, prim_ref = kd_ops.traverse_reference(kd, o, d, tmax, any_hit)
        worst[any_hit] = max(worst[any_hit],
                             float((t - t_ref).abs().max()))
        check(torch.equal(prim, prim_ref) and torch.equal(t, t_ref),
              f"kd walk {k} (any hit: {any_hit}): the kernel differs from "
              f"its twin (t err {worst})")
    # the any-hit walk's boolean is the closest-hit walk's on every
    # occlusion ray of the ao pass
    n_shadow_rays = 0
    for k, (o, d, tmax, prim) in enumerate(shadows):
        _, p_c = walk(kd, o, d, tmax)
        check(torch.equal(prim >= 0, p_c >= 0),
              f"any-hit walk {k}: its boolean differs from the closest "
              f"hit's on {int(((prim >= 0) != (p_c >= 0)).sum())} rays")
        n_shadow_rays += o.shape[0]
    del shadows
    marks.append(time.perf_counter())
    # the same estimator on the BVH (the same samples): the means agree
    img_bvh = kd_pass(hf)
    m_kd, m_bvh = float(img.double().mean()), float(img_bvh.double().mean())
    rel = abs(m_kd / m_bvh - 1.0)
    px_off = float(((img - img_bvh).abs().amax(-1) > 1e-4).float().mean())
    check(bool(torch.isfinite(img).all()) and rel < 1e-3,
          f"kd image mean {m_kd} against the BVH's {m_bvh}")
    img_ao_bvh = kd_pass(hf, cfg_ao)
    m_ao, m_ao_bvh = (float(x.double().mean()) for x in (img_ao,
                                                         img_ao_bvh))
    rel_ao = abs(m_ao / m_ao_bvh - 1.0)
    check(bool(torch.isfinite(img_ao).all()) and rel_ao < 1e-3,
          f"kd ao image mean {m_ao} against the BVH's {m_ao_bvh}")
    # one query, the camera rays' closest hit (the walk, the sphere and
    # the aaplane through kernel 2, the hit record): its launches by the
    # wrappers' counts; its torch kernels' device time by the device-only
    # profiler, whose traces of this query drop the two custom kernels'
    # records in most runs (seen: 2 of 3 traces); the walk's and kernel
    # 2's times on the query's own inputs by CUDA events
    o_c, d_c, tmax_c = full[0]
    inf = torch.full_like(tmax_c, float("inf"))

    def query():
        return isect_mod.intersect(scene, o_c, d_c, inf)
    w0, k0 = walk.launches, ik.intersect_brute.launches
    query()
    q_launches = (walk.launches - w0, ik.intersect_brute.launches - k0)
    prof_ms, by, traces = device_ms_by_kernel(
        query, ["kd_traverse_kernel", "intersect_kernel"], cpu=False)
    torch_ms = (prof_ms - by["kd_traverse_kernel"][0]
                - by["intersect_kernel"][0])
    t_c, _ = walk(kd, o_c, d_c, tmax_c)
    k2_args = ik.pack_scene(scene, tris=False) + (
        o_c, d_c, t_c, 0, scene.n_sph, scene.n_pln)
    k2_ms = sync_ms(lambda: ik.intersect_brute(*k2_args), 5)
    del k2_args
    marks.append(time.perf_counter())
    # the walk against kernel 3 on the same rays, in turns, each set
    # through the walk the pass gives it (the occlusion rays through the
    # any-hit walk, and also through the closest-hit one);
    # the twin on the camera and occlusion rays (all of them, bit for bit)
    # with its counts
    ms = {}
    for name, i, any_hit in (("camera", 0, False), ("shadow", 1, False),
                             ("bounce", 3, False),
                             ("ao", per_pass + 1, True)):
        o, d, tmax = full[i]

        def kd_fn():
            return walk(kd, o, d, tmax, any_hit)

        def kd_closest_fn():
            return walk(kd, o, d, tmax)

        def bvh_fn():
            return bk.bvh_traverse(hf.bvh, o, d, tmax, any_hit)
        fns = (kd_fn, bvh_fn) + ((kd_closest_fn,) if any_hit else ())
        for fn in fns:
            fn()
        got = {}
        for fn in fns + fns[::-1]:
            got[fn] = got.get(fn, 0.0) + sync_ms(fn, 10) / 2
        ms[name] = {"kd_ms": got[kd_fn], "bvh_ms": got[bvh_fn],
                    "finite_tmax_share": float(torch.isfinite(
                        tmax).float().mean())}
        if any_hit:
            ms[name]["kd_closest_ms"] = got[kd_closest_fn]
    marks.append(time.perf_counter())
    twin = {}
    for name, i, any_hit in (("camera", 0, False),
                             ("ao", per_pass + 1, True)):
        o, d, tmax = full[i]
        t_k, p_k = walk(kd, o, d, tmax, any_hit)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_ref, p_ref, counts = kd_ops.traverse_reference(
            kd, o, d, tmax, any_hit, counts=True)
        torch.cuda.synchronize()
        twin[name] = (1e3 * (time.perf_counter() - t0), counts,
                      kd_bound(kd, o.shape[0], counts))
        check(torch.equal(t_k, t_ref) and torch.equal(p_k, p_ref),
              f"kd walk on the {name} rays: the kernel differs from its "
              f"twin")
    marks.append(time.perf_counter())
    twin_ms, counts, bnd = twin["camera"]
    row = {"card": card, "triangles": scene.n_tri,
           "nodes": kd.nodes.shape[0], "prim_ids": kd.prim_ids.shape[0],
           "max_leaf": kd.max_leaf, "depth": kd.depth,
           "host_build_s": build_s, "lanes": W * H * KD_SPP,
           "spp": KD_SPP, "max_depth": KD_DEPTH,
           "render_pass_cuda_ms": pass_ms, "launches": launches,
           "any_hit_launches": any_launches,
           "launches_expected": per_pass + 2, "held_rays_per_query":
           calls[0][0].shape[0], "max_abs_err": worst[False],
           "any_hit_max_abs_err": worst[True],
           "shadow_rays_any_equals_closest": n_shadow_rays,
           "query_launches": q_launches, "query_torch_device_ms": torch_ms,
           "query_device_ms": torch_ms + ms["camera"]["kd_ms"] + k2_ms,
           "walk_ms": ms["camera"]["kd_ms"],
           "walk_share": ms["camera"]["kd_ms"]
           / (torch_ms + ms["camera"]["kd_ms"] + k2_ms),
           "kernel2_ms": k2_ms, "profile_traces": traces,
           "profiled_custom_records": [by["kd_traverse_kernel"][1],
                                       by["intersect_kernel"][1]],
           "mean": m_kd / KD_SPP,
           "bvh_mean": m_bvh / KD_SPP, "mean_rel": rel,
           "ao_mean": m_ao / KD_SPP, "ao_bvh_mean": m_ao_bvh / KD_SPP,
           "ao_mean_rel": rel_ao, "ao_radius": cfg_ao.ao_radius,
           "pixels_off_1e-4": px_off, "turns_ms": ms,
           "twin_camera_ms": twin_ms, "counts_camera": counts,
           "bound_ms": bnd[0], "bound_by": bnd[1],
           "twin_ao_ms": twin["ao"][0], "counts_ao": twin["ao"][1],
           "bound_ao_ms": twin["ao"][2][0],
           "bound_ao_by": twin["ao"][2][1],
           "item_s": dict(zip(("passes", "twin_checks", "bvh_and_query",
                               "turns", "twin_full"),
                              np.diff(marks).tolist()))}
    print(f"phase 22 kd cell ({card}): " + json.dumps(row))
    check(q_launches == (1, 1), f"the query's launches {q_launches}")
    return row


def brute_past_4096(dev, card, start, stop, filt):
    """(b) Kernel 2 on 8,204 primitives without a BVH: one 256² × 32-spp
    pass, timed; every query held to the twin on KD_SUBSET of its rays."""
    cfg = render_mod.RenderConfig(integrator="path", max_depth=KD_DEPTH)
    cam = entry._camera((W, H), dev)
    b = SceneBuilder()
    entry._fill_heightfield_cornell(b, *BRUTE_BIG_HF)
    scene = b.build(dev, use_bvh="never")
    check(scene.bvh is None and scene.n_tri == 8202
          and scene.n_prims == 8204, "the 8,204-primitive scene")
    per_pass = _loop_queries(scene, KD_DEPTH)

    def big_pass():
        return render_mod.render_pass(scene, cam, filt, cfg, W, H, KD_SPP,
                                      0, dev)
    ik.intersect_brute.launches = 0
    with recording_brute_force() as calls:
        img = big_pass()
        torch.cuda.synchronize()
    launches = ik.intersect_brute.launches
    check(launches == per_pass == len(calls),
          f"brute-force launches {launches}, the loop implies {per_pass}")
    start.record()
    big_pass()
    stop.record()
    torch.cuda.synchronize()
    pass_ms = start.elapsed_time(stop)
    held = []
    chunk_elems = ik.CHUNK_ELEMS
    ik.CHUNK_ELEMS = 1 << 24          # the twin's fold in larger chunks
    try:
        for args, (t, prim) in calls:
            n = args[3].shape[0]
            idx = torch.arange(0, n, max(1, n // KD_SUBSET),
                               device=dev)[:KD_SUBSET]
            sub = args[:3] + tuple(a[idx] for a in args[3:6]) + args[6:]
            held.append((sub, (t[idx], prim[idx])))
        worst = _hold_brute("kernel 2 past 4,096 primitives", held)
    finally:
        ik.CHUNK_ELEMS = chunk_elems
    mean = float(img.double().mean()) / KD_SPP
    check(bool(torch.isfinite(img).all()) and mean > 1e-3,
          "the 8,204-primitive pass's image")
    row = {"card": card, "primitives": scene.n_prims,
           "lanes": W * H * KD_SPP, "render_pass_cuda_ms": pass_ms,
           "launches": launches, "launches_expected": per_pass,
           "held_rays_per_query": KD_SUBSET, "max_abs_err": worst,
           "mean": mean}
    print(f"phase 22 kernel 2 past 4,096 primitives ({card}): "
          + json.dumps(row))
    return row


GATHER_LANES, GATHER_ROWS = 1 << 22, (5, 256, 4096)
# the profiler's name for replay's material gather backward
GATHER_BWD_OP = "autograd::engine::evaluate_function: _GatherRowsBackward"


def onehot_backward(idx, g, n):
    """pbrt_tpu's one-hot gather backward, onehot(idx, n)ᵀ @ g in float32
    (TF32 is off: core/transform.py) over chunks of lanes whose one-hot
    fits fastgather.ONEHOT_BUDGET_BYTES: the alternative to ``index_add_``
    that gather_checks times."""
    out = torch.zeros((n, g.shape[1]), dtype=g.dtype, device=g.device)
    cols = torch.arange(n, device=idx.device)
    chunk = max(8, fastgather.ONEHOT_BUDGET_BYTES // (n * 4))
    for s in range(0, idx.shape[0], chunk):
        out.addmm_((idx[s:s + chunk, None] == cols).to(g.dtype).T,
                   g[s:s + chunk])
    return out


def gather_checks(dev, card):
    """(c) fastgather.gather_rows at the training step's 4,194,304 lanes
    of width 3 (replay's kd rows): for each table size the forward equal
    to ``table[idx]`` bit for bit and the backward within rtol 1e-4 of a
    float64 ``index_add_``; the forward, the backward (on a retained
    graph) and ``index_add_`` in float32 timed by CUDA events; at 5 rows
    also advanced indexing's backward (torch's ``indexing_backward``, the
    path replay left), at 256 the one-hot product's (``onehot_backward``,
    pbrt_tpu's strategy there)."""
    gen = torch.Generator(device="cpu").manual_seed(19)
    ct = (0.5 + torch.rand(GATHER_LANES, 3, generator=gen)).to(dev)
    rows = {}
    for n in GATHER_ROWS:
        table = torch.rand(n, 3, generator=gen).to(dev).requires_grad_()
        idx = torch.randint(0, n, (GATHER_LANES,), generator=gen).to(dev)
        flat = table.detach()
        out = fastgather.gather_rows(table, idx)
        (grad,) = torch.autograd.grad(out, table, ct, retain_graph=True)
        want = torch.zeros(n, 3, dtype=torch.float64, device=dev)
        want.index_add_(0, idx, ct.double())
        rel = float(((grad.double() - want).abs()
                     / want.abs().clamp_min(1e-30)).max())
        row = {"fwd_equal": bool(torch.equal(out.detach(), flat[idx])),
               "bwd_max_rel_err": rel,
               "fwd_ms": sync_ms(lambda: fastgather.gather_rows(flat, idx),
                                 20),
               "bwd_ms": sync_ms(lambda: torch.autograd.grad(
                   out, table, ct, retain_graph=True), 10),
               "index_add_ms": sync_ms(lambda: torch.zeros_like(
                   flat).index_add_(0, idx, ct), 10)}
        if n == GATHER_ROWS[0]:
            leaf = flat.clone().requires_grad_()
            old = leaf[idx]
            row["index_backward_ms"] = sync_ms(lambda: torch.autograd.grad(
                old, leaf, ct, retain_graph=True), 1)
        if n == GATHER_ROWS[1]:
            row["onehot_bwd_ms"] = sync_ms(
                lambda: onehot_backward(idx, ct, n), 10)
        rows[n] = row
        check(row["fwd_equal"], f"gather_rows' forward at {n} rows")
        check(rel <= 1e-4, f"gather_rows' backward at {n} rows: rel {rel}")
    print(f"phase 22 fastgather ({card}, {GATHER_LANES} lanes × 3): "
          + json.dumps(rows))
    return rows


def sharded_cell(dev, card):
    """(c) The sharded render, three training steps and the dry run at
    world size 1 over NCCL, on the main path's scene, after
    ``gather_checks``."""
    gather = gather_checks(dev, card)
    world = multihost.initialize_multihost(
        f"localhost:{entry._free_port()}", 1, 0, "cuda")
    check(world == 1 and torch.distributed.get_backend() == "nccl",
          "the process group")
    try:
        mesh = par_render.make_mesh(1)
        scene, cam = entry._portal_scene(dev), entry._camera((W, H), dev)

        def sharded():
            return par_render.render_sharded(scene, cam, mesh,
                                             spp=SHARD_SPP,
                                             max_depth=MAX_DEPTH)
        fp.fused_bounce.launches = 0
        img = sharded()
        shard_launches = fp.fused_bounce.launches
        torch.cuda.synchronize()
        shard_ms = sync_ms(sharded, 3)
        ref = render_mod.render(scene, cam, spp=SHARD_SPP,
                                max_depth=MAX_DEPTH, device=dev)
        err = float((img - ref).abs().max())
        torch.testing.assert_close(img, ref, rtol=2e-3, atol=3e-4)
        target = torch.zeros_like(ref)
        params = {"kd": scene.materials.kd, "emit": scene.lights.emit}
        p, losses, step_ms, step_launches = params, [], [], []
        for k in range(TRAIN_STEPS):
            fp.fused_bounce.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, loss = par_render.inverse_render_step(
                scene, cam, mesh, target, p, lr=TRAIN_LR, spp=SHARD_SPP,
                max_depth=MAX_DEPTH)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            step_launches.append(fp.fused_bounce.launches)
            if k == 0:
                g_step = {n: (p[n] - new[n]) / TRAIN_LR for n in p}
            losses.append(float(loss))
            p = new
        # single-process autograd of render() at the same call
        leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
        img1 = render_mod.render(par_render._set_params(scene, leaves), cam,
                                 spp=SHARD_SPP, max_depth=MAX_DEPTH,
                                 device=dev)
        loss1 = torch.mean((img1 - target) ** 2)
        loss1.backward()
        g_err = {}
        for n in params:
            g_err[n] = float((g_step[n] - leaves[n].grad).abs().max())
            torch.testing.assert_close(g_step[n], leaves[n].grad, rtol=2e-3,
                                       atol=1e-6)
        check(abs(losses[0] / float(loss1.detach()) - 1.0) < 1e-4,
              f"the step's loss {losses[0]} against {float(loss1.detach())}")
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"the loss does not fall: {losses}")
        # where a step's time goes: one more step (its result unused)
        # under the device-only profiler, and its host time
        step = par_render.make_train_step(
            mesh, spp=SHARD_SPP, integrator="path", max_depth=MAX_DEPTH,
            seed=0, resolution=(W, H))
        t0 = time.perf_counter()
        step_dev_ms, step_top, step_kernels, gather_bwd_ms = top_kernels(
            lambda: step(scene, cam, params, target, TRAIN_LR),
            GATHER_BWD_OP)
        step_prof_ms = 1e3 * (time.perf_counter() - t0)
        dry = entry.dryrun_multichip(1)
        check(math.isfinite(dry["loss"]) and dry["dkd"] > 0,
              f"dryrun_multichip: {dry}")
    finally:
        torch.distributed.destroy_process_group()
    row = {"card": card, "world": 1, "backend": "nccl",
           "render_sharded": {"spp": SHARD_SPP, "max_depth": MAX_DEPTH,
                              "cuda_ms": shard_ms,
                              "fused_launches": shard_launches,
                              "max_abs_err_vs_render": err},
           "train": {"steps": TRAIN_STEPS, "lr": TRAIN_LR,
                     "losses": losses, "step_ms": step_ms,
                     "fused_launches_per_step": step_launches,
                     "grad_max_abs_err": g_err,
                     "profiled_step": {
                         "host_ms": step_prof_ms, "device_ms": step_dev_ms,
                         "top_kernels": step_top,
                         "gather_bwd_device_ms": gather_bwd_ms,
                         "gather_bwd_share": None if gather_bwd_ms is None
                         else gather_bwd_ms / step_dev_ms,
                         # replay's bounces × the timed 5-row backward
                         "gather_bwd_events_share":
                             (MAX_DEPTH + 1) * gather[5]["bwd_ms"]
                             / step_dev_ms}},
           "dryrun": dry, "fastgather": gather}
    print(f"phase 22 sharded path, world size 1 over NCCL ({card}): "
          + json.dumps(row))
    prof = row["train"]["profiled_step"]
    print(f"phase 22 training step ({card}): {step_ms} ms a step (host "
          f"clock), one step's device time {step_dev_ms:.3f} ms, the "
          f"material gather's backward {prof['gather_bwd_device_ms']} ms "
          f"(share {prof['gather_bwd_share']}; by events "
          f"{prof['gather_bwd_events_share']:.4f})")
    check(step_launches == [1] * TRAIN_STEPS and shard_launches == 1,
          f"fused launches: render {shard_launches}, steps {step_launches}")
    slow = [k for k in step_kernels if "indexing_backward" in k]
    check(not slow, f"the training step runs torch's index backward: {slow}")
    return row


def checkpoint_and_tools(dev, card):
    """(d) A render stopped after one pass and resumed equals the
    uninterrupted one; bsdftest on the card; makesky against the
    reference binary's sky."""
    scene, cam = entry._portal_scene(dev), entry._camera((64, 64), dev)
    kw = dict(every_spp=8, max_depth=MAX_DEPTH, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        full = checkpoint.render_with_checkpoints(scene, cam, 16, None, **kw)
        checkpoint.render_with_checkpoints(scene, cam, 8, path, **kw)
        check(checkpoint.load_checkpoint(path)["spp_done"] == 8,
              "the checkpoint after one pass")
        resumed = checkpoint.render_with_checkpoints(scene, cam, 16, path,
                                                     **kw)
        check(torch.equal(full, resumed) and float(full.mean()) > 1e-3,
              "the resumed render differs from the uninterrupted one")
        table = io.StringIO()
        t0 = time.perf_counter()
        failures = bsdftest.run(200_000, table, device=dev)
        bsdf_s = time.perf_counter() - t0
        print(table.getvalue().rstrip())
        check(failures == 0, "bsdftest fails on the card")
        sky = os.path.join(tmp, "sky.pfm")
        check(imgtool.main(["makesky", sky, "--resolution", "32",
                            "--elevation", "10", "--turbidity", "3",
                            "--albedo", "0.5"]) == 0, "imgtool makesky")
        ours = imageio.read_pfm(sky)
    ref = imageio.read_pfm("tests/oracle/sky_ref.pfm")
    nz = ref != 0
    rel = float((np.abs(ours - ref) / (np.abs(ref) + 1e-3))[nz].max())
    check(ours.shape == ref.shape and rel < 1e-4
          and np.array_equal(ours == 0, ref == 0),
          f"makesky against sky_ref.pfm: rel {rel}")
    row = {"card": card, "resumed_equals_uninterrupted": True,
           "bsdftest_failures": failures, "bsdftest_s": bsdf_s,
           "makesky_rel": rel}
    print(f"phase 22 checkpoint and tools ({card}): " + json.dumps(row))
    return row


def kd_sharded_tools(dev):
    """Phase 22 (see the module's docstring). Returns the numbers for the
    JSON lines."""
    card = card_line()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    filt = film_mod.make_filter("box", device=dev)
    out, secs = {"card": card}, {}
    for key, fn in (("kd", lambda: kd_cell(dev, card, start, stop, filt)),
                    ("brute_past_4096",
                     lambda: brute_past_4096(dev, card, start, stop, filt)),
                    ("sharded", lambda: sharded_cell(dev, card)),
                    ("checkpoint_tools",
                     lambda: checkpoint_and_tools(dev, card))):
        t0 = time.perf_counter()
        out[key] = fn()
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = secs
    print("phase 22 seconds by item: " + json.dumps(secs))
    return out


@contextlib.contextmanager
def recording_stats_path():
    """Record, per call, the wavefront loop's (L, live) and the fused
    path's L (``li_path``'s two branches) and count the brute-force
    twin's calls; the kernels' wrappers still count their launches."""
    rec = {"loop": [], "fused": [], "twin_calls": 0}
    loop, fused, twin = (render_mod._li_loop, fp.li_path_fused,
                         ik._intersect_reference)

    def record_loop(*args, **kw):
        out = loop(*args, **kw)
        rec["loop"].append(out)
        return out

    def record_fused(*args, **kw):
        out = fused(*args, **kw)
        rec["fused"].append(out)
        return out

    def count_twin(*args, **kw):
        rec["twin_calls"] += 1
        return twin(*args, **kw)
    render_mod._li_loop, fp.li_path_fused = record_loop, record_fused
    ik._intersect_reference = count_twin
    try:
        yield rec
    finally:
        render_mod._li_loop, fp.li_path_fused = loop, fused
        ik._intersect_reference = twin


def stats_bench_call(dev, scene, filt, card):
    """Phase 23 (a): bench.py's stats call against pbrt_tpu's counts."""
    cfg = render_mod.RenderConfig(max_depth=MAX_DEPTH, collect_stats=True)
    cam = entry._camera((W, H), dev)
    with recording_stats_path() as rec:
        img, live = render_mod.render_pass(scene, cam, filt, cfg, W, H, 1, 0,
                                           dev)
    torch.cuda.synchronize()
    counts = [int(v) for v in live.cpu()]
    diff = [c - r for c, r in zip(counts, REF_LIVE_COUNTS)]
    print(f"phase 23 (a) bench.py's stats call, {W}² × 1 spp ({card}): live "
          f"counts {counts} vs pbrt_tpu {REF_LIVE_COUNTS}, differences "
          f"{diff}; dead_lane_frac "
          f"{1.0 - sum(counts) / (len(counts) * W * H):.4f}")
    check(live.dtype == torch.float32 and live.device.type == "cuda",
          f"live counts {live.dtype} on {live.device}")
    check(rec["twin_calls"] == 0 and not rec["fused"],
          "the stats call left the card or took the fused kernel")
    out = {"live": counts, "ref": REF_LIVE_COUNTS, "diff": diff}
    if any(diff):
        # the same lanes on the CPU twins: the card's differences are
        # seam ties if the twins give pbrt_tpu's counts and the card's
        # lanes differ from theirs in no more lanes than a bounce's count
        scene_c = to_device(scene, "cpu")
        cam_c = entry._camera((W, H), "cpu")
        filt_c = film_mod.make_filter("box", device="cpu")
        with recording_stats_path() as rec_c:
            _, live_c = render_mod.render_pass(scene_c, cam_c, filt_c, cfg, W,
                                               H, 1, 0, "cpu")
        L_g, L_c = rec["loop"][0][0].cpu(), rec_c["loop"][0][0]
        lanes_off = torch.nonzero(
            (L_g - L_c).abs().amax(-1) > 1e-4).flatten().tolist()
        out.update(cpu_live=[int(v) for v in live_c], lanes_off=lanes_off)
        print(f"phase 23 (a): CPU twins' counts {out['cpu_live']}; lanes "
              f"whose radiance differs from the CPU's: {lanes_off}")
        check(out["cpu_live"] == REF_LIVE_COUNTS,
              "the CPU twins' counts differ from pbrt_tpu's")
        check(max(abs(v) for v in diff) <= min(LIVE_TIE_LANES,
                                                 len(lanes_off)),
              f"live counts off by {diff}")
    check(math.isfinite(float(img.sum())), "non-finite stats image")
    return out


def stats_full_width(dev, scene, filt, card):
    """Phase 23 (b): the main path at full width with the stats."""
    cam = entry._camera((W, H), dev)
    cfg = render_mod.RenderConfig(max_depth=MAX_DEPTH)
    cfg_s = dataclasses.replace(cfg, collect_stats=True)
    n_pass = SPP // CHUNK
    want = n_pass * _loop_queries(scene, MAX_DEPTH)
    torch.cuda.synchronize()
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    bk.bvh_traverse.launches = 0
    kd_ops.kd_traverse.launches = 0
    with recording_stats_path() as rec:
        stats = [render_mod.render_pass(scene, cam, filt, cfg_s, W, H, CHUNK,
                                        k * CHUNK, dev)
                 for k in range(n_pass)]
        torch.cuda.synchronize()
    n_k, n_i = fp.fused_bounce.launches, ik.intersect_brute.launches
    n_t = bk.bvh_traverse.launches + kd_ops.kd_traverse.launches
    print(f"phase 23 (b) stats render {W}² × {SPP} spp: {n_i} intersect "
          f"launches (the loop's {want}), {n_k} fused, {n_t} traversal, "
          f"{rec['twin_calls']} queries on the CPU")
    check(n_k == 0 and n_t == 0, "the stats render left the wavefront loop")
    check(n_i == want, f"{n_i} intersect launches, the loop implies {want}")
    check(rec["twin_calls"] == 0, "a query of the stats render ran on the CPU")
    check(len(rec["loop"]) == n_pass, "the passes did not run the loop")
    with recording_fused() as calls, recording_stats_path() as rec_f:
        fused = [render_mod.render_pass(scene, cam, filt, cfg, W, H, CHUNK,
                                        k * CHUNK, dev)
                 for k in range(n_pass)]
        torch.cuda.synchronize()
    check(len(calls) == n_pass and not rec_f["loop"],
          "the fused render did not launch the kernel once a pass")
    R = W * H * CHUNK
    live_per_pass, bad_total, worst, off_lanes = [], 0, 0.0, []
    for k in range(n_pass):
        L_s, live = rec["loop"][k]
        L_f = rec_f["fused"][k]
        check(L_s.shape == L_f.shape == (R, 3), "lane counts")
        d = (L_s - L_f).abs()
        bad = d.amax(-1) > 1e-4
        bad_total += int(bad.sum())
        worst = max(worst, float(d.max()))
        torch.testing.assert_close(L_s[~bad], L_f[~bad], atol=1.1e-4,
                                   rtol=0)
        live_f = fp.live_mask(calls[k][2][0]).sum(-1).to(torch.float32)
        off = (live - live_f).abs()
        off_lanes.append([int(v) for v in off.cpu()])
        live_per_pass.append([int(v) for v in live.cpu()])
        check(float(off.max()) <= 6e-3 * R,
              f"pass {k}: live counts off the fused residuals' by "
              f"{off_lanes[-1]}")
        check(math.isfinite(float(stats[k][0].sum())), "non-finite image")
    img_s = sum(img for img, _ in stats) / SPP
    img_f = sum(fused) / SPP
    rel = abs(float(img_s.mean() - img_f.mean())) / float(img_f.mean())
    check(bad_total <= 6e-3 * R * n_pass, f"{bad_total} lanes off the fused")
    check(rel < 0.01, f"image means differ by rel {rel}")
    live_tot = [sum(col) for col in zip(*live_per_pass)]
    live_per_bounce = [v / (W * H * SPP) for v in live_tot]
    dead = 1.0 - sum(live_per_bounce) / len(live_per_bounce)
    # each pass once more, timed in turns (stats, fused, fused, stats)
    ms = {}
    for key in ("stats", "fused", "fused", "stats"):
        c = cfg_s if key == "stats" else cfg
        ms[key] = ms.get(key, 0.0) + sync_ms(
            lambda: render_mod.render_pass(scene, cam, filt, c, W, H, CHUNK,
                                           0, dev), 3) / 2
    out = {"launches": n_i, "loop_queries": want, "live_per_pass":
           live_per_pass, "off_fused_live": off_lanes,
           "lanes_off_fused": bad_total, "max_abs_err": worst,
           "mean_rel": rel, "live_per_bounce": live_per_bounce,
           "dead_lane_frac": dead, "pass_ms": {k: round(v, 4)
                                               for k, v in ms.items()},
           "image_mean": float(img_s.double().mean())}
    print(f"phase 23 (b) ({card}): live_per_bounce "
          f"{[round(v, 4) for v in live_per_bounce]}, dead_lane_frac "
          f"{dead:.4f}; lanes off the fused kernel {bad_total} of "
          f"{R * n_pass} (max {worst:.3g}), means rel {rel:.3g}; counts "
          f"off the fused residuals' {off_lanes}; a 32-spp pass "
          f"{out['pass_ms']['stats']} ms with the stats vs "
          f"{out['pass_ms']['fused']} ms fused (CUDA events)")
    return out


def stats_trace(dev, scene, filt):
    """Phase 23 (c): a device trace of one 1-spp stats pass."""
    from pbrt_tpu_torch.utils import stats as stats_mod
    cfg = render_mod.RenderConfig(max_depth=MAX_DEPTH, collect_stats=True)
    cam = entry._camera((W, H), dev)
    with tempfile.TemporaryDirectory() as log_dir:
        with stats_mod.device_trace(log_dir) as prof:
            render_mod.render_pass(scene, cam, filt, cfg, W, H, 1, 0, dev)
            torch.cuda.synchronize()
        size = os.path.getsize(prof.trace_path)
        with open(prof.trace_path) as fh:
            events = json.load(fh)["traceEvents"]
    n_kernel = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"phase 23 (c) device_trace: {size} bytes, {len(events)} events, "
          f"{n_kernel} kernel records")
    check(size > 0 and events, "empty trace")
    return {"bytes": size, "events": len(events), "kernel_records": n_kernel}


def stats_entry(dev):
    """Phase 23 (d): entry() on the card."""
    fn, args = entry.entry()
    torch.cuda.synchronize()
    fp.fused_bounce.launches = 0
    ik.intersect_brute.launches = 0
    img = fn(*args)
    torch.cuda.synchronize()
    n_k, n_i = fp.fused_bounce.launches, ik.intersect_brute.launches
    mean = float(img.double().mean())
    rel = abs(mean - REF_ENTRY_MEAN) / REF_ENTRY_MEAN
    print(f"phase 23 (d) entry(): {tuple(img.shape)} on {img.device}, mean "
          f"{mean!r} vs pbrt_tpu {REF_ENTRY_MEAN!r} (rel {rel:.3g}), {n_k} "
          f"fused and {n_i} intersect launches")
    check(img.shape == (32, 32, 3) and img.device.type == "cuda",
          "entry()'s image")
    check(n_k == 1 and n_i == 0, "entry() did not launch the kernel once")
    check(rel < 1e-3, f"entry() mean off by rel {rel}")
    return {"launches": n_k, "mean": mean, "rel": rel}


def stats_phase(dev):
    """Phase 23 (see the module's docstring)."""
    card = card_line()
    scene = entry._portal_scene(dev)
    filt = film_mod.make_filter("box", device=dev)
    out, secs = {"card": card}, {}
    for key, fn in (("bench_call",
                     lambda: stats_bench_call(dev, scene, filt, card)),
                    ("full_width",
                     lambda: stats_full_width(dev, scene, filt, card)),
                    ("trace", lambda: stats_trace(dev, scene, filt)),
                    ("entry", lambda: stats_entry(dev))):
        t0 = time.perf_counter()
        out[key] = fn()
        secs[key] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    out["seconds"] = secs
    print("phase 23 seconds by item: " + json.dumps(secs))
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
        if name in ("fused_path", "intersect", "kexp_traverse",
                    "kd_traverse"):
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
    bvh_full = full_width_sample0(hf)

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
            dev_ms, by_kernel, _ = device_ms_by_kernel(bpass_fn, frags)
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
        dev_old, by_old, _ = device_ms_by_kernel(bpass_fn, frags)
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

    # ---- 17. textures, object instancing and participating media
    t0 = time.perf_counter()
    media = media_files(dev)
    media["phase_s"] = time.perf_counter() - t0
    print(f"media phase {media['phase_s']:.1f} s")

    # ---- 18. subsurface scattering
    t0 = time.perf_counter()
    sss = sss_files(dev)
    sss["phase_s"] = time.perf_counter() - t0
    print(f"subsurface phase {sss['phase_s']:.1f} s")

    # ---- 19. bdpt, the spatial strategy and MLT
    t0 = time.perf_counter()
    bdpt = bdpt_files(dev)
    bdpt["phase_s"] = time.perf_counter() - t0
    print(f"bdpt phase {bdpt['phase_s']:.1f} s")

    # ---- 20. SPPM and two-keyframe motion blur
    t0 = time.perf_counter()
    sm20 = sppm_motion_files(dev)
    sm20["phase_s"] = time.perf_counter() - t0
    print(f"sppm and motion phase {sm20['phase_s']:.1f} s")

    # ---- 21. curves, hair, Fourier and the other samplers
    t0 = time.perf_counter()
    p21 = curves_files(dev)
    p21["phase_s"] = time.perf_counter() - t0
    print(f"curves, hair, Fourier and samplers phase {p21['phase_s']:.1f} s")

    # ---- 22. the kd-tree, kernel 2 past 4,096 primitives, the sharded
    # path and the training step over NCCL, checkpoints and the tools
    t0 = time.perf_counter()
    p22 = kd_sharded_tools(dev)
    p22["phase_s"] = time.perf_counter() - t0
    print(f"kd-tree, sharded path, checkpoint and tools phase "
          f"{p22['phase_s']:.1f} s")

    # ---- 23. the renderer's statistics: live lanes per bounce
    t0 = time.perf_counter()
    p23 = stats_phase(dev)
    p23["phase_s"] = time.perf_counter() - t0
    print(f"stats phase {p23['phase_s']:.1f} s")

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
        "ptxas": ptxas["fused_path"],
        # phase 19's MLT on the portal scene: its launches, each held to
        # the twin, and the largest radiance error
        "mlt_path": bdpt["mlt_fused"],
        # phase 22: render_sharded and the training steps at world size 1
        # over NCCL (launches a render and a step, ms a step)
        "sharded_path": {k: p22["sharded"][k] for k in (
            "render_sharded", "train")},
        # phase 23 (d): entry()'s forward step on the card
        "entry_launches": p23["entry"]["launches"]}, {
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
        "hero_path": hero["kernel"],
        # the subsurface passes (phase 18): launches of each timed 128-spp
        # render, the largest error over all its queries (the probe
        # chain's among them), times and bound on its first probe query,
        # the kernel's device time inside the pass
        "sss_path": sss["kernel"],
        # phase 19: the in-process bdpt chunks' launches and the largest
        # error over all the queries held (theirs, MLT's four-step run's
        # and the spatial pass's), the full-width chunk's, the MLT
        # render's and the spatial pass's launches
        "bdpt_path": bdpt["kernel"],
        # phase 20: SPPM's queries (its passes ignore time, as pbrt_tpu's):
        # the oracle call's and the full-width cell's launches, the
        # largest error over one iteration's queries
        "sppm_path": sm20["kernel"]["sppm"],
        # phase 21: curves_oracle's in-process pass (every query held)
        # and CLI launches, the fur cell's, the Fourier furnace's, the
        # sampler passes'; the BVH scene with curves' brute-force queries
        "curves_path": p21["kernel"],
        # phase 22: a pass over 8,204 primitives without a BVH (every
        # query held to the twin on 65,536 rays) and the kd cell's
        # spheres and aaplane (its ms on the camera query's inputs)
        "past_4096": {k: p22["brute_past_4096"][k] for k in (
            "primitives", "launches", "max_abs_err",
            "render_pass_cuda_ms")},
        "kd_path_query_ms": p22["kd"]["kernel2_ms"],
        # phase 23: the main path's 64-spp render with collect_stats (the
        # wavefront loop, every query here): launches, the loop's count,
        # the largest radiance difference from the fused kernel's lanes
        "stats_path": {k: p23["full_width"][k] for k in (
            "launches", "loop_queries", "max_abs_err", "lanes_off_fused",
            "pass_ms")}}, {
        # the motion variant (18-float rows moved to each ray's time, one
        # ray a thread, no early reject), as phase 20's dofmotion pass
        # launches it; times and bound on that pass's camera rays, the
        # static kernel on the same rays in turns
        "name": "intersect_motion", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/intersect.cu",
        "replaces": "pbrt_tpu/ops/intersect_pallas.py:34",
        "launches": sm20["dofmotion"]["launches"],
        "max_abs_err": sm20["dofmotion"]["kernel_vs_twin_max_abs_err"],
        "ms": sm20["dofmotion"]["kernel_ms"],
        "plain_ms": sm20["dofmotion"]["twin_ms"],
        "bound_ms": sm20["dofmotion"]["bound_ms"],
        "bound_by": sm20["dofmotion"]["bound_by"], "library_ms": None,
        "static_turns_ms": sm20["dofmotion"]["turns_ms"],
        "cli_launches": sm20["cli_dofmotion"]["launches"][
            "intersect_brute_motion"]}, {
        # the render path's kernel as the render launches it; camera rays
        # of the heightfield tree in the callers' order (bounce and shadow
        # rays, the other grid and the L2 window in the lines above)
        "name": "bvh_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": "pbrt_tpu/ops/bvh_pallas.py:98",
        "launches": bvh_launches, "max_abs_err": traverse_err,
        "ms": tms["persistent_closest_camera"],
        "plain_ms": twin_ms, "bound_ms": tbound["camera"][0],
        "bound_by": tbound["camera"][1], "library_ms": None,
        # the subsurface heightfield's `path` pass (phase 18): its
        # traversal launches and largest error against the twin
        "sss_heightfield": {k: sss["heightfield"][k] for k in (
            "traverse_launches", "traverse_max_abs_err",
            "traverse_device_ms", "traverse_share")},
        # phase 19's bdpt chunk on a heightfield with a BVH
        "bdpt_heightfield": {k: bdpt["bvh"][k] for k in (
            "traverse_launches", "traverse_max_abs_err")},
        # phase 10's full-width render's sample index 0 against pbrt_tpu
        "full_width_sample0": bvh_full,
        # phase 21's heightfield with curves: its traversal launches and
        # largest error against the twin
        "curves_heightfield": p21["kernel"]["bvh"]}, {
        # the motion variant (80-byte records moved to each ray's time),
        # as phase 20's moving-heightfield pass launches it; times and
        # bound on that pass's camera rays, the static kernel on the same
        # rays (the tree at shutter time 0) in turns
        "name": "bvh_traverse_motion", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": "pbrt_tpu/ops/bvh_pallas.py:98",
        "launches": sm20["bvh"]["launches"],
        "max_abs_err": sm20["bvh"]["kernel_vs_twin_max_abs_err"],
        "ms": sm20["bvh"]["camera_kernel_ms"],
        "plain_ms": sm20["bvh"]["camera_twin_ms"],
        "bound_ms": sm20["bvh"]["bound_ms"],
        "bound_by": sm20["bvh"]["bound_by"], "library_ms": None,
        "static_turns_ms": sm20["bvh"]["turns_ms"]}, {
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
        "library_device_ms": probe["library_device_ms"]}, {
        # the port's own kernel (pbrt_tpu walks its kd-tree in plain JAX,
        # a vmapped lax.while_loop, no Pallas kernel), its closest-hit
        # instantiation: ms and plain_ms on the kd cell's 2,097,152 camera
        # rays, its launches and largest error over the pass's
        # closest-hit walks (65,536 rays each), the bound from the twin's
        # counts on the camera rays; kernel 3 in turns on the camera,
        # shadow (NEE) and bounce rays
        "name": "kd_traverse", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/kd_traverse.cu",
        "replaces": "pbrt_tpu/scene/kdtree.py:150",
        "own_kernel": True, "redesigned": True,
        "launches": p22["kd"]["launches"] - p22["kd"]["any_hit_launches"],
        "max_abs_err": p22["kd"]["max_abs_err"],
        "ms": p22["kd"]["turns_ms"]["camera"]["kd_ms"],
        "plain_ms": p22["kd"]["twin_camera_ms"],
        "bound_ms": p22["kd"]["bound_ms"], "bound_by": p22["kd"]["bound_by"],
        "library_ms": None,
        "kernel3_turns_ms": p22["kd"]["turns_ms"],
        "ptxas": ptxas["kd_traverse"]}, {
        # its any-hit instantiation, which the any-hit query (the ao
        # pass's occlusion rays) launches: ms and plain_ms on those rays
        # (beside the closest-hit walk's ms on them), launches and largest
        # error over the cell's any-hit walks, the bound from the twin's
        # counts on those rays
        "name": "kd_traverse_any_hit", "route": "cuda",
        "source": "pbrt_tpu_torch/csrc/kd_traverse.cu",
        "replaces": "pbrt_tpu/scene/kdtree.py:150",
        "own_kernel": True,
        "launches": p22["kd"]["any_hit_launches"],
        "max_abs_err": p22["kd"]["any_hit_max_abs_err"],
        "ms": p22["kd"]["turns_ms"]["ao"]["kd_ms"],
        "plain_ms": p22["kd"]["twin_ao_ms"],
        "bound_ms": p22["kd"]["bound_ao_ms"],
        "bound_by": p22["kd"]["bound_ao_by"], "library_ms": None,
        "closest_hit_ms": p22["kd"]["turns_ms"]["ao"]["kd_closest_ms"],
        "rays_any_equals_closest":
            p22["kd"]["shadow_rays_any_equals_closest"]}],
        "scene_files": files, "hero": hero, "bdpt": bdpt,
        "sppm_motion": sm20, "curves": p21, "kd_sharded_tools": p22,
        "stats": p23}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
