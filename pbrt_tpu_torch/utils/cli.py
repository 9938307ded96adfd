"""The ``pbrt`` command line of the port:
``python -m pbrt_tpu_torch.utils.cli scene.pbrt -o out.pfm`` (port of
pbrt_tpu/utils/cli.py; main() of src/main/pbrt.cpp:76-173).

It parses the file, builds the scene on the card, renders it with the
file's integrator, sampler, filter and crop window, and writes the image
(.pfm, .exr, .png or .tga). It runs on the card and raises without one,
unless asked for the CPU with ``--cpu``; it never falls back to the CPU
by itself. Unless ``--quiet``, stderr gets the card's name, the phase
times (the render also by CUDA events), pbrt's statistics and one
``pbrt_tpu_torch: summary {...}`` JSON line with the phase seconds, the
launches of each kernel, the primitive counts and the image mean.

``--debug-nans`` is the counterpart of pbrt_tpu's ``jax_debug_nans``: it
raises on the first pass whose radiance holds a NaN or an infinity,
before the render's clamp to black.

``--spectral`` builds the scene with 60-bin sampled spectra; a
``hero_path`` or ``hero_path_mis`` integrator (the file's or
``--integrator``'s) does so by itself, as pbrt_tpu's CLI does. A sampled
image is converted to RGB (``spectrum_to_rgb``) before it is written.
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser():
    ap = argparse.ArgumentParser(
        prog="pbrt_tpu_torch", description="pbrt-style renderer on a GPU")
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("--outfile", "-o", default=None,
                    help="output image path (default: the file's Film "
                         "filename)")
    ap.add_argument("--quick", action="store_true",
                    help="quarter sample count (pbrt --quick)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--integrator", default=None)
    ap.add_argument("--spectral", action="store_true",
                    help="60-bin sampled spectra (the hero_path* "
                         "integrators imply it)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (the kernels' plain twins)")
    ap.add_argument("--cat", action="store_true",
                    help="print a reformatted version of the scene to "
                         "stdout and exit (pbrt --cat)")
    ap.add_argument("--toply", action="store_true",
                    help="like --cat, but triangle meshes with >= 500 "
                         "indices are written as PLY sidecar files "
                         "(pbrt --toply; PLY_PREFIX sets the file prefix)")
    ap.add_argument("--cropwindow", type=float, nargs=4, default=None,
                    metavar=("X0", "X1", "Y0", "Y1"),
                    help="render a sub-window (NDC fractions)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="raise on the first pass with a NaN or infinite "
                         "radiance instead of clamping it to black")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cat or args.toply:
        from pbrt_tpu_torch.frontend.catply import reformat
        reformat(args.scene, to_ply=args.toply)
        return 0

    import torch

    from pbrt_tpu_torch.core import spectrum as spec_mod
    from pbrt_tpu_torch.frontend.parser import _INTEGRATORS, parse_file
    from pbrt_tpu_torch.integrators.render import render
    from pbrt_tpu_torch.ops import bvh, fused_path, intersect
    from pbrt_tpu_torch.scene.types import require_device
    from pbrt_tpu_torch.utils import imageio
    from pbrt_tpu_torch.utils import stats as stats_mod
    from pbrt_tpu_torch.utils.progress import ProgressReporter

    device = require_device("cpu" if args.cpu else "cuda")
    cfg = spec_mod.SAMPLED if args.spectral else spec_mod.RGB

    def say(msg):
        if not args.quiet:
            print(f"pbrt_tpu_torch: {msg}", file=sys.stderr)

    say("device " + (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"))
    say(f"parsing {args.scene}")
    phases0 = stats_mod.phase_times()    # main() may run more than once
    with stats_mod.profile_phase("Scene parsing"):
        ps = parse_file(args.scene, spectrum_cfg=cfg)
        name = args.integrator or _INTEGRATORS.get(
            ps.options["integrator"], "path")
        if name in ("hero_path", "hero_path_mis") and cfg.mode != "sampled":
            cfg = spec_mod.SAMPLED
            ps = parse_file(args.scene, spectrum_cfg=cfg)
    with stats_mod.profile_phase("Scene creation"):
        scene, cam, opts = ps.build(device)
        if device.type == "cuda":
            torch.cuda.synchronize()

    integrator = args.integrator or opts["integrator"]
    spp = args.spp or opts["spp"]
    if args.quick:
        spp = max(1, spp // 4)
    fname = args.outfile or opts["film"]["filename"]
    filt_name, filt_kwargs = opts["filter"]
    crop = args.cropwindow or opts["film"].get("crop")
    say(f"rendering {cam.resolution[0]}x{cam.resolution[1]} @ {spp}spp "
        f"({integrator}, sampler {opts['sampler']}, filter {filt_name})")

    counters = (fused_path.fused_bounce, intersect.intersect_brute,
                bvh.bvh_traverse)
    before = [c.launches for c in counters]
    t = {}
    if device.type == "cuda":
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
    with stats_mod.profile_phase("Integrator rendering"):
        img = render(scene, cam, spp=spp, integrator=integrator,
                     sampler=opts["sampler"], max_depth=opts["max_depth"],
                     filter_name=filt_name, filter_kwargs=filt_kwargs,
                     crop_window=crop,
                     integrator_params=opts["integrator_params"],
                     check_finite=args.debug_nans,
                     progress=ProgressReporter(spp, quiet=args.quiet),
                     device=device)
        if device.type == "cuda":
            ev1.record()
            torch.cuda.synchronize()
            t["render_cuda_ms"] = ev0.elapsed_time(ev1)
    if img.shape[-1] != 3:
        img = spec_mod.spectrum_to_rgb(img)
    img = img.cpu().numpy()
    with stats_mod.profile_phase("Film write"):
        imageio.write_image(fname, img)
    launches = {c.__name__: c.launches - b for c, b in zip(counters, before)}
    phases = stats_mod.phase_times()
    for key, name in (("parse_s", "Scene parsing"),
                      ("build_s", "Scene creation"),
                      ("render_s", "Integrator rendering"),
                      ("write_s", "Film write")):
        t[key] = phases[name] - phases0.get(name, 0.0)
    say(f"rendered in {t['render_s']:.3f}s (mean {img.mean():.6f}); "
        f"wrote {fname}")
    if not args.quiet:
        stats_mod.counter_add("Camera rays traced",
                              img.shape[0] * img.shape[1] * spp)
        stats_mod.print_stats()
        say("summary " + json.dumps(dict(
            t, launches=launches, mean=float(img.astype("float64").mean()),
            shape=list(img.shape), spp=spp, outfile=fname,
            integrator=integrator, channels=scene.n_channels,
            prims=dict(tri=scene.n_tri, sph=scene.n_sph, pln=scene.n_pln,
                       dsk=scene.n_dsk, bvh=scene.bvh is not None))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
