"""How far a scene file's render lands from the reference binary's image,
and how much of that is sampling noise:

    PYTHONPATH=. python pbrt_tpu_torch/tools/oracle_spread.py \
        tests/oracle/disney_oracle.pbrt --ref tests/oracle/disney_ref.pfm \
        --spp 32 128 1024 --seeds 8

renders the file (its integrator, max depth and filter) at each spp with
the halton sampler (seed 0) and with the independent sampler under seeds
0 … seeds−1, and prints one JSON line per render (sampler, seed, spp,
image mean, its signed relative difference from the reference's mean,
tests/test_oracle.py's mean delta and block relative L1 at blocks of 8
and 16) and one of the card, the package's path and, per spp, the mean,
spread and largest size of the independent renders' signed difference.
Its mean over many seeds at high spp is the renderer's bias against the
reference image (whose own noise included); its spread at low spp is the
noise a fixed-seed test at that spp sees. The last line also gives, per
spp, the mean and σ over the independent renders of the mean delta and
the block relative L1s, and with ``--limits MD [BL]`` (a test's limits
on the mean delta and on the relative L1 of 16-pixel blocks) how many σ
each mean lies below its limit. A ``hero_path*`` file renders 60-bin
spectra, converted to RGB as tests/test_oracle.py converts them. On the
card the line names the card and its power limit. Run as a file, the script
imports ``pbrt_tpu_torch`` from PYTHONPATH, so ``PYTHONPATH=<other
checkout>`` measures another tree on the same card.
Renders on the card; ``--cpu`` renders on the CPU twins.
"""

import argparse
import json
import subprocess

import numpy as np
import torch

import pbrt_tpu_torch
from pbrt_tpu_torch.core import spectrum as spec_mod
from pbrt_tpu_torch.frontend import load_pbrt
from pbrt_tpu_torch.integrators.render import render
from pbrt_tpu_torch.utils import imageio


def mean_delta(a, b):
    """imgtool diff's avgDelta (imgtool.cpp:418-420)."""
    ma, mb = float(a.mean()), float(b.mean())
    return abs(ma - mb) / max(min(ma, mb), 1e-9)


def block_rel_l1(a, b, k):
    """tests/test_oracle.py's blockwise relative L1."""
    h, w = a.shape[0] // k * k, a.shape[1] // k * k
    da = a[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    db = b[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    return float(np.abs(da - db).sum() / max(db.sum(), 1e-9))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scene")
    ap.add_argument("--ref", required=True, help="reference image (PFM)")
    ap.add_argument("--spp", type=int, nargs="+", default=[32, 128])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--limits", type=float, nargs="+", metavar="LIMIT",
                    help="a test's limits: mean delta [block rel-L1]")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    ref = imageio.read_pfm(args.ref)
    scene, cam, opts = load_pbrt(args.scene, device=device)
    spectral = opts["integrator"] in ("hero_path", "hero_path_mis")
    if spectral:
        scene, cam, opts = load_pbrt(args.scene, device=device,
                                     spectrum_cfg=spec_mod.SAMPLED)
    fname, fkw = opts["filter"]
    spread, errs = {}, {}
    runs = [("halton", 0)] + [("independent", s) for s in range(args.seeds)]
    for spp in args.spp:
        for sampler, seed in runs:
            img = render(scene, cam, spp=spp, integrator=opts["integrator"],
                         sampler=sampler, max_depth=opts["max_depth"],
                         filter_name=fname, filter_kwargs=fkw, seed=seed,
                         device=device)
            if spectral:
                img = spec_mod.spectrum_to_rgb(img)
            img = img.cpu().numpy()
            mean = float(img.astype(np.float64).mean())
            row = dict(sampler=sampler, seed=seed, spp=spp, mean=mean,
                       rel=mean / float(ref.mean()) - 1.0,
                       md=mean_delta(img, ref),
                       bl8=block_rel_l1(img, ref, 8),
                       bl16=block_rel_l1(img, ref, 16))
            print(json.dumps(row), flush=True)
            if sampler == "independent":
                spread.setdefault(spp, []).append(row["rel"])
                for k in ("md", "bl8", "bl16"):
                    errs.setdefault(spp, {}).setdefault(k, []).append(row[k])
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
    summary = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"), "card": card,
        "package": pbrt_tpu_torch.__file__, "scene": args.scene,
        "integrator": opts["integrator"], "ref_mean": float(ref.mean()),
        "independent_rel": {spp: {"mean": float(np.mean(v)),
                                  "std": float(np.std(v)),
                                  "max_abs": float(np.abs(v).max())}
                            for spp, v in spread.items()},
        "independent_err": {spp: {k: {"mean": float(np.mean(v)),
                                      "std": float(np.std(v))}
                                  for k, v in e.items()}
                            for spp, e in errs.items()}}
    if args.limits:
        limits = dict(zip(("md", "bl16"), args.limits))
        summary["limits"] = limits
        summary["margin_sigma"] = {
            spp: {k: (lim - e[k]["mean"]) / max(e[k]["std"], 1e-12)
                  for k, lim in limits.items()}
            for spp, e in summary["independent_err"].items()}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
