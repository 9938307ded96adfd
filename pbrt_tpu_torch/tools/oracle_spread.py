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
noise a fixed-seed test at that spp sees. Run as a file, the script
imports ``pbrt_tpu_torch`` from PYTHONPATH, so ``PYTHONPATH=<other
checkout>`` measures another tree on the same card.
Renders on the card; ``--cpu`` renders on the CPU twins.
"""

import argparse
import json

import numpy as np
import torch

import pbrt_tpu_torch
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
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    ref = imageio.read_pfm(args.ref)
    scene, cam, opts = load_pbrt(args.scene, device=device)
    fname, fkw = opts["filter"]
    spread = {}
    runs = [("halton", 0)] + [("independent", s) for s in range(args.seeds)]
    for spp in args.spp:
        for sampler, seed in runs:
            img = render(scene, cam, spp=spp, integrator=opts["integrator"],
                         sampler=sampler, max_depth=opts["max_depth"],
                         filter_name=fname, filter_kwargs=fkw, seed=seed,
                         device=device).cpu().numpy()
            mean = float(img.astype(np.float64).mean())
            row = dict(sampler=sampler, seed=seed, spp=spp, mean=mean,
                       rel=mean / float(ref.mean()) - 1.0,
                       md=mean_delta(img, ref),
                       bl8=block_rel_l1(img, ref, 8),
                       bl16=block_rel_l1(img, ref, 16))
            print(json.dumps(row), flush=True)
            if sampler == "independent":
                spread.setdefault(spp, []).append(row["rel"])
    print(json.dumps({
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "package": pbrt_tpu_torch.__file__, "ref_mean": float(ref.mean()),
        "independent_rel": {spp: {"mean": float(np.mean(v)),
                                  "std": float(np.std(v)),
                                  "max_abs": float(np.abs(v).max())}
                            for spp, v in spread.items()}}))


if __name__ == "__main__":
    main()
