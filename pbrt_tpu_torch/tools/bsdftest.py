"""bsdftest: numerical BSDF sampling / pdf consistency checker (port of
pbrt_tpu/tools/bsdftest.py, the counterpart of ``src/tools/bsdftest.cpp``).

For each material type of pbrt_tpu's table it (1) estimates the
hemispherical-directional reflectance rho by BSDF importance sampling,
E[f·|cos|/pdf], (2) checks that the pdf integrates to at most 1 over the
sphere by uniform Monte Carlo, and (3) cross-checks the sampled (f, pdf)
against their evaluation: the three diagnostics bsdftest.cpp prints per
BxDF. The BSDFs are the port's (scene/materials.py), evaluated on the card
unless ``--cpu``; the uniforms come from numpy's RandomState(0) in
pbrt_tpu's order, so both tools test the same directions.

Usage: ``python -m pbrt_tpu_torch.tools.bsdftest [N] [--cpu]``
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch


def run(n=200_000, out=sys.stdout, device="cuda"):
    """Print pbrt_tpu's table of the diagnostics; returns the number of
    materials that fail (rho above 1.02, or a pdf integral outside
    [0, 1.05])."""
    from pbrt_tpu_torch.scene import materials as mat
    from pbrt_tpu_torch.scene.types import require_device

    device = require_device(device)
    cases = [
        ("matte", dict(type=mat.MATTE, kd=0.7)),
        ("oren-nayar", dict(type=mat.MATTE, kd=0.7, sigma=20.0)),
        ("plastic", dict(type=mat.PLASTIC, kd=0.4, ks=0.3, roughness=0.1)),
        ("metal", dict(type=mat.METAL, roughness=0.05)),
        ("substrate", dict(type=mat.SUBSTRATE, kd=0.4, ks=0.2,
                           roughness=0.1)),
        ("translucent", dict(type=mat.TRANSLUCENT, kd=0.3, kt=0.3)),
        ("rough-glass", dict(type=mat.GLASS, roughness=0.2, eta=1.5)),
        ("disney", dict(type=mat.DISNEY, kd=0.5, metallic=0.3,
                        roughness=0.3)),
        ("hair", dict(type=mat.HAIR, sss_sigma_a=(0.1, 0.2, 0.3),
                      beta_m=0.3, beta_n=0.3, hair_alpha=2.0, eta=1.55)),
    ]
    rs = np.random.RandomState(0)
    wo = np.asarray([0.3, 0.4, 0.866])
    wo = wo / np.linalg.norm(wo)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    out.write(f"{'material':<12} {'rho_is':>8} {'pdf_int':>8} "
              f"{'f_match':>8} {'pdf_match':>9}\n")
    failures = 0
    with torch.no_grad():
        for name, row in cases:
            tbl = mat.make_material_table([row], 3, device=device)
            mp = mat.gather_materials(
                tbl, torch.zeros(n, dtype=torch.int32, device=device))
            wob = f32(wo).expand(n, 3)
            hh = (torch.zeros(n, device=device) if name == "hair"
                  else None)
            ul = f32(rs.rand(n))
            uu = f32(rs.rand(n, 2))
            wi, f, pdf, _ = mat.bsdf_sample(mp, wob, ul, uu, h=hh)
            ok = pdf > 1e-9
            rho = torch.where(
                ok[:, None], f * wi[:, 2:3].abs()
                / torch.clamp_min(pdf, 1e-9)[:, None], 0.0).mean(0)
            rho = rho.cpu().numpy()
            # the pdf's integral over the sphere, uniform directions
            z = 1 - 2 * rs.rand(n)
            phi = 2 * math.pi * rs.rand(n)
            s = np.sqrt(np.maximum(0, 1 - z * z))
            wiu = f32(np.stack([s * np.cos(phi), s * np.sin(phi), z], -1))
            pdf_int = float((mat.bsdf_pdf(mp, wob, wiu, h=hh)
                             * 4 * math.pi).mean())
            # sample against evaluation (delta lobes excluded by the pdf)
            fe = mat.bsdf_f(mp, wob, wi, h=hh)
            pe = mat.bsdf_pdf(mp, wob, wi, h=hh)
            f_match = float(torch.where(ok[:, None], (fe - f).abs(),
                                        0.0).max())
            p_match = float(torch.where(ok, (pe - pdf).abs(), 0.0).max())
            bad = bool(rho.max() > 1.02) or not (0.0 <= pdf_int <= 1.05)
            failures += bad
            out.write(f"{name:<12} {rho.mean():8.4f} {pdf_int:8.4f} "
                      f"{f_match:8.2e} {p_match:9.2e}"
                      + ("  FAIL\n" if bad else "\n"))
    return failures


def main(argv=None):
    args = list(argv if argv is not None else sys.argv[1:])
    device = "cpu" if "--cpu" in args else "cuda"
    args = [a for a in args if a != "--cpu"]
    n = int(args[0]) if args else 200_000
    return 1 if run(n, device=device) else 0


if __name__ == "__main__":
    sys.exit(main())
