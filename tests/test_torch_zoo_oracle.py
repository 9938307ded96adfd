"""The zoo's oracle files against the reference binary, from the files.

The port renders whitted_oracle (mirror and glass spheres, `whitted`),
caustic_oracle (a glass sphere's caustic, `path`), disney_oracle (solid,
thin and anisotropic metallic Disney rows), envcavity_oracle (a roofed
cavity under a constant infinite light, `path`) and envcam_oracle (the
environment camera) on the CPU, with the call, spp, sampler, seed and
limits of tests/test_oracle.py for each file (its whitted, caustic
`path`, disney, envcavity `path` and environment-camera tests), against
the *_ref.pfm images. ``reference_means`` prints pbrt_tpu's image means
for chip_smoke.py's in-process renders of the same files.
"""

import importlib
import os

import numpy as np
import pytest

from pbrt_tpu_torch.frontend import load_pbrt
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.utils import imageio
from test_torch_oracle import ORACLE, _block_rel_l1, _mean_delta

# file: (reference image, spp, integrator (None: the file's), sampler,
# seed, mean-delta limit or None, block rel-L1 limit and block size, or
# None). disney_oracle's mean delta is held on the card at the file's 128
# spp (chip_smoke.py), not here: at 32 spp its sampling noise alone is
# 0.0077 (the standard deviation of the mean's relative difference over 8
# seeds, pbrt_tpu_torch/tools/oracle_spread.py on the card), above the
# 0.006 limit, so the limit decides nothing at this spp. The port lands at
# 0.0082 here; pbrt_tpu lands at 0.0036 only because a +1.2% fluctuation
# meets its −1.3% bias under the surface of a dielectric (ROADMAP queue 3).
CASES = {
    "whitted": ("whitted_ref.pfm", 64, None, "independent", 2, 0.03,
                (0.05, 16)),
    "caustic": ("caustic_ref.pfm", 32, "path", "independent", 2, 0.035,
                (0.20, 16)),
    "disney": ("disney_ref.pfm", 32, None, "halton", 0, None, (0.095, 8)),
    "envcavity": ("envcavity_path_ref.pfm", 48, "path", "independent", 1,
                  0.02, None),
    "envcam": ("envcam_ref.pfm", 32, "path", "independent", 2, 0.02,
               (0.04, 16)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_files_match_reference_binary(name):
    ref_name, spp, integrator, sampler, seed, md_lim, bl = CASES[name]
    scene, cam, opts = load_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"),
                                 device="cpu")
    img = trender.render(scene, cam, spp=spp,
                         integrator=integrator or opts["integrator"],
                         sampler=sampler, max_depth=min(opts["max_depth"], 8),
                         seed=seed, device="cpu").numpy()
    ref = imageio.read_pfm(os.path.join(ORACLE, ref_name))
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    if md_lim is not None:
        assert md < md_lim, f"{name} mean delta {md:.4f} vs reference binary"
    if bl is not None:
        b = _block_rel_l1(img, ref, k=bl[1])
        assert b < bl[0], f"{name} block rel-L1 {b:.4f} vs reference binary"


# chip_smoke.py's in-process renders: the file's integrator and max depth,
# the halton sampler, seed 0, this many spp
MEAN_SPP = 8


def reference_means():
    """pbrt_tpu's float32 image means on the CPU backend for the five
    files at MEAN_SPP spp, halton, seed 0, with the port's one deviation
    from it patched in (``fixed_reference_patches``: it moves
    disney_oracle's mean). Run this file as a script from the root of the
    checkout, ``PYTHONPATH=. python tests/test_torch_zoo_oracle.py``, to
    print them."""
    from pbrt_tpu.frontend import load_pbrt as jload
    from pbrt_tpu.scene import materials as jm
    from test_torch_zoo_passes import fixed_reference_patches
    jrender = importlib.import_module("pbrt_tpu.integrators.render")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for fname, fn in fixed_reference_patches().items():
            mp.setattr(jm, fname, fn)
        for name in sorted(CASES):
            scene, cam, opts = jload(os.path.join(ORACLE,
                                                  f"{name}_oracle.pbrt"))
            img = jrender.render(scene, cam, spp=MEAN_SPP,
                                 integrator=opts["integrator"],
                                 sampler="halton",
                                 max_depth=opts["max_depth"], seed=0)
            out[name] = float(np.asarray(img, np.float64).mean())
    return out


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins JAX to the CPU backend)
    for key, mean in reference_means().items():
        print(key, repr(mean))
