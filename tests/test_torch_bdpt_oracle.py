"""bdpt and mlt against the reference binary, from the files.

The port renders caustic_oracle and deltalights_oracle with `bdpt`,
envcavity_oracle with ``render_bdpt`` and caustic_oracle with MLT on the
CPU, with tests/test_oracle.py's calls, spp, seeds and limits (its caustic
bdpt, deltalights bdpt, envcavity bdpt and mlt tests), against the
*_ref.pfm images:
- caustic, bdpt, 8 spp, seed 2: mean delta < 0.05, block rel-L1 (16²
  blocks) < 0.30;
- deltalights, bdpt, 16 spp, seed 2: mean delta < 0.02, block rel-L1 <
  0.03;
- envcavity, ``render_bdpt``, 48 spp, seed 2: the gap of the mean to the
  reference's `path` image under 0.6 × the reference binary's own bdpt
  gap, which stays above 0.08 (pbrt's connection cap truncates the deep
  paths harder than its path tracer);
- caustic, MLT: 64 mutations a pixel, 2^18 bootstrap samples, 8,192
  chains, seed 5: mean delta < 0.05.
The CLI's ``--integrator bdpt`` and ``--integrator mlt`` reach
``render_bdpt`` and ``render_mlt``.

The port's 8-spp ``render_bdpt`` of envcavity (seed 0, the file's
depth, pbrt_tpu's CPU chunk) is also held pixel for pixel against
pbrt_tpu's op-by-op image of the same render
(tests/torch_bdpt_envcavity_ref.npy): rtol 2e-5 / atol 1e-6 on all but
PIXELS_OFF_SHARE of the pixels, and the mean over the pixels that agree
to rel 1e-4. A pixel sums 2 × 8 lanes (its camera samples and about as
many light paths), so the 2% of lanes a seam tie may send elsewhere
(tests/test_torch_bdpt.py) allow 32% of the pixels off. Found: 43 of
2,304.

``PYTHONPATH=. python tests/test_torch_bdpt_oracle.py`` prints pbrt_tpu's
CPU means of ``render_bdpt`` of the three files at 8 spp, seed 0, the
file's depth, at pbrt_tpu's CPU chunk (chip_smoke.py's REF_BDPT_MEANS),
jitted and op by op, and the port's on the CPU, and writes pbrt_tpu's
op-by-op envcavity image.
"""

import os

import numpy as np
import pytest

from pbrt_tpu_torch.frontend import load_pbrt
from pbrt_tpu_torch.integrators import bdpt as tbdpt
from pbrt_tpu_torch.integrators import mlt as tmlt
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.utils import cli, imageio
from test_torch_oracle import ORACLE, _block_rel_l1, _mean_delta

BDPT_FILES = ("caustic", "deltalights", "envcavity")
MEAN_SPP = 8
ENV_REF = os.path.join(os.path.dirname(__file__),
                       "torch_bdpt_envcavity_ref.npy")
PIXELS_OFF_SHARE = 2 * MEAN_SPP * 0.02


def _load(name):
    return load_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"),
                     device="cpu")


def _ref(name):
    return imageio.read_pfm(os.path.join(ORACLE, name))


@pytest.mark.parametrize("name, spp, md_lim, bl_lim", [
    ("caustic", 8, 0.05, 0.30), ("deltalights", 16, 0.02, 0.03)])
def test_bdpt_file_matches_reference_binary(name, spp, md_lim, bl_lim):
    scene, cam, opts = _load(name)
    img = trender.render(scene, cam, spp=spp, integrator="bdpt",
                         max_depth=opts["max_depth"], seed=2,
                         device="cpu").numpy()
    ref = _ref(f"{name}_ref.pfm")
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    bl = _block_rel_l1(img, ref, k=16)
    assert md < md_lim, f"{name} bdpt mean delta {md:.4f}"
    assert bl < bl_lim, f"{name} bdpt block rel-L1 {bl:.4f}"


def test_envcavity_bdpt_closer_than_the_reference_binary():
    scene, cam, opts = _load("envcavity")
    img = tbdpt.render_bdpt(scene, cam, spp=48, max_depth=opts["max_depth"],
                            seed=2, device="cpu").numpy()
    ref_path = _ref("envcavity_path_ref.pfm")
    ref_bdpt = _ref("envcavity_bdpt_ref.pfm")
    assert img.shape == ref_path.shape and np.isfinite(img).all()
    ours_gap = abs(img.mean() - ref_path.mean()) / ref_path.mean()
    pbrt_gap = abs(ref_bdpt.mean() - ref_path.mean()) / ref_path.mean()
    assert pbrt_gap > 0.08, f"ref gap changed? {pbrt_gap:.4f}"
    assert ours_gap < pbrt_gap * 0.6, (ours_gap, pbrt_gap)


def _mean_render(name, device="cpu"):
    scene, cam, opts = _load(name)
    w, h = cam.resolution
    return tbdpt.render_bdpt(
        scene, cam, spp=MEAN_SPP, max_depth=opts["max_depth"], seed=0,
        chunk_spp=tbdpt.default_chunk_spp("cpu", w, h, MEAN_SPP),
        device=device)


def test_envcavity_pixels_match_pbrt_tpus_op_by_op_image():
    img = _mean_render("envcavity").numpy()
    ref = np.load(ENV_REF)
    assert img.shape == ref.shape
    agree = np.isclose(img, ref, rtol=2e-5, atol=1e-6).all(-1)
    off = int((~agree).sum())
    assert off <= PIXELS_OFF_SHARE * agree.size, f"{off} pixels off"
    m, m_ref = (float(a[agree].astype(np.float64).mean()) for a in (img, ref))
    assert abs(m - m_ref) / m_ref < 1e-4


def test_mlt_matches_reference_binary():
    scene, cam, opts = _load("caustic")
    img = tmlt.render_mlt(scene, cam, mutations_per_pixel=64,
                          n_bootstrap=1 << 18, n_chains=8192,
                          max_depth=opts["max_depth"], seed=5,
                          device="cpu").numpy()
    ref = _ref("caustic_ref.pfm")
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    assert md < 0.05, f"mlt mean delta {md:.4f}"


@pytest.mark.parametrize("integrator", ["bdpt", "mlt"])
def test_cli_renders_with_the_integrator(tmp_path, capsys, integrator):
    """``--integrator bdpt | mlt`` on deltalights at 1 spp (MLT: one
    mutation a pixel, the defaults' 4,096 chains and 16,384 bootstrap
    samples) equals ``render``'s image."""
    out = tmp_path / "x.pfm"
    path = os.path.join(ORACLE, "deltalights_oracle.pbrt")
    assert cli.main([path, "--cpu", "--spp", "1", "--integrator",
                     integrator, "-o", str(out)]) == 0
    scene, cam, opts = _load("deltalights")
    ref = trender.render(scene, cam, spp=1, integrator=integrator,
                         max_depth=opts["max_depth"],
                         integrator_params=opts["integrator_params"],
                         device="cpu").numpy()
    img = imageio.read_pfm(str(out))
    assert np.array_equal(img, ref) and img.mean() > 0
    assert f'"integrator": "{integrator}"' in capsys.readouterr().err


def test_sppm_renders_deltalights():
    """sppm renders deltalights (photons from its point, spot and distant
    lights): finite and lit, with no photon-cell entry skipped."""
    from pbrt_tpu_torch.integrators import sppm as tsppm
    from pbrt_tpu_torch.utils import stats as stats_mod
    scene, cam, opts = _load("deltalights")
    key = "SPPM/photon cell-scan overflow entries"
    before = stats_mod._COUNTERS[key]
    img = trender.render(scene, cam, spp=1, integrator="sppm",
                         max_depth=opts["max_depth"],
                         integrator_params=dict(iterations=2,
                                                photonsperiteration=4096),
                         device="cpu")
    assert img.shape[-1] == 3 and bool(img.isfinite().all())
    assert float(img.mean()) > 0 and stats_mod._COUNTERS[key] == before
    assert {int(t) for t in scene.lights.ltype} >= {
        tsppm.lights_mod.POINT, tsppm.lights_mod.SPOT,
        tsppm.lights_mod.DISTANT}


def reference_means():
    """pbrt_tpu's float32 image means on the CPU backend of
    ``render_bdpt`` of the three files at MEAN_SPP spp, seed 0, the file's
    max depth, at its CPU chunk: as pbrt_tpu runs it (its chunk a jitted
    program) and op by op (``jax.disable_jit``), and the port's on the
    CPU. pbrt_tpu's two differ: XLA's compiled program contracts
    multiply-adds across the ops it fuses, so a grazing ray can take
    another branch (on envcavity 130 of 2,304 pixels, the mean by
    7.1e-4); the port, like the op-by-op evaluation, rounds every
    operation. Writes the op-by-op envcavity image to ENV_REF. Run this
    file as a script from the root of the checkout."""
    import jax
    from pbrt_tpu.frontend import load_pbrt as jload
    from pbrt_tpu.integrators.bdpt import render_bdpt
    out = {}
    for name in BDPT_FILES:
        js, jc, jo = jload(os.path.join(ORACLE, f"{name}_oracle.pbrt"))
        img = render_bdpt(js, jc, spp=MEAN_SPP, max_depth=jo["max_depth"],
                          seed=0)
        out[f"{name}/jit"] = float(np.asarray(img, np.float64).mean())
        with jax.disable_jit():
            img = np.asarray(render_bdpt(js, jc, spp=MEAN_SPP,
                                         max_depth=jo["max_depth"], seed=0))
        out[f"{name}/op_by_op"] = float(img.astype(np.float64).mean())
        if name == "envcavity":
            np.save(ENV_REF, img.astype(np.float32))
        out[f"{name}/port_cpu"] = float(_mean_render(name).double().mean())
    return out


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins JAX to the CPU backend)
    for key, mean in reference_means().items():
        print(key, repr(mean))
