"""The scene-file slice as a whole: .pbrt file → parse → render → image.

(a) Against pbrt_tpu, lane for lane: one halton ``render_pass`` of
    deltalights_oracle.pbrt, parsed by each package, with the film cut to
    24×24 in the file's text (a test-size cut), 4 spp, per pixel rtol 1e-4
    / atol 1e-5 as the other pass tests. This is the file's one jitted
    pbrt_tpu program.
(b) Against the reference binary, image for image: the port renders
    ao_oracle, deltalights_oracle (path) and filter_oracle (mitchell)
    from the files on the CPU, with their own sampler (halton), and with
    tests/test_oracle.py's spp, seed and limits on the mean delta and the
    block relative L1 (k = 16) against the *_ref.pfm images.
(c) The CLI: ``cli.main`` writes the image ``render`` gives, ``--cat``
    prints what pbrt_tpu's prints, ``--cropwindow`` writes the crop and
    ``--spectral`` raises.
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.frontend import parse_pbrt_string as jparse
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu_torch.frontend import load_pbrt, parse_pbrt_string
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.utils import cli, imageio

jrender = importlib.import_module("pbrt_tpu.integrators.render")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "oracle")
DEMO = os.path.join(REPO, "scenes", "cornell_portal.pbrt")


def _block_rel_l1(a, b, k=8):
    """Blockwise relative L1: |mean_block(a)-mean_block(b)| summed, over
    sum(b) (a copy of tests/test_oracle.py's)."""
    h, w = a.shape[0] // k * k, a.shape[1] // k * k
    da = a[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    db = b[:h, :w].reshape(h // k, k, w // k, k, -1).mean((1, 3))
    return float(np.abs(da - db).sum() / max(db.sum(), 1e-9))


def _mean_delta(a, b):
    """imgtool diff's avgDelta (imgtool.cpp:418-420; a copy of
    tests/test_oracle.py's)."""
    ma, mb = float(a.mean()), float(b.mean())
    return abs(ma - mb) / max(min(ma, mb), 1e-9)


def test_halton_pass_of_a_file_matches_jax():
    with open(os.path.join(ORACLE, "deltalights_oracle.pbrt")) as f:
        text = f.read()
    full = '"integer xresolution" [96] "integer yresolution" [96]'
    assert full in text
    text = text.replace(full, '"integer xresolution" [24] '
                              '"integer yresolution" [24]')
    js, jc, jo = jparse(text, base_dir=ORACLE)
    ts, tc, to = parse_pbrt_string(text, base_dir=ORACLE, device="cpu")
    assert (to["integrator"], to["max_depth"], to["sampler"]) == \
        (jo["integrator"], jo["max_depth"], "halton")
    a = np.asarray(jrender.render_pass(
        js, jc, jfilm.make_filter("box"),
        jrender.RenderConfig(integrator="path", sampler="halton",
                             max_depth=jo["max_depth"]),
        24, 24, 4, jnp.asarray(0, jnp.uint32)))
    b = trender.render_pass(
        ts, tc, tfilm.make_filter("box"),
        trender.RenderConfig(integrator="path", sampler="halton",
                             max_depth=to["max_depth"]),
        24, 24, 4, 0, device="cpu")
    assert float(a.mean()) > 0.1
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-5)


# file, spp, mean-delta limit, block rel-L1 limit (tests/test_oracle.py)
ORACLE_CASES = {"ao": (64, 0.01, 0.05), "deltalights": (32, 0.01, 0.03),
                "filter": (64, 0.025, 0.04)}


@pytest.mark.parametrize("name", sorted(ORACLE_CASES))
def test_file_renders_match_reference_binary(name):
    spp, md_lim, bl_lim = ORACLE_CASES[name]
    scene, cam, opts = load_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"),
                                 device="cpu")
    fname, fkw = opts["filter"]
    assert opts["sampler"] == "halton"
    assert fname == ("mitchell" if name == "filter" else "box")
    img = trender.render(scene, cam, spp=spp, integrator=opts["integrator"],
                         sampler=opts["sampler"],
                         max_depth=opts["max_depth"], filter_name=fname,
                         filter_kwargs=fkw, seed=2, device="cpu").numpy()
    ref = imageio.read_pfm(os.path.join(ORACLE, f"{name}_ref.pfm"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    bl = _block_rel_l1(img, ref, k=16)
    assert md < md_lim, f"{name} mean delta {md:.4f} vs reference binary"
    assert bl < bl_lim, f"{name} block rel-L1 {bl:.4f} vs reference binary"


def test_cli_writes_the_render(tmp_path, capsys):
    out = tmp_path / "x.pfm"
    assert cli.main([DEMO, "--cpu", "--spp", "2", "-o", str(out)]) == 0
    img = imageio.read_pfm(str(out))
    scene, cam, opts = load_pbrt(DEMO, device="cpu")
    ref = trender.render(scene, cam, spp=2, integrator="path",
                         sampler="halton", max_depth=opts["max_depth"],
                         device="cpu").numpy()
    assert img.shape == (128, 128, 3)
    assert np.array_equal(img, ref)
    err = capsys.readouterr().err
    assert "pbrt_tpu_torch: device cpu" in err and '"launches"' in err
    crop = tmp_path / "c.pfm"
    assert cli.main([DEMO, "--cpu", "--spp", "1", "--quiet",
                     "--debug-nans", "--cropwindow", "0", "0.5", "0.25",
                     "0.5", "-o", str(crop)]) == 0
    assert imageio.read_pfm(str(crop)).shape == (32, 64, 3)


def test_cli_cat_matches_jax(capsys):
    from pbrt_tpu.utils import cli as jcli
    for path in (DEMO, os.path.join(ORACLE, "filter_oracle.pbrt")):
        jcli.main([path, "--cat"])
        want = capsys.readouterr().out
        cli.main([path, "--cat"])
        assert capsys.readouterr().out == want
        assert "WorldBegin" in want


def test_cli_spectral_and_no_card_raise():
    with pytest.raises(NotImplementedError, match="item 9"):
        cli.main([DEMO, "--cpu", "--spectral", "--quiet"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([DEMO, "--quiet"])


def reference_means():
    """pbrt_tpu's float32 image means on the CPU backend for the scene
    files chip_smoke.py renders in-process on the card (phase 15 b): each
    file at its own resolution, integrator, max depth and filter, 16 spp,
    the halton sampler, seed 0. Run this file as a script from the root of
    the checkout, ``PYTHONPATH=. python tests/test_torch_oracle.py``, to
    print them."""
    from pbrt_tpu.frontend import load_pbrt as jload
    out = {}
    for name in ("ao", "deltalights", "filter"):
        scene, cam, opts = jload(os.path.join(ORACLE, f"{name}_oracle.pbrt"))
        fname, fkw = opts["filter"]
        img = jrender.render(scene, cam, spp=16,
                             integrator=opts["integrator"], sampler="halton",
                             max_depth=opts["max_depth"], filter_name=fname,
                             filter_kwargs=fkw, seed=0)
        out[name] = float(np.asarray(img, np.float64).mean())
    return out


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins JAX to the CPU backend)
    for key, mean in reference_means().items():
        print(key, repr(mean))
