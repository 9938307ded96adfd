"""Resumable renders and the tools against pbrt_tpu.

(a) Checkpoints (utils/checkpoint.py): the npz round trip, in the port
    and across the packages (either one reads what the other wrote); a
    render stopped after one pass and resumed equals the uninterrupted
    one bit for bit; a checkpoint pbrt_tpu wrote after 8 of 16 spp
    resumes in the port to pbrt_tpu's uninterrupted image, rtol 1e-5 /
    atol 1e-6 (tests/test_checkpoint.py's scene and call).
(b) The tools on the same inputs as pbrt_tpu's: obj2pbrt and cyhair2pbrt
    text equal (tests/test_tools.py's files); imgtool's info and cat text
    equal, diff's text and difference image equal, convert (despike,
    bloom, tone map, gamma) and assemble images equal, makesky's image
    equal to pbrt_tpu's and to tests/oracle/sky_ref.pfm within
    tests/test_tools.py's limit (rel 1e-4, zero where the reference is
    zero); bsdftest's table on the CPU equal to pbrt_tpu's, no material
    failing.
"""

import contextlib
import io
import os
import struct

import numpy as np
import pytest
import torch

from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.scene import camera as jcam_mod
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu.tools import bsdftest as jbsdftest
from pbrt_tpu.tools import cyhair2pbrt as jcyhair
from pbrt_tpu.tools import imgtool as jimgtool
from pbrt_tpu.tools import obj2pbrt as jobj2pbrt
from pbrt_tpu.tools.hosek import makesky_image as jmakesky
from pbrt_tpu.utils import checkpoint as jck
from pbrt_tpu_torch.core import transform
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene.types import SceneBuilder
from pbrt_tpu_torch.tools import bsdftest, cyhair2pbrt, imgtool, obj2pbrt
from pbrt_tpu_torch.tools.hosek import makesky_image
from pbrt_tpu_torch.utils import checkpoint as ck
from pbrt_tpu_torch.utils import imageio

HERE = os.path.dirname(os.path.abspath(__file__))


def _fill(b):
    """tests/test_checkpoint.py's scene."""
    m = b.add_material(type=0, kd=(0.6, 0.5, 0.4))
    b.add_mesh([(-2, 0, -2), (2, 0, -2), (2, 0, 2), (-2, 0, 2)],
               [(0, 1, 2), (0, 2, 3)], mat=m)
    b.add_light(type="point", I=10.0, pos=(0, 2, 0))


def _scene():
    b = SceneBuilder()
    _fill(b)
    return b.build("cpu")


def _cam():
    return cam_mod.make_perspective(
        transform.look_at((0, 1.5, -3), (0, 0, 0), (0, 1, 0)), 45.0, (8, 8))


KW = dict(every_spp=8, max_depth=2, seed=3, device="cpu")


def test_save_load_round_trip_across_packages(tmp_path):
    film = np.random.RandomState(0).rand(4, 4, 3).astype(np.float32)
    for i, (save, load) in enumerate(((ck.save_checkpoint, ck.load_checkpoint),
                                      (ck.save_checkpoint,
                                       jck.load_checkpoint),
                                      (jck.save_checkpoint,
                                       ck.load_checkpoint))):
        p = str(tmp_path / f"ck{i}.npz")
        save(p, film, spp_done=24, seed=7, meta={"spp_target": 64})
        z = load(p)
        np.testing.assert_array_equal(z["film_sum"], film)
        assert z["spp_done"] == 24 and z["seed"] == 7
        assert int(z["meta"]["spp_target"]) == 64


def test_resume_equals_uninterrupted(tmp_path):
    scene, cam = _scene(), _cam()
    p = str(tmp_path / "render.npz")
    full = ck.render_with_checkpoints(scene, cam, 16, None, **KW)
    ck.render_with_checkpoints(scene, cam, 8, p, **KW)
    assert ck.load_checkpoint(p)["spp_done"] == 8
    resumed = ck.render_with_checkpoints(scene, cam, 16, p, **KW)
    assert torch.equal(full, resumed) and float(full.mean()) > 1e-4
    assert ck.load_checkpoint(p)["spp_done"] == 16


def test_pbrt_tpu_checkpoint_resumes_in_the_port(tmp_path):
    jb = JaxBuilder(RGB)
    _fill(jb)
    js = jb.build()
    jc = jcam_mod.make_perspective(
        jtransform.look_at((0, 1.5, -3), (0, 0, 0), (0, 1, 0)), 45.0, (8, 8))
    p = str(tmp_path / "jax.npz")
    want = np.asarray(jck.render_with_checkpoints(js, jc, 16, None,
                                                  every_spp=8, max_depth=2,
                                                  seed=3))
    jck.render_with_checkpoints(js, jc, 8, p, every_spp=8, max_depth=2,
                                seed=3)
    got = ck.render_with_checkpoints(_scene(), _cam(), 16, p, **KW).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


OBJ = """mtllib box.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vn 0 0 1
vt 0 0
vt 1 0
vt 1 1
usemtl red
f 1//1 2//1 3//1 4//1
usemtl shiny
f 1/1 2/2 5/3
f -3 -2 -1
"""
MTL = "newmtl red\nKd 0.8 0.1 0.1\nnewmtl shiny\nKd 0.2 0.2 0.2\n" \
      "Ks 0.5 0.5 0.5\nNs 40\nKe 1 1 0.5\n"


def _hair_file(path):
    """tests/test_tools.py's four-point strand, and a second strand with
    per-point thickness and segment counts."""
    pts = np.asarray([[0, 0, 0], [0, 1, 0], [0, 2, 0.5], [0, 3, 1.0],
                      [1, 0, 0], [1, 1, 0.2], [1, 2, 0.1]], np.float32)
    with open(path, "wb") as f:
        f.write(b"HAIR")
        f.write(struct.pack("<IIII", 2, 7, 1 | 2 | 4, 3))
        f.write(struct.pack("<ff", 0.1, 1.0))
        f.write(struct.pack("<fff", 0.5, 0.3, 0.1))
        f.write(b"\0" * 88)
        f.write(np.asarray([3, 2], "<u2").tobytes())
        f.write(pts.tobytes())
        f.write(np.linspace(0.05, 0.01, 7).astype("<f4").tobytes())


def test_converters_write_pbrt_tpus_text(tmp_path):
    obj = tmp_path / "box.obj"
    obj.write_text(OBJ)
    (tmp_path / "box.mtl").write_text(MTL)
    hair = tmp_path / "s.hair"
    _hair_file(hair)
    for mine, theirs, src in ((obj2pbrt, jobj2pbrt, obj),
                              (cyhair2pbrt, jcyhair, hair)):
        a, b = io.StringIO(), io.StringIO()
        mine.convert(str(src), a)
        theirs.convert(str(src), b)
        assert a.getvalue() == b.getvalue() and len(a.getvalue()) > 100


def _stdout(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = tmp_path_factory.mktemp("img")
    rs = np.random.RandomState(5)
    a = rs.rand(12, 16, 3).astype(np.float32)
    a[3, 4] = 40.0                                 # a spike
    b = a + rs.normal(0, 0.01, a.shape).astype(np.float32)
    c = rs.rand(6, 9, 3).astype(np.float32)
    paths = {}
    for name, img in (("a", a), ("b", b), ("c", c)):
        paths[name] = str(d / f"{name}.pfm")
        imageio.write_image(paths[name], img)
    paths["dir"] = d
    return paths


@pytest.mark.parametrize("cmd", ["info", "cat", "diff", "convert",
                                 "assemble"])
def test_imgtool_matches_pbrt_tpus(images, cmd):
    d = images["dir"]
    argv = {
        "info": ["info", images["a"]],
        "cat": ["cat", images["c"]],
        "diff": ["diff", images["a"], images["b"], "--difftol", "0.02",
                 "--outfile", "{out}"],
        "convert": ["convert", images["a"], "{out}", "--scale", "1.5",
                    "--despike", "5", "--bloomlevel", "0.9",
                    "--bloomwidth", "6", "--bloomiters", "2", "--tonemap",
                    "--gamma", "2.2"],
        "assemble": ["assemble", "{out}", images["a"], images["c"]],
    }[cmd]
    results = []
    for tool, tag in ((imgtool, "port"), (jimgtool, "jax")):
        out = str(d / f"{cmd}_{tag}.pfm")
        results.append(_stdout(tool.main, [x.replace("{out}", out)
                                           for x in argv]) + (out,))
    (rc, text, out), (jrc, jtext, jout) = results
    assert rc == jrc and text == jtext
    if "{out}" in " ".join(argv):
        np.testing.assert_array_equal(imageio.read_image(out),
                                      imageio.read_image(jout))


def test_makesky_matches_pbrt_tpu_and_the_reference():
    ours = makesky_image(np.radians(10.0), 3.0, 0.5, 32)
    np.testing.assert_array_equal(ours, jmakesky(np.radians(10.0), 3.0, 0.5,
                                                 32))
    ref = imageio.read_pfm(os.path.join(HERE, "oracle", "sky_ref.pfm"))
    assert ours.shape == ref.shape
    b = ref != 0
    rel = np.abs(ours - ref) / (np.abs(ref) + 1e-3)
    assert rel[b].max() < 1e-4, rel[b].max()
    np.testing.assert_array_equal(ours == 0, ref == 0)


def test_bsdftest_matches_pbrt_tpus_table():
    mine, theirs = io.StringIO(), io.StringIO()
    assert bsdftest.run(20_000, mine, device="cpu") == 0
    assert jbsdftest.run(20_000, theirs) == 0
    assert mine.getvalue() == theirs.getvalue()
    assert bsdftest.main(["2000", "--cpu"]) == 0
