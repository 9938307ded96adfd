"""The port's reconstruction filters, image I/O and crop windows.

- The five filters' tables (256 inverse-CDF offsets and weights per axis)
  and the offsets and weights they draw for seeded uniforms equal
  pbrt_tpu's ``make_filter`` / ``sample_filter_offset`` exactly.
- PFM, EXR, PNG and TGA files the port writes are byte for byte the ones
  pbrt_tpu writes; PFM and EXR read back exactly, PNG to its 8-bit sRGB
  quantization; ``read_pfm`` of every reference-binary image under
  tests/oracle/ gives pbrt_tpu's arrays bit for bit.
- A crop window renders exactly the same pixels as the full frame, on the
  generic loop (halton) and on the fused path's twin (independent).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.utils import imageio as jio
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.frontend import load_pbrt
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.utils import imageio as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "tests", "oracle")
FILTERS = {"box": {}, "triangle": {"xwidth": 1.5},
           "gaussian": {"xwidth": 2.5, "ywidth": 1.5, "alpha": 3.0},
           "mitchell": {"xwidth": 2.0, "ywidth": 2.0},
           "sinc": {"tau": 2.5}}


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filters_match_jax(name):
    kw = FILTERS[name]
    jf = jfilm.make_filter(name, **kw)
    tf = tfilm.make_filter(name, **kw)
    bf = bridge.filter_from_jax(jf)
    assert tf.is_box == bf.is_box == (name == "box")
    assert torch.equal(tf.radius, bf.radius)
    for k in ("inv_cdf", "inv_cdf_y", "w_x", "w_y"):
        a, b = getattr(tf, k), getattr(bf, k)
        assert (a is None and b is None) or torch.equal(a, b), k
    u = np.random.RandomState(3).rand(4096, 2).astype(np.float32)
    u[:4] = [[0, 0], [0.999999, 0.5], [0.5, 0.999999], [1e-7, 1e-7]]
    off_j, w_j = jfilm.sample_filter_offset(jf, jnp.asarray(u))
    off_t, w_t = tfilm.sample_filter_offset(tf, torch.as_tensor(u))
    assert np.array_equal(off_t.numpy(), np.asarray(off_j))
    assert np.array_equal(w_t.numpy(), np.asarray(w_j, np.float32))
    if name == "mitchell":
        assert (w_t < 0).any()      # the negative lobes carry a sign


def _image(h=13, w=17, seed=4):
    img = np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)
    img[0, 0] = (0.0, 1.0, 2.5)                # out of [0, 1] too
    return img


@pytest.mark.parametrize("ext", ("pfm", "exr", "png", "tga"))
def test_image_files_match_jax(ext, tmp_path):
    img = _image()
    tp, jp = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    tio.write_image(str(tp), img)
    jio.write_image(str(jp), img)
    assert tp.read_bytes() == jp.read_bytes()
    if ext == "tga":
        return                                  # write-only, as pbrt_tpu
    back = tio.read_image(str(tp))
    assert back.shape == img.shape and back.dtype == np.float32
    assert np.array_equal(back, jio.read_image(str(tp)))
    if ext == "png":
        # 8-bit sRGB: the quantization step at 1.0 is ≈ 1/255 / 0.42
        np.testing.assert_allclose(back, np.clip(img, 0, 1), atol=1e-2)
    else:
        assert np.array_equal(back, img)


def test_reference_pfms_read_as_jax():
    paths = sorted(glob.glob(os.path.join(ORACLE, "*_ref.pfm")))
    assert len(paths) >= 20
    for p in paths:
        a, b = tio.read_pfm(p), jio.read_pfm(p)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b), p


def test_exr_zip_blocks_decode():
    """The ZIP predictor's inverse: delta-decode then de-interleave."""
    raw = np.arange(10, dtype=np.uint8).tobytes()
    assert tio._exr_unpredict(raw) == jio._exr_unpredict(raw)


CROP = (0.25, 0.8, 0.1, 0.55)


@pytest.mark.parametrize("case", ("halton_loop", "independent_fused"))
def test_crop_renders_the_full_frames_pixels(case):
    """A crop keys its sample streams on the full image's pixel ids, so it
    renders exactly the same pixels (port only)."""
    if case == "halton_loop":
        scene, cam, opts = load_pbrt(
            os.path.join(ORACLE, "deltalights_oracle.pbrt"), device="cpu")
        cam.resolution = (24, 20)
        kw = dict(integrator="path", sampler="halton", max_depth=3)
    else:
        scene, cam = entry._portal_scene("cpu"), entry._camera((24, 20),
                                                               "cpu")
        kw = dict(integrator="path", sampler="independent", max_depth=3)
        assert scene.fused_profile is not None
    full = trender.render(scene, cam, spp=3, device="cpu", **kw)
    crop = trender.render(scene, cam, spp=3, crop_window=CROP,
                          device="cpu", **kw)
    px0, py0, wc, hc = trender.crop_bounds(CROP, 24, 20)
    assert (px0, py0, wc, hc) == (6, 2, 14, 9)
    assert crop.shape == (hc, wc, 3)
    assert torch.equal(crop, full[py0:py0 + hc, px0:px0 + wc])
