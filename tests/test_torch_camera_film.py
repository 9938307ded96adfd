"""Camera rays and box-filter offsets of the port against pbrt_tpu's,
lane for lane, on the main path's camera at 64².

Both packages compute the same float32 formulas from the same pcg4d
samples; atol 1e-6 covers float32 rounding of the 3×3 camera products
and rsqrt, which the two libraries may order differently.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch.core import transform as ttransform
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import camera as tcam
from pbrt_tpu_torch.scene import film as tfilm

jrender = importlib.import_module("pbrt_tpu.integrators.render")

RES = 64
CHUNK = 2


def _jax_lanes(cam, res=RES, chunk=CHUNK, spp_offset=0):
    """render_pass's lane layout and front half, in pbrt_tpu."""
    from pbrt_tpu.samplers import make_sampler
    n_pix = res * res
    lid = jnp.tile(jnp.arange(n_pix, dtype=jnp.uint32), chunk)
    sidx = jnp.repeat(jnp.arange(chunk, dtype=jnp.uint32), n_pix) \
        + jnp.uint32(spp_offset)
    sfn = make_sampler("independent")
    px = (lid % res).astype(jnp.float32)
    py = (lid // res).astype(jnp.float32)
    pid = py.astype(jnp.uint32) * jnp.uint32(res) + px.astype(jnp.uint32)
    u_film = jrender._sample2(sfn, pid, sidx, (0, 1), 0)
    off, w = jfilm.sample_filter_offset(jfilm.make_filter("box"), u_film)
    p_film = jnp.stack([px + 0.5, py + 0.5], -1) + off
    rays = jcam.generate_rays(cam, p_film,
                              jrender._sample2(sfn, pid, sidx, (2, 3), 0),
                              sfn(pid, sidx, 4, 0))
    return rays, pid, sidx, off, w


@pytest.mark.parametrize("spp_offset", [0, 30])
def test_camera_rays_match_jax(spp_offset):
    rays_j, pid_j, sidx_j, _, w_j = _jax_lanes(ge._camera((RES, RES)),
                                              spp_offset=spp_offset)
    cfg = trender.RenderConfig(max_depth=4)
    rays_t, pid_t, sidx_t, w_t = trender.camera_rays(
        entry._camera((RES, RES), "cpu"), tfilm.make_filter("box"), cfg, RES,
        RES,
        CHUNK, spp_offset, "cpu")
    np.testing.assert_array_equal(pid_t.numpy(), np.asarray(pid_j))
    np.testing.assert_array_equal(sidx_t.numpy(), np.asarray(sidx_j))
    np.testing.assert_allclose(rays_t.o.numpy(), np.asarray(rays_j.o),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(rays_t.d.numpy(), np.asarray(rays_j.d),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


def test_box_filter_offsets_match_jax():
    rs = np.random.default_rng(3)
    u = rs.random((RES * RES, 2), dtype=np.float32)
    for width in (None, 1.5):
        kw = {} if width is None else dict(xwidth=width, ywidth=0.25)
        off_j, w_j = jfilm.sample_filter_offset(jfilm.make_filter("box",
                                                                  **kw),
                                                jnp.asarray(u))
        off_t, w_t = tfilm.sample_filter_offset(tfilm.make_filter("box",
                                                                  **kw),
                                                torch.as_tensor(u))
        np.testing.assert_allclose(off_t.numpy(), np.asarray(off_j),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


def test_thin_lens_rays_match_jax():
    """The thin-lens branch (lens radius > 0) on random film and lens
    samples; the camera built by each package from the same parameters
    and, through the bridge, from pbrt_tpu's own camera."""
    rs = np.random.default_rng(5)
    n = 4096
    p_film = (rs.random((n, 2), dtype=np.float32) * np.float32(48))
    u_lens = rs.random((n, 2), dtype=np.float32)
    u_time = rs.random(n, dtype=np.float32)
    args = ((0.1, 0.4, -1.2), (0.5, 0.5, 1.0), (0, 1, 0))
    cj = jcam.make_perspective(jtransform.look_at(*args), 35.0, (48, 32),
                               lens_radius=0.05, focal_distance=1.7)
    ct = tcam.make_perspective(ttransform.look_at(*args), 35.0, (48, 32),
                               lens_radius=0.05, focal_distance=1.7)
    rj = jcam.generate_rays(cj, jnp.asarray(p_film), jnp.asarray(u_lens),
                            jnp.asarray(u_time))
    for cam in (ct, bridge.camera_from_jax(cj)):
        rt = tcam.generate_rays(cam, torch.as_tensor(p_film),
                                torch.as_tensor(u_lens),
                                torch.as_tensor(u_time))
        np.testing.assert_allclose(rt.o.numpy(), np.asarray(rj.o),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(rt.d.numpy(), np.asarray(rj.d),
                                   atol=1e-6, rtol=0)


def test_unported_camera_filter_sampler_raise():
    from pbrt_tpu_torch.samplers import make_sampler
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sampler("sobol")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sampler("stratified")
    # a moving camera (motion blur) is not ported
    moving = dataclasses.replace(ge._camera((8, 8)), anim=object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        bridge.camera_from_jax(moving)


def test_core_math_matches_jax():
    """vecmath, sampling warps, transforms and the per-bounce dimension
    layout on random inputs (float32 rounding: atol 1e-6)."""
    from pbrt_tpu.core import sampling as jsamp
    from pbrt_tpu.core import vecmath as jvec
    from pbrt_tpu_torch.core import sampling as tsamp
    from pbrt_tpu_torch.core import vecmath as tvec
    rs = np.random.default_rng(9)
    a, b, c = (rs.standard_normal((512, 3)).astype(np.float32)
               for _ in range(3))
    u = rs.random((512, 2), dtype=np.float32)
    u[:4] = 0.5                       # the concentric map's zero branch
    ta, tb, tc = (torch.as_tensor(x) for x in (a, b, c))
    pairs = [
        (tvec.dot(ta, tb), jvec.dot(a, b)),
        (tvec.cross(ta, tb), jvec.cross(a, b)),
        (tvec.normalize(ta), jvec.normalize(a)),
        (tvec.face_forward(ta, tb), jvec.face_forward(a, b)),
        (tvec.offset_ray_origin(ta, tvec.normalize(tb), tc),
         jvec.offset_ray_origin(a, jvec.normalize(b), c)),
        (tsamp.concentric_sample_disk(torch.as_tensor(u)),
         jsamp.concentric_sample_disk(jnp.asarray(u))),
        (tsamp.cosine_sample_hemisphere(torch.as_tensor(u)),
         jsamp.cosine_sample_hemisphere(jnp.asarray(u))),
    ]
    m = rs.standard_normal((4, 4)).astype(np.float32)
    m[3] = (0, 0, 0, 1)
    tt, tj = ttransform.from_matrix(m), jtransform.from_matrix(m)
    pairs += [(tt.apply_point(ta), tj.apply_point(a)),
              (tt.apply_vector(ta), tj.apply_vector(a))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    for bounce in range(7):
        assert trender._bounce_dims(bounce) == jrender._bounce_dims(bounce)
