"""Participating media and `volpath`: the port's scene/media.py and
integrators/volpath.py against pbrt_tpu's, and volpath_oracle.pbrt and
gridvol_oracle.pbrt against the reference binary.

- **Media.** A homogeneous medium and a 5×4×3 density grid built by
  pbrt_tpu and bridged; seeded points, directions, segments and tracking
  seeds go through both packages' ``density_at``, ``hg_phase``,
  ``sample_hg``, ``transmittance``, ``sample_distance`` and the per-lane
  ``*_set`` dispatchers (vacuum, homogeneous and grid lanes mixed),
  eagerly. The tracking draws the same counter-hash streams, so the
  sampled distances, the medium / surface decisions and the step counts
  agree lane for lane: booleans exactly, floats at atol 1e-6 + rtol 1e-5.
- **Passes.** Each file parsed by pbrt_tpu and bridged, one `volpath`
  render_pass of a 16² window of its film × 4 spp with the file's halton
  sampler and depth (one jitted pbrt_tpu program per file): per pixel
  rtol 1e-4 / atol 1e-5 with at most 6e-3 of the pixels outside (seam
  ties, tests/test_fused_path.py:258-261), image mean rel 1e-4.
- **The oracle files** on the CPU with tests/test_oracle.py's calls, spp,
  seed and limits (:292-339): 48 spp, seed 2; volpath md < 0.02,
  bl < 0.06; gridvol md < 0.05, bl < 0.08 (its reference image carries an
  ≈ +8% in-fog residual that pbrt_tpu shows too, tests/oracle/README.md).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.frontend import load_pbrt as jload_pbrt
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import media as jmedia
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.frontend import load_pbrt as tload_pbrt
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import media as tmedia
from pbrt_tpu_torch.utils import imageio
from test_torch_oracle import _block_rel_l1, _mean_delta

jrender = importlib.import_module("pbrt_tpu.integrators.render")

ORACLE = os.path.join(os.path.dirname(__file__), "oracle")
R = 512
CROP = (40, 40, 16, 16)     # a 16² window of the 96² films
SPP = 4
# file: (md limit, bl limit) of tests/test_oracle.py
FILES = {"volpath": (0.02, 0.06), "gridvol": (0.05, 0.08)}


def _media():
    dens = np.random.RandomState(4).uniform(0.0, 2.5, (3, 4, 5))
    homog = jmedia.make_homogeneous((0.08, 0.10, 0.12), (0.35, 0.30, 0.25),
                                    0.2)
    grid = jmedia.make_grid(0.12, 0.5, dens, (-0.9, 0.1, -0.6),
                            (0.9, 1.9, 1.2), -0.3)
    return (homog, grid)


def _inputs():
    rs = np.random.RandomState(8)
    p0 = rs.uniform((-1.2, -0.2, -0.9), (1.2, 2.2, 1.5), (R, 3))
    p1 = rs.uniform((-1.2, -0.2, -0.9), (1.2, 2.2, 1.5), (R, 3))
    d = rs.randn(R, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return dict(
        p0=p0.astype(np.float32), p1=p1.astype(np.float32),
        d=d.astype(np.float32),
        t_max=rs.uniform(0.1, 3.0, R).astype(np.float32),
        u=rs.uniform(0.0, 1.0, R).astype(np.float32),
        u2=rs.uniform(0.0, 1.0, (R, 2)).astype(np.float32),
        cos=rs.uniform(-1.0, 1.0, R).astype(np.float32),
        g=rs.choice([-0.5, 0.0, 5e-4, 0.2, 0.8], R).astype(np.float32),
        seed=rs.randint(0, 2**32, R, dtype=np.uint64).astype(np.uint32),
        med_id=rs.randint(-1, 2, R).astype(np.int32))


def _call(pkg, media, name, x):
    """Evaluate ``name`` with package ``pkg`` (jmedia or tmedia) on the
    inputs ``x``; returns a tuple of arrays."""
    if pkg is jmedia:
        a = {k: jnp.asarray(v) for k, v in x.items()}
    else:
        a = {k: torch.as_tensor(v.astype(np.int64) if k == "seed" else v)
             for k, v in x.items()}
    homog, grid = media
    out = {
        "density_at": lambda: pkg.density_at(grid, a["p0"]),
        "hg_phase": lambda: pkg.hg_phase(a["cos"], a["g"]),
        "sample_hg": lambda: pkg.sample_hg(a["d"], a["u2"], a["g"]),
        "tr_homogeneous": lambda: pkg.transmittance(homog, a["p0"],
                                                    a["p1"], a["seed"]),
        "tr_grid": lambda: pkg.transmittance(grid, a["p0"], a["p1"],
                                             a["seed"]),
        "distance_homogeneous": lambda: pkg.sample_distance(
            homog, a["p0"], a["d"], a["t_max"], a["u"], a["seed"]),
        "distance_grid": lambda: pkg.sample_distance(
            grid, a["p0"], a["d"], a["t_max"], a["u"], a["seed"]),
        "tr_set": lambda: pkg.transmittance_set(
            media, a["med_id"], a["p0"], a["p1"], a["seed"]),
        "distance_set": lambda: pkg.sample_distance_set(
            media, a["med_id"], a["p0"], a["d"], a["t_max"], a["u"],
            a["seed"]),
        "phase_g_set": lambda: pkg.phase_g_set(media, a["med_id"]),
    }[name]()
    out = out if isinstance(out, tuple) else (out,)
    return tuple(np.asarray(v) if pkg is jmedia else v.numpy() for v in out)


MEDIUM_FUNCS = ["density_at", "hg_phase", "sample_hg", "tr_homogeneous",
                "tr_grid", "distance_homogeneous", "distance_grid", "tr_set",
                "distance_set", "phase_g_set"]


@pytest.mark.parametrize("name", MEDIUM_FUNCS)
def test_medium_functions_match_jax(name):
    jm = _media()
    tm = tuple(bridge.medium_from_jax(m) for m in jm)
    x = _inputs()
    want = _call(jmedia, jm, name, x)
    got = _call(tmedia, tm, name, x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
            if name.startswith("distance"):
                assert 0.05 < w.mean() < 0.95   # both outcomes occur
        else:
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-5)


def test_grid_density_zero_padding():
    """pbrt's D() is 0 outside the sample lattice (grid.h:61-69): half a
    cell in from the box's faces the lookup fades toward 0, and it is 0
    outside the box."""
    _, grid = (bridge.medium_from_jax(m) for m in _media())
    lo, hi = grid.grid_lo, grid.grid_hi
    mid = 0.5 * (lo + hi)
    inside_face = torch.stack([lo[0] + 1e-4, mid[1], mid[2]])
    outside = torch.stack([lo[0] - 1e-3, mid[1], mid[2]])
    d = tmedia.density_at(grid, torch.stack([inside_face, outside, mid]))
    assert float(d[1]) == 0.0 and float(d[2]) > 0.0
    assert float(d[0]) < float(d[2])


@pytest.fixture(scope="module", params=sorted(FILES))
def volpath_pass(request):
    name = request.param
    js, jcam, opts = jload_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"))
    assert opts["integrator"] == "volpath" and js.media
    cfg = dict(integrator="volpath", sampler="halton",
               max_depth=opts["max_depth"], seed=2)
    want = np.asarray(jrender.render_pass(
        js, jcam, jfilm.make_filter("box"), jrender.RenderConfig(**cfg),
        96, 96, SPP, jnp.asarray(0, jnp.uint32), crop=CROP))
    ts = bridge.scene_from_jax(js)
    got = trender.render_pass(
        ts, bridge.camera_from_jax(jcam), tfilm.make_filter("box"),
        trender.RenderConfig(**cfg), 96, 96, SPP, 0, "cpu",
        crop=CROP).numpy()
    return name, ts, got, want


def test_volpath_pass_matches_jax(volpath_pass):
    name, ts, got, want = volpath_pass
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and want.mean() > 0.05
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 6e-3, f"{name}: {bad.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-4


def test_volpath_scene_tables(volpath_pass):
    """The bridged scene carries the media, the null sphere's interface
    (inside: the medium, outside: vacuum) and no fused profile; the
    port's own parse of the file builds the same."""
    name, ts, _, _ = volpath_pass
    assert len(ts.media) == 1 and ts.camera_med == -1
    assert ts.media[0].is_grid == (name == "gridvol")
    sphere = ts.n_tri
    assert int(ts.prim_med_in[sphere]) == 0
    assert int(ts.prim_med_out[sphere]) == -1
    assert ts.fused_profile is None
    ps, _, _ = tload_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"),
                          device="cpu")
    for key in ("prim_med_in", "prim_med_out", "prim_mat"):
        assert torch.equal(getattr(ps, key), getattr(ts, key)), key
    for f in ("sigma_a", "sigma_s", "g", "density", "grid_lo", "grid_hi",
              "max_density"):
        assert torch.equal(getattr(ps.media[0], f),
                           getattr(ts.media[0], f)), f


@pytest.mark.parametrize("name", sorted(FILES))
def test_volpath_file_matches_reference_binary(name):
    """tests/test_oracle.py's call (48 spp, seed 2) with the file's halton
    sampler, in one pass of 48 spp."""
    md_lim, bl_lim = FILES[name]
    scene, cam, opts = tload_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"),
                                  device="cpu")
    assert opts["integrator"] == "volpath"
    img = trender.render(scene, cam, spp=48, integrator=opts["integrator"],
                         sampler=opts["sampler"],
                         max_depth=opts["max_depth"], seed=2, chunk_spp=48,
                         device="cpu").numpy()
    ref = imageio.read_pfm(os.path.join(ORACLE, f"{name}_ref.pfm"))
    assert img.shape == ref.shape and np.isfinite(img).all()
    md = _mean_delta(img, ref)
    bl = _block_rel_l1(img, ref, k=16)
    assert md < md_lim, f"{name} mean delta {md:.4f}"
    assert bl < bl_lim, f"{name} block rel-L1 {bl:.4f}"


def reference_means():
    """pbrt_tpu's float32 image means on the CPU backend of the two files
    with `volpath` at their own resolution and max depth, 8 spp, the
    halton sampler, seed 0 (chip_smoke.py's REF_MEDIA_MEANS).
    ``PYTHONPATH=. python tests/test_torch_volpath.py`` prints them."""
    out = {}
    for name in sorted(FILES):
        js, jc, jo = jload_pbrt(os.path.join(ORACLE, f"{name}_oracle.pbrt"))
        img = jrender.render(js, jc, spp=8, integrator="volpath",
                             sampler="halton", max_depth=jo["max_depth"],
                             seed=0)
        out[name] = float(np.asarray(img, np.float64).mean())
    return out


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    print(reference_means())
