"""The spatial light strategy and PSSMLT against pbrt_tpu.

Spatial (scene/lightdistrib.py): the per-voxel tables of
``build_spatial_distribution`` to rel 1e-6 and ``sample_spatial``'s
indices equal (pmf rtol 1e-6) on tests/test_lightdistrib.py's two-light
floor and on tests/test_torch_bdpt.py's ``area`` scene (three area
lights), but for the voxel rows where the sphere light's estimate is off
by XLA's contracted cone (6 of 4,096, by up to 1.9e-6: rtol 2e-5, the
sphere bound of tests/test_torch_intersect.py); a `path` pass and a `volpath` pass (the same scene in a
homogeneous camera medium: pbrt_tpu's volpath draws every lane from the
voxel of the world origin, ROADMAP queue 3) lane for lane under the
spatial strategy, at tests/test_torch_sss.py's bound (per pixel rtol
1e-4 / atol 1e-5 on all but 2% of the pixels, the mean to 1e-4); and
tests/test_lightdistrib.py's two properties on the port.

MLT (integrators/mlt.py) on the ``area`` scene at 16², max_depth 4 (56
dims): ``_mutate`` within 2 ulps of pbrt_tpu's (torch's erfinv is
another approximation than XLA's), ``_eval_target`` lane for lane at the
pass bound, the bootstrap normalization b to rel 1e-5 and the resampled
start states equal, one chain step's film against pbrt_tpu's
``_mlt_chains``, and four steps, with the chains that diverge counted: a
proposal whose acceptance ``u < a`` sits on an ulp flips when the two
packages' luminances differ in the last bit. Found: 0 of 1,024 chains
after four steps. The films are held at the pass bound (2 of 256 pixels
off after one step, by 4.1e-5).

Jitted pbrt_tpu programs: the two passes, ``_eval_target_jit`` at the
chains' and at the bootstrap's shape, and ``_mlt_chains`` at one step.

``PYTHONPATH=. python tests/test_torch_lightdistrib_mlt.py`` prints
pbrt_tpu's CPU mean of chip_smoke.py's spatial pass (REF_SPATIAL_MEAN).
"""

import contextlib
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import transform as jtransform
from pbrt_tpu.core.spectrum import RGB
from pbrt_tpu.integrators import mlt as jmlt
from pbrt_tpu.scene import camera as jcam
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu.scene import lightdistrib as jld
from pbrt_tpu.scene import media as jmedia
from pbrt_tpu.scene.types import SceneBuilder as JaxBuilder
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.integrators import mlt as tmlt
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from pbrt_tpu_torch.scene import lightdistrib as tld
from pbrt_tpu_torch.scene.types import SceneBuilder
from test_torch_bdpt import fill_area

jrender = importlib.import_module("pbrt_tpu.integrators.render")

RES, SPP = 16, 4
MLT_DEPTH = 4
N_CHAINS = 1024
N_BOOT = 1 << 14
SEED = 5
# chip_smoke.py's spatial pass: 256² × 32 spp `path`, max_depth 4
SPATIAL_RES, SPATIAL_SPP, SPATIAL_DEPTH = 256, 32, 4


def fill_two_lights(b):
    """tests/test_lightdistrib.py's scene: two point lights at opposite
    ends of a long floor."""
    m = b.add_material(type=0, kd=0.6)
    b.add_mesh([(-10, 0, -2), (10, 0, -2), (10, 0, 2), (-10, 0, 2)],
               [(0, 1, 2), (0, 2, 3)], mat=m)
    b.add_light(type="point", I=10.0, pos=(-8, 1, 0))
    b.add_light(type="point", I=10.0, pos=(8, 1, 0))


def two_light_camera(res=(10, 10)):
    return jcam.make_perspective(
        jtransform.look_at((0, 4, -6), (0, 0, 0), (0, 1, 0)), 50.0, res)


def area_camera(res=RES):
    return jcam.make_perspective(
        jtransform.look_at((0.5, 0.5, -1.3), (0.5, 0.45, 0.5), (0, 1, 0)),
        40.0, (res, res))


def _both(fill):
    b = JaxBuilder(RGB)
    fill(b)
    js = b.build()
    return js, bridge.scene_from_jax(js)


@pytest.fixture(scope="module")
def scenes():
    return {"two_lights": _both(fill_two_lights), "area": _both(fill_area)}


@pytest.fixture(scope="module")
def spatial(scenes):
    """Each scene's spatial table in each package, built once: name ->
    (pbrt_tpu's, the port's)."""
    tables = {}

    def get(name):
        if name not in tables:
            js, ts = scenes[name]
            tables[name] = (jld.build_spatial_distribution(js),
                            tld.build_spatial_distribution(ts))
        return tables[name]
    return get


# ---------------------------------------------------------------------------
# the spatial strategy
# ---------------------------------------------------------------------------

def _sphere_light_columns(ts):
    """The light columns of area lights on spheres."""
    prim = ts.lights.prim_id
    return ((ts.lights.ltype == 3) & (prim >= ts.n_tri)
            & (prim < ts.n_tri + ts.n_sph)).numpy()


def _rows_off(ts, got, want):
    """Voxel rows whose func is off rel 1e-6; only a sphere light's
    column may be (XLA contracts Sample_Li's sphere cone on the CPU)."""
    off = ~np.isclose(got, want, rtol=1e-6, atol=0)
    assert not off[:, ~_sphere_light_columns(ts)].any()
    return off.any(-1)


@pytest.mark.parametrize("name", ["two_lights", "area"])
def test_spatial_tables_match_pbrt_tpu(scenes, spatial, name):
    """func, cdf and func_int of every voxel to rel 1e-6, but for the
    rows where a sphere light's entry is off by XLA's contracted cone
    (found: 6 of 4,096 rows on the area scene, by up to 1.9e-6), which
    hold rtol 2e-5, the bound of tests/test_torch_intersect.py's sphere
    hits."""
    _, ts = scenes[name]
    want, got = spatial(name)
    assert tuple(np.asarray(want.res)) == got.res
    off = _rows_off(ts, got.func.numpy(), np.asarray(want.func))
    assert off.mean() <= 0.01, f"{off.sum()} rows"
    for f in ("func", "cdf", "func_int"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        np.testing.assert_allclose(g[~off], w[~off], rtol=1e-6, atol=0,
                                   err_msg=f)
        np.testing.assert_allclose(g[off], w[off], rtol=2e-5, atol=0,
                                   err_msg=f)
    # every light is reachable from every voxel, and some voxel prefers
    # another light than the rest
    assert (got.func > 0).all()
    assert len(set(got.func.argmax(-1).tolist())) > 1


@pytest.mark.parametrize("name", ["two_lights", "area"])
def test_sample_spatial_matches_pbrt_tpu(scenes, spatial, name):
    """Seeded points inside and outside the bounds, seeded u."""
    js, ts = scenes[name]
    rng = np.random.default_rng(11)
    lo, hi = np.asarray(js.world_lo), np.asarray(js.world_hi)
    p = (lo + (hi - lo) * rng.uniform(-0.1, 1.1, (8192, 3))).astype(
        np.float32)
    u = rng.random(8192).astype(np.float32)
    jd, td = spatial(name)
    iw, pw = jld.sample_spatial(jd, js, jnp.asarray(p), jnp.asarray(u))
    ig, pg = tld.sample_spatial(td, ts, torch.as_tensor(p),
                                torch.as_tensor(u))
    np.testing.assert_array_equal(ig.numpy(), np.asarray(iw))
    # the pmf to rel 1e-6 where the voxel's row is (see above)
    off = _rows_off(ts, td.func.numpy(), np.asarray(jd.func))[
        tld.lookup_voxel(td, ts, torch.as_tensor(p)).numpy()]
    pg, pw = pg.numpy(), np.asarray(pw)
    np.testing.assert_allclose(pg[~off], pw[~off], rtol=1e-6)
    np.testing.assert_allclose(pg[off], pw[off], rtol=2e-5)


def _check_pass(got, want, name):
    assert got.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(got).all() and want.mean() > 0.01
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5).all(-1)
    assert bad.mean() <= 0.02, f"{name}: {bad.sum()} pixels differ"
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-4


@pytest.mark.parametrize("integrator", ["path", "volpath"])
def test_pass_under_spatial_matches_pbrt_tpu(scenes, spatial, integrator):
    """A 16² × 4-spp pass of the area scene with the spatial strategy,
    each package with its own table; `volpath` in a homogeneous camera
    medium."""
    js, _ = scenes["area"]
    jd, td = spatial("area")
    if integrator == "volpath":
        js = dataclasses.replace(js, media=(jmedia.make_homogeneous(
            (0.05, 0.06, 0.07), (0.2, 0.2, 0.2), 0.3),), camera_med=0)
        jd = jld.build_spatial_distribution(js)
    ts = bridge.scene_from_jax(js)
    if integrator == "volpath":
        td = tld.build_spatial_distribution(ts)
    cfg = dict(integrator=integrator, max_depth=5, seed=2,
               light_strategy="spatial")
    jc = area_camera()
    want = np.asarray(jrender.render_pass(
        js, jc, jfilm.make_filter("box"), jrender.RenderConfig(**cfg), RES,
        RES, SPP, jnp.asarray(0, jnp.uint32), jd))
    got = trender.render_pass(
        ts, bridge.camera_from_jax(jc), tfilm.make_filter("box"),
        trender.RenderConfig(**cfg), RES, RES, SPP, 0, "cpu",
        power_distr=td).numpy()
    _check_pass(got, want, integrator)


def test_voxels_prefer_their_light(scenes, spatial):
    """tests/test_lightdistrib.py: points beside a light choose it."""
    _, ts = scenes["two_lights"]
    _, d = spatial("two_lights")
    u = trng.uniform(torch.arange(1000), 0, 0)
    for x, want in ((-8.0, 0), (8.0, 1)):
        p = torch.tensor([[x, 0.1, 0.0]]).expand(1000, 3)
        idx, pmf = tld.sample_spatial(d, ts, p, u)
        assert (idx == want).float().mean() > 0.8
        assert float(pmf[idx == want].mean()) > 0.8


def test_spatial_and_uniform_agree_in_the_mean():
    """tests/test_lightdistrib.py: `direct`, 10² × 256 spp, seed 3, the
    two strategies within 5%."""
    b = SceneBuilder()
    fill_two_lights(b)
    scene = b.build("cpu")
    cam = bridge.camera_from_jax(two_light_camera())
    img = {s: trender.render(scene, cam, spp=256, integrator="direct",
                             light_strategy=s, seed=3, device="cpu")
           for s in ("uniform", "spatial")}
    assert float(img["uniform"].mean()) > 1e-3
    np.testing.assert_allclose(float(img["spatial"].mean()),
                               float(img["uniform"].mean()), rtol=0.05)


# ---------------------------------------------------------------------------
# MLT
# ---------------------------------------------------------------------------

def _mlt_cfgs():
    kw = dict(integrator="path", max_depth=MLT_DEPTH, seed=0)
    return jrender.RenderConfig(**kw), trender.RenderConfig(**kw)


@pytest.fixture(scope="module")
def mlt_case(scenes):
    js, ts = scenes["area"]
    jc = area_camera()
    return js, ts, jc, bridge.camera_from_jax(jc)


def _primary_samples(n, D, seed):
    return np.random.default_rng(seed).random((n, D)).astype(np.float32)


def test_mutate_within_two_ulps():
    """The step kind exact, a large step's uniforms bit-equal, and every
    mutated sample within 2 ulps of pbrt_tpu's at the scale of the
    primary sample space (2 ulps of 1.0f, 2.4e-7): torch's erfinv is
    within 64 ulps of XLA's (1.2% of the draws past 2), which the step's
    0.01 scale brings under the last bits of X + σ·g; a sample wrapped
    near 0 keeps the sum's absolute error."""
    X = _primary_samples(4096, tmlt._n_dims(MLT_DEPTH), 1)
    ids = np.arange(4096)
    for step in (0, 3):
        xw, lw = jmlt._mutate(jnp.asarray(X), step,
                              jnp.asarray(ids, jnp.uint32))
        xg, lg = tmlt._mutate(torch.as_tensor(X), step, torch.as_tensor(ids))
        lg, xg, xw = lg.numpy(), xg.numpy(), np.asarray(xw)
        np.testing.assert_array_equal(lg, np.asarray(lw))
        assert 0.2 < lg.mean() < 0.4
        np.testing.assert_array_equal(xg[lg], xw[lg])
        assert np.abs(xg - xw).max() <= 2 * np.spacing(np.float32(1.0))
        assert (xg == xw).mean() > 0.95


def _eval_both(mlt_case, X):
    js, ts, jc, tc = mlt_case
    cfg_j, cfg_t = _mlt_cfgs()
    want = [np.asarray(a) for a in jmlt._eval_target_jit(
        js, jc, jnp.asarray(X), cfg_j)]
    got = [a.numpy() for a in tmlt._eval_target(ts, tc, torch.as_tensor(X),
                                                cfg_t)]
    return got, want


def _lanes_off(got, want, rtol=2e-5, atol=1e-6):
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    return bad.reshape(bad.shape[0], -1).any(-1)


def test_eval_target_matches_pbrt_tpu(mlt_case):
    """Radiance, luminance and film position of 1,024 seeded primary
    sample vectors, lane for lane."""
    X = _primary_samples(N_CHAINS, tmlt._n_dims(MLT_DEPTH), 2)
    got, want = _eval_both(mlt_case, X)
    bad = np.zeros(N_CHAINS, bool)
    for g, w in zip(got, want):
        bad |= _lanes_off(g, w)
    assert (want[1] > 0).mean() > 0.3
    assert bad.mean() <= 0.02, f"{bad.sum()} lanes differ"


@contextlib.contextmanager
def captured_chains():
    """pbrt_tpu's render_mlt up to its chain phase: the start states, b
    and the step count it hands ``_mlt_chains``."""
    seen, real = {}, jmlt._mlt_chains

    def capture(scene, cam, X, b, seed, cfg, n_steps, width, height):
        seen.update(X=np.asarray(X), b=float(b), n_steps=n_steps)
        return jnp.zeros((height, width, scene.n_channels))
    jmlt._mlt_chains = capture
    try:
        yield seen
    finally:
        jmlt._mlt_chains = real


@pytest.fixture(scope="module")
def start(mlt_case):
    """Both packages' bootstrap and start states."""
    js, ts, jc, tc = mlt_case
    with captured_chains() as seen:
        jmlt.render_mlt(js, jc, mutations_per_pixel=16, n_chains=N_CHAINS,
                        n_bootstrap=N_BOOT, max_depth=MLT_DEPTH, seed=SEED)
    _, cfg_t = _mlt_cfgs()
    Xb, I_boot, b = tmlt.bootstrap(ts, tc, N_BOOT, tmlt._n_dims(MLT_DEPTH),
                                   SEED, cfg_t, torch.device("cpu"))
    X, idx = tmlt.start_states(Xb, I_boot, N_CHAINS, SEED)
    return seen, (X, idx, b)


def test_bootstrap_and_start_states_match_pbrt_tpu(start):
    """b to rel 1e-5; the start states equal (the bootstrap samples are
    bit-equal pcg4d, so an equal index gives an equal row)."""
    seen, (X, _, b) = start
    assert seen["n_steps"] == RES * RES * 16 // N_CHAINS
    assert b > 0
    assert abs(b - seen["b"]) / seen["b"] < 1e-5
    np.testing.assert_array_equal(X.numpy(), seen["X"])


def _port_chains(mlt_case, start, n_steps):
    """The port's ``_mlt_chains`` from pbrt_tpu's start states and b."""
    _, ts, _, tc = mlt_case
    seen, _ = start
    _, cfg_t = _mlt_cfgs()
    return tmlt._mlt_chains(
        ts, tc, torch.as_tensor(seen["X"].copy()),
        torch.tensor(seen["b"], dtype=torch.float32), SEED, cfg_t, n_steps,
        RES, RES).numpy()


def _port_states(mlt_case, start, n_steps, monkeypatch):
    """The chains' states after each of ``n_steps`` steps: step k + 1's
    ``_mutate`` reads the state step k left, so the chains run one step
    more and every call but the first is kept."""
    states, inner = [], tmlt._mutate

    def seen_mutate(X, *a):
        states.append(X.clone())
        return inner(X, *a)
    monkeypatch.setattr(tmlt, "_mutate", seen_mutate)
    _port_chains(mlt_case, start, n_steps + 1)
    return states[1:]


def test_one_chain_step_matches_pbrt_tpu(mlt_case, start):
    """pbrt_tpu's ``_mlt_chains`` at one step against the port's, from
    the same start states and b."""
    js, ts, jc, tc = mlt_case
    seen, _ = start
    cfg_j, _ = _mlt_cfgs()
    want = np.asarray(jmlt._mlt_chains(
        js, jc, jnp.asarray(seen["X"]), jnp.asarray(seen["b"], jnp.float32),
        jnp.asarray(SEED, jnp.uint32), cfg_j, 1, RES, RES))
    got = _port_chains(mlt_case, start, 1)
    # the pass bound: a sphere-seam lane moves its pixel
    _check_pass(got, want, "one step")


def test_four_chain_steps_and_diverged_chains(mlt_case, start, monkeypatch):
    """Four steps, pbrt_tpu's step run as ``_mlt_chains`` runs it (its
    ``_mutate``, its jitted ``_eval_target``, its acceptance draw and
    splat) and the port's chains: the chains whose states differ after
    each step are counted (a state off by more than the mutation's ulps).
    Found: none; the film then equal at the one-step bound."""
    js, _, jc, _ = mlt_case
    seen, _ = start
    cfg_j, _ = _mlt_cfgs()
    ids = jnp.arange(N_CHAINS, dtype=jnp.uint32)
    b = jnp.asarray(seen["b"], jnp.float32)
    X = jnp.asarray(seen["X"])
    L_cur, I_cur, p_cur = jmlt._eval_target_jit(js, jc, X, cfg_j)
    film = jnp.zeros((RES, RES, 3))
    want_states = []
    for step in range(4):
        X_prop, is_large = jmlt._mutate(X, step, ids)
        L_prop, I_prop, p_prop = jmlt._eval_target_jit(js, jc, X_prop, cfg_j)
        a = jnp.minimum(1.0, I_prop / jnp.maximum(I_cur, 1e-12))
        a = jnp.where(I_cur <= 0, 1.0, a)
        w_prop = (a + is_large.astype(jnp.float32)) \
            / jnp.maximum(I_prop / b + jmlt.P_LARGE, 1e-12)
        w_cur = (1.0 - a) / jnp.maximum(I_cur / b + jmlt.P_LARGE, 1e-12)
        film = jfilm.splat(film, p_prop, L_prop * w_prop[:, None], I_prop > 0)
        film = jfilm.splat(film, p_cur, L_cur * w_cur[:, None], I_cur > 0)
        accept = jrng.uniform(ids, step, 9992, jnp.uint32(SEED)) < a
        X = jnp.where(accept[:, None], X_prop, X)
        L_cur = jnp.where(accept[:, None], L_prop, L_cur)
        I_cur = jnp.where(accept, I_prop, I_cur)
        p_cur = jnp.where(accept[:, None], p_prop, p_cur)
        want_states.append(np.asarray(X))
    got = _port_chains(mlt_case, start, 4)
    states = _port_states(mlt_case, start, 4, monkeypatch)
    diverged = [int((~np.isclose(s.numpy(), w, rtol=0, atol=1e-6)
                     ).any(-1).sum()) for s, w in zip(states, want_states)]
    assert diverged == [0, 0, 0, 0], f"diverged chains by step: {diverged}"
    _check_pass(got, np.asarray(film), "four steps")


def reference_means():
    """pbrt_tpu's CPU mean of chip_smoke.py's spatial pass: the two-light
    scene, `path`, 256² × 32 spp, max_depth 4, the independent sampler,
    seed 0, the spatial strategy."""
    b = JaxBuilder(RGB)
    fill_two_lights(b)
    js = b.build()
    img = jrender.render(js, two_light_camera((SPATIAL_RES, SPATIAL_RES)),
                         spp=SPATIAL_SPP, integrator="path",
                         max_depth=SPATIAL_DEPTH, light_strategy="spatial")
    return {"spatial_two_lights": float(np.asarray(img, np.float64).mean())}


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins JAX to the CPU backend)
    for key, mean in reference_means().items():
        print(key, repr(mean))
