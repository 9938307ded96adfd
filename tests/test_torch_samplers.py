"""The port's samplers against pbrt_tpu's, bit for bit.

pbrt_tpu has two float32 formulas for a dimension: the unrolled static one
for a dim that is a Python int (``sample``), and the masked dynamic one for
a dim traced inside its bounce loop (the port's ``sample.in_loop``). Both
are held here exactly: the static dims 0, 1, 2, 7, 33, 200 and 300 (past
the 256-dim wrap of the permutations) eagerly at 96², 128² and 37×23; the
loop dims through one ``jax.jit`` of the traced formula, as
tests/test_samplers.py runs it. The sample indices include values whose
global index wraps uint32, and ``index_for`` is compared as integers.

The other samplers (Sobol' with the resolution at 96² and 37×23, the
(0,2) sequence under its four names, Halton without the resolution and
``halton_cp``, stratified and max-min distance, each at spp 16, the
render's, and 64) on
seeded (pixel, sample, dim) triples, the sample indices past 2^16 and the
dims past 64 (Sobol's 128-dim table wraps at 300): the dims 0–3, 7, 64,
65, 130 and 300 with their static formulas in one jitted pbrt_tpu program
per sampler, and the dims from 2 up as its bounce loop traces them in
another; the port has one formula for both. (At a count that is not a
power of two, pbrt_tpu's own jitted stratified values part from its eager
ones in the last bit: XLA multiplies by the count's reciprocal there.)
Then one `path` pass (``render_pass``, 16² × 2 spp, max_depth 4) of
``_sphere_cornell`` with each sampler the render can take, pixel for
pixel against pbrt_tpu's jitted pass (rtol 1e-4 / atol 1e-5,
tests/test_torch_li_loop.py's pass rule) on all but 1% of the pixels:
the unscrambled Sobol' and (0,2) points fall on exact dyadic positions,
where a lane can meet the box's seam, and XLA's multiply-adds and the
port's rounded operations then pick different walls (found: one pixel of
256 with `sobol` and with `zerotwosequence`, none with the others).
Run as a script, the file writes pbrt_tpu's image means of the
full-width passes that chip_smoke.py's phase 21 renders
(tests/torch_sampler_means.json).
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pbrt_tpu import samplers as jsamplers
from pbrt_tpu.scene import film as jfilm
from pbrt_tpu_torch import bridge, entry
from pbrt_tpu_torch import samplers as tsamplers
from pbrt_tpu_torch.integrators import render as trender
from pbrt_tpu_torch.scene import film as tfilm
from test_torch_intersect import jax_scene

jrender = importlib.import_module("pbrt_tpu.integrators.render")

RESOLUTIONS = ((96, 96), (128, 128), (37, 23))
STATIC_DIMS = (0, 1, 2, 7, 33, 200, 300)
LOOP_DIMS = (6, 7, 15, 16, 26, 45, 55, 200, 300)


def _lanes(res, n=3000, seed=0):
    """Pixel ids and sample indices from a seed; the first 64 sample
    indices lie around and past the value whose index wraps uint32."""
    rs = np.random.RandomState(seed)
    stride = jsamplers.make_halton_global(res).stride
    pid = rs.randint(0, res[0] * res[1], n).astype(np.uint32)
    sidx = rs.randint(0, 300, n).astype(np.uint32)
    wrap = 2 ** 32 // stride
    sidx[:64] = rs.randint(wrap - 8, min(wrap + 100_000, 2 ** 32 - 1), 64)
    return pid, sidx


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_index_for_matches_jax(res):
    pid, sidx = _lanes(res)
    jsf, tsf = jsamplers.make_halton_global(res), \
        tsamplers.make_halton_global(res)
    assert (tsf.stride, tsf.base_scales, tsf.base_exponents) == \
        (jsf.stride, jsf.base_scales, jsf.base_exponents)
    ji = np.asarray(jsf.index_for(jnp.asarray(pid), jnp.asarray(sidx)))
    ti = tsf.index_for(_t(pid), _t(sidx)).numpy()
    assert np.array_equal(ji.astype(np.int64), ti)
    # the wrap-around is exercised: some indices are below their
    # sample's unwrapped value
    assert (ti[:64] < sidx[:64].astype(np.int64) * tsf.stride).any()


@pytest.mark.parametrize("res", RESOLUTIONS)
def test_static_dims_match_jax_bit_for_bit(res):
    pid, sidx = _lanes(res, seed=1)
    jsf, tsf = jsamplers.make_halton_global(res), \
        tsamplers.make_halton_global(res)
    for dim in STATIC_DIMS:
        for seed in (0, 2):
            a = np.asarray(jsf(jnp.asarray(pid), jnp.asarray(sidx), dim,
                               seed))
            b = tsf(_t(pid), _t(sidx), dim, seed).numpy()
            assert np.array_equal(a, b), (dim, seed)
            assert b.dtype == np.float32 and (b >= 0).all() and \
                (b < 1).all()


def test_loop_dims_match_traced_jax_bit_for_bit():
    """The dims of pbrt_tpu's bounce loop are traced: one jitted program
    of its dynamic formula against the port's ``in_loop``."""
    res = (96, 96)
    pid, sidx = _lanes(res, seed=2)
    jsf, tsf = jsamplers.make_halton_global(res), \
        tsamplers.make_halton_global(res)
    traced = jax.jit(lambda p, s, d: jsf(p, s, d, 2))
    for dim in LOOP_DIMS:
        a = np.asarray(traced(jnp.asarray(pid), jnp.asarray(sidx),
                              jnp.asarray(dim, jnp.int32)))
        b = tsf.in_loop(_t(pid), _t(sidx), dim, 2).numpy()
        assert np.array_equal(a, b), dim


def test_make_sampler_routes():
    sf = tsamplers.make_sampler("halton", resolution=(16, 8))
    assert sf.stride == 16 * 9 and hasattr(sf, "in_loop")
    ind = tsamplers.make_sampler("independent")
    assert not hasattr(ind, "in_loop")
    # without the resolution, halton is the Cranley–Patterson sampler
    assert tsamplers.make_sampler("halton") is tsamplers.make_sampler(
        "halton_cp")
    sob = tsamplers.make_sampler("sobol", resolution=(16, 8))
    assert sob.log2_resolution == 4 and not hasattr(sob, "in_loop")
    zt = tsamplers.make_sampler("sobol")
    assert all(tsamplers.make_sampler(n) is zt for n in (
        "zerotwosequence", "lowdiscrepancy", "02sequence"))
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamplers.make_sampler("pmj02bn")


# sampler groups: (name, resolution) pairs held together
SAMPLERS = {
    "sobol": (("sobol", (96, 96)), ("sobol", (37, 23))),
    "zerotwo": (("sobol", None), ("zerotwosequence", None),
                ("lowdiscrepancy", None), ("02sequence", None)),
    "halton_cp": (("halton", None), ("halton_cp", None)),
    "stratified": (("stratified", None),),
    "maxmindist": (("maxmindist", None),),
}
DIMS = (0, 1, 2, 3, 7, 64, 65, 130, 300)


def _triples(n=4096, seed=3):
    """Pixel ids of a 96² image and sample indices, a quarter of them
    past 2^16 (up to 2^31)."""
    rs = np.random.RandomState(seed)
    pid = rs.randint(0, 96 * 96, n).astype(np.uint32)
    sidx = rs.randint(0, 300, n).astype(np.uint32)
    sidx[: n // 4] = rs.randint(1 << 16, 1 << 31, n // 4)
    return pid, sidx


@pytest.mark.parametrize("group", sorted(SAMPLERS))
def test_other_samplers_match_jax_bit_for_bit(group):
    pid, sidx = _triples()
    jp, js_ = jnp.asarray(pid), jnp.asarray(sidx)
    tp, ts_ = _t(pid), _t(sidx)
    for name, res in SAMPLERS[group]:
        for spp in (16, 64):
            jsf = jsamplers.make_sampler(name, spp=spp, resolution=res)
            tsf = tsamplers.make_sampler(name, spp=spp, resolution=res)
            static = jax.jit(lambda p, s: jnp.stack(
                [jsf(p, s, d, seed) for d in DIMS for seed in (0, 3)]))
            want = np.asarray(static(jp, js_))
            got = [tsf(tp, ts_, d, seed).numpy() for d in DIMS
                   for seed in (0, 3)]
            for k, g in enumerate(got):
                assert g.dtype == np.float32 and np.array_equal(
                    g, want[k]), (name, res, spp, DIMS[k // 2])
                assert (g >= 0).all() and (g < 1).all()
            traced = jax.jit(lambda p, s, d: jsf(p, s, d, 2))
            for d in DIMS[2:]:
                want = np.asarray(traced(jp, js_, jnp.asarray(d, jnp.int32)))
                assert np.array_equal(tsf(tp, ts_, d, 2).numpy(), want), \
                    (name, res, spp, d)


# the samplers a render takes (it always passes the resolution, so
# `sobol` is the global sampler and `halton` pbrt's HaltonSampler)
PASS_SAMPLERS = ("sobol", "zerotwosequence", "halton_cp", "stratified",
                 "maxmindist")
PASS_RES, PASS_SPP = 16, 2


def _pass(ts, js, sampler, res, spp):
    """pbrt_tpu's jitted ``render_pass`` of ``js`` (or None) and the
    port's of ``ts``, `path` at max_depth 4."""
    want = None if js is None else np.asarray(jrender.render_pass(
        js, ge._camera((res, res)), jfilm.make_filter("box"),
        jrender.RenderConfig(integrator="path", sampler=sampler,
                             max_depth=4),
        res, res, spp, jnp.asarray(0, jnp.uint32)))
    got = None if ts is None else trender.render_pass(
        ts, entry._camera((res, res), "cpu"), tfilm.make_filter("box"),
        trender.RenderConfig(integrator="path", sampler=sampler,
                             max_depth=4), res, res, spp, 0, "cpu").numpy()
    return got, want


@pytest.fixture(scope="module")
def sphere_cornell():
    js = jax_scene(entry._fill_sphere_cornell)
    return js, bridge.scene_from_jax(js)


@pytest.mark.parametrize("sampler", PASS_SAMPLERS)
def test_pass_with_each_sampler_matches_jax(sphere_cornell, sampler):
    js, ts = sphere_cornell
    got, want = _pass(ts, js, sampler, PASS_RES, PASS_SPP)
    assert float(want.mean()) > 0.05
    off = (np.abs(got - want) > 1e-5 + 1e-4 * np.abs(want)).any(-1)
    assert off.sum() <= 0.01 * off.size, np.argwhere(off)


MEANS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_sampler_means.json")


def write_reference_means():
    """pbrt_tpu's float32 CPU image means (float64 sums) of the 256² ×
    4-spp `path` passes of ``_sphere_cornell`` that chip_smoke.py's phase
    21 renders with each sampler of PASS_SAMPLERS; run this file as a
    script from the root of the checkout, ``JAX_PLATFORMS=cpu
    PYTHONPATH=.:tests python tests/test_torch_samplers.py``."""
    js = jax_scene(entry._fill_sphere_cornell)
    means = {s: float(_pass(None, js, s, 256, 4)[1].astype(np.float64)
                      .mean()) for s in PASS_SAMPLERS}
    with open(MEANS_FILE, "w") as f:
        json.dump({"scene": "_sphere_cornell", "res": 256, "spp": 4,
                   "max_depth": 4, "means": means}, f, indent=1)
    return means


if __name__ == "__main__":
    import conftest  # noqa: F401  (pins JAX to the CPU backend)
    print(write_reference_means())
