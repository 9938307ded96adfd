"""The port's Halton sampler against pbrt_tpu's ``make_halton_global``,
bit for bit.

pbrt_tpu has two float32 formulas for a dimension: the unrolled static one
for a dim that is a Python int (``sample``), and the masked dynamic one for
a dim traced inside its bounce loop (the port's ``sample.in_loop``). Both
are held here exactly: the static dims 0, 1, 2, 7, 33, 200 and 300 (past
the 256-dim wrap of the permutations) eagerly at 96², 128² and 37×23; the
loop dims through one ``jax.jit`` of the traced formula, as
tests/test_samplers.py runs it. The sample indices include values whose
global index wraps uint32, and ``index_for`` is compared as integers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu import samplers as jsamplers
from pbrt_tpu_torch import samplers as tsamplers

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
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        tsamplers.make_sampler("halton")       # no resolution
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        tsamplers.make_sampler("sobol", resolution=(16, 8))
