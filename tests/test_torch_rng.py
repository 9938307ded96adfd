"""The port's counter-based RNG against pbrt_tpu's: exact bits.

Every sample stream of the renderer is pcg4d of (pixel, sample index,
dimension, seed), so the port must reproduce the JAX package's uint32
outputs and uniforms bit for bit, including counters near 2³²−1 where
int64 emulation of uint32 arithmetic would first go wrong.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu_torch.core import rng as trng


def _counters(n=100_000, seed=7):
    rs = np.random.default_rng(seed)
    c = rs.integers(0, 2**32, size=(4, n), dtype=np.uint64)
    # a slice of counters at the top of the range and at zero
    c[:, :1000] = 2**32 - 1 - rs.integers(0, 64, size=(4, 1000))
    c[:, 1000:1100] = rs.integers(0, 3, size=(4, 100))
    return c.astype(np.uint32)


def test_pcg4d_bits_match_jax():
    c = _counters()
    want = jrng.pcg4d(*(jnp.asarray(x) for x in c))
    got = trng.pcg4d(*(torch.as_tensor(x.astype(np.int64)) for x in c))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))
        assert int(g.min()) >= 0 and int(g.max()) < 2**32


@pytest.mark.parametrize("fn", ["uniform", "uniform2"])
def test_uniform_bits_match_jax(fn):
    pid, sidx, dim, seed = _counters(seed=11)
    want = getattr(jrng, fn)(jnp.asarray(pid), jnp.asarray(sidx),
                             jnp.asarray(dim), jnp.asarray(seed))
    got = getattr(trng, fn)(torch.as_tensor(pid.astype(np.int64)),
                            torch.as_tensor(sidx.astype(np.int64)),
                            torch.as_tensor(dim.astype(np.int64)),
                            torch.as_tensor(seed.astype(np.int64)))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))
        assert float(g.max()) < 1.0 and float(g.min()) >= 0.0


def test_uniform_scalar_counters_broadcast():
    """Sample index, dimension and seed given as Python ints broadcast
    over the pixel ids, as the renderer calls it."""
    pid = np.arange(4096, dtype=np.uint32) * 977
    want = np.asarray(jrng.uniform(jnp.asarray(pid), 3, 17, 5))
    got = trng.uniform(torch.as_tensor(pid.astype(np.int64)), 3, 17, 5)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
