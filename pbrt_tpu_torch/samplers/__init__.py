"""Samplers (port of the independent and Halton samplers of
pbrt_tpu/samplers/__init__.py).

A sampler is a pure function ``u = sample(pixel_id, sample_idx, dim,
seed)``, so any lane can draw any dimension.

- ``independent``: the counter-based ``core.rng.uniform`` itself.
- ``halton`` with the image resolution: pbrt's HaltonSampler, a
  GlobalSampler (samplers/halton.cpp:64-127). One global Halton sequence
  tiles the image and pixel (x, y) owns the indices
  ``offset(x, y) + j·stride``; dims 0 and 1 are the offsets inside the
  pixel, every later dim is a scrambled radical inverse of the pixel's
  global index with a random digit permutation per dimension
  (ScrambledRadicalInverse, lowdiscrepancy.cpp:405-424).

pbrt_tpu evaluates a dimension in one of two float32 formulas that differ
in the last bits: a dim that is a Python int takes the unrolled static
formula (a fixed digit count, then the closed-form tail), and a dim traced
inside ``_li_loop``'s ``fori_loop`` takes the masked dynamic formula (it
stops at the index's last non-zero digit). Every dim here is a Python int,
so the sampler exposes both: ``sample`` is the static formula and
``sample.in_loop`` the dynamic one, which the generic loop calls for its
per-bounce dims, exactly where pbrt_tpu's dims are traced.

torch's uint32 lacks ``+`` and ``>>`` on the CPU, so the index arithmetic
runs in int64 masked to 32 bits, as ``core/rng.py`` does. The digit
permutations are drawn with numpy's ``RandomState`` as pbrt_tpu draws
them, cached per seed and uploaded once per device.

The stratified, Sobol', (0,2) and max-min-distance samplers raise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pbrt_tpu_torch.core import rng as rng_mod

ONE_MINUS_EPS = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
_M32 = 0xFFFFFFFF

_PRIMES = np.array([2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47,
                    53, 59, 61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107,
                    109, 113, 127, 131, 137, 139, 149, 151, 157, 163, 167,
                    173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
                    233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283,
                    293, 307, 311, 313, 317], np.int32)
_N_PRIMES = len(_PRIMES)
# digits needed so that base^digits >= 2^32
_MAX_DIGITS = np.ceil(32.0 / np.log2(_PRIMES.astype(np.float64))).astype(
    np.int32)
_KMAX_RESOLUTION = 128  # samplers/halton.cpp:41
_MAX_HALTON_DIMS = 256  # permutations repeat past this


def _perm_for_dim(dim: int, seed: int) -> np.ndarray:
    """Random digit permutation for prime(dim % 66), keyed by the
    dimension mod 256 and the seed (ComputeRadicalInversePermutations +
    PermutationForDimension, halton.h:70-75)."""
    dim = dim % _MAX_HALTON_DIMS
    base = int(_PRIMES[dim % _N_PRIMES])
    rs = np.random.RandomState((dim * 0x9E3779B9 + seed * 0x85EBCA6B)
                               & 0x7FFFFFFF)
    return rs.permutation(base).astype(np.int32)


_PERMS: dict = {}    # (dim % 256, seed) → permutation (numpy int32)
_DEVICE_PERMS: dict = {}  # (dim % 256, seed, device) → float32 tensor


def _perm(dim: int, seed: int) -> np.ndarray:
    key = (dim % _MAX_HALTON_DIMS, seed)
    if key not in _PERMS:
        _PERMS[key] = _perm_for_dim(dim, seed)
    return _PERMS[key]


def _perm_on(dim: int, seed: int, device) -> torch.Tensor:
    key = (dim % _MAX_HALTON_DIMS, seed, torch.device(device))
    if key not in _DEVICE_PERMS:
        _DEVICE_PERMS[key] = torch.as_tensor(
            _perm(dim, seed).astype(np.float32), device=device)
    return _DEVICE_PERMS[key]


def _radical_inverse_static(base: int, n_digits: int, a: torch.Tensor
                            ) -> torch.Tensor:
    """RadicalInverse in a fixed base, unrolled (lowdiscrepancy.cpp:426+).
    ``a``: int64 holding uint32 values."""
    inv_base = np.float32(1.0 / base)
    val = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_bn = np.float32(1.0)
    for _ in range(n_digits):
        nxt = a // base
        digit = a - nxt * base
        inv_bn = np.float32(inv_bn * inv_base)
        val = val + digit.to(torch.float32) * float(inv_bn)
        a = nxt
    return torch.clamp_max(val, ONE_MINUS_EPS)


def _scrambled_radical_inverse(dim: int, a: torch.Tensor, seed: int
                               ) -> torch.Tensor:
    """ScrambledRadicalInverse, static formula: permuted digits over the
    fixed digit count that covers 2^32, plus the closed-form tail of the
    infinitely many leading perm[0] digits (all in float32)."""
    base = int(_PRIMES[dim % _N_PRIMES])
    n_digits = int(_MAX_DIGITS[dim % _N_PRIMES])
    perm = _perm_on(dim, seed, a.device)
    inv_base = np.float32(1.0 / base)
    val = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_bn = np.float32(1.0)
    for _ in range(n_digits):
        nxt = a // base
        digit = a - nxt * base
        inv_bn = np.float32(inv_bn * inv_base)
        val = val + perm[digit] * float(inv_bn)
        a = nxt
    tail = (np.float32(_perm(dim, seed)[0]) * inv_bn * inv_base
            / (np.float32(1.0) - inv_base))
    return torch.clamp_max(val + float(tail), ONE_MINUS_EPS)


def _scrambled_radical_inverse_loop(dim: int, a: torch.Tensor, seed: int
                                    ) -> torch.Tensor:
    """ScrambledRadicalInverse, dynamic formula (pbrt_tpu's
    ``_scrambled_radical_inverse_dyn``): a digit counts only while the
    remaining index is non-zero, and the tail starts after the last
    non-zero digit. pbrt_tpu runs 32 masked steps; past the digit count
    that covers 2^32 every step is masked off, so this loop stops
    there. Unlike the static formula it takes the base, too, from the
    dim mod 256."""
    k = dim % _MAX_HALTON_DIMS % _N_PRIMES
    base = int(_PRIMES[k])
    perm = _perm_on(dim, seed, a.device)
    inv_base = float(np.float32(1.0) / np.float32(base))
    val = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_bn = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    for _ in range(int(_MAX_DIGITS[k])):
        nxt = a // base
        digit = a - nxt * base
        upd = a > 0
        inv_bn = torch.where(upd, inv_bn * inv_base, inv_bn)
        val = val + torch.where(upd, perm[digit] * inv_bn, 0.0)
        a = nxt
    tail = (float(_perm(dim, seed)[0]) * inv_bn * inv_base
            / float(np.float32(1.0) - np.float32(inv_base)))
    return torch.clamp_max(val + tail, ONE_MINUS_EPS)


def _reverse_digits(v: torch.Tensor, base: int, n_digits: int
                    ) -> torch.Tensor:
    """InverseRadicalInverse (lowdiscrepancy.h:83-92): mirror the
    n_digits base-``base`` digits of v (leading zeros included)."""
    out = torch.zeros_like(v)
    for _ in range(n_digits):
        nxt = v // base
        out = out * base + (v - nxt * base)
        v = nxt
    return out


def make_halton_global(resolution, spp: int = 16) -> Callable:
    """pbrt's HaltonSampler (samplers/halton.cpp:64-127): one global
    Halton sequence; pixel (x, y) owns indices offset(x, y) + j·stride."""
    bs, be = [], []
    for i, base in ((0, 2), (1, 3)):
        scale, exp = 1, 0
        while scale < min(int(resolution[i]), _KMAX_RESOLUTION):
            scale *= base
            exp += 1
        bs.append(scale)
        be.append(exp)
    stride = bs[0] * bs[1]
    # multiplicativeInverse (samplers/halton.cpp:45-62)
    minv = (pow(bs[1] % bs[0], -1, bs[0]) if bs[0] > 1 else 0,
            pow(bs[0] % bs[1], -1, bs[1]) if bs[1] > 1 else 0)
    coef = ((stride // bs[0]) * minv[0] % stride,
            (stride // bs[1]) * minv[1] % stride)
    width = int(resolution[0])

    def index_for(pid, sample_idx) -> torch.Tensor:
        """The pixel's global sequence index of its sample ``sample_idx``
        (GetIndexForSample), uint32 wrap-around included."""
        pid = rng_mod._u32(pid)
        px = pid % width
        py = pid // width
        dof_x = _reverse_digits(px % bs[0], 2, be[0])
        dof_y = _reverse_digits(py % bs[1], 3, be[1])
        off = (dof_x * coef[0] + dof_y * coef[1]) % stride
        return (off + rng_mod._u32(sample_idx, pid) * stride) & _M32

    def sample(pixel_id, sample_idx, dim, seed=0):
        dim, seed = int(dim), int(seed)
        idx = index_for(pixel_id, sample_idx)
        if dim == 0:
            return _radical_inverse_static(2, 32 - be[0], idx >> be[0])
        if dim == 1:
            return _radical_inverse_static(3, 21, idx // bs[1])
        return _scrambled_radical_inverse(dim, idx, seed)

    def in_loop(pixel_id, sample_idx, dim, seed=0):
        """A dim pbrt_tpu traces inside its bounce loop: always >= 2."""
        return _scrambled_radical_inverse_loop(
            int(dim), index_for(pixel_id, sample_idx), int(seed))

    sample.in_loop = in_loop
    sample.index_for = index_for
    sample.base_scales, sample.base_exponents = tuple(bs), tuple(be)
    sample.stride = stride
    return sample


def make_sampler(name: str, spp: int = 16, resolution=None) -> Callable:
    """Return sample(pixel_id, sample_idx, dim, seed) → float32 in [0,1).
    ``halton`` needs the image resolution (pbrt's pixel enumeration)."""
    name = name.lower()
    if name in ("independent", "random"):
        def sample(pixel_id, sample_idx, dim, seed=0):
            return rng_mod.uniform(pixel_id, sample_idx, dim, seed)
        return sample
    if name == "halton" and resolution is not None:
        return make_halton_global(resolution, spp)
    raise NotImplementedError(
        f"sampler {name!r}: ROADMAP queue 1 item 8 (only 'independent' and "
        "'halton' with the image resolution are ported)")
