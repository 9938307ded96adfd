"""Samplers (port of pbrt_tpu/samplers/__init__.py).

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
- ``sobol`` with the resolution: pbrt's SobolSampler, the global Sobol'
  sequence over a power-of-two square covering the image (the pixel's
  index from a GF(2) system solved per resolution on the host, in place
  of SobolIntervalToIndex's tables); dims 0 and 1 rescaled into the pixel.
- ``halton`` without the resolution (and ``halton_cp``): a radical
  inverse in prime(dim) with a per-(pixel, dim) Cranley–Patterson
  rotation.
- ``stratified``: jittered strata over the sample index, their order
  permuted per (pixel, dim) by a hash.
- ``maxmindist``: the first pair from the CMaxMinDist generator matrices
  (x_i = i/2^k, y_i = C·i over GF(2)) in a per-pixel shuffled order, every
  later dim from the (0,2) pair (samplers/maxmin.cpp's split).
- ``sobol`` without the resolution, ``zerotwosequence``,
  ``lowdiscrepancy``, ``02sequence``: the Owen-scrambled (0,2) pair of
  Sobol' dims 0 and 1, the scramble keyed per (pixel, pair of dims).

``stratified`` and ``maxmindist`` take the sampler's ``spp``; the render
builds every sampler with the default 16, as pbrt_tpu's does. The Sobol'
and max-min generator matrices are this package's copies of pbrt_tpu's
tables (``sobolmatrices.py``, ``maxmindist.py``).

pbrt_tpu evaluates a dimension in one of two float32 formulas that differ
in the last bits: a dim that is a Python int takes the unrolled static
formula (a fixed digit count, then the closed-form tail), and a dim traced
inside ``_li_loop``'s ``fori_loop`` takes the masked dynamic formula (it
stops at the index's last non-zero digit). Every dim here is a Python int,
so the sampler exposes both: ``sample`` is the static formula and
``sample.in_loop`` the dynamic one, which the generic loop calls for its
per-bounce dims, exactly where pbrt_tpu's dims are traced.

torch's uint32 lacks ``+`` and ``>>`` on the CPU, so the index and bit
arithmetic runs in int64 masked to 32 bits, as ``core/rng.py`` does (the
low 32 bits of a product are exact even when the int64 wraps). The digit
permutations are drawn with numpy's ``RandomState`` as pbrt_tpu draws
them, cached per seed and uploaded once per device. A division by a
count divides by a tensor: a CUDA division by a Python scalar multiplies
by its reciprocal, which would part the card's values from the CPU's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from pbrt_tpu_torch.core import rng as rng_mod
from pbrt_tpu_torch.samplers.maxmindist import CMAXMIN
from pbrt_tpu_torch.samplers.sobolmatrices import N_SOBOL_DIMS, SOBOL_MATRICES

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


def _sobol_matrices():
    """The generator matrices of Sobol' dims 0 and 1, the (0,2)-sequence
    pair: the identity (van der Corput) and Pascal's triangle mod 2."""
    m0 = [1 << (31 - i) for i in range(32)]
    m1, v = [], 1 << 31
    for _ in range(32):
        m1.append(v)
        v ^= v >> 1
    return m0, m1


_SM0, _SM1 = _sobol_matrices()


def _sobol_bits(a, cols) -> torch.Tensor:
    """The GF(2) product of a 32-column generator matrix and the index
    bits (SobolSampleFloat, lowdiscrepancy.h:259-267); a: int64 uint32
    values."""
    acc = torch.zeros_like(a)
    for i in range(32):
        c = int(cols[i])
        if c:
            acc = acc ^ (((a >> i) & 1) * c)
    return acc


def _reverse_bits(v):
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & _M32


def _owen_hash_scramble(bits, seed):
    """Laine–Karras hash-based Owen scrambling on the reversed bits."""
    v = (_reverse_bits(bits) + seed) & _M32
    for k in (0x6c50b47c, 0xb82f1e52, 0xc7afe638, 0x8d22f6e6):
        v = v ^ ((v * k) & _M32)
    return _reverse_bits(v)


def _div(x, k):
    """x / k as a tensor division (see the module's docstring)."""
    return x / torch.tensor(float(k), dtype=x.dtype, device=x.device)


def _lane_u32(v, pid):
    """A uint32 value (a Python int or a tensor) broadcast over the
    lanes of ``pid``."""
    return rng_mod._u32(v, pid).expand(pid.shape)


def make_sobol_global(resolution, spp: int = 16) -> Callable:
    """pbrt's SobolSampler (samplers/sobol.cpp, SobolIntervalToIndex of
    lowdiscrepancy.h:229-249): the global Sobol' sequence over the
    power-of-two square that covers the image; the global index of
    (pixel, sample) solves a GF(2) system in the index's low 2m bits,
    solved here per resolution by Gaussian elimination on the host. Valid
    while spp << 2^(32−2m); dims 0 and 1 are rescaled into the pixel."""
    width, height = int(resolution[0]), int(resolution[1])
    res, m = 1, 0
    while res < max(width, height):
        res *= 2
        m += 1
    m2 = 2 * m
    if m2 > 26:
        raise ValueError("sobol global sampler supports images up to 8192px")
    c0, c1 = SOBOL_MATRICES[0], SOBOL_MATRICES[1]

    def out_bits(j):   # the pixel bits index bit j sets, packed in 2m bits
        return (((int(c0[j]) >> (32 - m)) << m)
                | (int(c1[j]) >> (32 - m))) if m else 0

    n_frame_bits = min(32 - m2, 24)
    frame_cols = [out_bits(m2 + c) for c in range(n_frame_bits)]
    basis = [out_bits(j) for j in range(m2)]
    inv = [1 << j for j in range(m2)]   # index bits behind each column
    for bit in range(m2):
        piv = next((k for k in range(bit, m2) if (basis[k] >> bit) & 1),
                   None)
        if piv is None:
            raise ValueError("Sobol pixel matrix singular (bad matrices)")
        basis[bit], basis[piv] = basis[piv], basis[bit]
        inv[bit], inv[piv] = inv[piv], inv[bit]
        for k in range(m2):
            if k != bit and (basis[k] >> bit) & 1:
                basis[k] ^= basis[bit]
                inv[k] ^= inv[bit]
    # basis[k] is now 1 << k, and inv[k] the index bits that set pixel bit k

    def index_for(pid, sample_idx) -> torch.Tensor:
        pid = rng_mod._u32(pid)
        f = _lane_u32(sample_idx, pid)
        if m == 0:
            return f
        target = ((pid % width) << m) | (pid // width)
        for c in range(n_frame_bits):
            if frame_cols[c]:
                target = target ^ (((f >> c) & 1) * frame_cols[c])
        low = torch.zeros_like(target)
        for k in range(m2):
            if inv[k]:
                low = low ^ (((target >> k) & 1) * inv[k])
        return ((f << m2) | low) & _M32

    def sample(pixel_id, sample_idx, dim, seed=0):
        dim = int(dim)
        s = rng_mod.u32_to_uniform(_sobol_bits(
            index_for(pixel_id, sample_idx),
            SOBOL_MATRICES[dim % N_SOBOL_DIMS]))
        if dim < 2 and m > 0:
            pid = rng_mod._u32(pixel_id)
            pix = pid % width if dim == 0 else pid // width
            s = torch.clamp(s * res - pix.to(torch.float32), 0.0,
                            ONE_MINUS_EPS)
        return s

    sample.index_for = index_for
    sample.log2_resolution = m
    return sample


def radical_inverse(base_idx: torch.Tensor, a: torch.Tensor
                    ) -> torch.Tensor:
    """RadicalInverse (lowdiscrepancy.h:78-96) of a in base
    prime[base_idx] per lane, 21 digits: base_idx (R,) integer, a (R,)
    integers holding uint32 values. Each step is ``_radical_inverse``'s
    fused multiply-add."""
    primes = torch.as_tensor(_PRIMES.astype(np.int64), device=a.device)
    base = primes[base_idx.long().clamp(0, _N_PRIMES - 1)]
    inv_base = 1.0 / base.to(torch.float32)
    a = a.long() & 0xFFFFFFFF
    rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_bn = inv_base
    for _ in range(21):
        nxt = a // base
        rev = (rev.double() + (a - nxt * base).double() * inv_bn.double()
               ).float()
        inv_bn = inv_bn * inv_base
        a = nxt
    return torch.clamp_max(rev, ONE_MINUS_EPS)


def _radical_inverse(dim: int, a):
    """RadicalInverse (lowdiscrepancy.h:78-96) in base prime(dim % 66),
    21 digits: the Cranley–Patterson sampler's formula. pbrt_tpu's loop
    body contracts ``rev + digit·inv_bn`` into one fused multiply-add, so
    each step here is exact in float64 and rounded once to float32."""
    base = int(_PRIMES[dim % _N_PRIMES])
    inv_base = np.float32(1.0) / np.float32(base)
    rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    inv_bn = inv_base
    for _ in range(21):
        nxt = a // base
        rev = (rev.double() + (a - nxt * base).double() * float(inv_bn)
               ).float()
        inv_bn = np.float32(inv_bn * inv_base)
        a = nxt
    return torch.clamp_max(rev, ONE_MINUS_EPS)


def _halton_cp(pixel_id, sample_idx, dim, seed=0):
    """Halton with a per-(pixel, dim) Cranley–Patterson rotation."""
    dim = int(dim)
    pid = rng_mod._u32(pixel_id)
    ri = _radical_inverse(dim, _lane_u32(sample_idx, pid))
    rot = rng_mod.uniform(pid, 0, dim, seed ^ 0x9e3779b9)
    return torch.fmod(ri + rot, 1.0)


def _zerotwo(pixel_id, sample_idx, dim, seed=0):
    """The Owen-scrambled (0,2) pair: Sobol' dim 0 for even dims, dim 1
    for odd ones, the scramble keyed per (pixel, dim // 2) (the role of
    pbrt's per-pair Shuffle, samplers/zerotwosequence.cpp)."""
    dim = int(dim)
    pid = rng_mod._u32(pixel_id)
    bits = _sobol_bits(_lane_u32(sample_idx, pid), _SM1 if dim & 1
                       else _SM0)
    sseed = rng_mod.hash_u32(pid, dim >> 1, seed, 29)
    return rng_mod.u32_to_uniform(_owen_hash_scramble(bits, sseed))


def _make_stratified(spp: int):
    def sample(pixel_id, sample_idx, dim, seed=0):
        """Jittered strata over the sample index, their order permuted
        per (pixel, dim) (samplers/stratified.cpp)."""
        pid = rng_mod._u32(pixel_id)
        j = rng_mod.uniform(pid, sample_idx, dim, seed ^ 0x5bf03635)
        perm = rng_mod.hash_u32(pid, dim, seed, 17)
        idx = ((_lane_u32(sample_idx, pid) + perm) & _M32) % spp
        return _div(idx.to(torch.float32) + j, spp)
    return sample


def _make_maxmindist(spp: int):
    """MaxMinDistSampler (samplers/maxmin.{h,cpp}): the first pair is the
    max-min-distance set x_i = i/2^k, y_i = CMaxMinDist[k]·i over GF(2)
    (k = ⌈log2 spp⌉), its order shuffled per pixel by an invertible mix of
    the low k index bits (StartPixel's Shuffle); every later dim is the
    (0,2) pair's."""
    k = max(0, min(16, (max(int(spp), 1) - 1).bit_length()))
    n = 1 << k
    mask = n - 1
    cpix = CMAXMIN[k]

    def shuffle(idx, pid, seed):
        if k == 0:
            return torch.zeros_like(idx)
        key = rng_mod.hash_u32(pid, seed, 0x6d2d, 11)
        i = ((idx & mask) ^ key) & mask
        i = (i * (0x9E3779B9 | 1)) & mask
        i = i ^ (i >> max(1, k // 2))
        i = (i ^ (key >> 16)) & mask
        return (i * (0x85EBCA6B | 1)) & mask

    def sample(pixel_id, sample_idx, dim, seed=0):
        dim = int(dim)
        if dim >= 2:
            return _zerotwo(pixel_id, sample_idx, dim, seed)
        pid = rng_mod._u32(pixel_id)
        i = shuffle(_lane_u32(sample_idx, pid), pid, seed)
        if dim == 0:
            return torch.clamp_max(_div(i.to(torch.float32), n),
                                   ONE_MINUS_EPS)
        return rng_mod.u32_to_uniform(_sobol_bits(i, cpix))
    return sample


def make_sampler(name: str, spp: int = 16, resolution=None) -> Callable:
    """Return sample(pixel_id, sample_idx, dim, seed) → float32 in [0,1).
    With ``resolution=(width, height)``, ``halton`` and ``sobol`` are
    pbrt's global samplers; an unknown name raises ValueError."""
    name = name.lower()
    if name == "halton" and resolution is not None:
        return make_halton_global(resolution, spp)
    if name == "sobol" and resolution is not None:
        return make_sobol_global(resolution, spp)
    if name in ("independent", "random"):
        def sample(pixel_id, sample_idx, dim, seed=0):
            return rng_mod.uniform(pixel_id, sample_idx, dim, seed)
        return sample
    if name == "stratified":
        return _make_stratified(spp)
    if name in ("halton", "halton_cp"):
        return _halton_cp
    if name == "maxmindist":
        return _make_maxmindist(spp)
    if name in ("sobol", "zerotwosequence", "lowdiscrepancy", "02sequence"):
        return _zerotwo
    raise ValueError(f"unknown sampler {name!r}")
