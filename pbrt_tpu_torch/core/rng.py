"""Counter-based RNG (port of pbrt_tpu/core/rng.py).

Every sample dimension is a pure hash of ``(pixel_id, sample_index,
dimension, seed)`` — pcg4d (Jarzynski & Olano, JCGT 2020) — so the port
draws bit-for-bit the same streams as the JAX package and needs no
``torch.Generator``.

torch's uint32 lacks ``+`` and ``>>`` on the CPU, so the hash runs in
int64 masked to the low 32 bits after every step. The low 32 bits of an
int64 product are exact even when the product wraps.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223


def _u32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    device = like.device if like is not None else None
    return torch.as_tensor(int(x) & _M32, dtype=torch.int64, device=device)


def pcg4d(a, b, c, d):
    """4-in/4-out mixing hash on uint32 values held in int64 tensors
    (broadcastable). Returns four int64 tensors in [0, 2³²)."""
    like = next((x for x in (a, b, c, d) if isinstance(x, torch.Tensor)),
                None)
    v0, v1, v2, v3 = (_u32(x, like) for x in (a, b, c, d))
    v0 = (v0 * _MUL + _INC) & _M32
    v1 = (v1 * _MUL + _INC) & _M32
    v2 = (v2 * _MUL + _INC) & _M32
    v3 = (v3 * _MUL + _INC) & _M32
    v0 = (v0 + v1 * v3) & _M32
    v1 = (v1 + v2 * v0) & _M32
    v2 = (v2 + v0 * v1) & _M32
    v3 = (v3 + v1 * v2) & _M32
    v0 = v0 ^ (v0 >> 16)
    v1 = v1 ^ (v1 >> 16)
    v2 = v2 ^ (v2 >> 16)
    v3 = v3 ^ (v3 >> 16)
    v0 = (v0 + v1 * v3) & _M32
    v1 = (v1 + v2 * v0) & _M32
    v2 = (v2 + v0 * v1) & _M32
    v3 = (v3 + v1 * v2) & _M32
    return v0, v1, v2, v3


def hash_u32(a, b=0, c=0, d=0) -> torch.Tensor:
    """One uint32 hash (int64 in [0, 2³²)) of up to four uint32 inputs,
    broadcast to ``a``'s shape (pbrt_tpu's ``hash_u32``)."""
    a = _u32(a)
    return pcg4d(a, *(_u32(x, a).expand(a.shape) for x in (b, c, d)))[0]


def u32_to_uniform(u: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in [0, 1): top 24 bits / 2²⁴, exactly as
    pbrt_tpu's ``u32_to_uniform``. Every stream depends on this form."""
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _counters(pixel_id, sample_idx, dim, seed):
    pid = _u32(pixel_id)
    shape = pid.shape
    return [pid] + [_u32(x, pid).expand(shape)
                    for x in (sample_idx, dim, seed)]


def uniform(pixel_id, sample_idx, dim, seed=0) -> torch.Tensor:
    """One uniform float per element (Sampler::Get1D analogue)."""
    return u32_to_uniform(pcg4d(*_counters(pixel_id, sample_idx, dim,
                                           seed))[0])


def uniform2(pixel_id, sample_idx, dim, seed=0):
    """Two uniforms from two hash outputs (Sampler::Get2D analogue)."""
    out = pcg4d(*_counters(pixel_id, sample_idx, dim, seed))
    return u32_to_uniform(out[0]), u32_to_uniform(out[1])
