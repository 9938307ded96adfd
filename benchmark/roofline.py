"""The least time the card could take for a kernel's work, and the
published peaks it is measured against.

Copied from chip_smoke.py (``PEAK_*``, ``OPS_*``, ``bound_ms``,
``fused_bound``), with one change of source: the fused kernel's sweeps
are counted from the benchmark's reference (its live lanes a bounce),
not from the residual codes the program writes, so a change to the
program cannot move its own yardstick.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: device memory rate, and float32 rate
# outside the tensor cores (a multiply-add counts as two operations)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# float operations of one ray-triangle test (Möller–Trumbore: multiplies,
# adds, subtracts, the division; compares and selects not counted) and of
# one ray-aaplane test
OPS_TRI, OPS_PLN = 46, 8


def bound_ms(n_bytes: float, n_ops: float):
    """(ms, "bytes" | "operations"): the larger of the two bounds."""
    t_b, t_o = n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_FP32_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def fused_counts(n_rays: int, n_tri: int, live, mode: int = 1):
    """(bytes, operations) of one launch of the fused bounce kernel over
    ``n_rays`` lanes, ``live[b]`` of them alive entering bounce b.

    A live lane sweeps every triangle and the light's plane once for its
    closest hit and, but on the emission-only last bounce, once (mode 1,
    the portal projection) or twice (mode 0) more for next-event
    estimation. Bytes: each ray read once (o, d: 24 B; pixel and sample
    ids: 8 B), each bounce's residuals written once (code, knee, kc:
    12 B), the triangle table (64 B a row) read once."""
    n_b = len(live)
    per = [2 if mode == 1 else 3] * (n_b - 1) + [1]
    sweeps = sum(int(c) * p for c, p in zip(live, per))
    n_ops = sweeps * (OPS_TRI * n_tri + OPS_PLN)
    n_bytes = n_rays * (24 + 8 + 12 * n_b) + 64 * n_tri
    return n_bytes, n_ops
