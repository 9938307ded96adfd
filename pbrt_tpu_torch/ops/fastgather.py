"""Row gathers for small per-lane tables (port of
pbrt_tpu/ops/fastgather.py).

pbrt_tpu gathers the rows of small tables (material rows, filter tables,
a hit primitive's rows) by an unrolled select chain (at most
``MAX_SELECT`` rows) or a one-hot product (at most ``MAX_ONEHOT``),
because on the TPU an indexed gather stages its indices through scalar
memory. The card has no such hazard, so every forward here is one
``index_select`` or ``gather``, equal bit for bit to ``table[clip(idx)]``
as pbrt_tpu's are. What matters here is the backward.

Advanced indexing's backward is ``index_put_(accumulate=True)``, which on
the card folds millions of lanes into a few rows serially (torch's
``indexing_backward_kernel``). A table of at most ``MAX_SELECT`` rows
gets pbrt_tpu's select chain's VJP instead (``_GatherRows``): one masked
sum over the lanes a row, deterministic, and on an H100 faster than
``index_add_``, whose atomics pile onto a few words. A larger table gets
``index_select``'s own backward, ``index_add_``, which there beats the
transpose of pbrt_tpu's one-hot product by an order of magnitude
(chip_smoke.py phase 22 (c) times all three; PERF.md). So pbrt_tpu's
one-hot window (``MAX_ONEHOT``, ``ONEHOT_BUDGET_BYTES``) selects no path
here; the names stay pbrt_tpu's.
"""

from __future__ import annotations

import dataclasses

import torch

# pbrt_tpu's largest table for a one-hot product
MAX_ONEHOT = 512
# up to this row count pbrt_tpu gathers by an unrolled select chain, and
# the port's backward is that chain's
MAX_SELECT = 32
# pbrt_tpu's peak bytes of a one-hot intermediate
ONEHOT_BUDGET_BYTES = 128 << 20


class _GatherRows(torch.autograd.Function):
    """table[idx] for an in-range (R,) index of a table of ≤ MAX_SELECT
    rows; the backward sums g over the lanes of each row (the select
    chain's VJP). g (R, ...) → (n, ...)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        return torch.index_select(table, 0, idx)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = g.reshape(g.shape[0], -1)
        rows = [torch.where((idx == j)[:, None], flat, 0.0).sum(0)
                for j in range(ctx.n)]
        return torch.stack(rows).reshape((ctx.n,) + g.shape[1:]), None


def _take(table, idx):
    """Rows ``idx`` (clipped, any shape) of ``table``."""
    if idx.ndim != 1:
        return torch.index_select(table, 0, idx.reshape(-1)).reshape(
            idx.shape + table.shape[1:])
    if table.requires_grad and table.shape[0] <= MAX_SELECT:
        return _GatherRows.apply(table, idx)
    return torch.index_select(table, 0, idx)


def gather_rows(table, idx):
    """``table[idx]`` along the first axis, idx clipped into range."""
    return _take(table, idx.clamp(0, table.shape[0] - 1))


def make_row_gather(n: int, idx):
    """g(a) gathering rows idx (clipped once) from any (n, ...) array."""
    idx = idx.clamp(0, n - 1)
    return lambda a: _take(a, idx)


def gather_tree(tree, idx, n: int):
    """Rows idx of every (n, ...) tensor in a tree of dataclasses, dicts,
    lists and tuples; other leaves pass through unchanged."""
    g = make_row_gather(n, idx)

    def walk(x):
        if isinstance(x, torch.Tensor):
            return g(x) if x.ndim >= 1 and x.shape[0] == n else x
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: walk(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(map(walk, x))
        return x
    return walk(tree)


def select_component(v, ax):
    """v[..., ax] for a per-element axis index ax in [0, C) (every
    caller's range; pbrt_tpu's one-hot dot gives 0 outside it)."""
    return torch.gather(v, -1, ax.long().unsqueeze(-1)).squeeze(-1)


def select_row(v, idx):
    """v[r, idx[r]] for v (R, M, ...) and idx (R,) in [0, M)."""
    at = idx.long().reshape((-1, 1) + (1,) * (v.ndim - 2))
    return torch.gather(v, 1, at.expand((v.shape[0], 1) + v.shape[2:])
                        ).squeeze(1)


def select_along_last(v, idx):
    """take_along_axis(v, idx[..., None], -1)[..., 0]."""
    return select_component(v, idx)
