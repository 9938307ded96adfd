"""The numbers that decide ``correct``, each against the limit the
configuration's file gives it (``limits``), and how they are printed.

- ``image_rel_l1``: for each image in a sample drawn from the seed of
  those the window finished, sum |program − reference| over sum
  |reference|, at the image's own seed; the worst of the sample.
- ``loss_gap``: for each of the training steps the reference follows,
  |loss_program − loss_reference| / loss_reference; the worst step.
- ``grad_gap``: for each parameter leaf, the gap between the norm of the
  program's first gradient (worked out from its parameters before and
  after the first step: (p0 − p1) / lr) and the norm of the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf; the worst leaf.
- ``change_gap``: the same of the parameters' change over the compared
  steps (p_n − p0).

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of both leaf gaps (they move by round-off alone).
"""

from __future__ import annotations

import math
import statistics
import sys

import torch


def rel_l1(prog: torch.Tensor, ref: torch.Tensor) -> float:
    p, r = prog.detach().double(), ref.detach().double()
    if p.shape != r.shape:
        return math.inf
    return float((p - r).abs().sum() / r.abs().sum())


def loss_gap(prog, ref) -> float:
    if len(prog) != len(ref):
        return math.inf
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def _norms(leaves: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in leaves.items()}


def kept_leaves(ref_grad: dict) -> list[str]:
    n = _norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k in sorted(n) if n[k] >= 1e-3 * med]


def leaf_gap(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| over max(‖ref‖, median ‖ref‖)."""
    if set(prog) != set(ref):
        return math.inf
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn[k] for k in keep)
    return max(abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep)


def checks(values: dict, limits: dict) -> dict:
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in values.items()}


def is_correct(chk: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in chk.values())


def print_checks(chk: dict, file=sys.stderr) -> None:
    for k, c in chk.items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r}) {ok}",
              file=file)
