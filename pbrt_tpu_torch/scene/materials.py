"""Material table: the matte rows the fused path admits (a subset of
pbrt_tpu/scene/materials.py MaterialTable).

A row carries ``type`` (0 = matte), ``kd`` (C channels) and ``sigma``
(Oren–Nayar roughness, degrees). Every other material type and
parameter belongs to the generic loop and raises here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MATTE = 0
ROW_KEYS = frozenset({"type", "kd", "sigma"})


@dataclasses.dataclass
class MaterialTable:
    mtype: torch.Tensor   # (M,) int32
    kd: torch.Tensor      # (M,C) diffuse reflectance
    sigma: torch.Tensor   # (M,) Oren–Nayar sigma (degrees)


def check_row(row: dict) -> None:
    extra = set(row) - ROW_KEYS
    if extra or int(row.get("type", MATTE)) != MATTE:
        raise NotImplementedError(
            f"material {row.get('type', MATTE)} with {sorted(extra)}: only "
            "matte rows (type, kd, sigma) are ported; the rest is ROADMAP "
            "queue 1 items 5 and 8")


def make_material_table(rows: list[dict], n_channels: int,
                        device="cpu") -> MaterialTable:
    """Host-side builder from parameter dicts (defaults as pbrt_tpu's)."""
    for r in rows:
        check_row(r)
    kd = np.array(
        [np.broadcast_to(np.asarray(r.get("kd", 0.5), np.float32),
                         (n_channels,)) for r in rows]
        or [np.full(n_channels, 0.5, np.float32)], np.float32)
    return MaterialTable(
        mtype=torch.tensor([int(r.get("type", MATTE)) for r in rows]
                           or [MATTE], dtype=torch.int32, device=device),
        kd=torch.as_tensor(kd, device=device),
        sigma=torch.as_tensor(np.array([r.get("sigma", 0.0) for r in rows]
                                       or [0.0], np.float32),
                              device=device))
