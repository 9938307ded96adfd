"""Light table: diffuse area lights with portals (the fields of
pbrt_tpu/scene/lights.py LightTable that the fused path reads).

``build_light_table`` follows pbrt_tpu's (lights.py:102-230) for area
rows. Point, spot, distant, infinite, goniometric and projection lights
come with the generic loop and raise here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# portal strategies (lights/portal_arealight.h:12)
STRAT_LIGHT = 0
STRAT_PORTAL = 1
STRAT_PROJECTION = 2
_STRATEGIES = {"light": STRAT_LIGHT, "portal": STRAT_PORTAL,
               "projection": STRAT_PROJECTION}

MAXP = 4  # hard cap on portals per light, as in pbrt_tpu


@dataclasses.dataclass
class LightTable:
    emit: torch.Tensor           # (L,C) radiance
    prim_id: torch.Tensor        # (L,) the area light's global prim
    two_sided: torch.Tensor      # (L,) bool
    strategy: torch.Tensor       # (L,) int32
    n_portals: torch.Tensor      # (L,) int32
    portal_lo: torch.Tensor      # (L,P,3)
    portal_hi: torch.Tensor      # (L,P,3)
    portal_ax: torch.Tensor      # (L,P) int32
    portal_facing: torch.Tensor  # (L,P) bool


def build_light_table(builder, device="cpu") -> LightTable:
    """builder.light_rows (dicts) → LightTable. Row keys: type ('area'),
    L (spectrum), scale, prim (global id or (family, local) pair),
    two_sided, strategy, portals=[(lo, hi, ax, facing), ...]."""
    rows = builder.light_rows
    C = builder.n_channels
    n = max(1, len(rows))
    emit = np.zeros((n, C), np.float32)
    prim_id = np.full(n, -1, np.int32)
    two_sided = np.zeros(n, bool)
    strategy = np.zeros(n, np.int32)
    n_portals = np.zeros(n, np.int32)
    maxp = max([1] + [min(len(r.get("portals", [])), MAXP) for r in rows])
    p_lo = np.zeros((n, maxp, 3), np.float32)
    p_hi = np.zeros((n, maxp, 3), np.float32)
    p_ax = np.full((n, maxp), 2, np.int32)
    p_fw = np.zeros((n, maxp), bool)
    for i, r in enumerate(rows):
        if r.get("type", "point") != "area":
            raise NotImplementedError(
                f"light type {r.get('type', 'point')!r}: ROADMAP queue 1 "
                "item 5 (only area lights are ported)")
        e = np.asarray(r.get("L", np.ones(C)), np.float32)
        sc = np.asarray(r.get("scale", np.ones(C)), np.float32)
        emit[i] = np.broadcast_to(e * sc, (C,))
        pr = r.get("prim", -1)
        prim_id[i] = builder.prim_index(*pr) if isinstance(pr, tuple) \
            else int(pr)
        two_sided[i] = bool(r.get("two_sided", False))
        strategy[i] = _STRATEGIES[r.get("strategy", "light")]
        portals = r.get("portals", [])
        n_portals[i] = len(portals)
        for j, (plo, phi, pax, pfw) in enumerate(portals[:maxp]):
            p_lo[i, j] = plo
            p_hi[i, j] = phi
            p_ax[i, j] = pax
            p_fw[i, j] = pfw

    def t(a):
        return torch.as_tensor(a, device=device)

    return LightTable(
        emit=t(emit),
        prim_id=t(prim_id), two_sided=t(two_sided), strategy=t(strategy),
        n_portals=t(n_portals), portal_lo=t(p_lo), portal_hi=t(p_hi),
        portal_ax=t(p_ax), portal_facing=t(p_fw))
