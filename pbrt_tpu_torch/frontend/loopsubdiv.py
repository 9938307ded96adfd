"""Loop subdivision surfaces, host side in numpy (port of
pbrt_tpu/frontend/loopsubdiv.py; shapes/loopsubdiv.cpp): subdivide a
control mesh ``nlevels`` times with Loop's rules (pbrt's beta weights:
3/16 for valence 3, else 3/(8n); boundary rules 1/8-3/4-1/8) and emit a
triangle mesh. Like pbrt_tpu it does not project to the limit surface
and leaves the normals geometric.
"""

from __future__ import annotations

import numpy as np


def loop_subdivide(vertices: np.ndarray, indices: np.ndarray,
                   nlevels: int = 1):
    """vertices (V,3), indices (F,3) → (vertices', indices')."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(indices, np.int64).reshape(-1, 3)
    for _ in range(max(0, int(nlevels))):
        v, f = _subdivide_once(v, f)
    return v.astype(np.float32), f.astype(np.int32)


def _subdivide_once(v: np.ndarray, f: np.ndarray):
    nv = len(v)
    # --- edge table
    e_raw = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    e_sorted = np.sort(e_raw, axis=1)
    edges, inv = np.unique(e_sorted, axis=0, return_inverse=True)
    ne = len(edges)
    # opposite vertex for each face-edge slot
    opp = np.concatenate([f[:, 2], f[:, 0], f[:, 1]])

    # adjacency counts & opposite accumulation per unique edge
    cnt = np.bincount(inv, minlength=ne)
    opp_sum = np.zeros((ne, 3))
    np.add.at(opp_sum, inv, v[opp])
    boundary_e = cnt == 1

    # --- odd (edge) vertices
    mid = 0.5 * (v[edges[:, 0]] + v[edges[:, 1]])
    interior_pos = (3.0 / 8.0) * (v[edges[:, 0]] + v[edges[:, 1]]) \
        + (1.0 / 8.0) * opp_sum
    odd = np.where(boundary_e[:, None], mid, interior_pos)

    # --- even (original) vertices
    valence = np.bincount(edges.reshape(-1), minlength=nv)
    # neighbor sums over edges
    nb_sum = np.zeros((nv, 3))
    np.add.at(nb_sum, edges[:, 0], v[edges[:, 1]])
    np.add.at(nb_sum, edges[:, 1], v[edges[:, 0]])
    n = np.maximum(valence, 1)
    beta = np.where(n == 3, 3.0 / 16.0, 3.0 / (8.0 * n))
    even_int = (1.0 - n[:, None] * beta[:, None]) * v + beta[:, None] * nb_sum

    # boundary evens: 3/4 self + 1/8 each boundary neighbor
    b_nb_sum = np.zeros((nv, 3))
    b_nb_cnt = np.zeros(nv)
    be = edges[boundary_e]
    np.add.at(b_nb_sum, be[:, 0], v[be[:, 1]])
    np.add.at(b_nb_sum, be[:, 1], v[be[:, 0]])
    np.add.at(b_nb_cnt, be[:, 0], 1)
    np.add.at(b_nb_cnt, be[:, 1], 1)
    on_boundary = b_nb_cnt > 0
    even_bnd = 0.75 * v + 0.125 * b_nb_sum
    even = np.where(on_boundary[:, None], even_bnd, even_int)

    # --- new faces: v0-e01-e20, v1-e12-e01, v2-e20-e12, e01-e12-e20
    F = len(f)
    e01 = inv[0:F] + nv
    e12 = inv[F:2 * F] + nv
    e20 = inv[2 * F:3 * F] + nv
    new_f = np.concatenate([
        np.stack([f[:, 0], e01, e20], 1),
        np.stack([f[:, 1], e12, e01], 1),
        np.stack([f[:, 2], e20, e12], 1),
        np.stack([e01, e12, e20], 1)])
    return np.concatenate([even, odd]), new_f
