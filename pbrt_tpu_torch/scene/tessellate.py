"""Host-side tessellators for parametric shapes (the port's copy of the
part of pbrt_tpu/scene/tessellate.py its scenes use: the heightfield and
the cone, a quadric of revolution; numpy only).

Every curved shape tessellates to triangles at scene-build time (as pbrt
itself does for heightfield.cpp:60-89), so the device-side intersection
stays one ray–triangle test. All functions return (vertices (V,3), indices
(F,3), normals (V,3)|None) in object space; callers apply the transform.
"""

from __future__ import annotations

import numpy as np


def _revolve(profile_r, profile_z, phi_max, n_phi):
    """Surface of revolution: per-row radius/height arrays."""
    n_z = len(profile_r)
    phis = np.linspace(0.0, phi_max, n_phi + 1)
    verts = []
    norms = []
    dr = np.gradient(np.asarray(profile_r, np.float64))
    dz = np.gradient(np.asarray(profile_z, np.float64))
    for i, phi in enumerate(phis):
        c, s = np.cos(phi), np.sin(phi)
        for k in range(n_z):
            r, z = profile_r[k], profile_z[k]
            verts.append((r * c, r * s, z))
            # normal of revolution surface: (dz, -dr) profile normal
            nr, nz = dz[k], -dr[k]
            ln = max(np.hypot(nr, nz), 1e-12)
            norms.append((nr / ln * c, nr / ln * s, nz / ln))
    verts = np.asarray(verts, np.float32)
    norms = np.asarray(norms, np.float32)
    faces = []
    for i in range(n_phi):
        for k in range(n_z - 1):
            a = i * n_z + k
            b = (i + 1) * n_z + k
            faces.append((a, b, b + 1))
            faces.append((a, b + 1, a + 1))
    return verts, np.asarray(faces, np.int32), norms


def tessellate_cone(radius=1.0, height=1.0, phi_max=2 * np.pi,
                    n_phi=64, n_z=8):
    """shapes/cone.cpp: apex at z=height, base radius at z=0."""
    zs = np.linspace(0.0, height, n_z + 1)
    rs = radius * (1.0 - zs / height)
    return _revolve(rs, zs, phi_max, n_phi)


def tessellate_heightfield(nx: int, ny: int, z: np.ndarray):
    """shapes/heightfield.cpp:60-89: (nx×ny) z-grid over [0,1]²."""
    z = np.asarray(z, np.float32).reshape(ny, nx)
    xs = np.linspace(0.0, 1.0, nx)
    ys = np.linspace(0.0, 1.0, ny)
    X, Y = np.meshgrid(xs, ys)
    verts = np.stack([X, Y, z], -1).reshape(-1, 3).astype(np.float32)
    faces = []
    for j in range(ny - 1):
        for i in range(nx - 1):
            a = j * nx + i
            b = a + nx
            faces.append((a, a + 1, b + 1))
            faces.append((a, b + 1, b))
    return verts, np.asarray(faces, np.int32), None
