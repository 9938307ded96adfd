"""Host-side tessellators for parametric shapes (port of
pbrt_tpu/scene/tessellate.py; numpy only): the quadrics cylinder, cone,
paraboloid and hyperboloid as surfaces of revolution, the heightfield,
the curve ribbon (``tessellate_curve``, which the parser does not call:
curves are intersected analytically, scene/shapes.py) and the NURBS
surface.

Every curved shape tessellates to triangles at scene-build time (as pbrt
itself does for heightfield.cpp:60-89), so the device-side intersection
stays one ray–triangle test. All functions return (vertices (V,3), indices
(F,3), normals (V,3)|None) in object space; callers apply the transform.
"""

from __future__ import annotations

import numpy as np


def _grid_mesh(nu: int, nv: int, wrap_u=False):
    """Index grid for an (nu+1)×(nv+1) vertex lattice."""
    faces = []
    for i in range(nu):
        i1 = (i + 1) % (nu + 1) if wrap_u and i + 1 == nu + 1 else i + 1
        for j in range(nv):
            a = i * (nv + 1) + j
            b = i1 * (nv + 1) + j
            faces.append((a, b, b + 1))
            faces.append((a, b + 1, a + 1))
    return np.asarray(faces, np.int32)


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


def tessellate_cylinder(radius=1.0, zmin=-1.0, zmax=1.0, phi_max=2 * np.pi,
                        n_phi=64, n_z=8):
    """shapes/cylinder.cpp: x²+y²=r², zmin≤z≤zmax, φ≤phiMax."""
    zs = np.linspace(zmin, zmax, n_z + 1)
    return _revolve([radius] * (n_z + 1), zs, phi_max, n_phi)


def tessellate_cone(radius=1.0, height=1.0, phi_max=2 * np.pi,
                    n_phi=64, n_z=8):
    """shapes/cone.cpp: apex at z=height, base radius at z=0."""
    zs = np.linspace(0.0, height, n_z + 1)
    rs = radius * (1.0 - zs / height)
    return _revolve(rs, zs, phi_max, n_phi)


def tessellate_paraboloid(radius=1.0, zmin=0.0, zmax=1.0,
                          phi_max=2 * np.pi, n_phi=64, n_z=12):
    """shapes/paraboloid.cpp: z = zmax·(x²+y²)/r²."""
    zs = np.linspace(max(zmin, 1e-6), zmax, n_z + 1)
    rs = radius * np.sqrt(zs / zmax)
    return _revolve(rs, zs, phi_max, n_phi)


def tessellate_hyperboloid(p1=(1.0, 0.0, 0.0), p2=(1.0, 0.0, 1.0),
                           phi_max=2 * np.pi, n_phi=64, n_z=12):
    """shapes/hyperboloid.cpp: sweep of the line p1→p2 around z."""
    p1 = np.asarray(p1, np.float64)
    p2 = np.asarray(p2, np.float64)
    ts = np.linspace(0.0, 1.0, n_z + 1)
    pts = p1[None] * (1 - ts[:, None]) + p2[None] * ts[:, None]
    rs = np.hypot(pts[:, 0], pts[:, 1])
    zs = pts[:, 2]
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


def _bezier_point(cp, u):
    """Cubic Bézier evaluation; cp (4,3)."""
    u1 = 1.0 - u
    return (u1 ** 3 * cp[0] + 3 * u1 ** 2 * u * cp[1]
            + 3 * u1 * u ** 2 * cp[2] + u ** 3 * cp[3])


def _bezier_tangent(cp, u):
    u1 = 1.0 - u
    return 3 * (u1 ** 2 * (cp[1] - cp[0]) + 2 * u1 * u * (cp[2] - cp[1])
                + u ** 2 * (cp[3] - cp[2]))


def tessellate_curve(cp, width0: float, width1: float, n_seg: int = 16):
    """shapes/curve.cpp's flat ribbon as triangles: a cubic Bézier segment
    → a strip whose side vector is parallel-transported along the curve.
    Returns (vertices, faces, uvs): u along the curve, v across the width
    (the hair's h = 2v − 1)."""
    cp = np.asarray(cp, np.float64).reshape(4, 3)
    us = np.linspace(0.0, 1.0, n_seg + 1)
    pts = np.stack([_bezier_point(cp, u) for u in us])
    tans = np.stack([_bezier_tangent(cp, u) for u in us])
    tans /= np.maximum(np.linalg.norm(tans, axis=-1, keepdims=True), 1e-12)
    side = np.cross(tans[0], [0.0, 0.0, 1.0])
    if np.linalg.norm(side) < 1e-6:
        side = np.cross(tans[0], [0.0, 1.0, 0.0])
    side /= np.linalg.norm(side)
    verts = []
    for k, u in enumerate(us):
        side = side - tans[k] * np.dot(side, tans[k])
        side /= max(np.linalg.norm(side), 1e-12)
        w = 0.5 * ((1 - u) * width0 + u * width1)
        verts.append(pts[k] - side * w)
        verts.append(pts[k] + side * w)
    faces = []
    for k in range(n_seg):
        a = 2 * k
        faces += [(a, a + 2, a + 3), (a, a + 3, a + 1)]
    uvs = np.zeros((2 * (n_seg + 1), 2), np.float32)
    uvs[0::2, 0] = us
    uvs[1::2, 0] = us
    uvs[1::2, 1] = 1.0
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            uvs)


def _nurbs_basis(i, k, t, knots):
    """Cox–de Boor recursion (nurbs.cpp)."""
    if k == 0:
        return 1.0 if knots[i] <= t < knots[i + 1] else 0.0
    out = 0.0
    d1 = knots[i + k] - knots[i]
    if d1 > 1e-12:
        out += (t - knots[i]) / d1 * _nurbs_basis(i, k - 1, t, knots)
    d2 = knots[i + k + 1] - knots[i + 1]
    if d2 > 1e-12:
        out += (knots[i + k + 1] - t) / d2 * _nurbs_basis(i + 1, k - 1, t,
                                                         knots)
    return out


def tessellate_nurbs(nu, uorder, uknots, nv, vorder, vknots, P,
                     n_tess_u=24, n_tess_v=24):
    """shapes/nurbs.cpp: evaluate the NURBS surface on a regular lattice.
    P: (nu*nv, 3) or (nu*nv, 4) homogeneous control points."""
    P = np.asarray(P, np.float64)
    homog = P.shape[-1] == 4
    P = P.reshape(nv, nu, -1) if P.shape[0] == nu * nv else P
    uknots = np.asarray(uknots, np.float64)
    vknots = np.asarray(vknots, np.float64)
    u0, u1 = uknots[uorder - 1], uknots[nu]
    v0, v1 = vknots[vorder - 1], vknots[nv]
    us = np.linspace(u0, u1 - 1e-6, n_tess_u + 1)
    vs = np.linspace(v0, v1 - 1e-6, n_tess_v + 1)
    verts = np.zeros(((n_tess_u + 1) * (n_tess_v + 1), 3), np.float32)
    idx = 0
    for u in us:
        bu = np.asarray([_nurbs_basis(i, uorder - 1, u, uknots)
                         for i in range(nu)])
        for v in vs:
            bv = np.asarray([_nurbs_basis(j, vorder - 1, v, vknots)
                             for j in range(nv)])
            w = np.outer(bv, bu)[..., None]
            pt = (w * P).sum((0, 1))
            if homog:
                pt = pt[:3] / max(pt[3], 1e-12)
            verts[idx] = pt[:3]
            idx += 1
    faces = _grid_mesh(n_tess_u, n_tess_v)
    return verts, faces, None
