"""Hit records, per-ray (paired) shape tests and area sampling (port of
the triangle, sphere, aaplane and disk parts of pbrt_tpu/scene/shapes.py).

The render path never runs an all-pairs test of triangles, spheres or
aaplanes: the brute-force closest hit over the whole scene is the kernel
of ops/intersect.py (and its plain-torch twin), and BVH and kd scenes
walk their trees. The routines here work on ONE primitive per ray,
gathered beforehand (light sampling, Pdf_Li and the portal samplers);
pbrt_tpu's all-pairs ``intersect_triangles / _spheres / _aaplanes`` are
those paired tests broadcast over (ray, primitive) pairs, for callers
outside the render path. The all-pairs disk test is the one the render
path runs, outside the kernel, as pbrt_tpu does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (uniform_cone_pdf,
                                          uniform_sample_cone,
                                          uniform_sample_sphere,
                                          uniform_sample_triangle)
from pbrt_tpu_torch.core.vecmath import (absdot, cross, length_squared,
                                         normalize, take_axis)
from pbrt_tpu_torch.ops import fastgather

BIG = 1e30


@dataclasses.dataclass
class Hit:
    """Batched hit records (SurfaceInteraction's SoA analogue)."""
    valid: torch.Tensor    # (R,) bool
    t: torch.Tensor        # (R,)
    p: torch.Tensor        # (R,3)
    ng: torch.Tensor       # (R,3) geometric normal
    ns: torch.Tensor       # (R,3) shading normal
    uv: torch.Tensor       # (R,2)
    prim_id: torch.Tensor  # (R,) int64 global primitive index (−1 = miss)
    dpdu: Optional[torch.Tensor] = None  # (R,3) ∂p/∂u, unnormalized
    dpdv: Optional[torch.Tensor] = None  # (R,3)


# ---------------------------------------------------------------------------
# Triangles (shapes/triangle.cpp)
# ---------------------------------------------------------------------------

def intersect_triangle_paired(o, d, tmax, v0, v1, v2):
    """Per-ray ray×triangle test (one triangle per ray; all args (R,...)).
    Möller–Trumbore, both sides. Returns (t, u, v, hit): each (R,)."""
    e1 = v1 - v0
    e2 = v2 - v0
    ro = o - v0
    pvec = cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    u = torch.sum(ro * pvec, dim=-1) * inv_det
    qvec = cross(ro, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
           & (t < tmax))
    return t, u, v, hit


def intersect_triangles(o, d, tmax, v0, v1, v2):
    """All-pairs ray×triangle test: o, d (R,3), tmax (R,); v0..v2 (T,3),
    or (R,T,3) per ray (motion-blurred vertices at each ray's time).
    Returns (t, u, v, hit): each (R,T)."""
    V0, V1, V2 = (v if v.ndim == 3 else v[None] for v in (v0, v1, v2))
    return intersect_triangle_paired(o[:, None], d[:, None], tmax[:, None],
                                     V0, V1, V2)


def triangle_normal(v0, v1, v2):
    return normalize(cross(v1 - v0, v2 - v0))


def triangle_area(v0, v1, v2):
    return 0.5 * vecmath.length(cross(v1 - v0, v2 - v0))


def sample_triangle(v0, v1, v2, u):
    """Uniform area sampling (triangle.cpp Triangle::Sample). Returns
    (p, n, 1/area)."""
    b = uniform_sample_triangle(u)
    p = (b[..., 0:1] * v0 + b[..., 1:2] * v1
         + (1.0 - b[..., 0:1] - b[..., 1:2]) * v2)
    n = triangle_normal(v0, v1, v2)
    area = triangle_area(v0, v1, v2)
    return p, n, 1.0 / torch.clamp_min(area, 1e-20)


# ---------------------------------------------------------------------------
# Spheres (shapes/sphere.cpp): world-space center + radius
# ---------------------------------------------------------------------------

def intersect_sphere_paired(o, d, tmax, center, radius):
    """Per-ray ray×sphere (one sphere per ray), stable quadratic of
    sphere.cpp:141-150. Returns (t, hit): (R,)."""
    oc = o - center
    a = torch.sum(d * d, dim=-1)
    b = 2.0 * torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = vecmath.safe_sqrt(disc)
    q = -0.5 * (b + torch.sign(b) * sq)
    q = torch.where(b == 0.0, -0.5 * sq, q)
    t0 = q / torch.clamp_min(a, 1e-20)
    t1 = c / torch.where(q.abs() > 1e-20, q, 1e-20)
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t = torch.where(tn > 1e-4, tn, tf)
    hit = ok & (t > 1e-4) & (t < tmax)
    return t, hit


def intersect_spheres(o, d, tmax, center, radius):
    """All-pairs ray×sphere: o, d (R,3), tmax (R,); center (S,3), radius
    (S,). Returns (t, hit): (R,S)."""
    return intersect_sphere_paired(o[:, None], d[:, None], tmax[:, None],
                                   center[None], radius[None])


def sphere_normal_uv(p, center, radius):
    n = normalize(p - center)
    phi = vecmath.spherical_phi(n)
    theta = vecmath.spherical_theta(n)
    uv = torch.stack([phi * (0.5 / math.pi), theta / math.pi], dim=-1)
    return n, uv


def sample_sphere_from_ref(center, radius, ref_p, u):
    """Cone sampling toward the sphere from a reference point (sphere.cpp
    Sphere::Sample(ref,u), the solid-angle strategy); uniform-area
    sampling when ref is inside. center (R,3), radius (R,). Returns
    (p, n, pdf_solid_angle)."""
    dc = center - ref_p
    dist2 = length_squared(dc)
    r2 = radius * radius
    inside = dist2 <= r2 * (1.0 + 1e-4)

    # outside: sample the cone of directions subtending the sphere
    dist = torch.sqrt(torch.clamp_min(dist2, 1e-20))
    sin_theta_max2 = torch.clamp(r2 / dist2, 0.0, 1.0)
    cos_theta_max = vecmath.safe_sqrt(1.0 - sin_theta_max2)
    wc = normalize(dc)
    wcx, wcy = vecmath.coordinate_system(wc)
    dir_local = uniform_sample_cone(u, cos_theta_max)
    w = (dir_local[..., 0:1] * wcx + dir_local[..., 1:2] * wcy
         + dir_local[..., 2:3] * wc)
    cos_theta = dir_local[..., 2]
    ds = (dist * cos_theta
          - vecmath.safe_sqrt(
              r2 - dist2 * (1.0 - cos_theta * cos_theta)))
    p_out = ref_p + ds[..., None] * w
    n_out = normalize(p_out - center)
    pdf_out = uniform_cone_pdf(cos_theta_max)

    # inside: uniform area sampling, pdf converted to solid angle
    d_sph = uniform_sample_sphere(u)
    p_in = center + radius[..., None] * d_sph
    n_in = d_sph
    wi = p_in - ref_p
    d2 = length_squared(wi)
    wi = normalize(wi)
    area = 4.0 * math.pi * r2
    pdf_in = d2 / torch.clamp_min(absdot(n_in, -wi) * area, 1e-12)

    p = torch.where(inside[..., None], p_in, p_out)
    n = torch.where(inside[..., None], n_in, n_out)
    pdf = torch.where(inside, pdf_in, pdf_out)
    return p, n, pdf


def sphere_pdf_wi(center, radius, ref_p, wi):
    """Solid-angle pdf of sample_sphere_from_ref for direction wi (0 when
    wi misses the sphere)."""
    dc = center - ref_p
    dist2 = length_squared(dc)
    r2 = radius * radius
    inside = dist2 <= r2 * (1.0 + 1e-4)
    sin_theta_max2 = torch.clamp(r2 / torch.clamp_min(dist2, 1e-20), 0.0, 1.0)
    cos_theta_max = vecmath.safe_sqrt(1.0 - sin_theta_max2)
    pdf_cone = uniform_cone_pdf(cos_theta_max)
    t, hit = intersect_sphere_paired(ref_p, wi, torch.full_like(radius, BIG),
                                     center, radius)
    p = ref_p + t[..., None] * wi
    n = normalize(p - center)
    area = 4.0 * math.pi * r2
    pdf_area = (t * t) / torch.clamp_min(absdot(n, -wi) * area, 1e-12)
    pdf = torch.where(inside, pdf_area, pdf_cone)
    return torch.where(hit, pdf, 0.0)


# ---------------------------------------------------------------------------
# AAPlane (shapes/plane.cpp:15-115)
# ---------------------------------------------------------------------------

def _axis_onehot(ax):
    return torch.nn.functional.one_hot(ax.long(), 3).to(torch.float32)


def aaplane_axes(ax):
    """(ax0, ax1) per plane.cpp's ctor: ax0 = {z:0, x:1, y:2}[axis],
    ax1 = {z:1, x:2, y:0}[axis]."""
    ax0 = torch.where(ax == 2, 0, torch.where(ax == 0, 1, 2))
    ax1 = torch.where(ax == 2, 1, torch.where(ax == 0, 2, 0))
    return ax0, ax1


def aaplane_normal(ax, facing_fw):
    """plane.cpp:95-104 Normal(): +axis, negated when not facing forward."""
    n = _axis_onehot(ax)
    return torch.where(facing_fw[..., None], n, -n)


def aaplane_area(lo, hi, ax):
    ax0, ax1 = aaplane_axes(ax)
    d = hi - lo
    return take_axis(d, ax0) * take_axis(d, ax1)


def intersect_aaplane_paired(o, d, tmax, lo, hi, ax):
    """Per-ray ray×aaplane test (one plane per ray; all args (R,...)).
    Returns (t, u, v, hit): each (R,)."""
    d_ax = take_axis(d, ax)
    o_ax = take_axis(o, ax)
    lo_ax = take_axis(lo, ax)
    ok = d_ax.abs() > 1e-12
    t = (lo_ax - o_ax) / torch.where(ok, d_ax, 1e-12)
    p = o + t[..., None] * d
    ax0, ax1 = aaplane_axes(ax)
    p0, p1 = take_axis(p, ax0), take_axis(p, ax1)
    lo0, lo1 = take_axis(lo, ax0), take_axis(lo, ax1)
    hi0, hi1 = take_axis(hi, ax0), take_axis(hi, ax1)
    u = (p0 - lo0) / torch.clamp_min(hi0 - lo0, 1e-12)
    v = (p1 - lo1) / torch.clamp_min(hi1 - lo1, 1e-12)
    hit = (ok & (t > 1e-4) & (t < tmax)
           & (p0 > lo0) & (p0 < hi0) & (p1 > lo1) & (p1 < hi1))
    return t, u, v, hit


def intersect_aaplanes(o, d, tmax, lo, hi, ax):
    """All-pairs ray×axis-aligned rectangle (plane.cpp:15-55): o, d
    (R,3), tmax (R,); lo, hi (P,3), ax (P,). Returns (t, u, v, hit):
    each (R,P)."""
    R, P = o.shape[0], lo.shape[0]
    return intersect_aaplane_paired(
        o[:, None].expand(R, P, 3), d[:, None].expand(R, P, 3),
        tmax[:, None], lo[None].expand(R, P, 3), hi[None].expand(R, P, 3),
        ax[None].expand(R, P))


def aaplane_corners(lo, hi, ax):
    """V0..V3 (plane.cpp:85-107): V0 = lo, V2 = hi, V1 = lo with the ax1
    coordinate of hi, V3 = lo with the ax0 coordinate of hi."""
    ax0, ax1 = aaplane_axes(ax)
    c = take_axis(lo, ax)
    v1 = axis_point(ax, ax0, ax1, c, take_axis(lo, ax0), take_axis(hi, ax1))
    v3 = axis_point(ax, ax0, ax1, c, take_axis(hi, ax0), take_axis(lo, ax1))
    return lo, v1, hi, v3


def axis_point(ax, ax0, ax1, c, c0, c1):
    """The point whose coordinate on axis ax is c, on ax0 c0, on ax1 c1."""
    return (_axis_onehot(ax) * c[..., None] + _axis_onehot(ax0) * c0[..., None]
            + _axis_onehot(ax1) * c1[..., None])


def sample_aaplane(lo, hi, ax, facing_fw, u):
    """Uniform area sampling (plane.cpp:57-78 Sample). lo, hi (...,3);
    u (...,2). Returns (p, n, area_pdf)."""
    ax0, ax1 = aaplane_axes(ax)
    lo0, lo1 = take_axis(lo, ax0), take_axis(lo, ax1)
    p = axis_point(ax, ax0, ax1, take_axis(lo, ax),
                   lo0 + (take_axis(hi, ax0) - lo0) * u[..., 0],
                   lo1 + (take_axis(hi, ax1) - lo1) * u[..., 1])
    n = aaplane_normal(ax, facing_fw)
    pdf = 1.0 / torch.clamp_min(aaplane_area(lo, hi, ax), 1e-20)
    return p, n, pdf


def aaplane_in_front(p, lo, ax, facing_fw):
    """plane.cpp:109-115 InFront half-space test; batched over p."""
    p_ax = take_axis(p, ax)
    lo_ax = take_axis(lo, ax)
    return torch.where(facing_fw, p_ax > lo_ax, p_ax < lo_ax)


# ---------------------------------------------------------------------------
# Disks (shapes/disk.cpp): world-space center, unit normal, radii
# ---------------------------------------------------------------------------

def intersect_disks(o, d, tmax, center, normal, radius, inner_radius):
    """All-pairs ray×disk. o, d: (R,3); tmax: (R,); center, normal: (D,3);
    radius, inner_radius: (D,). Returns (t, hit): (R,D)."""
    denom = torch.sum(d[:, None, :] * normal[None], dim=-1)
    ok = denom.abs() > 1e-12
    t = torch.sum((center[None] - o[:, None, :]) * normal[None], dim=-1) \
        / torch.where(ok, denom, 1e-12)
    p = o[:, None, :] + t[..., None] * d[:, None, :]
    r2 = torch.sum((p - center[None]) ** 2, dim=-1)
    hit = (ok & (t > 1e-4) & (t < tmax[:, None])
           & (r2 <= (radius * radius)[None])
           & (r2 >= (inner_radius * inner_radius)[None]))
    return t, hit


# ---------------------------------------------------------------------------
# Cubic Bézier curves (shapes/curve.cpp): analytic span test
# ---------------------------------------------------------------------------

CURVE_SEGMENTS = 32   # pbrt recurses to maxDepth ≈ 5 and runs the same
                      # linear-segment leaf test on each of 2^depth spans
                      # (curve.cpp:147-163); pbrt_tpu scans 32 fixed spans
CURVE_TILE_ELEMS = 1 << 24   # the (R, tile) tensors of one tile at most


def bezier_point(cp, u):
    """Cubic Bézier evaluation; cp (...,4,3), u (...)."""
    u = u[..., None]
    u1 = 1.0 - u
    return (u1 ** 3 * cp[..., 0, :] + 3 * u1 ** 2 * u * cp[..., 1, :]
            + 3 * u1 * u ** 2 * cp[..., 2, :] + u ** 3 * cp[..., 3, :])


def bezier_tangent(cp, u):
    u = u[..., None]
    u1 = 1.0 - u
    return 3.0 * (u1 ** 2 * (cp[..., 1, :] - cp[..., 0, :])
                  + 2 * u1 * u * (cp[..., 2, :] - cp[..., 1, :])
                  + u ** 2 * (cp[..., 3, :] - cp[..., 2, :]))


def _ray_frame(d):
    """Ray-space frame: z along the normalized direction (the LookAt
    objectToRay of curve.cpp:93-104)."""
    dn = normalize(d)
    e1, e2 = vecmath.coordinate_system(dn)
    return dn, e1, e2


def curve_slerp_normal(n, u):
    """A ribbon's orientation normal at u: the spherical lerp between its
    u = 0 and u = 1 normals (curve.cpp:44-58, :169). n (...,2,3); u
    broadcastable to n[..., 0, 0]. Returns (...,3), not normalized."""
    n0 = n[..., 0, :]
    n1 = n[..., 1, :]
    ang = torch.acos(torch.clamp(torch.sum(n0 * n1, -1), -1.0, 1.0))
    sinang = torch.sin(ang)
    safe = sinang > 1e-4
    inv = torch.clamp_min(sinang, 1e-9)
    s0 = torch.where(safe, torch.sin((1.0 - u) * ang) / inv, 1.0 - u)
    s1 = torch.where(safe, torch.sin(u * ang) / inv, u)
    return s0[..., None] * n0 + s1[..., None] * n1


def curve_pairs(o, d, tmax, cp, w, n=None):
    """Ray × curve pairs (curve.cpp Curve::Intersect). o, d: (R,3); tmax
    (R,); cp (N,B,4,3) world-space control points, w (N,B,2) the widths
    at u = 0 and 1, n (N,B,2,3) ribbon normals (zero rows: flat and
    cylinder) or None; B is 1 (every ray against every curve) or R (ray r
    against its own N curves). Returns (t, u, v, hit), each (N,R), the
    long ray axis the inner one of every operation: t along the
    normalized direction (BIG where no span is hit), v ∈ [0,1] the offset
    across the width (the hair's h = 2v − 1).

    pbrt_tpu's order of operations: each of the CURVE_SEGMENTS spans is
    projected into the ray's frame, the chord's closest approach to the
    ray axis is tested against the half width interpolated at that u (a
    ribbon's scaled by |n(u)·d|, curve.cpp:165-172), and a span replaces
    the pair's best only under a strict t < best. Each pair's values are
    independent of the other pairs."""
    dn, e1, e2 = _ray_frame(d)
    o_c = [o[:, k] for k in range(3)]
    frame = [[f[:, k] for k in range(3)] for f in (e1, e2, dn)]
    us = [i / CURVE_SEGMENTS for i in range(CURVE_SEGMENTS + 1)]
    uu = torch.tensor(us, dtype=cp.dtype, device=cp.device)
    # every span end of every curve at once: (N,B,S+1,3)
    ends = bezier_point(cp[..., None, :, :], uu.expand(cp.shape[:-2]
                                                       + (len(us),)))

    def ray_space(i):
        q = [ends[..., i, k] - o_c[k] for k in range(3)]
        return [q[0] * f[0] + q[1] * f[1] + q[2] * f[2] for f in frame]

    w0, w1 = w[..., 0], w[..., 1]
    is_ribbon = (torch.sum(n[..., 0, :] * n[..., 0, :], -1) > 1e-12
                 if n is not None else None)
    # a pair's best so far starts at tmax, so the strict t < best is also
    # pbrt_tpu's t < tmax, and a pair hit iff its best fell below tmax;
    # v is formed once, from the best span's dist², side and half width
    shape = (cp.shape[0], o.shape[0])
    bt = tmax.expand(shape)
    bu, bd2, bside, bhw = (torch.zeros(shape, device=o.device)
                           for _ in range(4))
    ax, ay, az = ray_space(0)
    for i in range(CURVE_SEGMENTS):
        ui, uj = us[i], us[i + 1]
        bx, by, bz = ray_space(i + 1)
        abx = bx - ax
        aby = by - ay
        denom = torch.clamp_min(abx * abx + aby * aby, 1e-12)
        s = torch.clamp(-(ax * abx + ay * aby) / denom, 0.0, 1.0)
        px = ax + s * abx
        py = ay + s * aby
        t = az + s * (bz - az)
        u_hit = ui + s * (uj - ui)
        hw = 0.5 * (w0 * (1.0 - u_hit) + w1 * u_hit)
        if is_ribbon is not None:
            nhit = curve_slerp_normal(n, u_hit)
            cosr = ((nhit[..., 0] * frame[2][0] + nhit[..., 1] * frame[2][1]
                     + nhit[..., 2] * frame[2][2]).abs()
                    / torch.clamp_min(vecmath.length(nhit), 1e-9))
            hw = torch.where(is_ribbon, hw * cosr, hw)
        dist2 = px * px + py * py
        hit = (dist2 <= hw * hw) & (t > 1e-4) & (t < bt)
        # the side of the chord gives v's sign (curve.cpp:173-180)
        side = px * (-aby) + py * abx
        bt = torch.where(hit, t, bt)
        bu = torch.where(hit, u_hit, bu)
        bd2 = torch.where(hit, dist2, bd2)
        bside = torch.where(hit, side, bside)
        bhw = torch.where(hit, hw, bhw)
        ax, ay, az = bx, by, bz
    bh = bt < tmax
    v = 0.5 + torch.sign(bside) * vecmath.safe_sqrt(bd2) \
        / torch.clamp_min(2.0 * bhw, 1e-9)
    return (torch.where(bh, bt, BIG), bu,
            torch.where(bh, torch.clamp(v, 0.0, 1.0), 0.0), bh)


def intersect_curves(o, d, tmax, cp, w, n=None):
    """Every ray against every curve (pbrt_tpu's ``intersect_curves``):
    cp (N,4,3), w (N,2), n (N,2,3) or None. Returns (t, u, v, hit), each
    (R,N). Untiled: the scene's queries go through ``closest_curves`` and
    ``any_curves``."""
    out = curve_pairs(o, d, tmax, cp[:, None], w[:, None],
                      None if n is None else n[:, None])
    return tuple(x.T for x in out)


def curve_tile(n_rays: int, n_curves: int) -> int:
    """Curves a tile: the most whose (tile, R) tensors stay at or under
    CURVE_TILE_ELEMS elements (at least one)."""
    return max(1, min(n_curves, CURVE_TILE_ELEMS // max(n_rays, 1)))


def _tiles(o, cp, w, n, tile):
    tile = tile or curve_tile(o.shape[0], cp.shape[0])
    for s in range(0, cp.shape[0], tile):
        yield s, (cp[s:s + tile, None], w[s:s + tile, None],
                  None if n is None else n[s:s + tile, None])


def closest_curves(o, d, tmax, cp, w, n=None, tile=None):
    """The first curve of least t below tmax for each ray, the curves
    taken in tiles (``curve_tile``) folded in order under a strict <:
    each pair's test is independent of the others, so the result equals
    the untiled family best (pbrt_tpu's ``_family_best`` over
    ``intersect_curves``) bit for bit. Returns (t, idx, u, v), t BIG where
    no curve is hit."""
    best = None
    for s, tables in _tiles(o, cp, w, n, tile):
        t, u, v, h = curve_pairs(o, d, tmax, *tables)
        tb, idx = torch.where(h, t, BIG).min(dim=0)
        # u, v at the argmin (pbrt_tpu's select_along_last of (R, N))
        cur = (tb, idx + s, fastgather.select_along_last(u.T, idx),
               fastgather.select_along_last(v.T, idx))
        if best is None:
            best = cur
        else:
            upd = cur[0] < best[0]
            best = tuple(torch.where(upd, c, b) for c, b in zip(cur, best))
    return best



def any_curves(o, d, tmax, cp, w, n=None, tile=None):
    """Does any curve block the ray below tmax? (R,) bool, in tiles."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for _, tables in _tiles(o, cp, w, n, tile):
        occ = occ | curve_pairs(o, d, tmax, *tables)[3].any(0)
    return occ


def curve_hit_frame(o, d, cp, w, u, v, p, nrows=None):
    """Shading attributes at a curve hit: dpdu the fiber tangent (the
    hair BSDF's frame), the normal −d made perpendicular to it (the flat
    and cylinder shading normal, curve.cpp:213-230) or a ribbon's slerped
    normal (curve.cpp:213-218). cp (R,4,3) and nrows (R,2,3) are the hit
    curves' rows. Returns (tangent, normal)."""
    tang = normalize(bezier_tangent(cp, u))
    dn = normalize(d)
    n = -dn + tang * torch.sum(dn * tang, -1, keepdim=True)
    z = torch.tensor([0.0, 0.0, 1.0], device=d.device).expand(n.shape)
    n = normalize(torch.where(torch.sum(n * n, -1, keepdim=True) > 1e-12,
                              n, z))
    if nrows is not None:
        is_rib = torch.sum(nrows[:, 0] * nrows[:, 0], -1) > 1e-12
        n_rib = curve_slerp_normal(nrows, u)
        n_rib = normalize(torch.where(
            torch.sum(n_rib * n_rib, -1, keepdim=True) > 1e-12, n_rib, n))
        n = torch.where(is_rib[..., None], n_rib, n)
    return tang, n
