"""Hit records, per-ray (paired) shape tests and area sampling (port of
the triangle, sphere, aaplane and disk parts of pbrt_tpu/scene/shapes.py).

pbrt_tpu's all-pairs ``intersect_triangles / _spheres / _aaplanes`` have
no counterpart here: the brute-force closest hit over the whole scene is
the kernel of ops/intersect.py (and its plain-torch twin). What remains
are the routines that work on ONE primitive per ray, gathered beforehand
(light sampling, Pdf_Li and the portal samplers), and the all-pairs disk
test, which pbrt_tpu, too, runs outside its kernel.
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
