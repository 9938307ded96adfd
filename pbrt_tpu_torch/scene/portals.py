"""Light portals: in-front tests and the three sampling strategies (port
of pbrt_tpu/scene/portals.py).

Counterpart of the fork's ``src/portals/`` (AAPortal) and the estimator
dispatch of PortalArealight. Everything is batched over shading points,
with the portal dimension padded to the scene's largest portal count.

- InFront: half-space test against the portal plane.
- Visible-portal selection: uniform among in-front portals; behind all →
  fall back to light sampling.
- SamplePortal: uniform area on the portal, solid-angle pdf.
- SampleProj: project the light rect from the shading point onto the
  portal plane, clip against the portal rect, sample the clipped rect.
  As in pbrt_tpu, both rect axes get their own sample (u.x / u.y) and an
  empty clip returns pdf 0.
"""

from __future__ import annotations

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.vecmath import absdot, normalize, take_axis
from pbrt_tpu_torch.ops import fastgather
from pbrt_tpu_torch.scene import shapes


def portals_in_front(p, g_lights):
    """(R, P) mask: portal j of each ray's light exists and p is on its
    forward side (portal_arealight.cpp:52-56)."""
    maxp = g_lights.portal_lo.shape[1]
    in_front = shapes.aaplane_in_front(
        p[:, None, :].expand(-1, maxp, -1), g_lights.portal_lo,
        g_lights.portal_ax, g_lights.portal_facing)
    valid = torch.arange(maxp, device=p.device)[None, :] \
        < g_lights.n_portals[:, None]
    return in_front & valid


def select_visible_portal(in_front, u):
    """Uniformly pick one in-front portal per ray
    (portal_arealight.cpp:75-98). Returns (portal_idx (R,), select_pdf
    (R,), behind_all (R,))."""
    w = in_front.to(torch.float32)
    count = w.sum(-1)
    behind_all = count == 0.0
    # k-th visible portal with k = floor(u * count)
    k = torch.minimum((u * count).to(torch.int32),
                      torch.clamp_min(count.to(torch.int32) - 1, 0))
    csum = torch.cumsum(w, dim=-1)  # rank of portal j among visible: csum−1
    is_kth = in_front & ((csum - 1.0).to(torch.int32) == k[:, None])
    idx = torch.argmax(is_kth.to(torch.int32), dim=-1)
    pdf = torch.where(behind_all, 0.0, 1.0 / torch.clamp_min(count, 1.0))
    return idx, pdf, behind_all


def _gather_portal(g_lights, pidx):
    """Each lane's portal slot pidx of its light's (R, P, ...) rows."""
    return (fastgather.select_row(g_lights.portal_lo, pidx),
            fastgather.select_row(g_lights.portal_hi, pidx),
            fastgather.select_row(g_lights.portal_ax, pidx),
            fastgather.select_row(g_lights.portal_facing, pidx))


def sample_portal(g_lights, pidx, ref_p, u):
    """AAPortal::SamplePortal (aaportal.cpp:73-86): uniform point on the
    portal rect; pdf w.r.t. solid angle from ref_p. Returns (wi (R,3),
    pdf (R,), p_portal (R,3))."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    p, n, area_pdf = shapes.sample_aaplane(lo, hi, ax, fw, u)
    to_p = p - ref_p
    d2 = vecmath.length_squared(to_p)
    wi = normalize(to_p)
    pdf = d2 * area_pdf / torch.clamp_min(absdot(n, -wi), 1e-9)
    return wi, pdf, p


def pdf_portal(g_lights, pidx, ref_p, wi):
    """AAPortal::Pdf_Portal (aaportal.cpp:88-99): solid-angle pdf of
    sample_portal for direction wi (0 if the portal is missed)."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    tmax = torch.full(ref_p.shape[:1], vecmath.INF, device=ref_p.device)
    t, _, _, hit = shapes.intersect_aaplane_paired(ref_p, wi, tmax, lo, hi,
                                                   ax)
    n = shapes.aaplane_normal(ax, fw)
    area = shapes.aaplane_area(lo, hi, ax)
    pdf = (t * t) / torch.clamp_min(absdot(n, -wi) * area, 1e-9)
    return torch.where(hit, pdf, 0.0)


def _clipped_projection(lo, hi, ax, light_lo, light_hi, ref_p):
    """The light rect projected from ref_p onto the portal plane and
    clipped against the portal rect: (plane_c, ax0, ax1, c0, len0, c1,
    len1, ok) with the clipped rect [c, c + len] on each tangent axis."""
    ax0, ax1 = shapes.aaplane_axes(ax)
    plane_c = take_axis(lo, ax)              # portal plane coordinate

    # project a light corner lc from ref_p onto the portal plane:
    # point = lc + t (ref_p − lc), t such that point[ax] == plane_c
    def project(lc):
        dvec = ref_p - lc
        d_ax = take_axis(dvec, ax)
        ok = d_ax.abs() > 1e-12
        t = (plane_c - take_axis(lc, ax)) / torch.where(ok, d_ax, 1e-12)
        return lc + t[..., None] * dvec, ok

    proj_lo, ok_lo = project(light_lo)
    proj_hi, ok_hi = project(light_hi)

    def clip_axis(axis_sel):
        a = take_axis(proj_lo, axis_sel)
        b = take_axis(proj_hi, axis_sel)
        cmin = torch.maximum(take_axis(lo, axis_sel), torch.minimum(a, b))
        cmax = torch.minimum(take_axis(hi, axis_sel), torch.maximum(a, b))
        return cmin, torch.clamp_min(cmax - cmin, 0.0)

    c0, len0 = clip_axis(ax0)
    c1, len1 = clip_axis(ax1)
    return plane_c, ax0, ax1, c0, len0, c1, len1, ok_lo & ok_hi


def sample_projection(g_lights, pidx, light_lo, light_hi, light_ax, ref_p,
                      u):
    """AAPortal::SampleProj (aaportal.cpp:114-159): sample the clipped
    projection of the light rect through the portal plane as seen from
    ref_p. The light plane must be parallel to the portal plane (shared
    axis), as in the reference. Returns (wi, pdf, p_sampled)."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    plane_c, ax0, ax1, c0, len0, c1, len1, ok = _clipped_projection(
        lo, hi, ax, light_lo, light_hi, ref_p)
    area = len0 * len1
    ok = ok & (area > 1e-12)
    sampled = shapes.axis_point(ax, ax0, ax1, plane_c,
                                c0 + u[..., 0] * len0, c1 + u[..., 1] * len1)
    to_p = sampled - ref_p
    d2 = vecmath.length_squared(to_p)
    wi = normalize(to_p)
    n = shapes.aaplane_normal(ax, fw)
    pdf = d2 / torch.clamp_min(absdot(n, -wi) * area, 1e-9)
    return wi, torch.where(ok, pdf, 0.0), sampled


def pdf_projection(g_lights, pidx, light_lo, light_hi, light_ax, ref_p, wi):
    """Pdf of sample_projection for direction wi (the reference's Pdf_Proj
    is unimplemented, aaportal.cpp:161-164; provided for tests and MIS)."""
    lo, hi, ax, fw = _gather_portal(g_lights, pidx)
    _, ax0, ax1, c0, len0, c1, len1, _ = _clipped_projection(
        lo, hi, ax, light_lo, light_hi, ref_p)
    area = len0 * len1
    # does wi hit the clipped rect?
    tmax = torch.full(ref_p.shape[:1], vecmath.INF, device=ref_p.device)
    t, _, _, hit_plane = shapes.intersect_aaplane_paired(ref_p, wi, tmax, lo,
                                                         hi, ax)
    p = ref_p + t[..., None] * wi
    p0 = take_axis(p, ax0)
    p1 = take_axis(p, ax1)
    inside = (hit_plane & (p0 >= c0) & (p0 <= c0 + len0)
              & (p1 >= c1) & (p1 <= c1 + len1) & (area > 1e-12))
    n = shapes.aaplane_normal(ax, fw)
    pdf = (t * t) / torch.clamp_min(absdot(n, -wi) * area, 1e-9)
    return torch.where(inside, pdf, 0.0)
