"""Ray–scene intersection over the ported primitive families (port of
pbrt_tpu/scene/intersect.py).

Counterpart of Scene::Intersect / IntersectP. Two paths, chosen as
pbrt_tpu chooses them:

- **BVH**: a scene that carries one (``Scene.bvh``, built by
  ``SceneBuilder.build`` for more than 256 triangles) sends its triangle
  queries through the traversal kernel of ops/bvh.py and its spheres and
  aaplanes through the brute-force kernel (scene/bvh.py).
- **kd-tree**: a scene whose aggregate is a kd-tree (``Accelerator
  "kdtree"``, scene/kdtree.py) walks its triangles through the kd kernel
  of ops/kdtree.py, then its spheres and aaplanes through the
  brute-force kernel and its disks in plain torch, and nothing else, as
  pbrt_tpu's kd path.
- **Brute force**: a scene without an aggregate, of any number of
  triangles, spheres and aaplanes, goes through the brute-force kernel of
  ops/intersect.py as a whole.

On a CUDA tensor these are the kernels, on a CPU tensor their twins.
Disks, curves and instanced objects stay outside the kernels, as in
pbrt_tpu: after the kernel's closest hit, ``closest_disk`` tests every
disk in plain torch with the kernel's ``t`` as its bound, then
``closest_curve`` every curve (in tiles, scene/shapes.py), then
scene/instances.py walks the instances the same way, and the any-hit
query ORs in a disk, a curve or an instance hit. The brute-force path
hands the curve's (u, v) to ``finalize_hit`` as pbrt_tpu's cache does;
the BVH path does not, and ``finalize_hit`` rescans the hit curve
(bound t + 1e-3), as pbrt_tpu does.
``finalize_hit`` turns ``(t, prim)`` into a Hit record with normals, uvs
and tangents.

Two-keyframe motion blur: on a scene with motion (``Scene.has_motion``),
a query given the rays' shutter times ``time`` runs the kernels' motion
variants, which move each triangle to the ray's time (v + time·dv), and
``finalize_hit`` reads the moved vertices; a query without times (the
integrators that ignore time, as pbrt_tpu's do) sees the triangles at
shutter time 0 through the static kernels.
"""

from __future__ import annotations

import math

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.vecmath import normalize
from pbrt_tpu_torch.ops import fastgather
from pbrt_tpu_torch.ops import intersect as ik
from pbrt_tpu_torch.scene import bvh as bvh_mod
from pbrt_tpu_torch.scene import instances as inst_mod
from pbrt_tpu_torch.scene import kdtree as kd_mod
from pbrt_tpu_torch.scene import shapes
from pbrt_tpu_torch.scene.shapes import Hit


def _aggregate(scene):
    """"kd", "bvh" or None: the scene's triangle aggregate. Any other
    object there raises."""
    if scene.bvh is None:
        return None
    if isinstance(scene.bvh, kd_mod.KdTree):
        return "kd"
    if isinstance(scene.bvh, bvh_mod.FlatBVH):
        return "bvh"
    raise NotImplementedError(
        f"aggregate {type(scene.bvh).__name__}: the port's are "
        "scene/bvh.py::FlatBVH and scene/kdtree.py::KdTree")


def _moving(scene, time) -> bool:
    return time is not None and scene.has_motion


def _closest(scene, o, d, tmax, time=None):
    """(t, prim) of the closest hit, through the brute-force kernel (its
    motion variant for rays with shutter times on a scene with motion).
    Not differentiated: the estimator differentiates the integrand, not
    the sampled hit distances."""
    with torch.no_grad():
        args = (o.detach().contiguous(), d.detach().contiguous(),
                tmax.detach().contiguous())
        if _moving(scene, time):
            tri, sph, pln = ik.pack_scene(scene, motion=True)
            return ik.intersect_brute_motion(
                tri, sph, pln, *args, time.detach().contiguous(),
                scene.n_tri, scene.n_sph, scene.n_pln)
        tri, sph, pln = ik.pack_scene(scene)
        return ik.intersect_brute(tri, sph, pln, *args, scene.n_tri,
                                  scene.n_sph, scene.n_pln)


def _disk_hits(scene, o, d, tmax):
    g = scene.geom
    with torch.no_grad():
        return shapes.intersect_disks(o.detach(), d.detach(), tmax.detach(),
                                      g.dsk_center, g.dsk_normal,
                                      g.dsk_radius, g.dsk_inner)


def closest_disk(scene, o, d, best_t, prim_id):
    """Fold the disks into a closest hit (best_t, prim_id): pbrt_tpu's
    family update ``any & (tb < best_t)`` with the first disk of least t."""
    if not scene.n_dsk:
        return best_t, prim_id
    t, h = _disk_hits(scene, o, d, best_t)
    tb, idx = torch.where(h, t, shapes.BIG).min(dim=-1)
    upd = (tb < shapes.BIG) & (tb < best_t)
    base = scene.n_tri + scene.n_sph + scene.n_pln
    return (torch.where(upd, tb, best_t),
            torch.where(upd, base + idx.to(prim_id.dtype), prim_id))


def _curve_tables(scene):
    g = scene.geom
    return g.crv_cp, g.crv_w, g.crv_n


def closest_curve(scene, o, d, best_t, prim_id):
    """Fold the curves into a closest hit (best_t, prim_id), after the
    disks: pbrt_tpu's family update ``any & (tb < best_t)`` with the first
    curve of least t, the curves tested below ``best_t``. Returns (t,
    prim, (u, v)) with the family best's (u, v) (pbrt_tpu's
    ``results["crv"]``), or (t, prim, None) without curves."""
    if not scene.n_crv:
        return best_t, prim_id, None
    with torch.no_grad():
        tb, idx, ub, vb = shapes.closest_curves(
            o.detach(), d.detach(), best_t.detach(), *_curve_tables(scene))
    upd = (tb < shapes.BIG) & (tb < best_t)
    base = scene.n_tri + scene.n_sph + scene.n_pln + scene.n_dsk
    return (torch.where(upd, tb, best_t),
            torch.where(upd, base + idx.to(prim_id.dtype), prim_id),
            (ub, vb))


def any_curve(scene, o, d, tmax):
    """Does any curve block the segment below tmax? (R,) bool."""
    with torch.no_grad():
        return shapes.any_curves(o.detach(), d.detach(), tmax.detach(),
                                 *_curve_tables(scene))


def any_disk(scene, o, d, tmax):
    """Does any disk block the segment below tmax? (R,) bool."""
    if not scene.n_dsk:
        return torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    return _disk_hits(scene, o, d, tmax)[1].any(-1)


def intersect(scene, o, d, tmax, surface_only=False, time=None) -> Hit:
    """Closest-hit query. o, d: (R,3); tmax: (R,); time: (R,) shutter
    times, or None (shutter time 0). Returns Hit (R,...); with
    ``surface_only`` its uv, dpdu and dpdv are left out (see
    ``finalize_hit``)."""
    agg = _aggregate(scene)
    if agg == "kd":
        return kd_mod.intersect_kd(scene, o, d, tmax, surface_only)
    if agg == "bvh":
        return bvh_mod.intersect_bvh(scene, o, d, tmax, surface_only,
                                     time=time)
    t, prim = closest_disk(scene, o, d, *_closest(scene, o, d, tmax, time))
    t, prim, crv_uv = closest_curve(scene, o, d, t, prim)
    t, prim = inst_mod.update_closest(scene, o, d, t, prim)
    return finalize_hit(scene, o, d, t, prim, surface_only, time=time,
                        crv_uv=crv_uv)


def intersect_p(scene, o, d, tmax, time=None):
    """Any-hit (shadow) query → occluded mask (R,)."""
    agg = _aggregate(scene)
    if agg == "kd":
        return kd_mod.intersect_p_kd(scene, o, d, tmax)
    if agg == "bvh":
        return bvh_mod.intersect_p_bvh(scene, o, d, tmax, time=time)
    occ = _closest(scene, o, d, tmax, time)[1] >= 0
    if scene.n_dsk:
        occ = occ | any_disk(scene, o, d, tmax)
    if scene.n_crv:
        occ = occ | any_curve(scene, o, d, tmax)
    if scene.inst is not None:
        occ = occ | inst_mod.any_hit(scene, o, d, tmax)
    return occ


def _tri_verts(scene, gt, time):
    """The vertices of the triangles that the row gather ``gt`` reads
    (``fastgather.make_row_gather`` over the triangles), moved to the
    rays' shutter times on a scene with motion (pbrt_tpu's finalize_hit
    lerp)."""
    g = scene.geom
    hv = [gt(v) for v in (g.tri_v0, g.tri_v1, g.tri_v2)]
    if _moving(scene, time):
        tt = time[:, None]
        hv = [v + tt * gt(dv)
              for v, dv in zip(hv, (g.tri_dv0, g.tri_dv1, g.tri_dv2))]
    return hv


def _attach_t(scene, o, d, t, prim_id, time=None):
    """The kernels' ``t`` of the hit primitive with the gradient of that
    primitive's ray distance with respect to the ray (its value stays the
    kernel's): a ray whose origin or direction depends on a
    differentiated parameter (volpath's medium events, a portal's NEE
    direction) moves its hit along the surface, as pbrt_tpu's
    brute-force ``t`` does. Triangles, disks and aaplanes by their plane,
    spheres by the quadratic's root nearer the kernel's t, curves by
    pbrt_tpu's span test of the hit curve (the projection of the chord's
    closest point on the normalized direction, bound t + 1e-3); an
    instanced hit keeps a constant t. A moving triangle's plane is the
    one at the ray's shutter time."""
    g = scene.geom
    nt, ns, npl, nd = scene.n_tri, scene.n_sph, scene.n_pln, scene.n_dsk
    ta = torch.zeros_like(t)
    fam = torch.zeros_like(prim_id, dtype=torch.bool)

    def plane_t(p0, n):
        den = vecmath.dot(d, n)
        return vecmath.dot(p0 - o, n) / torch.where(den.abs() > 1e-30, den,
                                                    1e-30)
    if nt:
        on = (prim_id >= 0) & (prim_id < nt)
        v0, v1, v2 = _tri_verts(
            scene, fastgather.make_row_gather(nt, prim_id), time)
        n = vecmath.cross(v1 - v0, v2 - v0)
        ta = torch.where(on, plane_t(v0, n), ta)
        fam = fam | on
    if ns:
        on = (prim_id >= nt) & (prim_id < nt + ns)
        gs = fastgather.make_row_gather(ns, prim_id - nt)
        oc = o - gs(g.sph_center)
        a = torch.clamp_min(vecmath.dot(d, d), 1e-20)
        b = vecmath.dot(oc, d)
        disc = b * b - a * (vecmath.dot(oc, oc) - gs(g.sph_radius) ** 2)
        sq = vecmath.safe_sqrt(disc)
        t_n, t_f = (-b - sq) / a, (-b + sq) / a
        near = (t_n - t.detach()).abs() <= (t_f - t.detach()).abs()
        ta = torch.where(on, torch.where(near, t_n, t_f), ta)
        fam = fam | on
    if npl:
        on = (prim_id >= nt + ns) & (prim_id < nt + ns + npl)
        gp = fastgather.make_row_gather(npl, prim_id - nt - ns)
        axis = torch.nn.functional.one_hot(gp(g.pln_ax).long(), 3)
        ta = torch.where(on, plane_t(gp(g.pln_lo), axis.to(o.dtype)), ta)
        fam = fam | on
    if nd:
        base = nt + ns + npl
        on = (prim_id >= base) & (prim_id < base + nd)
        gd = fastgather.make_row_gather(nd, prim_id - base)
        ta = torch.where(on, plane_t(gd(g.dsk_center), gd(g.dsk_normal)),
                         ta)
        fam = fam | on
    if scene.n_crv:
        base = nt + ns + npl + nd
        on = (prim_id >= base) & (prim_id < scene.n_base_prims)
        tc = _curve_rescan(scene, o, d, t.detach(), prim_id - base)[0]
        ta = torch.where(on, tc, ta)
        fam = fam | on
    return t.detach() + torch.where(fam, ta - ta.detach(), 0.0)


def _curve_rescan(scene, o, d, t, ci):
    """The span test of ray r against its hit curve ci[r] alone, below
    t + 1e-3: (t, u, v, hit), each (R,). Each pair's test is independent
    of the other curves, so this is pbrt_tpu's rescan
    (``intersect_curves`` over every curve, read at column ci)."""
    gc = fastgather.make_row_gather(scene.n_crv, ci)
    cp, w, n = _curve_tables(scene)
    out = shapes.curve_pairs(o, d, t + 1e-3, gc(cp)[None], gc(w)[None],
                             None if n is None else gc(n)[None])
    return tuple(x[0] for x in out)


def finalize_hit(scene, o, d, t, prim_id, surface_only=False,
                 time=None, crv_uv=None) -> Hit:
    """Hit attributes (p, ng, ns, uv, dpdu, dpdv) from (t, prim_id), a
    moving triangle's at the rays' shutter times ``time``. Where the ray
    carries a gradient, ``t`` takes the hit primitive's (``_attach_t``).
    ``surface_only`` (the subsurface probe chain, which reads the point
    and the normals) leaves uv zero and dpdu / dpdv None, but on a scene
    with instances. A curve hit takes its (u, v) from ``crv_uv`` (the
    brute-force query's family best) or, without it, from a rescan of the
    hit curve; its normals and dpdu are ``shapes.curve_hit_frame``'s."""
    g = scene.geom
    surface_only = surface_only and scene.inst is None
    R = o.shape[0]
    dev = o.device
    prim_id = prim_id.long()   # the kernel's int32 ids index tables below
    if torch.is_grad_enabled() and (o.requires_grad or d.requires_grad):
        t = _attach_t(scene, o, d, t, prim_id, time)
    valid = prim_id >= 0
    # park missed rays at their origin: a t of 1e30 would overflow squared
    # distances downstream (inf → NaN in masked-lane gradients)
    p = o + torch.where(valid, t, 0.0)[..., None] * d
    ng = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(R, 3)
    ns = ng
    uv = torch.zeros((R, 2), device=dev)
    dpdu = torch.tensor([1.0, 0.0, 0.0], device=dev).expand(R, 3)

    nt, nsp, npl = scene.n_tri, scene.n_sph, scene.n_pln
    if nt:
        gt = fastgather.make_row_gather(nt, prim_id)
        is_tri = (valid & (prim_id < nt))[..., None]
        hv0, hv1, hv2 = _tri_verts(scene, gt, time)
        ngt = shapes.triangle_normal(hv0, hv1, hv2)
        # barycentrics recomputed at the hit point (the kernel carries only
        # t and the prim id): project onto the triangle basis
        e1 = hv1 - hv0
        e2 = hv2 - hv0
        rp = p - hv0
        d00 = vecmath.dot(e1, e1)
        d01 = vecmath.dot(e1, e2)
        d11 = vecmath.dot(e2, e2)
        d20 = vecmath.dot(rp, e1)
        d21 = vecmath.dot(rp, e2)
        denom = torch.clamp_min(d00 * d11 - d01 * d01, 1e-20)
        bu = torch.clamp((d11 * d20 - d01 * d21) / denom, 0.0, 1.0)
        bv = torch.clamp((d00 * d21 - d01 * d20) / denom, 0.0, 1.0)
        w = torch.clamp(1.0 - bu - bv, 0.0, 1.0)
        nst = normalize(w[..., None] * gt(g.tri_n0)
                        + bu[..., None] * gt(g.tri_n1)
                        + bv[..., None] * gt(g.tri_n2))
        ng = torch.where(is_tri, ngt, ng)
        ns = torch.where(is_tri, nst, ns)
    if nt and not surface_only:
        uv0, uv1, uv2 = gt(g.tri_uv0), gt(g.tri_uv1), gt(g.tri_uv2)
        uvt = w[..., None] * uv0 + bu[..., None] * uv1 + bv[..., None] * uv2
        uv = torch.where(is_tri, uvt, uv)
        # ∂p/∂u, ∂p/∂v from the uv parameterization (triangle.cpp:157-168)
        duv1 = uv1 - uv0
        duv2 = uv2 - uv0
        det = duv1[..., 0] * duv2[..., 1] - duv1[..., 1] * duv2[..., 0]
        ok_uv = det.abs() > 1e-12
        inv = torch.where(ok_uv, 1.0 / torch.where(ok_uv, det, 1.0), 0.0)
        dpdu_t = (duv2[..., 1:2] * e1 - duv1[..., 1:2] * e2) * inv[..., None]
        dpdv_t = (-duv2[..., 0:1] * e1 + duv1[..., 0:1] * e2) * inv[..., None]
        # degenerate uvs → arbitrary in-plane tangents
        t1_fb, t2_fb = vecmath.coordinate_system(ngt)
        dpdu_t = torch.where(ok_uv[..., None], dpdu_t, t1_fb)
        dpdv_t = torch.where(ok_uv[..., None], dpdv_t, t2_fb)
        dpdu = torch.where(is_tri, dpdu_t, dpdu)
    if nsp:
        gs = fastgather.make_row_gather(nsp, prim_id - nt)
        is_sph = (valid & (prim_id >= nt) & (prim_id < nt + nsp))[..., None]
        sph_c = gs(g.sph_center)
        if surface_only:
            nsph = normalize(p - sph_c)
        else:
            nsph, uvs = shapes.sphere_normal_uv(p, sph_c, gs(g.sph_radius))
            uv = torch.where(is_sph, uvs, uv)
        ng = torch.where(is_sph, nsph, ng)
        ns = torch.where(is_sph, nsph, ns)
    if nsp and not surface_only:
        # ∂p/∂u = 2π·(−y, x, 0) in sphere-local coords (sphere.cpp:145)
        pl = p - sph_c
        dpdu_s = 2.0 * math.pi * torch.stack(
            [-pl[..., 1], pl[..., 0], torch.zeros_like(pl[..., 0])], dim=-1)
        t1_fbs, _ = vecmath.coordinate_system(nsph)
        dpdu_s = torch.where(
            (vecmath.length_squared(dpdu_s) > 1e-12)[..., None], dpdu_s,
            t1_fbs)
        dpdu = torch.where(is_sph, dpdu_s, dpdu)
    if npl:
        gp = fastgather.make_row_gather(npl, prim_id - nt - nsp)
        is_pln = (valid & (prim_id >= nt + nsp)
                  & (prim_id < nt + nsp + npl))[..., None]
        npln = shapes.aaplane_normal(gp(g.pln_ax), gp(g.pln_facing))
        ng = torch.where(is_pln, npln, ng)
        ns = torch.where(is_pln, npln, ns)
    if scene.n_dsk:
        base = nt + nsp + npl
        nd = fastgather.make_row_gather(scene.n_dsk, prim_id - base)(
            g.dsk_normal)
        is_dsk = (valid & (prim_id >= base)
                  & (prim_id < base + scene.n_dsk))[..., None]
        ng = torch.where(is_dsk, nd, ng)
        ns = torch.where(is_dsk, nd, ns)

    # the geometric normal keeps its own orientation (as pbrt's); the
    # shading normal is flipped to its side
    ns = vecmath.face_forward(ns, ng)
    if scene.n_crv:
        base = nt + nsp + npl + scene.n_dsk
        is_crv = (valid & (prim_id >= base)
                  & (prim_id < scene.n_base_prims))[..., None]
        ci = prim_id - base
        gc = fastgather.make_row_gather(scene.n_crv, ci)
        if crv_uv is None:
            with torch.no_grad():
                _, u_c, v_c, _ = _curve_rescan(scene, o.detach(),
                                               d.detach(), t.detach(),
                                               ci)
        else:
            u_c, v_c = crv_uv
        cp, w, n = _curve_tables(scene)
        tang, n_c = shapes.curve_hit_frame(
            o, d, gc(cp), gc(w), u_c, v_c, p,
            nrows=None if n is None else gc(n))
        ng = torch.where(is_crv, n_c, ng)
        ns = torch.where(is_crv, n_c, ns)
        if not surface_only:
            uv = torch.where(is_crv, torch.stack([u_c, v_c], -1), uv)
            dpdu = torch.where(is_crv, tang, dpdu)
    if surface_only:
        return Hit(valid=valid, t=t, p=p, ng=ng, ns=ns, uv=uv,
                   prim_id=torch.where(valid, prim_id, -1))
    # ∂p/∂v: exact for triangles, the frame-completing cross product for
    # the analytic shapes
    dpdv = vecmath.cross(ng, dpdu)
    if nt:
        dpdv = torch.where(is_tri, dpdv_t, dpdv)
    if scene.inst is not None and scene.n_vprims:
        ng, ns, uv, dpdu, dpdv = inst_mod.finalize_instance_hits(
            scene, t, prim_id, p, ng, ns, uv, dpdu, dpdv)
        ns = vecmath.face_forward(ns, ng)
    return Hit(valid=valid, t=t, p=p, ng=ng, ns=ns, uv=uv,
               prim_id=torch.where(valid, prim_id, -1), dpdu=dpdu,
               dpdv=dpdv)


def unoccluded(scene, p0, n0, p1):
    """VisibilityTester::Unoccluded (core/light.cpp:56-62): segment test
    between offset endpoints."""
    d = p1 - p0
    o = vecmath.offset_ray_origin(p0, n0, d)
    dist = vecmath.length(d)
    dn = d / torch.clamp_min(dist, 1e-12)[..., None]
    # shorten to avoid re-hitting the light itself
    tmax = dist * (1.0 - 1e-3)
    return ~intersect_p(scene, o, dn, tmax)
