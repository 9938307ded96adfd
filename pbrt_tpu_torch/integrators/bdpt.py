"""Bidirectional path tracing (port of pbrt_tpu/integrators/bdpt.py).

Counterpart of ``integrators/bdpt.{h,cpp}``: GenerateCameraSubpath and
GenerateLightSubpath (:69-95) are fixed-length vectorized random walks
that store each vertex in (R, V, ...) tensors; ConnectBDPT (:401+)
evaluates every (s, t) strategy over all lanes with masks; MISWeight
(:302-399) is the pdf_fwd / pdf_rev ratio product over the stored
vertices. The t = 1 (light-tracing) strategies splat at their raster
positions (Film::AddSplat, film.h:83-87) in ``light_splat_pass``, which
``render_bdpt`` adds to each chunk's camera pass.

As in pbrt_tpu, and so as a copy of what it ignores (ROADMAP queue 3):
the vertices read the material rows' own kd (no texture), no BSSRDF and
no medium, and a light subpath starts on the emitter's own shape, not on
its portals. Every closest-hit and shadow query goes through
``scene/intersect.py``: the brute-force kernel, or the traversal kernel
with it under a BVH. Which strategies run is fixed by the scene (an
infinite light adds the environment family, a distant light its far
shadow ray), so a pass's kernel launches are known before it runs
(``queries_per_chunk``).

As in pbrt_tpu, the BSDFs here take ``make_frame``'s frame and no
fiber offset or Fourier tables: a HAIR row is evaluated at h = 0, its
frame not along the fiber, and a FOURIER row is black (ROADMAP queue
3).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (INV_PI, concentric_sample_disk,
                                          cosine_sample_hemisphere,
                                          uniform_sample_sphere)
from pbrt_tpu_torch.core.vecmath import absdot, dot, normalize
from pbrt_tpu_torch.integrators import common
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import film as film_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import shapes
from pbrt_tpu_torch.scene.lights import (AREA, DISTANT, GONIO, INFINITE,
                                         POINT, PROJECTION, SPOT)

# vertex types (bdpt.h VertexType)
VT_NONE = 0
VT_CAMERA = 1
VT_LIGHT = 2
VT_SURFACE = 3

# the splat pass's path ids start here (pbrt_tpu's light_splat_pass)
SPLAT_PID_BASE = 1 << 26


@dataclasses.dataclass
class Subpath:
    """Vertex storage, (R, V, ...), allocated once and written slot by
    slot in place (bdpt needs no autograd)."""
    vtype: torch.Tensor     # (R,V) int32
    p: torch.Tensor         # (R,V,3)
    ns: torch.Tensor        # (R,V,3)
    ng: torch.Tensor        # (R,V,3)
    beta: torch.Tensor      # (R,V,C) throughput up to this vertex
    pdf_fwd: torch.Tensor   # (R,V) area-measure pdf arriving forward
    pdf_rev: torch.Tensor   # (R,V) area-measure pdf if generated in reverse
    mat_id: torch.Tensor    # (R,V) int32
    light_id: torch.Tensor  # (R,V) int32
    wo: torch.Tensor        # (R,V,3) toward the previous vertex
    delta: torch.Tensor     # (R,V) bool, specular vertex
    # the escaped-ray record: if the walk's segment into slot i missed the
    # scene, esc[i] is set and esc_d / esc_beta / esc_pdf hold the escape
    # direction, the throughput up to the previous vertex and the
    # solid-angle BSDF pdf of having sampled it (0 after a specular bounce)
    esc: torch.Tensor       # (R,V) bool
    esc_d: torch.Tensor     # (R,V,3)
    esc_beta: torch.Tensor  # (R,V,C)
    esc_pdf: torch.Tensor   # (R,V)


def empty_subpath(R: int, V: int, C: int, device) -> Subpath:
    def z(*shape, dtype=torch.float32):
        return torch.zeros((R, V) + shape, dtype=dtype, device=device)
    return Subpath(vtype=z(dtype=torch.int32), p=z(3), ns=z(3), ng=z(3),
                   beta=z(C), pdf_fwd=z(), pdf_rev=z(),
                   mat_id=z(dtype=torch.int32),
                   light_id=torch.full((R, V), -1, dtype=torch.int32,
                                       device=device),
                   wo=z(3), delta=z(dtype=torch.bool),
                   esc=z(dtype=torch.bool), esc_d=z(3), esc_beta=z(C),
                   esc_pdf=z())


def max_vertices(max_depth: int) -> int:
    """Vertices of a subpath: max_depth + 2, capped at 6 (pbrt_tpu)."""
    return min(max_depth + 2, 6)


def queries_per_chunk(scene, max_depth: int) -> int:
    """Closest-hit and shadow queries of one chunk of ``render_bdpt``,
    from the loops below: each walk step, each (s, t) connection, each
    distant-light far shadow ray (s = 1, when the scene has a distant
    light), each environment NEE (when it has an infinite light), and the
    splat pass's walk and its camera shadow rays. Under a BVH each query
    launches the traversal kernel and the brute-force kernel once each."""
    v = max_vertices(max_depth)
    n = 2 * (v - 1) + (v - 2) * (v - 1) // 2 + 2 * (v - 1)
    if lights_mod._lt_present(scene.lights, DISTANT):
        n += v - 2
    if lights_mod._lt_present(scene.lights, INFINITE):
        n += v - 2
    return n


def _dir_pdf_to_area(pdf_dir, p_from, p_to, n_to):
    """Solid angle → area measure (bdpt Vertex::ConvertDensity)."""
    d = p_to - p_from
    dist2 = vecmath.length_squared(d)
    w = d * torch.rsqrt(torch.clamp_min(dist2, 1e-20))[..., None]
    return pdf_dir * absdot(n_to, w) / torch.clamp_min(dist2, 1e-20)


def _remap0(x):
    """remap0 (bdpt.cpp:295): a pdf of 0 marks a delta interaction, whose
    ratio passes through as 1."""
    return torch.where(x != 0.0, x, 1.0)


def _is_delta_position(ltype):
    return (ltype == POINT) | (ltype == SPOT) | (ltype == GONIO) \
        | (ltype == PROJECTION)


def _random_walk(scene, sp: Subpath, o, d, beta0, pdf_dir0, start_i: int,
                 n_steps: int, pid, sidx, sfn, seed, dim_base: int):
    """Extend a subpath by BSDF sampling (bdpt.cpp RandomWalk), writing
    slots start_i .. start_i + n_steps - 1 of ``sp`` in place."""
    R = o.shape[0]
    o_cur, d_cur = o, d
    beta = beta0
    pdf_dir = pdf_dir0
    active = beta0.amax(dim=-1) > 0
    inf = torch.full((R,), vecmath.INF, device=o.device)
    for step in range(n_steps):
        i = start_i + step
        hit = isect_mod.intersect(scene, o_cur, d_cur, inf)
        ok = active & hit.valid
        gone = active & ~hit.valid
        sp.esc[:, i] = gone
        sp.esc_d[:, i] = torch.where(gone[..., None], d_cur, 0.0)
        sp.esc_beta[:, i] = torch.where(gone[..., None], beta, 0.0)
        sp.esc_pdf[:, i] = torch.where(gone, pdf_dir, 0.0)
        light_id = torch.where(ok, scene.light_at(hit.prim_id), -1)
        mat_id = scene.mat_at(hit.prim_id)
        pdf_area = _dir_pdf_to_area(pdf_dir, o_cur, hit.p, hit.ng)
        sp.vtype[:, i] = torch.where(ok, VT_SURFACE, VT_NONE)
        sp.p[:, i] = torch.where(ok[..., None], hit.p, 0.0)
        sp.ns[:, i] = torch.where(ok[..., None], hit.ns, 0.0)
        sp.ng[:, i] = torch.where(ok[..., None], hit.ng, 0.0)
        sp.beta[:, i] = torch.where(ok[..., None], beta, 0.0)
        sp.pdf_fwd[:, i] = torch.where(ok, pdf_area, 0.0)
        sp.mat_id[:, i] = torch.where(ok, mat_id, 0)
        sp.light_id[:, i] = light_id
        sp.wo[:, i] = torch.where(ok[..., None], -d_cur, 0.0)

        mp = mat_mod.gather_materials(scene.materials, mat_id.clamp_min(0))
        t1, t2 = common.make_frame(hit.ns)
        wo = common.to_local(t1, t2, hit.ns, -d_cur)
        dim = dim_base + step * 3
        u_l = sfn(pid, sidx, dim, seed)
        u = torch.stack([sfn(pid, sidx, dim + 1, seed),
                         sfn(pid, sidx, dim + 2, seed)], -1)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(mp, wo, u_l, u)
        wi = common.to_world(t1, t2, hit.ns, wi_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        sp.delta[:, i] = ok & is_spec

        # the reverse pdf at the previous vertex
        pdf_rev_dir = mat_mod.bsdf_pdf(mp, wi_loc, wo)
        prev = i - 1
        pdf_rev_area = _dir_pdf_to_area(pdf_rev_dir, hit.p, sp.p[:, prev],
                                        sp.ng[:, prev])
        sp.pdf_rev[:, prev] = torch.where(ok, pdf_rev_area,
                                          sp.pdf_rev[:, prev])

        thr = f * (absdot(wi, hit.ns)
                   / torch.clamp_min(pdf, 1e-20))[..., None]
        beta = torch.where(ok[..., None], beta * thr, beta)
        active = ok & (pdf > 0) & (beta.amax(dim=-1) > 0)
        # a specular bounce records pdf 0 (the next vertex's pdf_fwd and
        # this one's pdf_rev), which remap0 passes through as 1
        pdf_dir = torch.where(is_spec, 0.0, pdf)
        o_cur = vecmath.offset_ray_origin(hit.p, hit.ng, wi)
        d_cur = wi
    return sp


def generate_camera_subpath(scene, o, d, max_v, pid, sidx, sfn, seed,
                            cam=None):
    """bdpt.cpp:69-88. Vertex 0 is the camera. ``cam`` gives the first
    segment's directional density (Pdf_We), which every strategy's weight
    reads through the t = 1 term; without one a unit density stands in
    (exact only when no t = 1 strategy runs)."""
    R, C = o.shape[0], scene.n_channels
    sp = empty_subpath(R, max_v, C, o.device)
    sp.vtype[:, 0] = VT_CAMERA
    sp.p[:, 0] = o
    sp.ns[:, 0] = d
    sp.ng[:, 0] = d
    sp.beta[:, 0] = 1.0
    sp.pdf_fwd[:, 0] = 1.0
    pdf_dir0 = (cam_mod.camera_pdf_dir(cam, d) if cam is not None
                else torch.ones(R, device=o.device))
    return _random_walk(scene, sp, o, d, torch.ones((R, C), device=o.device),
                        pdf_dir0, 1, max_v - 1, pid, sidx, sfn, seed, 100)


def generate_light_subpath(scene, max_v, pid, sidx, sfn, seed):
    """bdpt.cpp:95-141: choose a light (uniformly), sample a point and a
    direction on it, walk. Area lights on triangles, aaplanes and spheres
    emit cosine-weighted; point, goniometric and projection lights
    uniformly over the sphere (the latter two scaled by their map), spot
    lights uniformly in their cone; an infinite light starts on a
    world-radius disk beyond the scene along a direction drawn from its
    map. A distant light starts no subpath: its paths end in one delta
    segment, which the s = 1 delta-direction connection reaches with
    weight 1 (a far-disk walk would count them twice)."""
    R, C = pid.shape[0], scene.n_channels
    dev = pid.device
    sp = empty_subpath(R, max_v, C, dev)
    lt = scene.lights
    u_sel = sfn(pid, sidx, 200, seed)
    light_idx, sel_pmf = common.choose_light(scene, u_sel, None)
    g = lights_mod.gather_lights(lt, light_idx)
    ap = lights_mod.gather_area_prim(scene, g.prim_id)
    u_pos = torch.stack([sfn(pid, sidx, 201, seed),
                         sfn(pid, sidx, 202, seed)], -1)
    p_tri, n_tri, ip_tri = shapes.sample_triangle(ap.v0, ap.v1, ap.v2, u_pos)
    p_pln, n_pln, ip_pln = shapes.sample_aaplane(ap.lo, ap.hi, ap.ax,
                                                 ap.facing, u_pos)
    d_sph = uniform_sample_sphere(u_pos)
    p_sph = ap.center + ap.radius[..., None] * d_sph
    ip_sph = 1.0 / torch.clamp_min(4.0 * math.pi * ap.radius * ap.radius,
                                   1e-20)
    p_l = torch.where(ap.is_sph[..., None], p_sph,
                      torch.where(ap.is_pln[..., None], p_pln, p_tri))
    n_l = torch.where(ap.is_sph[..., None], d_sph,
                      torch.where(ap.is_pln[..., None], n_pln, n_tri))
    pdf_pos = torch.where(ap.is_sph, ip_sph,
                          torch.where(ap.is_pln, ip_pln, ip_tri))
    is_area = g.ltype == AREA
    # goniometric and projection lights emit as point lights scaled by
    # their map (lights_mod.emission_scale)
    is_point = (g.ltype == POINT) | (g.ltype == GONIO) \
        | (g.ltype == PROJECTION)
    is_spot = g.ltype == SPOT
    is_dist = g.ltype == DISTANT

    # cosine-weighted emission direction (diffuse.cpp Sample_Le)
    u_dir = torch.stack([sfn(pid, sidx, 203, seed),
                         sfn(pid, sidx, 204, seed)], -1)
    d_loc = cosine_sample_hemisphere(u_dir)
    t1, t2 = common.make_frame(n_l)
    d_l = common.to_world(t1, t2, n_l, d_loc)
    pdf_dir = torch.clamp_min(d_loc[..., 2], 1e-6) * INV_PI

    # point (point.cpp Sample_Le): a uniform direction over the sphere
    d_unif = uniform_sample_sphere(u_dir)
    # spot (spot.cpp Sample_Le): uniform in the cone around g.dir
    zc = 1.0 + u_dir[..., 1] * (g.cos_total - 1.0)
    sc = torch.sqrt(torch.clamp_min(1.0 - zc * zc, 0.0))
    phic = 2.0 * math.pi * u_dir[..., 0]
    ts1, ts2 = common.make_frame(g.dir)
    d_cone = (torch.cos(phic) * sc)[..., None] * ts1 \
        + (torch.sin(phic) * sc)[..., None] * ts2 + zc[..., None] * g.dir
    pdf_cone = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - g.cos_total),
                                     1e-9)
    # distant (distant.cpp Sample_Le): a point on a world-radius disk
    # outside the scene, the delta direction g.dir
    wr = scene.world_radius()
    wc = 0.5 * (scene.world_lo + scene.world_hi)
    td1, td2 = common.make_frame(g.dir)
    dk = concentric_sample_disk(u_pos)
    p_disk = wc[None, :] - g.dir * (2.0 * wr) \
        + (dk[..., 0:1] * td1 + dk[..., 1:2] * td2) * wr
    pdf_pos_disk = 1.0 / torch.clamp_min(math.pi * wr * wr, 1e-20)
    emits = is_area | is_point | is_spot

    # an infinite light (bdpt.cpp:95-141 with :123-133): a direction from
    # the map (InfiniteAreaLight::Sample_Le), an origin on a world-radius
    # disk beyond the scene, the ray along −direction
    is_inf = g.ltype == INFINITE
    has_inf = lights_mod._lt_present(lt, INFINITE)
    if has_inf:
        wc_b = wc.expand(R, 3)
        ls_env = lights_mod.sample_li(scene, light_idx, wc_b, u_dir)
        d_toward = ls_env["wi"]
        pdf_dir_env = ls_env["pdf"]
        le_env = ls_env["li"]
        te1, te2 = common.make_frame(d_toward)
        dk_e = concentric_sample_disk(u_pos)
        p_env = wc[None, :] + d_toward * (2.0 * wr) \
            + (dk_e[..., 0:1] * te1 + dk_e[..., 1:2] * te2) * wr
        emits = emits | (is_inf & (pdf_dir_env > 0))
    pt_or_spot = is_point | is_spot
    p_l = torch.where(is_dist[..., None], p_disk,
                      torch.where(pt_or_spot[..., None], g.pos, p_l))
    d_l = torch.where(is_dist[..., None], g.dir,
                      torch.where(is_spot[..., None], d_cone,
                                  torch.where(is_point[..., None], d_unif,
                                              d_l)))
    # a delta light's vertex "normal" is its emission direction (pbrt's
    # EndpointInteraction); a distant light's, the disk's normal g.dir
    n_l = torch.where((pt_or_spot | is_dist)[..., None], d_l, n_l)
    pdf_pos = torch.where(is_dist, pdf_pos_disk,
                          torch.where(pt_or_spot, 1.0, pdf_pos))
    pdf_dir = torch.where(is_dist, 1.0,
                          torch.where(is_spot, pdf_cone,
                                      torch.where(is_point,
                                                  1.0 / (4.0 * math.pi),
                                                  pdf_dir)))

    # the walk's throughput carries the emission along the sampled
    # direction (spot falloff, map, window); the vertex's beta does not:
    # an s = 1 connection evaluates the emission toward its own direction
    le_walk = g.emit * lights_mod.emission_scale(lt, g, d_l)
    v0_emit = g.emit
    if has_inf:
        p_l = torch.where(is_inf[..., None], p_env, p_l)
        d_l = torch.where(is_inf[..., None], -d_toward, d_l)
        n_l = torch.where(is_inf[..., None], -d_toward, n_l)
        pdf_pos = torch.where(is_inf, pdf_pos_disk, pdf_pos)
        pdf_dir = torch.where(is_inf, pdf_dir_env, pdf_dir)
        le_walk = torch.where(is_inf[..., None], le_env, le_walk)
        v0_emit = torch.where(is_inf[..., None], le_env, v0_emit)
    cos_term = torch.where(is_area, absdot(d_l, n_l), 1.0)
    beta0 = le_walk * (cos_term / torch.clamp_min(
        sel_pmf * pdf_pos * pdf_dir, 1e-20))[..., None]
    beta0 = torch.where(emits[..., None], beta0, 0.0)
    # vertex 0's forward density: selPmf / area, or for the environment
    # the solid-angle InfiniteLightDensity (bdpt.cpp:131-133)
    pdf_fwd0 = sel_pmf * pdf_pos
    if has_inf:
        pdf_fwd0 = torch.where(
            is_inf, sel_pmf * lights_mod.pdf_li(scene, light_idx, wc_b,
                                                d_toward), pdf_fwd0)
    sp.vtype[:, 0] = torch.where(emits, VT_LIGHT, VT_NONE)
    sp.p[:, 0] = p_l
    sp.ns[:, 0] = n_l
    sp.ng[:, 0] = n_l
    sp.beta[:, 0] = torch.where(
        emits[..., None],
        v0_emit / torch.clamp_min(sel_pmf * pdf_pos, 1e-20)[..., None], 0.0)
    sp.pdf_fwd[:, 0] = pdf_fwd0
    sp.light_id[:, 0] = light_idx
    o0 = torch.where(pt_or_spot[..., None], p_l,
                     vecmath.offset_ray_origin(p_l, n_l, d_l))
    _random_walk(scene, sp, o0, d_l, beta0, pdf_dir, 1, max_v - 1, pid, sidx,
                 sfn, seed, 220)
    if has_inf:
        # the first walk vertex's density from an infinite light
        # (bdpt.cpp:124-129): pdfPos·|cosθ| in area measure, replacing the
        # walk's direction → area conversion
        v1ok = is_inf & (sp.vtype[:, 1] == VT_SURFACE)
        fix1 = pdf_pos_disk * absdot(d_l, sp.ng[:, 1])
        sp.pdf_fwd[:, 1] = torch.where(v1ok, fix1, sp.pdf_fwd[:, 1])
    return sp


def _vertex_bsdf(scene, sp: Subpath, i: int):
    mp = mat_mod.gather_materials(scene.materials, sp.mat_id[:, i])
    t1, t2 = common.make_frame(sp.ns[:, i])
    return mp, t1, t2


def _vertex_f(scene, sp: Subpath, i: int, w_world):
    """BSDF f and pdf at vertex i toward the world direction w."""
    mp, t1, t2 = _vertex_bsdf(scene, sp, i)
    wo = common.to_local(t1, t2, sp.ns[:, i], sp.wo[:, i])
    wi = common.to_local(t1, t2, sp.ns[:, i], w_world)
    return mat_mod.bsdf_f(mp, wo, wi), mat_mod.bsdf_pdf(mp, wo, wi)


def _bsdf_pdf_dir(scene, sp: Subpath, i: int, wo_world, wi_world):
    """Directional BSDF pdf at vertex i for any wo / wi (world)."""
    mp, t1, t2 = _vertex_bsdf(scene, sp, i)
    wo = common.to_local(t1, t2, sp.ns[:, i], wo_world)
    wi = common.to_local(t1, t2, sp.ns[:, i], wi_world)
    return mat_mod.bsdf_pdf(mp, wo, wi)


def _emitter_term(scene, light_sp: Subpath, w, C):
    """The s = 1 endpoint's emission toward −w: an area light emits on
    its normal side unless two-sided, a delta-position light everywhere,
    spot, goniometric and projection lights scaled toward −w. Returns
    (term (R, C), the light rows, delta-position mask)."""
    g0 = lights_mod.gather_lights(scene.lights,
                                  light_sp.light_id[:, 0].clamp_min(0))
    is_del0 = _is_delta_position(g0.ltype)
    emit_ok = (torch.sum(light_sp.ng[:, 0] * -w, -1) > 0) \
        | g0.two_sided | is_del0
    scale0 = lights_mod.emission_scale(scene.lights, g0, -w)
    term = torch.where(emit_ok[..., None],
                       scale0 * torch.ones((w.shape[0], C), device=w.device),
                       0.0)
    return term, g0, is_del0


def connect_bdpt(scene, cam_sp: Subpath, light_sp: Subpath, s: int, t: int):
    """ConnectBDPT (bdpt.cpp:401+) for one strategy with t ≥ 2, s ≥ 1:
    the unweighted contribution (R, C) and its validity mask. s = 0
    (emission picked up by the camera walk) is the caller's."""
    C = cam_sp.beta.shape[-1]
    cv, lv = t - 1, s - 1
    pc = cam_sp.p[:, cv]
    pl = light_sp.p[:, lv]
    valid = (cam_sp.vtype[:, cv] == VT_SURFACE) \
        & (light_sp.vtype[:, lv] != VT_NONE) \
        & ~cam_sp.delta[:, cv] & ~light_sp.delta[:, lv]
    d = pl - pc
    dist2 = vecmath.length_squared(d)
    w = d * torch.rsqrt(torch.clamp_min(dist2, 1e-20))[..., None]
    f_c, _ = _vertex_f(scene, cam_sp, cv, w)
    if s == 1:
        # the emitter vertex itself: its beta carries Le/(selPmf·pdf_pos),
        # so the connection's light-side term is its emission toward the
        # camera vertex; a delta light has no surface, so no cosine
        f_light_term, g0, is_del0 = _emitter_term(scene, light_sp, w, C)
        cos_l = torch.where(is_del0, 1.0, absdot(light_sp.ns[:, 0], w))
        # an infinite light's s = 1 strategy is the environment NEE of
        # li_bdpt (pbrt reaches it through Sample_Li)
        valid = valid & (g0.ltype != INFINITE)
        is_dist0 = g0.ltype == DISTANT
        if lights_mod._lt_present(scene.lights, DISTANT):
            # a distant light: NEE along its delta direction, as
            # DistantLight::Sample_Li (wi = −dir, pdf 1); the shadow ray
            # must leave the scene. The caller sets its weight to 1
            w_d = -g0.dir
            f_cd, _ = _vertex_f(scene, cam_sp, cv, w_d)
            pl_far = pc + w_d * (2.2 * scene.world_radius())
            vis_d = isect_mod.unoccluded(scene, pc, cam_sp.ns[:, cv], pl_far)
            # selPmf of the uniform chooser is 1/n: divided back out
            contrib_dist = (cam_sp.beta[:, cv] * f_cd * g0.emit
                            * (absdot(cam_sp.ns[:, cv], w_d)
                               * scene.lights.n)[..., None])
            valid_dist = (cam_sp.vtype[:, cv] == VT_SURFACE) \
                & ~cam_sp.delta[:, cv] & vis_d \
                & (light_sp.light_id[:, 0] >= 0)
    else:
        f_light_term, _ = _vertex_f(scene, light_sp, lv, -w)
        cos_l = absdot(light_sp.ns[:, lv], w)

    geom = absdot(cam_sp.ns[:, cv], w) * cos_l / torch.clamp_min(dist2,
                                                                  1e-20)
    vis = isect_mod.unoccluded(scene, pc, cam_sp.ns[:, cv], pl)
    contrib = (cam_sp.beta[:, cv] * f_c * f_light_term
               * light_sp.beta[:, lv] * geom[..., None])
    valid = valid & vis & (geom > 0)
    contrib = torch.where(valid[..., None], contrib, 0.0)
    if s == 1 and lights_mod._lt_present(scene.lights, DISTANT):
        contrib = torch.where(is_dist0[..., None],
                              torch.where(valid_dist[..., None],
                                          contrib_dist, 0.0), contrib)
        valid = torch.where(is_dist0, valid_dist, valid)
    return contrib, valid


def _light_origin_pdfs(scene, light_id, ng, w_out):
    """(pdf_pos·selPmf, pdf_dir) of the light emitting at this vertex
    along w_out (Vertex::PdfLightOrigin / PdfLight): an area light
    1/area and the cosine hemisphere; a point light (0, 1/4π) and a spot
    light (0, its cone pdf), whose position is a delta distribution (so
    remap0 passes the term through, as {Point,Spot}Light::Pdf_Le); a
    distant light (1/(π·wr²), 0), whose direction is."""
    n = scene.lights.n
    g = lights_mod.gather_lights(scene.lights, light_id.clamp_min(0))
    ap = lights_mod.gather_area_prim(scene, g.prim_id)
    area = torch.where(
        ap.is_sph, 4.0 * math.pi * ap.radius * ap.radius,
        torch.where(ap.is_pln, shapes.aaplane_area(ap.lo, ap.hi, ap.ax),
                    shapes.triangle_area(ap.v0, ap.v1, ap.v2)))
    pdf_pos = 1.0 / torch.clamp_min(area, 1e-20) / n
    pdf_dir = torch.clamp_min(absdot(ng, w_out), 1e-6) * INV_PI
    is_point = (g.ltype == POINT) | (g.ltype == GONIO) \
        | (g.ltype == PROJECTION)
    is_spot = g.ltype == SPOT
    is_dist = g.ltype == DISTANT
    pdf_cone = torch.where(
        dot(w_out, g.dir) >= g.cos_total,
        1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - g.cos_total), 1e-9),
        0.0)
    pdf_dir = torch.where(is_point, 1.0 / (4.0 * math.pi),
                          torch.where(is_spot, pdf_cone,
                                      torch.where(is_dist, 0.0, pdf_dir)))
    wr = scene.world_radius()
    pdf_pos = torch.where(
        is_point | is_spot, 0.0,
        torch.where(is_dist,
                    1.0 / torch.clamp_min(math.pi * wr * wr, 1e-20) / n,
                    pdf_pos))
    ok = light_id >= 0
    return torch.where(ok, pdf_pos, 0.0), torch.where(ok, pdf_dir, 0.0)


def _is_env_start(scene, light_sp: Subpath):
    g = lights_mod.gather_lights(scene.lights,
                                 light_sp.light_id[:, 0].clamp_min(0))
    return (g.ltype == INFINITE) & (light_sp.light_id[:, 0] >= 0), g


def _light_side_sum(scene, light_sp: Subpath, lv: int, w, rev_lv, rev_lvm1,
                    weight_sum, phantom_s0: bool, delta_light):
    """The light-side hypothetical strategies (bdpt.cpp:382-395) added to
    ``weight_sum``. ``phantom_s0`` leaves out s' = 0, which cannot run at
    the strategy cap; ``delta_light`` (or None) suppresses the term below
    a delta-position light (bdpt.cpp:391)."""
    R = w.shape[0]
    is_env0, _ = _is_env_start(scene, light_sp)
    ri = torch.ones(R, device=w.device)
    for i in range(lv, -1, -1):
        rev = light_sp.pdf_rev[:, i]
        if i == lv:
            rev = rev_lv
        elif i == lv - 1 and rev_lvm1 is not None:
            rev = rev_lvm1
        if i == 0 and lv >= 1:
            # an environment endpoint's densities stay in solid angle
            # (ConvertDensity's infinite-light rule, bdpt.h:105-112),
            # toward the true direction, −ns[0] (the far-disk position
            # would add parallax and break the partition)
            wo_1 = -w if lv == 1 else light_sp.wo[:, 1]
            rev_sa = _bsdf_pdf_dir(scene, light_sp, 1, wo_1,
                                   -light_sp.ns[:, 0])
            rev = torch.where(is_env0, rev_sa, rev)
        ri = ri * _remap0(rev) / _remap0(light_sp.pdf_fwd[:, i])
        if i == 0 and phantom_s0:
            continue
        below = ~light_sp.delta[:, i - 1] if i >= 1 else (
            ~delta_light if delta_light is not None
            else torch.ones(R, dtype=torch.bool, device=w.device))
        not_delta = ~light_sp.delta[:, i] & below
        weight_sum = weight_sum + torch.where(not_delta, ri, 0.0)
    return weight_sum


def mis_weight(scene, cam_sp: Subpath, light_sp: Subpath, s: int, t: int,
               include_t1: bool = False):
    """The BDPT MIS weight (bdpt.cpp MISWeight:302-399): 1/(1 + Σ ri) with
    the four endpoint pdf_rev values recomputed for this connection (the
    ScopedAssignment overrides), delta vertices skipped. t' = 1 (light
    tracing) enters only when the splat pass runs it (``include_t1``)."""
    R = cam_sp.p.shape[0]
    dev = cam_sp.p.device
    cv, lv = t - 1, s - 1
    if s >= 1:
        w = normalize(light_sp.p[:, lv] - cam_sp.p[:, cv])

    # pdf_rev at the camera endpoint: the light side generating it
    if s == 0:
        rev_cv, _ = _light_origin_pdfs(scene, cam_sp.light_id[:, cv],
                                       cam_sp.ng[:, cv], cam_sp.wo[:, cv])
    elif s == 1:
        _, pdf_dir = _light_origin_pdfs(scene, light_sp.light_id[:, 0],
                                        light_sp.ng[:, 0], -w)
        rev_cv = _dir_pdf_to_area(pdf_dir, light_sp.p[:, 0],
                                  cam_sp.p[:, cv], cam_sp.ng[:, cv])
    else:
        pdf_dir = _bsdf_pdf_dir(scene, light_sp, lv, light_sp.wo[:, lv], -w)
        rev_cv = _dir_pdf_to_area(pdf_dir, light_sp.p[:, lv],
                                  cam_sp.p[:, cv], cam_sp.ng[:, cv])

    # pdf_rev at cam[cv-1]: cam[cv] scattering back with the new incoming
    # direction
    rev_cvm1 = None
    if t >= 3:
        back = normalize(cam_sp.p[:, cv - 1] - cam_sp.p[:, cv])
        if s == 0:
            _, pdf_dir_b = _light_origin_pdfs(
                scene, cam_sp.light_id[:, cv], cam_sp.ng[:, cv], back)
        else:
            pdf_dir_b = _bsdf_pdf_dir(scene, cam_sp, cv, w, back)
        rev_cvm1 = _dir_pdf_to_area(pdf_dir_b, cam_sp.p[:, cv],
                                    cam_sp.p[:, cv - 1],
                                    cam_sp.ng[:, cv - 1])

    # pdf_rev at the light endpoint and the vertex before it
    if s >= 1:
        pdf_dir_c = _bsdf_pdf_dir(scene, cam_sp, cv, cam_sp.wo[:, cv], w)
        rev_lv = _dir_pdf_to_area(pdf_dir_c, cam_sp.p[:, cv],
                                  light_sp.p[:, lv], light_sp.ng[:, lv])
    rev_lvm1 = None
    if s >= 2:
        pdf_dir_lb = _bsdf_pdf_dir(
            scene, light_sp, lv, -w,
            normalize(light_sp.p[:, lv - 1] - light_sp.p[:, lv]))
        rev_lvm1 = _dir_pdf_to_area(pdf_dir_lb, light_sp.p[:, lv],
                                    light_sp.p[:, lv - 1],
                                    light_sp.ng[:, lv - 1])

    # camera-side hypothetical strategies (bdpt.cpp:365-380): the term
    # added after index i is the t' = i strategy
    weight_sum = torch.ones(R, device=dev)
    ri = torch.ones(R, device=dev)
    min_t = 1 if include_t1 else 2
    for i in range(cv, 0, -1):
        rev = cam_sp.pdf_rev[:, i]
        if i == cv:
            rev = rev_cv
        elif i == cv - 1 and rev_cvm1 is not None:
            rev = rev_cvm1
        ri = ri * _remap0(rev) / _remap0(cam_sp.pdf_fwd[:, i])
        if i < min_t:
            continue
        not_delta = ~cam_sp.delta[:, i] & ~cam_sp.delta[:, i - 1]
        weight_sum = weight_sum + torch.where(not_delta, ri, 0.0)
    if s >= 1:
        _, g_l0 = _is_env_start(scene, light_sp)
        delta_light = _is_delta_position(g_l0.ltype) \
            & (light_sp.light_id[:, 0] >= 0)
        # s' = 0 for a (max_v + 1)-vertex path would need a camera
        # subpath of max_v + 1 slots: at the cap it is a phantom
        weight_sum = _light_side_sum(
            scene, light_sp, lv, w, rev_lv, rev_lvm1, weight_sum,
            s + t == cam_sp.p.shape[1] + 1, delta_light)
    return 1.0 / weight_sum


def _env_weight_common(cam_sp: Subpath, cv: int, rev_cv, fwd_cv, rev_cvm1,
                       include_t1: bool, cv_is_env: bool):
    """The camera-side sum shared by the environment escape (s = 0) and
    environment NEE (s = 1) weights; rev_cv / fwd_cv override slot cv,
    rev_cvm1 (or None) slot cv − 1; ``cv_is_env``: slot cv is the
    endpoint at infinity (not delta, fwd in solid angle)."""
    R = cam_sp.p.shape[0]
    dev = cam_sp.p.device
    weight_sum = torch.ones(R, device=dev)
    ri = torch.ones(R, device=dev)
    min_t = 1 if include_t1 else 2
    for i in range(cv, 0, -1):
        rev = cam_sp.pdf_rev[:, i]
        fwd = cam_sp.pdf_fwd[:, i]
        if i == cv:
            rev, fwd = rev_cv, fwd_cv
        elif i == cv - 1 and rev_cvm1 is not None:
            rev = rev_cvm1
        ri = ri * _remap0(rev) / _remap0(fwd)
        if i < min_t:
            continue
        di = (torch.zeros(R, dtype=torch.bool, device=dev)
              if cv_is_env and i == cv else cam_sp.delta[:, i])
        not_delta = ~di & ~cam_sp.delta[:, i - 1]
        weight_sum = weight_sum + torch.where(not_delta, ri, 0.0)
    return weight_sum


def _mis_weight_env_escape(scene, cam_sp: Subpath, t: int, env_idx,
                           pmf_env: float, include_t1: bool):
    """The weight of the escaped camera path (pbrt's s = 0 with an
    infinite-light endpoint: PdfLightOrigin = InfiniteLightDensity,
    PdfLight = |cos|/(π·wr²); endpoint densities in solid angle,
    bdpt.h:105-123)."""
    cv = t - 1
    d_esc = cam_sp.esc_d[:, cv]
    wr = scene.world_radius()
    rev_cv = pmf_env * lights_mod.pdf_li(scene, env_idx, cam_sp.p[:, cv - 1],
                                         d_esc)
    rev_cvm1 = None
    if t >= 3:
        rev_cvm1 = (1.0 / torch.clamp_min(math.pi * wr * wr, 1e-20)) \
            * absdot(cam_sp.ng[:, cv - 1], d_esc)
    return 1.0 / _env_weight_common(cam_sp, cv, rev_cv, cam_sp.esc_pdf[:, cv],
                                    rev_cvm1, include_t1, cv_is_env=True)


def _mis_weight_env_nee(scene, cam_sp: Subpath, t: int, wi_e, pdf_e_sa,
                        include_t1: bool):
    """The weight of the environment NEE at camera vertex cv (pbrt's
    s = 1 with a map-sampled infinite-light vertex): the light-side term
    (s' = 0, the camera escape) compares the vertex's solid-angle BSDF pdf
    toward the environment with the NEE's solid-angle density."""
    cv = t - 1
    wr = scene.world_radius()
    rev_cv = (1.0 / torch.clamp_min(math.pi * wr * wr, 1e-20)) \
        * absdot(cam_sp.ng[:, cv], wi_e)
    rev_cvm1 = None
    if t >= 3:
        pdf_dir_b = _bsdf_pdf_dir(
            scene, cam_sp, cv, wi_e,
            normalize(cam_sp.p[:, cv - 1] - cam_sp.p[:, cv]))
        rev_cvm1 = _dir_pdf_to_area(pdf_dir_b, cam_sp.p[:, cv],
                                    cam_sp.p[:, cv - 1],
                                    cam_sp.ng[:, cv - 1])
    weight_sum = _env_weight_common(cam_sp, cv, rev_cv, cam_sp.pdf_fwd[:, cv],
                                    rev_cvm1, include_t1, cv_is_env=False)
    if t < cam_sp.p.shape[1]:
        # s' = 0 (the escape) needs t + 1 camera slots: a phantom at the
        # cap
        rev_lv_sa = _bsdf_pdf_dir(scene, cam_sp, cv, cam_sp.wo[:, cv], wi_e)
        ri_l = _remap0(rev_lv_sa) / _remap0(pdf_e_sa)
        weight_sum = weight_sum + torch.where(~cam_sp.delta[:, cv], ri_l,
                                              0.0)
    return 1.0 / weight_sum


def _li_bdpt_impl(scene, o, d, pid, sidx, sfn, cfg, include_t1, cam=None):
    max_v = max_vertices(cfg.max_depth)
    cam_sp = generate_camera_subpath(scene, o, d, max_v, pid, sidx, sfn,
                                     cfg.seed, cam=cam)
    light_sp = generate_light_subpath(scene, max_v, pid, sidx, sfn, cfg.seed)
    R, C = o.shape[0], scene.n_channels
    dev = o.device
    L = torch.zeros((R, C), device=dev)

    # s = 0: the camera walk hits an emitter
    for t in range(2, max_v + 1):
        cv = t - 1
        lid = cam_sp.light_id[:, cv]
        ok = (cam_sp.vtype[:, cv] == VT_SURFACE) & (lid >= 0)
        g = lights_mod.gather_lights(scene.lights, lid.clamp_min(0))
        le = lights_mod.area_light_L(g.emit, g.two_sided, cam_sp.ng[:, cv],
                                     cam_sp.wo[:, cv])
        w = mis_weight(scene, cam_sp, light_sp, 0, t, include_t1=include_t1)
        # beta at cv is the throughput up to cv, without cv's own BSDF
        L = L + torch.where(ok[..., None],
                            cam_sp.beta[:, cv] * le * w[..., None], 0.0)

    # connections, s ≥ 1, t ≥ 2, under pbrt's cap (bdpt.cpp:382: a
    # strategy's path has at most max_v = maxDepth + 2 vertices)
    for t in range(2, max_v + 1):
        for s in range(1, max_v + 1):
            if s + t > max_v:
                continue
            contrib, _ = connect_bdpt(scene, cam_sp, light_sp, s, t)
            w = mis_weight(scene, cam_sp, light_sp, s, t,
                           include_t1=include_t1)
            if s == 1:
                # a distant light's s = 1 is a delta-direction strategy,
                # the only one for its paths: weight 1
                g0 = lights_mod.gather_lights(
                    scene.lights, light_sp.light_id[:, 0].clamp_min(0))
                w = torch.where(g0.ltype == DISTANT, 1.0, w)
            L = L + contrib * w[..., None]

    # the infinite light's paths: the camera escape (s = 0), the
    # environment NEE (s = 1, by Sample_Li as pbrt's ConnectBDPT s == 1),
    # s ≥ 2 connections from environment walks (above) and t = 1 splats,
    # under one MIS accounting with solid-angle endpoint densities
    if lights_mod._lt_present(scene.lights, INFINITE):
        ltypes = scene.lights.ltype
        env_row = torch.argmax((ltypes == INFINITE).to(torch.int32))
        pmf_env = 1.0 / scene.lights.n     # the uniform chooser's pmf
        env_idx = env_row.to(torch.int32).expand(R)
        inf = torch.full((R,), vecmath.INF, device=dev)
        for t in range(2, max_v + 1):
            cv = t - 1
            esc = cam_sp.esc[:, cv]
            d_esc = cam_sp.esc_d[:, cv]
            le = lights_mod.escaped_radiance(scene, d_esc)
            if t == 2:
                # the camera ray escaped directly: the only strategy for
                # a path without surface vertices, weight 1
                w_esc = torch.ones(R, device=dev)
            else:
                w_esc = _mis_weight_env_escape(scene, cam_sp, t, env_idx,
                                               pmf_env, include_t1)
            L = L + torch.where(esc[..., None],
                                cam_sp.esc_beta[:, cv] * le
                                * w_esc[..., None], 0.0)
            # the environment NEE at surface vertex cv, for t ≤ max_v − 1
            # (its path has t + 1 vertices)
            if t >= max_v:
                continue
            vok = cam_sp.vtype[:, cv] == VT_SURFACE
            u_env = torch.stack([sfn(pid, sidx, 300 + 2 * t, cfg.seed),
                                 sfn(pid, sidx, 301 + 2 * t, cfg.seed)], -1)
            ls = lights_mod.sample_li(scene, env_idx, cam_sp.p[:, cv], u_env)
            wi_e = ls["wi"]
            pdf_e = ls["pdf"] * pmf_env
            f_e, _ = _vertex_f(scene, cam_sp, cv, wi_e)
            hit_e = isect_mod.intersect(
                scene, vecmath.offset_ray_origin(cam_sp.p[:, cv],
                                                 cam_sp.ng[:, cv], wi_e),
                wi_e, inf, surface_only=True)
            w_nee = _mis_weight_env_nee(scene, cam_sp, t, wi_e, pdf_e,
                                        include_t1)
            cos_e = absdot(wi_e, cam_sp.ns[:, cv])
            good = vok & ~hit_e.valid & (pdf_e > 1e-12)
            L = L + torch.where(
                good[..., None],
                cam_sp.beta[:, cv] * f_e * ls["li"]
                * (cos_e * w_nee / torch.clamp_min(pdf_e, 1e-20))[..., None],
                0.0)
    return L


def li_bdpt(scene, o, d, pid, sidx, sfn, cfg, power_distr, cam=None):
    """The BDPT estimator over the strategies with t ≥ 2 (the camera
    connected); the t = 1 splats are ``render_bdpt``'s."""
    return _li_bdpt_impl(scene, o, d, pid, sidx, sfn, cfg, False, cam=cam)


def li_bdpt_t1(scene, o, d, pid, sidx, sfn, cfg, power_distr, cam=None):
    """The camera-side strategies with t' = 1 in their MIS weights, for
    use with ``light_splat_pass`` (``render_bdpt``)."""
    return _li_bdpt_impl(scene, o, d, pid, sidx, sfn, cfg, True, cam=cam)


# ---------------------------------------------------------------------------
# t = 1 light-tracing splats and the whole BDPT render (bdpt.cpp's t == 1
# strategy and Film::AddSplat, film.h:83-87)
# ---------------------------------------------------------------------------

def _mis_weight_t1(scene, cam, light_sp: Subpath, s: int, p_cam):
    """The weight of the (s, t = 1) strategy: light-side hypothetical
    strategies only, with the camera's directional density at
    light_sp[s-1] and that vertex's backward BSDF pdf as the endpoint
    overrides."""
    R = light_sp.p.shape[0]
    lv = s - 1
    w = normalize(light_sp.p[:, lv] - p_cam)      # camera → vertex
    pdf_dir_c = cam_mod.camera_pdf_dir(cam, w)
    rev_lv = _dir_pdf_to_area(pdf_dir_c, p_cam, light_sp.p[:, lv],
                              light_sp.ng[:, lv])
    rev_lvm1 = None
    if s >= 2:
        pdf_dir_lb = _bsdf_pdf_dir(
            scene, light_sp, lv, -w,
            normalize(light_sp.p[:, lv - 1] - light_sp.p[:, lv]))
        rev_lvm1 = _dir_pdf_to_area(pdf_dir_lb, light_sp.p[:, lv],
                                    light_sp.p[:, lv - 1],
                                    light_sp.ng[:, lv - 1])
    # s' = 0 (a full camera walk of s + 1 slots) cannot run at the cap
    return 1.0 / _light_side_sum(
        scene, light_sp, lv, w, rev_lv, rev_lvm1,
        torch.ones(R, device=w.device), s == light_sp.p.shape[1], None)


def light_splat_pass(scene, cam, n_paths: int, chunk_it: int, seed: int,
                     max_v: int, width: int, height: int):
    """One pass of the t = 1 strategies: ``n_paths`` light subpaths, each
    vertex connected to the pinhole (the lens centre) and splatted at its
    raster position. The paths are keyed by path id 2^26 + i and the
    chunk's ordinal ``chunk_it``, with the independent sampler, as
    pbrt_tpu keys them. Returns the (H, W, C) sum."""
    C = scene.n_channels
    dev = scene.world_lo.device
    pid = torch.arange(n_paths, dtype=torch.int64, device=dev) \
        + SPLAT_PID_BASE
    sidx = torch.full((n_paths,), int(chunk_it), dtype=torch.int64,
                      device=dev)
    sfn = make_sampler("independent")
    light_sp = generate_light_subpath(scene, max_v, pid, sidx, sfn, seed)
    p_cam = cam.cam_to_world.apply_point(torch.zeros((1, 3), device=dev))[0]
    p_cam_b = p_cam.expand(n_paths, 3)

    film = torch.zeros((height, width, C), device=dev)
    # s ≤ max_v − 1: an (s, t = 1) path has s + 1 vertices
    for s in range(1, max_v):
        lv = s - 1
        valid = light_sp.vtype[:, lv] != VT_NONE
        d = light_sp.p[:, lv] - p_cam_b
        dist2 = vecmath.length_squared(d)
        w = normalize(d)      # camera → vertex
        we, p_raster, cam_ok = cam_mod.camera_we(cam, p_cam_b, w)
        if s == 1:
            f_term, g0, _ = _emitter_term(scene, light_sp, w, C)
            # an environment's far-disk vertex does not splat directly:
            # the camera escape at t = 2 owns that path with weight 1
            not_spec = g0.ltype != INFINITE
        else:
            f_term, _ = _vertex_f(scene, light_sp, lv, -w)
            not_spec = ~light_sp.delta[:, lv]
        cos_v = absdot(light_sp.ns[:, lv], w)
        vis = isect_mod.unoccluded(scene, light_sp.p[:, lv],
                                   light_sp.ns[:, lv], p_cam_b)
        contrib = (light_sp.beta[:, lv] * f_term
                   * (we * cos_v / torch.clamp_min(dist2, 1e-12))[..., None])
        contrib = contrib * _mis_weight_t1(scene, cam, light_sp, s,
                                           p_cam_b)[..., None]
        ok = valid & cam_ok & vis & not_spec
        film = film_mod.splat(film, p_raster, contrib, ok)
    return film


def default_chunk_spp(device, width: int, height: int, spp: int) -> int:
    """pbrt_tpu's chunk (samples per pixel of a pass): 65,536 lanes on its
    CPU backend, 2,000,000 on an accelerator. The splat pass keys its
    paths by the chunk's ordinal, so two renders draw the same samples
    only at the same chunk."""
    target = 65_536 if torch.device(device).type == "cpu" else 2_000_000
    return max(1, min(spp, target // (width * height)))


def render_bdpt(scene, cam, spp: int = 16, max_depth: int = 5,
                seed: int = 0, chunk_spp: int | None = None, progress=None,
                device="cuda"):
    """The whole BDPT (the camera strategies and the t = 1 light-tracing
    splats, with MIS weights that count each other): (H, W, C). Each
    chunk of ``chunk_spp`` samples per pixel (``default_chunk_spp`` for
    the device when None) is one ``bdpt_t1`` camera pass plus one splat
    pass of as many light paths. The perspective camera only (the
    others raise)."""
    from pbrt_tpu_torch.integrators import render as render_mod
    from pbrt_tpu_torch.scene.types import require_device, to_device

    device = require_device(device)
    scene = to_device(scene, device)
    cam = to_device(cam, device)
    cam_mod._perspective_only(cam, "bdpt's importance")
    width, height = cam.resolution
    filt = film_mod.make_filter("box", device=device)
    cfg = render_mod.RenderConfig(integrator="bdpt_t1", max_depth=max_depth,
                                  seed=seed)
    chunk = chunk_spp or default_chunk_spp(device, width, height, spp)
    max_v = max_vertices(max_depth)
    img = torch.zeros((height, width, scene.n_channels), device=device)
    done = it = 0
    while done < spp:
        c = min(chunk, spp - done)
        cam_part = render_mod.render_pass(scene, cam, filt, cfg, width,
                                          height, c, done, device)
        splat_part = light_splat_pass(scene, cam, width * height * c, it,
                                      seed, max_v, width, height)
        if c == chunk:
            img = img + (cam_part + splat_part)
        else:   # pbrt_tpu's short last chunk adds the two in turn
            img = img + cam_part
            img = img + splat_part
        done += c
        it += 1
        if progress is not None:
            progress.update(c)
    if progress is not None:
        progress.finish()
    return img / spp
