"""Stochastic progressive photon mapping (port of
pbrt_tpu/integrators/sppm.py).

Counterpart of ``integrators/sppm.cpp`` (:63-98): each iteration a camera
pass stores one visible point per pixel at its first diffuse vertex, with
the emitted and directly lit radiance on the way; the visible points go
into a uniform grid (each into the 8 cells its radius box touches, the
cell at least as large as the largest radius); the photon pass walks
light paths and, from the second vertex on, deposits flux onto the
visible points of each photon's cell within their radius; the pixels'
radius and flux shrink by the SPPM update (alpha = 2/3).

pbrt's lock-free grid becomes, as in pbrt_tpu, the entries sorted by
cell (stably: a cell's entries in visible-point order) and two binary
searches per photon. pbrt_tpu scans a fixed ``max_per_cell`` entries from
the photon's first one in a loop; the port enumerates the same (photon,
entry) pairs at once, in chunks of at most 2^23 pairs (2^20 on the CPU), and
evaluates the BSDF only on the pairs within the radius. Each pair's
contribution is the one pbrt_tpu computes; the sum over pairs runs in
another order (``index_add_``), so the flux agrees to float rounding and
the photon counts exactly. ``max_per_cell`` is pbrt_tpu's: the exact
largest cell occupancy, found on the host each iteration and rounded up
to a power of two, so no entry is skipped (the overflow counter stays 0).
As in pbrt_tpu, a photon in the last occupied cell of the sorted entries
re-reads that cell's last entry once for each scan slot past its own
entries (pbrt_tpu clips the scan index to the table); that only happens
when every pixel has a visible point (ROADMAP queue 3).

Every closest-hit query (camera pass, NEE and photon walk) goes through
scene/intersect.py: kernel 2, or kernel 3 with kernel 2 under a BVH. The
queries of one iteration are fixed by the scene (``queries_per_iteration``).
The visible points read the material rows' own kd, and the passes ignore
the rays' shutter times, as pbrt_tpu's do.

As in pbrt_tpu, the BSDFs here take ``make_frame``'s frame and no
fiber offset or Fourier tables: a HAIR row is evaluated at h = 0, its
frame not along the fiber, and a FOURIER row is black (ROADMAP queue
3).
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from pbrt_tpu_torch.core import vecmath
from pbrt_tpu_torch.core.sampling import (INV_PI, concentric_sample_disk,
                                          cosine_sample_hemisphere,
                                          sample_distribution_2d,
                                          uniform_sample_sphere)
from pbrt_tpu_torch.core.vecmath import absdot
from pbrt_tpu_torch.integrators import common
from pbrt_tpu_torch.samplers import make_sampler
from pbrt_tpu_torch.scene import camera as cam_mod
from pbrt_tpu_torch.scene import intersect as isect_mod
from pbrt_tpu_torch.scene import lights as lights_mod
from pbrt_tpu_torch.scene import materials as mat_mod
from pbrt_tpu_torch.scene import shapes
from pbrt_tpu_torch.scene.types import require_device, to_device
from pbrt_tpu_torch.utils import stats as stats_mod

GRID_RES = 64          # at most 64 cells an axis
SPPM_ALPHA = 2.0 / 3.0
PHOTON_PID_BASE = 1 << 24   # the photons' sample keys start here
# a photon's scan of a cell's entries when the caller gives no bound
# (``render_sppm`` passes ``needed_capacity``'s)
MAX_PER_CELL = 32
_DIFFUSE = (mat_mod.MATTE, mat_mod.PLASTIC, mat_mod.SUBSTRATE, mat_mod.UBER,
            mat_mod.TRANSLUCENT)
_SENTINEL = 2 ** 30    # the cell of an invalid visible point's entries


def queries_per_iteration(max_depth: int, lights) -> int:
    """Closest-hit queries of one iteration, from the loops below: each
    camera-pass bounce's trace and its NEE trace, plus the NEE's
    BSDF-strategy trace where ``lights`` has a light that takes it
    (``lights.takes_bsdf_half``), and each photon bounce's trace. Under a
    BVH each query launches the traversal kernel, and the brute-force
    kernel too where the scene has spheres or aaplanes."""
    per_bounce = 2 + int(lights_mod.takes_bsdf_half(lights))
    return max_depth * per_bounce + max_depth


def _pair_chunk(device) -> int:
    """(photon, entry) pairs a deposit step evaluates at once."""
    return 1 << 23 if torch.device(device).type == "cuda" else 1 << 20


# ---------------------------------------------------------------------------
# the camera pass: one visible point per pixel
# ---------------------------------------------------------------------------

def camera_pass(scene, cam, width, height, it, seed, max_depth, device):
    """One camera path per pixel to its first diffuse vertex, with the
    emitted and direct radiance on the way (sppm.cpp's camera pass). The
    pixel's sample index is the iteration. Returns the visible points:
    valid, p, ns, wo, beta, mat and L_direct."""
    R = width * height
    C = scene.n_channels
    pid = torch.arange(R, dtype=torch.int64, device=device)
    sfn = make_sampler("independent")
    sidx = torch.full((R,), it, dtype=torch.int64, device=device)
    px = (pid % width).to(torch.float32)
    py = (pid // width).to(torch.float32)

    def u2(d0, d1):
        return torch.stack([sfn(pid, sidx, d0, seed),
                            sfn(pid, sidx, d1, seed)], -1)
    p_film = torch.stack([px + 0.5, py + 0.5], -1) + (u2(0, 1) - 0.5)
    rays = cam_mod.generate_rays(cam, p_film,
                                 torch.zeros((R, 2), device=device),
                                 torch.zeros(R, device=device))
    o_cur, d_cur = rays.o, rays.d
    f3 = torch.zeros((R, 3), device=device)
    beta = torch.ones((R, C), device=device)
    L_direct = torch.zeros((R, C), device=device)
    vp = dict(valid=torch.zeros(R, dtype=torch.bool, device=device),
              p=f3, ns=f3, wo=f3, beta=torch.zeros((R, C), device=device),
              mat=torch.zeros(R, dtype=torch.int32, device=device))
    active = torch.ones(R, dtype=torch.bool, device=device)
    specular = torch.ones(R, dtype=torch.bool, device=device)
    inf = torch.full((R,), vecmath.INF, device=device)

    for b in range(max_depth):
        hit = isect_mod.intersect(scene, o_cur, d_cur, inf)
        light_id = torch.where(hit.valid, scene.light_at(hit.prim_id), -1)
        gl = lights_mod.gather_lights(scene.lights, light_id.clamp_min(0))
        le = lights_mod.area_light_L(gl.emit, gl.two_sided, hit.ng, -d_cur)
        le = torch.where((light_id >= 0)[..., None], le, 0.0)
        env = lights_mod.escaped_radiance(scene, d_cur)
        emit = torch.where(hit.valid[..., None], le, env)
        L_direct = L_direct + torch.where((active & specular)[..., None],
                                          beta * emit, 0.0)
        active = active & hit.valid
        mat_id = scene.mat_at(hit.prim_id)
        mp = mat_mod.gather_materials(scene.materials, mat_id)
        # NEE at every vertex (sppm.cpp's direct lighting at the visible
        # points and on the specular chain before them)
        ld = common.estimate_direct(scene, hit, mp, -d_cur,
                                    sfn(pid, sidx, 10 + 8 * b, seed),
                                    u2(11 + 8 * b, 12 + 8 * b),
                                    u2(13 + 8 * b, 14 + 8 * b),
                                    sfn(pid, sidx, 15 + 8 * b, seed))
        L_direct = L_direct + torch.where(active[..., None], beta * ld, 0.0)

        # the visible point at the first diffuse vertex
        is_diffuse = torch.zeros_like(active)
        for t in _DIFFUSE:
            is_diffuse = is_diffuse | (mp.mtype == t)
        newly = active & is_diffuse & ~vp["valid"]
        vp["valid"] = vp["valid"] | newly
        for key, val in (("p", hit.p), ("ns", hit.ns), ("wo", -d_cur),
                         ("beta", beta)):
            vp[key] = torch.where(newly[..., None], val, vp[key])
        vp["mat"] = torch.where(newly, mat_id, vp["mat"])
        active = active & ~newly

        # the specular continuation only
        t1, t2 = common.make_frame(hit.ns)
        wo = common.to_local(t1, t2, hit.ns, -d_cur)
        wi_loc, f, pdf, flags = mat_mod.bsdf_sample(
            mp, wo, sfn(pid, sidx, 16 + 8 * b, seed),
            u2(17 + 8 * b, 18 + 8 * b))
        wi = common.to_world(t1, t2, hit.ns, wi_loc)
        is_spec = (flags & mat_mod.FLAG_SPECULAR) > 0
        alive = active & is_spec & (pdf > 0)
        thr = f * (absdot(wi, hit.ns) / torch.clamp_min(pdf, 1e-20))[..., None]
        beta = torch.where(alive[..., None], beta * thr, beta)
        o_cur = torch.where(alive[..., None],
                            vecmath.offset_ray_origin(hit.p, hit.ng, wi),
                            o_cur)
        d_cur = torch.where(alive[..., None], wi, d_cur)
        specular = specular | alive
        active = alive
    vp["L_direct"] = L_direct
    return vp


# ---------------------------------------------------------------------------
# the grid of visible points
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Grid:
    lo: torch.Tensor          # (3,) the world bounds' low corner
    cell: torch.Tensor        # () cell size
    res: torch.Tensor         # (3,) int64 cells an axis
    entry_cell: torch.Tensor  # (8R,) int64 sorted cell ids
    entry_vp: torch.Tensor    # (8R,) int64 their visible points


def _corner_offsets(device):
    """The 8 corners of a radius box, in pbrt_tpu's (dx, dy, dz) order."""
    return torch.tensor([[dx, dy, dz] for dx in (0, 1) for dy in (0, 1)
                         for dz in (0, 1)], dtype=torch.float32,
                        device=device) * 2.0 - 1.0


def cell_id(p, grid: Grid):
    """The grid cell of points p (..., 3): truncated toward zero, then
    clipped into the grid, as pbrt_tpu's cell_id."""
    c = ((p - grid.lo) / grid.cell).to(torch.int32).to(torch.int64)
    c = torch.minimum(torch.clamp_min(c, 0), grid.res - 1)
    return (c[..., 0] * grid.res[1] + c[..., 1]) * grid.res[2] + c[..., 2]


def build_grid(vps, radius, grid_lo, grid_hi) -> Grid:
    """Insert each valid visible point into the 8 cells its radius box
    touches. The cell size is max(extent / GRID_RES, the largest radius),
    so the 8 corners cover every cell the box overlaps; the entries are
    sorted by cell, stably (ties in insertion order), an invalid point's
    after every cell."""
    dev = radius.device
    max_r = torch.where(vps["valid"], radius, 0.0).amax()
    ext = grid_hi - grid_lo
    cell = torch.maximum(ext.amax() / GRID_RES, max_r)
    res = torch.clamp((ext / cell).to(torch.int32).to(torch.int64), 1,
                      GRID_RES)
    g = Grid(lo=grid_lo, cell=cell, res=res, entry_cell=None, entry_vp=None)
    off = _corner_offsets(dev)
    corners = vps["p"][:, None, :] + off[None] * radius[:, None, None]
    ec = cell_id(corners, g).reshape(-1)                    # (8R,)
    R = radius.shape[0]
    ec = torch.where(vps["valid"].repeat_interleave(8), ec, _SENTINEL)
    order = torch.sort(ec, stable=True).indices
    ev = torch.arange(R, device=dev).repeat_interleave(8)
    return dataclasses.replace(g, entry_cell=ec[order], entry_vp=ev[order])


def needed_capacity(vps, radius, grid_lo, grid_hi) -> int:
    """The largest number of entries of one cell, on the host (numpy, as
    pbrt_tpu's render_sppm computes it), rounded up to a power of two
    (at least 8)."""
    valid = vps["valid"].cpu().numpy()
    if not valid.any():
        return 8
    p = vps["p"].cpu().numpy()
    r = radius.cpu().numpy()
    lo = grid_lo.cpu().numpy()
    hi = grid_hi.cpu().numpy()
    max_r = float(r[valid].max())
    cell = max(float((hi - lo).max()) / GRID_RES, max_r)
    res3 = np.clip(((hi - lo) / cell).astype(np.int64), 1, GRID_RES)
    ids = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                off = np.asarray([dx, dy, dz], np.float32)
                q = p + (off * 2.0 - 1.0) * r[:, None]
                c = np.clip(((q - lo) / cell).astype(np.int64), 0, res3 - 1)
                ids.append((c[:, 0] * res3[1] + c[:, 1]) * res3[2]
                           + c[:, 2])
    ids = np.concatenate([i[valid] for i in ids])
    need = int(np.bincount(ids).max())
    return max(8, 1 << int(np.ceil(np.log2(max(need, 1)))))


# ---------------------------------------------------------------------------
# the photon pass
# ---------------------------------------------------------------------------

def emit_photons(scene, n_photons, it, seed, device):
    """Photon origins, directions and weights (sppm.cpp's Sample_Le for
    every light type): area lights on triangles, aaplanes and spheres
    cosine-weighted from a uniform surface point, point, goniometric and
    projection lights uniformly over the sphere, spot lights uniformly in
    their cone, a distant light from a world-radius disk outside the scene
    along its direction, an infinite light along a direction from its map
    from a disk beyond the scene. Returns (o, d, beta, active)."""
    P = n_photons
    ppid = torch.arange(P, dtype=torch.int64, device=device) \
        + PHOTON_PID_BASE
    sidx = torch.full((P,), it, dtype=torch.int64, device=device)
    sfn = make_sampler("independent")
    lt = scene.lights

    def u2(d0, d1):
        return torch.stack([sfn(ppid, sidx, d0, seed),
                            sfn(ppid, sidx, d1, seed)], -1)
    light_idx, sel_pmf = common.choose_light(scene, sfn(ppid, sidx, 300,
                                                        seed), None)
    g = lights_mod.gather_lights(lt, light_idx)
    ap = lights_mod.gather_area_prim(scene, g.prim_id)
    u_pos = u2(301, 302)
    p_tri, n_tri, ip_tri = shapes.sample_triangle(ap.v0, ap.v1, ap.v2, u_pos)
    p_pln, n_pln, ip_pln = shapes.sample_aaplane(ap.lo, ap.hi, ap.ax,
                                                 ap.facing, u_pos)
    # a sphere light: a uniform point on its area (sphere.cpp Sample)
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
    is_area = g.ltype == lights_mod.AREA
    is_point = (g.ltype == lights_mod.POINT) | (g.ltype == lights_mod.GONIO) \
        | (g.ltype == lights_mod.PROJECTION)
    is_spot = g.ltype == lights_mod.SPOT
    is_dist = g.ltype == lights_mod.DISTANT
    is_inf = g.ltype == lights_mod.INFINITE
    u_dir = u2(303, 304)
    d_loc = cosine_sample_hemisphere(u_dir)
    t1, t2 = common.make_frame(n_l)
    d_l = common.to_world(t1, t2, n_l, d_loc)
    pdf_dir = torch.clamp_min(d_loc[..., 2], 1e-6) * INV_PI

    d_unif = uniform_sample_sphere(u_dir)                  # point
    zc = 1.0 + u_dir[..., 1] * (g.cos_total - 1.0)         # spot cone
    sc = torch.sqrt(torch.clamp_min(1.0 - zc * zc, 0.0))
    phic = 2.0 * math.pi * u_dir[..., 0]
    ts1, ts2 = common.make_frame(g.dir)
    d_cone = (torch.cos(phic) * sc)[..., None] * ts1 \
        + (torch.sin(phic) * sc)[..., None] * ts2 + zc[..., None] * g.dir
    pdf_cone = 1.0 / torch.clamp_min(2.0 * math.pi * (1.0 - g.cos_total),
                                     1e-9)
    wr = scene.world_radius()
    wc = 0.5 * (scene.world_lo + scene.world_hi)
    dk = concentric_sample_disk(u_pos)
    pdf_disk = 1.0 / torch.clamp_min(math.pi * wr * wr, 1e-20)
    # distant: a disk outside the scene, the delta direction
    td1, td2 = common.make_frame(g.dir)
    p_disk_dist = wc[None, :] - g.dir * (2.0 * wr) \
        + (dk[..., 0:1] * td1 + dk[..., 1:2] * td2) * wr
    if lights_mod._lt_present(lt, lights_mod.INFINITE):
        # infinite: a direction from the map into the scene, from a disk
        # beyond it (infinite.cpp Sample_Le)
        uv_e, pdf_uv_e = sample_distribution_2d(lt.env_distr, u_dir)
        th_e = uv_e[..., 1] * math.pi
        ph_e = uv_e[..., 0] * 2.0 * math.pi
        sin_e = torch.sin(th_e)
        w_env = torch.stack([sin_e * torch.cos(ph_e), torch.cos(th_e),
                             sin_e * torch.sin(ph_e)], -1)
        d_env = -w_env
        pdf_env_dir = pdf_uv_e / torch.clamp_min(
            2.0 * math.pi * math.pi * sin_e, 1e-9)
        le_env = lights_mod.env_radiance(lt, w_env) * g.emit
        te1, te2 = common.make_frame(d_env)
        p_disk_env = wc[None, :] + w_env * (2.0 * wr) \
            + (dk[..., 0:1] * te1 + dk[..., 1:2] * te2) * wr
    else:
        d_env = d_l
        pdf_env_dir = torch.ones_like(pdf_dir)
        le_env = torch.zeros_like(g.emit)
        p_disk_env = p_l

    emits = is_area | is_point | is_spot | is_dist | is_inf
    pt_or_spot = is_point | is_spot
    p_l = torch.where(is_dist[..., None], p_disk_dist,
                      torch.where(is_inf[..., None], p_disk_env,
                                  torch.where(pt_or_spot[..., None], g.pos,
                                              p_l)))
    d_l = torch.where(is_dist[..., None], g.dir,
                      torch.where(is_inf[..., None], d_env,
                                  torch.where(is_spot[..., None], d_cone,
                                              torch.where(is_point[..., None],
                                                          d_unif, d_l))))
    n_l = torch.where((~is_area)[..., None], d_l, n_l)
    pdf_pos = torch.where(is_dist | is_inf, pdf_disk,
                          torch.where(pt_or_spot, 1.0, pdf_pos))
    pdf_dir = torch.where(is_dist, 1.0,
                          torch.where(is_inf, pdf_env_dir,
                                      torch.where(is_spot, pdf_cone,
                                                  torch.where(
                                                      is_point,
                                                      1.0 / (4 * math.pi),
                                                      pdf_dir))))
    Le = g.emit * lights_mod.emission_scale(lt, g, d_l)
    Le = torch.where(is_inf[..., None], le_env, Le)
    cos_term = torch.where(is_area, absdot(d_l, n_l), 1.0)
    beta = Le * (cos_term / torch.clamp_min(sel_pmf * pdf_pos * pdf_dir,
                                            1e-20))[..., None]
    beta = torch.where(emits[..., None], beta, 0.0)
    o = torch.where(pt_or_spot[..., None], p_l,
                    vecmath.offset_ray_origin(p_l, n_l, d_l))
    return o, d_l, beta, emits


def _scan_counts(grid: Grid, pc, active, max_per_cell):
    """Per photon in cell pc: its first entry, the scan slots that read an
    entry of its cell (pbrt_tpu's ``same``) and the entries past
    ``max_per_cell`` it skips. Slot k reads entry min(start + k, last):
    the cell's own n entries for k < n, and, where the cell's entries end
    the table, its last entry again for the remaining slots."""
    L = grid.entry_cell.shape[0]
    start = torch.searchsorted(grid.entry_cell, pc, side="left")
    end = torch.searchsorted(grid.entry_cell, pc, side="right")
    n = end - start
    slots = torch.where((end == L) & (n > 0), max_per_cell,
                        torch.clamp_max(n, max_per_cell))
    slots = torch.where(active, slots, 0)
    skipped = torch.where(active, torch.clamp_min(n - max_per_cell, 0), 0)
    return start, slots, skipped


def deposit_pairs(scene, vps, radius, grid: Grid, hit_p, d_in, beta, start,
                  slots, p0, p1):
    """The deposits of photons p0..p1: each (photon, scan slot) pair whose
    visible point lies within its radius of the photon's hit point, with
    the photon's weight times the visible point's BSDF toward the photon
    (pbrt_tpu's dep_body). Returns the photons (n,) int64, their scan
    slots (n,), the visible points (n,) and the contributions (n, C)."""
    dev = hit_p.device
    cnt = slots[p0:p1]
    ph = torch.repeat_interleave(torch.arange(p0, p1, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(ph.shape[0], device=dev) \
        - torch.repeat_interleave(first, cnt)
    e = torch.clamp_max(start[ph] + k, grid.entry_cell.shape[0] - 1)
    vp = grid.entry_vp[e]
    d2 = ((vps["p"][vp] - hit_p[ph]) ** 2).sum(-1)
    near = vps["valid"][vp] & (d2 <= radius[vp] ** 2)
    keep = torch.nonzero(near).flatten()
    ph, k, vp = ph[keep], k[keep], vp[keep]
    mpv = mat_mod.gather_materials(scene.materials, vps["mat"][vp])
    ns = vps["ns"][vp]
    t1v, t2v = common.make_frame(ns)
    wo_v = common.to_local(t1v, t2v, ns, vps["wo"][vp])
    wi_v = common.to_local(t1v, t2v, ns, -d_in[ph])
    f_v = mat_mod.bsdf_f(mpv, wo_v, wi_v)
    return ph, k, vp, beta[ph] * f_v


def _deposit(scene, vps, radius, grid, hit_p, d_in, beta, start, slots, phi,
             m_cnt):
    """Every deposit of one bounce into phi (R,C) and m_cnt (R,), over
    chunks of at most ``_pair_chunk`` pairs (one host read of the pair
    counts a bounce)."""
    pair_chunk = _pair_chunk(hit_p.device)
    ends = torch.cumsum(slots, 0).cpu().numpy()
    P = slots.shape[0]
    p0 = 0
    while p0 < P:
        # the photons whose pairs fit the chunk (at least one photon)
        base = ends[p0 - 1] if p0 else 0
        p1 = max(p0 + 1, int(np.searchsorted(ends, base + pair_chunk,
                                             side="right")))
        p1 = min(p1, P)
        if ends[p1 - 1] > base:
            _, _, vp, contrib = deposit_pairs(scene, vps, radius, grid,
                                              hit_p, d_in, beta, start,
                                              slots, p0, p1)
            phi.index_add_(0, vp, contrib)
            m_cnt.index_add_(0, vp, torch.ones_like(vp, dtype=m_cnt.dtype))
        p0 = p1


def photon_pass(scene, vps, radius, n_photons, it, seed, max_depth, grid_lo,
                grid_hi, max_per_cell=MAX_PER_CELL):
    """Shoot the iteration's photons and deposit their flux on the visible
    points (sppm.cpp's photon pass). Returns (phi (R,C), M (R,), the
    entries skipped past ``max_per_cell``, as a Python float)."""
    dev = radius.device
    R, C, P = radius.shape[0], scene.n_channels, n_photons
    grid = build_grid(vps, radius, grid_lo, grid_hi)
    o_cur, d_cur, beta, active = emit_photons(scene, P, it, seed, dev)
    ppid = torch.arange(P, dtype=torch.int64, device=dev) + PHOTON_PID_BASE
    sidx = torch.full((P,), it, dtype=torch.int64, device=dev)
    sfn = make_sampler("independent")
    phi = torch.zeros((R, C), device=dev)
    m_cnt = torch.zeros(R, device=dev)
    overflow = torch.zeros((), device=dev)
    inf = torch.full((P,), vecmath.INF, device=dev)

    for b in range(max_depth):
        hit = isect_mod.intersect(scene, o_cur, d_cur, inf)
        active = active & hit.valid
        if b > 0:   # the first vertex's light is the camera pass's NEE
            start, slots, skipped = _scan_counts(
                grid, cell_id(hit.p, grid), active, max_per_cell)
            overflow = overflow + skipped.sum().to(torch.float32)
            _deposit(scene, vps, radius, grid, hit.p, d_cur, beta, start,
                     slots, phi, m_cnt)

        # the photon's continuation, with russian roulette
        mp = mat_mod.gather_materials(scene.materials,
                                      scene.mat_at(hit.prim_id))
        t1, t2 = common.make_frame(hit.ns)
        wo = common.to_local(t1, t2, hit.ns, -d_cur)
        u_cu = torch.stack([sfn(ppid, sidx, 311 + 4 * b, seed),
                            sfn(ppid, sidx, 312 + 4 * b, seed)], -1)
        wi_loc, f, pdf, _ = mat_mod.bsdf_sample(
            mp, wo, sfn(ppid, sidx, 310 + 4 * b, seed), u_cu)
        wi = common.to_world(t1, t2, hit.ns, wi_loc)
        thr = f * (absdot(wi, hit.ns) / torch.clamp_min(pdf, 1e-20))[..., None]
        beta_new = beta * thr
        q = torch.clamp_min(1.0 - beta_new.amax(-1)
                            / torch.clamp_min(beta.amax(-1), 1e-20), 0.0)
        survive = sfn(ppid, sidx, 313 + 4 * b, seed) >= q
        beta = torch.where(survive[..., None],
                           beta_new / torch.clamp_min(1 - q, 1e-6)[..., None],
                           beta)
        active = active & (pdf > 0) & survive & (beta.amax(-1) > 0)
        o_cur = vecmath.offset_ray_origin(hit.p, hit.ng, wi)
        d_cur = wi
    return phi, m_cnt, float(overflow)


def sppm_update(radius, N, tau, phi, M, vp_beta):
    """The SPPM update of each pixel that received photons this iteration
    (sppm.cpp:~270): N' = N + alpha·M, r' = r·sqrt(N' / (N + M)),
    tau' = (tau + beta·phi)·N' / (N + M)."""
    phi = phi * vp_beta
    has = M > 0
    N_new = N + SPPM_ALPHA * M
    ratio = torch.where(has, N_new / torch.clamp_min(N + M, 1e-6), 1.0)
    r_new = radius * torch.sqrt(ratio)
    tau_new = (tau + phi) * ratio[..., None]
    return (torch.where(has, r_new, radius), torch.where(has, N_new, N),
            torch.where(has[..., None], tau_new, tau))


def render_sppm(scene, cam, n_iterations=8, photons_per_iter=4096,
                initial_radius=None, max_depth=5, seed=0, device="cuda"):
    """The whole SPPM render (SPPMIntegrator::Render) → (H, W, C) on
    ``device``: the card unless the caller asks for the CPU.
    ``initial_radius`` None takes pbrt_tpu's resolution-adaptive default
    (two pixels' share of the world radius); ``render`` passes the scene
    file's (pbrt's default 1.0)."""
    device = require_device(device)
    scene = to_device(scene, device)
    cam = to_device(cam, device)
    width, height = cam.resolution
    R, C = width * height, scene.n_channels
    if initial_radius is None:
        initial_radius = float(scene.world_radius()) * 2.0 / max(width,
                                                                  height)
    radius = torch.full((R,), initial_radius, device=device)
    N = torch.zeros(R, device=device)
    tau = torch.zeros((R, C), device=device)
    L_direct_sum = torch.zeros((R, C), device=device)
    overflow = 0.0
    for it in range(n_iterations):
        vps = camera_pass(scene, cam, width, height, it, seed, max_depth,
                          device)
        cap = needed_capacity(vps, radius, scene.world_lo, scene.world_hi)
        phi, M, ovf = photon_pass(scene, vps, radius, photons_per_iter, it,
                                  seed, max_depth, scene.world_lo,
                                  scene.world_hi, cap)
        radius, N, tau = sppm_update(radius, N, tau, phi, M, vps["beta"])
        L_direct_sum = L_direct_sum + vps["L_direct"]
        overflow += ovf
    # no silent caps: skipped entries would bias dense cells dark
    stats_mod.counter_add("SPPM/photon cell-scan overflow entries", overflow)
    if overflow > 0:
        print(f"pbrt_tpu_torch sppm: {overflow:.0f} visible-point entries "
              "exceeded the host-computed cell capacity and were skipped",
              file=sys.stderr)
    n_total = n_iterations * photons_per_iter
    L_indirect = tau / torch.clamp_min(
        n_total * math.pi * (radius ** 2)[..., None], 1e-20)
    img = L_direct_sum / n_iterations + L_indirect
    return img.reshape(height, width, C)
