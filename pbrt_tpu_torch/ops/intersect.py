"""Brute-force closest-hit kernel (port of
pbrt_tpu/ops/intersect_pallas.py).

For every ray it tests every triangle, sphere and aaplane of a scene with
no BVH and returns ``(t, prim)``: the closest hit distance and the global
primitive index, −1 on a miss. It carries every integrator but the fused
path on such scenes, of any primitive count (the kernel streams the
tables through shared-memory tiles), and the spheres and aaplanes of a
scene whose triangles sit in a BVH or a kd-tree (scene/bvh.py,
scene/kdtree.py).

``intersect_brute`` dispatches on the device of its tensors: a CUDA tensor
launches ``csrc/intersect.cu``; a CPU tensor runs ``_intersect_reference``,
the plain-torch twin that does the same tests with the same tie rule: it
folds the triangles and spheres in chunks of rows, each chunk's first
least ``t`` against the best so far under the same strict ``<``, which
equals the kernel's one-by-one fold bit for bit and keeps its (R, chunk)
temporaries bounded. Nothing falls back from one to the other. The query is not
differentiated (pbrt_tpu's custom_vjp returns zero cotangents): callers
run it under ``torch.no_grad()``.

Two-keyframe motion blur has the kernel's motion variant,
``intersect_brute_motion``: (T,18) rows v0 v1 v2 dv0 dv1 dv2
(``pack_scene(..., motion=True)``) moved to each ray's shutter time
before the triangle test, one ray a thread without the early reject (each
lane's row is its own), with its own launch count; its twin is
``_intersect_reference(..., time=...)``.

The kernel's design has two steps, the bits of a design: two rays per
thread (TWO; ``lane_rays`` is the map) and the warp-wide early reject of
``csrc/tri_sweep.cuh`` (REJECT, whose torch mirror is
``tri_reject_reference``). The render path runs the kernel's own choice
(``intersect_render_design`` in the source: both); ``_launch_design``
launches any design, for the timing turns of ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes

import torch

BIG = 1e30
TWO, REJECT = 1, 2   # design steps of csrc/intersect.cu
CHUNK_ELEMS = 1 << 20  # the twin's (R, chunk) temporaries, in elements
DESIGNS = (0, TWO, REJECT, TWO | REJECT)


def pack_scene(scene, tris=True, motion=False):
    """Pack the primitive tables into the kernel's layouts: tri (T,9) =
    v0, e1, e2; sph (S,4) = center, radius; pln (P,8) = lo, hi, axis, pad.
    A family with no primitive keeps its one padding row, which the
    kernel never reads (its count is 0). ``tris=False`` leaves the
    triangles out (one padding row): a scene with a BVH sends only its
    spheres and aaplanes through this kernel. ``motion`` (a scene with
    two-keyframe motion) gives the motion variant's (T,18) rows v0, v1,
    v2, dv0, dv1, dv2 instead: the vertices at shutter time 0 and their
    motion to time 1."""
    g = scene.geom
    if tris and motion:
        tri = torch.cat([g.tri_v0, g.tri_v1, g.tri_v2, g.tri_dv0, g.tri_dv1,
                         g.tri_dv2], dim=-1)
    elif tris:
        tri = torch.cat([g.tri_v0, g.tri_v1 - g.tri_v0, g.tri_v2 - g.tri_v0],
                        dim=-1)
    else:
        tri = g.tri_v0.new_zeros((1, 9))
    sph = torch.cat([g.sph_center, g.sph_radius[:, None]], dim=-1)
    pln = torch.cat([g.pln_lo, g.pln_hi,
                     g.pln_ax[:, None].to(torch.float32),
                     torch.zeros_like(g.pln_lo[:, :1])], dim=-1)
    return tri.contiguous(), sph.contiguous(), pln.contiguous()


def lane_rays(n_threads: int, rays_per_thread: int):
    """The rays that the kernel's threads 0..n_threads-1 carry
    (csrc/intersect.cu intersect_kernel): lane l of warp w takes rays
    32·p·w + 32·k + l, k < p, so each store of a warp is 32 consecutive
    rays and a warp covers 32·p consecutive rays. Returns (n_threads, p)
    int64."""
    g = torch.arange(n_threads)
    k = torch.arange(rays_per_thread)
    return ((g // 32) * 32 * rays_per_thread + (g % 32))[:, None] + 32 * k


# ---------------------------------------------------------------------------
# plain-torch twins of the kernel and of its early reject
# ---------------------------------------------------------------------------

def tri_reject_reference(tri, o, d):
    """csrc/tri_sweep.cuh's tri_pre and tri_reject, operation for
    operation in float32, on rays o, d (R,3) against triangle rows tri
    (R,9) = v0, e1, e2, pair by pair. Returns (reject (R,) bool, det, nu,
    nv, nt). Where reject holds, the exact test of
    ``_intersect_reference`` misses whatever the best t."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    rx = ox - v0x
    ry = oy - v0y
    rz = oz - v0z
    nu = rx * px + ry * py + rz * pz
    qx = ry * e1z - rz * e1y
    qy = rz * e1x - rx * e1z
    qz = rx * e1y - ry * e1x
    nv = dx * qx + dy * qy + dz * qz
    nt = e2x * qx + e2y * qy + e2z * qz
    ad = det.abs()
    pos = det > 0.0
    su = torch.where(pos, nu, -nu)
    sv = torch.where(pos, nv, -nv)
    st = torch.where(pos, nt, -nt)
    g = ad * 2.0 ** -64
    reject = (~(ad > 1e-12) | (st <= 0.0) | (su <= -g) | (sv <= -g)
              | (su + sv > ad * (1.0 + 2.0 ** -20)))
    return reject, det, nu, nv, nt


def ray_tri_reference(o, d, rows, best_t):
    """csrc/ray_tri.cuh's test, operation for operation in float32: rays
    o, d (..., 3) against triangle rows (..., 9) = v0, e1, e2 (or the
    nine components as a sequence), broadcast against each other and
    against best_t. Returns (t, hit); a hit needs |det| > 1e-12, u ≥ 0,
    v ≥ 0, u + v ≤ 1, t > 1e-4 and t < best_t."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        rows.unbind(-1) if torch.is_tensor(rows) else rows)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    okd = det.abs() > 1e-12
    inv_det = torch.where(okd, 1.0 / det, 0.0)
    rx = ox - v0x
    ry = oy - v0y
    rz = oz - v0z
    u = (rx * px + ry * py + rz * pz) * inv_det
    qx = ry * e1z - rz * e1y
    qy = rz * e1x - rx * e1z
    qz = rx * e1y - ry * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = (okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
           & (t < best_t))
    return t, hit


def _motion_rows(rows, time):
    """(C,18) motion rows v0 v1 v2 dv0 dv1 dv2 at each ray's shutter time
    (R,): the nine (R, C) components of the moved vertex v0 and the edges
    of the moved vertices, as the motion variant forms them (v + time·dv,
    then e1 = v1 − v0, e2 = v2 − v0), each contiguous."""
    w = [rows[:, k] + time[:, None] * rows[:, 9 + k] for k in range(9)]
    return w[0:3] + [w[3 + k] - w[k] for k in range(3)] \
        + [w[6 + k] - w[k] for k in range(3)]


def _sqrt_rn(x):
    """The correctly rounded float32 square root, as the kernels' sqrtf.
    torch's float32 sqrt on the CPU is not: it is 1 ulp off on about one
    element in 160, and up to 1e-4 off on some of a process's first
    calls. So the CPU takes it in float64, whose root rounds to the
    float32 one."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _fold(best_t, best_p, t, hit, base):
    """Fold a chunk's (R, C) hits into the best so far: the chunk's first
    least t, taken where it is strictly nearer (the kernel's one-by-one
    strict ``<`` gives the same)."""
    tb, idx = torch.where(hit, t, torch.inf).min(dim=-1)
    upd = hit.any(-1) & (tb < best_t)
    return (torch.where(upd, tb, best_t),
            torch.where(upd, (base + idx).to(best_p.dtype), best_p))


def _intersect_reference(tri, sph, pln, o, d, tmax, n_tri, n_sph, n_pln,
                         time=None):
    """What the kernel computes, vectorized over rays and over chunks of
    rows, in the kernel's order. Returns t (R,) float32 and prim (R,)
    int32. With ``time`` (R,), what the motion variant computes: ``tri``
    holds (T,18) motion rows, moved to each ray's time before the
    triangle test."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    best_t = torch.clamp_max(tmax, BIG)
    best_p = torch.full_like(ox, -1, dtype=torch.int32)
    chunk = max(1, CHUNK_ELEMS // max(1, o.shape[0]))

    # triangles: Möller–Trumbore (shapes/triangle.cpp role)
    for c0 in range(0, n_tri, chunk):
        rows = tri[c0:min(n_tri, c0 + chunk)]
        if time is not None:
            rows = _motion_rows(rows, time)
        t, hit = ray_tri_reference(o[:, None], d[:, None], rows,
                                   best_t[:, None])
        best_t, best_p = _fold(best_t, best_p, t, hit, c0)

    # spheres: stable quadratic (sphere.cpp:141-150)
    if n_sph:
        a = (dx * dx + dy * dy + dz * dz)[:, None]
    for c0 in range(0, n_sph, chunk):
        cx, cy, cz, rad = sph[c0:min(n_sph, c0 + chunk)].unbind(-1)
        lx = ox[:, None] - cx
        ly = oy[:, None] - cy
        lz = oz[:, None] - cz
        b = 2.0 * (lx * dx[:, None] + ly * dy[:, None] + lz * dz[:, None])
        c = lx * lx + ly * ly + lz * lz - rad * rad
        disc = b * b - 4.0 * a * c
        ok = disc >= 0.0
        sq = _sqrt_rn(torch.clamp_min(disc, 0.0))
        q = torch.where(b >= 0.0, -0.5 * (b + sq), -0.5 * (b - sq))
        t0 = q / torch.clamp_min(a, 1e-20)
        t1 = c / torch.where(q.abs() > 1e-20, q, 1e-20)
        tn = torch.minimum(t0, t1)
        tf = torch.maximum(t0, t1)
        t = torch.where(tn > 1e-4, tn, tf)
        hit = ok & (t > 1e-4) & (t < best_t[:, None])
        best_t, best_p = _fold(best_t, best_p, t, hit, n_tri + c0)

    # aaplanes (plane.cpp:15-55): open bounds on the rectangle
    ray_o, ray_d = (ox, oy, oz), (dx, dy, dz)
    for i in range(n_pln):
        row = pln[i].unbind(0)
        lo, hi = row[0:3], row[3:6]
        ax = int(row[6])
        ax0, ax1 = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[ax]
        d_ax = ray_d[ax]
        okd = d_ax.abs() > 1e-12
        t = (lo[ax] - ray_o[ax]) / torch.where(okd, d_ax, 1e-12)
        p0 = ray_o[ax0] + t * ray_d[ax0]
        p1 = ray_o[ax1] + t * ray_d[ax1]
        hit = (okd & (t > 1e-4) & (t < best_t) & (p0 > lo[ax0])
               & (p0 < hi[ax0]) & (p1 > lo[ax1]) & (p1 < hi[ax1]))
        best_t = torch.where(hit, t, best_t)
        best_p = torch.where(hit, n_tri + n_sph + i, best_p)
    return best_t, best_p


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from pbrt_tpu_torch.ops import _build

    lib = _build.load("intersect")
    if lib.intersect_launch.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.intersect_launch.argtypes = [vp] * 8 + [i32] * 5 + [vp]
        lib.intersect_motion_launch.argtypes = [vp] * 9 + [i32] * 4 + [vp]
        lib.intersect_render_design.argtypes = []
        for fn in (lib.intersect_launch, lib.intersect_motion_launch,
                   lib.intersect_render_design):
            fn.restype = i32
    return lib


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} on {device}, "
                         f"got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def intersect_brute(tri, sph, pln, o, d, tmax, n_tri, n_sph, n_pln):
    """Closest hit of rays o, d (R,3) within tmax (R,) against the packed
    tables (``pack_scene``). Returns t (R,) float32, prim (R,) int32.

    On the CPU this is the twin; on CUDA it launches the kernel (and adds
    one to ``intersect_brute.launches``). Any other device raises."""
    if o.device.type == "cpu":
        return _intersect_reference(tri, sph, pln, o, d, tmax, n_tri, n_sph,
                                    n_pln)
    if o.device.type != "cuda":
        raise NotImplementedError(f"intersect_brute on {o.device}")
    return _launch_design(tri, sph, pln, o, d, tmax, n_tri, n_sph, n_pln,
                          _lib().intersect_render_design())


def _launch_design(tri, sph, pln, o, d, tmax, n_tri, n_sph, n_pln, design):
    """Launch the kernel of ``design`` (one of DESIGNS) on CUDA tensors;
    ``intersect_brute`` launches the render path's. Every design gives the
    same results bit for bit. Adds one to ``intersect_brute.launches``."""
    dev = o.device
    R = o.shape[0]
    f32 = torch.float32
    if dev.type != "cuda" or design not in DESIGNS:
        raise ValueError(f"design {design} on {dev}")
    if not (0 <= n_tri <= tri.shape[0] and 0 <= n_sph <= sph.shape[0]
            and 0 <= n_pln <= pln.shape[0] and R > 0):
        raise ValueError(f"bad sizes n_tri={n_tri} n_sph={n_sph} "
                         f"n_pln={n_pln} R={R}")
    _check("tri", tri, f32, (tri.shape[0], 9), dev)
    _check("sph", sph, f32, (sph.shape[0], 4), dev)
    _check("pln", pln, f32, (pln.shape[0], 8), dev)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().intersect_launch(
        tri.data_ptr(), sph.data_ptr(), pln.data_ptr(), o.data_ptr(),
        d.data_ptr(), tmax.data_ptr(), t.data_ptr(), prim.data_ptr(), R,
        n_tri, n_sph, n_pln, design, stream)
    if err != 0:
        raise RuntimeError(f"intersect kernel launch failed: CUDA error "
                           f"{err}")
    intersect_brute.launches += 1
    return t, prim


intersect_brute.launches = 0


def intersect_brute_motion(tri, sph, pln, o, d, tmax, time, n_tri, n_sph,
                           n_pln):
    """The motion variant: closest hit of rays o, d (R,3) within tmax (R,)
    at their shutter times ``time`` (R,), against (T,18) motion rows
    (``pack_scene(..., motion=True)``) and the static sphere and aaplane
    tables. Returns t (R,) float32, prim (R,) int32.

    On the CPU this is the twin (``_intersect_reference`` with ``time``);
    on CUDA it launches the kernel's motion variant (and adds one to
    ``intersect_brute_motion.launches``). Any other device raises."""
    if o.device.type == "cpu":
        return _intersect_reference(tri, sph, pln, o, d, tmax, n_tri, n_sph,
                                    n_pln, time=time)
    if o.device.type != "cuda":
        raise NotImplementedError(f"intersect_brute_motion on {o.device}")
    dev = o.device
    R = o.shape[0]
    f32 = torch.float32
    if not (0 <= n_tri <= tri.shape[0] and 0 <= n_sph <= sph.shape[0]
            and 0 <= n_pln <= pln.shape[0] and R > 0):
        raise ValueError(f"bad sizes n_tri={n_tri} n_sph={n_sph} "
                         f"n_pln={n_pln} R={R}")
    _check("tri", tri, f32, (tri.shape[0], 18), dev)
    _check("sph", sph, f32, (sph.shape[0], 4), dev)
    _check("pln", pln, f32, (pln.shape[0], 8), dev)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("tmax", tmax, f32, (R,), dev)
    _check("time", time, f32, (R,), dev)
    t = torch.empty(R, dtype=f32, device=dev)
    prim = torch.empty(R, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().intersect_motion_launch(
        tri.data_ptr(), sph.data_ptr(), pln.data_ptr(), o.data_ptr(),
        d.data_ptr(), tmax.data_ptr(), time.data_ptr(), t.data_ptr(),
        prim.data_ptr(), R, n_tri, n_sph, n_pln, stream)
    if err != 0:
        raise RuntimeError(f"intersect motion kernel launch failed: CUDA "
                           f"error {err}")
    intersect_brute_motion.launches += 1
    return t, prim


intersect_brute_motion.launches = 0
