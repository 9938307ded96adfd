"""Plain reference of the `cornell_portal` configuration: pbrt-v3's
`path` integrator with the light-portal fork's projection strategy, on a
scene of triangles, matte materials and one axis-aligned area light seen
through an opening (the portal).

It works the scene out again from the scene file (``pbrt_scene``), draws
every sample from the same counter-based streams the configuration names
(pcg4d over pixel, sample, dimension and seed, with the dimension layout
of pbrt_tpu: 0-1 film, 2-3 lens, 4 time, then 10 a bounce from 6:
+1/+2 the light point, +7/+8 the continuation, +9 russian roulette), and
computes each lane's radiance in float64 by brute force over every
primitive, with torch autograd for the gradients with respect to the
materials' albedo (``kd``) and the light's emission (``emit``).

It imports nothing of the renderer under test. Lanes are processed in
blocks, so that a 16-million-lane image fits beside nothing else on the
card. ``dtype`` sets the precision of every float; ``ray_dtype`` rounds
the camera rays alone to another (the benchmark's lower-precision
control).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark.reference import pbrt_scene

BIG = 1e30
T_MIN = 1e-4          # the smallest hit distance a sweep accepts
SHADOW_EPS = 1e-3     # offset of a new ray's origin, scaled by |p|
DIM_BASE, DIM_STRIDE = 6, 10
INV_PI = 1.0 / math.pi
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# sample streams: pcg4d (Jarzynski & Olano, JCGT 2020) on 32-bit words
# ---------------------------------------------------------------------------

def pcg4d(v0, v1, v2, v3):
    """Four int64 tensors holding uint32 words → four hashed words."""
    mul, inc = 1664525, 1013904223
    v0 = (v0 * mul + inc) & _M32
    v1 = (v1 * mul + inc) & _M32
    v2 = (v2 * mul + inc) & _M32
    v3 = (v3 * mul + inc) & _M32
    for _ in range(2):
        v0 = (v0 + v1 * v3) & _M32
        v1 = (v1 + v2 * v0) & _M32
        v2 = (v2 + v0 * v1) & _M32
        v3 = (v3 + v1 * v2) & _M32
        if _ == 0:
            v0, v1, v2, v3 = (v ^ (v >> 16) for v in (v0, v1, v2, v3))
    return v0, v1, v2, v3


def uniform(pid, sidx, dim, seed, dtype):
    """One uniform in [0, 1) a lane: the top 24 bits of the hash's first
    word over 2^24."""
    shape = pid.shape
    words = [pid & _M32, sidx & _M32,
             torch.full(shape, dim & _M32, dtype=torch.int64,
                        device=pid.device),
             torch.full(shape, seed & _M32, dtype=torch.int64,
                        device=pid.device)]
    h = pcg4d(*words)[0]
    return (h >> 8).to(dtype) * (1.0 / 16777216.0)


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PortalScene:
    v0: torch.Tensor          # (N, 3) triangle vertex 0
    e1: torch.Tensor          # (N, 3) v1 - v0
    e2: torch.Tensor          # (N, 3) v2 - v0
    nrm: torch.Tensor         # (N, 3) unit geometric normal, cross(e1, e2)
    tri_mat: torch.Tensor     # (N,) material row
    kd: torch.Tensor          # (M, 3) matte albedo a row
    light_lo: tuple           # the light's rectangle (3 floats each)
    light_hi: tuple
    light_axis: int
    light_sign: float         # +1 when the light faces +axis
    light_mat: int
    emit: torch.Tensor        # (3,) emitted radiance
    portal_lo: tuple
    portal_hi: tuple
    portal_facing: bool
    cam_to_world: np.ndarray  # (4, 4) float64
    fov_deg: float
    resolution: tuple
    max_depth: int
    filter_radius: float

    @property
    def n_mat(self):
        return self.kd.shape[0]


def _look_at(eye, look, up):
    """pbrt-v3 LookAt's camera-to-world matrix."""
    eye, look, up = (np.asarray(v, np.float64) for v in (eye, look, up))
    d = (look - eye) / np.linalg.norm(look - eye)
    right = np.cross(up / np.linalg.norm(up), d)
    right /= np.linalg.norm(right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, np.cross(d, right), d, eye
    return m


def _portal(text: str):
    """The fork's portalData string ``((AA x0 y0 z0 x1 y1 z1 axis ±))``:
    one axis-aligned portal's corners and whether it faces +axis."""
    f = text.replace("(", " ").replace(")", " ").split()
    if len(f) != 9 or f[0] != "AA":
        raise ValueError(f"portal {text!r}: one AA portal expected")
    return (tuple(float(x) for x in f[1:4]), tuple(float(x) for x in f[4:7]),
            int(f[7]), f[8] == "+")


# the settings the reference implements, and pbrt-v3's box filter radius
SETTINGS = {"integrator": "path", "sampler": "independent", "filter": "box"}
BOX_RADIUS = 0.5


def load(path: str, settings: dict, device,
         dtype=torch.float64) -> PortalScene:
    """The scene file's triangles, materials, light, portal and camera,
    with the configuration's ``settings`` (integrator, sampler, filter,
    max_depth: those the program is given; the scene file's own are not
    read). Raises on a setting the reference does not implement."""
    for key, want in SETTINGS.items():
        if settings[key] != want:
            raise ValueError(f"{key} {settings[key]!r}: the reference "
                             f"implements {want!r} only")
    with open(path) as fh:
        desc = pbrt_scene.parse(fh.read())
    one, many = pbrt_scene.one, pbrt_scene.many
    kd = [[0.5, 0.5, 0.5]] + [None] * (desc["n_materials"] - 1)
    tris, mats, light = [], [], None
    for sh in desc["shapes"]:
        row, mname, mp = sh["material"]
        if mname != "matte":
            raise ValueError(f"material {mname!r}: matte only")
        kd[row] = [float(x) for x in many(mp, "Kd", [0.5, 0.5, 0.5])]
        p = sh["params"]
        if sh["name"] == "trianglemesh":
            idx = np.asarray(many(p, "indices"), np.int64).reshape(-1, 3)
            pts = np.asarray(many(p, "P"), np.float64).reshape(-1, 3)
            tris.append(pts[idx])
            mats += [row] * len(idx)
        elif sh["name"] == "aaplane":
            if sh["area"] is None or sh["area"][0] != "portal" or light:
                raise ValueError("one aaplane, the portal area light")
            ap = sh["area"][1]
            if one(ap, "strategy") != "projection":
                raise ValueError("the projection strategy only")
            light = dict(lo=tuple(many(p, "lo")), hi=tuple(many(p, "hi")),
                         axis=int(one(p, "axis")),
                         sign=1.0 if one(p, "facingFw", "true") in
                         ("true", True) else -1.0,
                         mat=row, emit=many(ap, "L"),
                         portal=_portal(one(ap, "portalData")))
        else:
            raise ValueError(f"shape {sh['name']!r}")
    kd = [k if k is not None else [0.5, 0.5, 0.5] for k in kd]
    t = torch.as_tensor(np.concatenate(tris), dtype=dtype, device=device)
    v0, e1, e2 = t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]
    n = torch.linalg.cross(e1, e2)
    n = n / n.norm(dim=-1, keepdim=True)
    po_lo, po_hi, po_axis, po_facing = light["portal"]
    if po_axis != light["axis"]:
        raise ValueError("portal and light on one axis only")
    la = [float(x) for x in desc["look_at"]]
    film = desc["film"][1]
    return PortalScene(
        v0=v0, e1=e1, e2=e2, nrm=n,
        tri_mat=torch.as_tensor(mats, dtype=torch.int64, device=device),
        kd=torch.as_tensor(kd, dtype=dtype, device=device),
        light_lo=light["lo"], light_hi=light["hi"],
        light_axis=light["axis"], light_sign=light["sign"],
        light_mat=light["mat"],
        emit=torch.as_tensor(light["emit"], dtype=dtype, device=device),
        portal_lo=po_lo, portal_hi=po_hi, portal_facing=po_facing,
        cam_to_world=_look_at(la[0:3], la[3:6], la[6:9]),
        fov_deg=float(pbrt_scene.one(desc["camera"][1], "fov", 90.0)),
        resolution=(int(one(film, "xresolution")),
                    int(one(film, "yresolution"))),
        max_depth=int(settings["max_depth"]),
        filter_radius=BOX_RADIUS)


# ---------------------------------------------------------------------------
# one block of lanes
# ---------------------------------------------------------------------------

def camera_rays(sc: PortalScene, px, py, pid, sidx, seed, width, height,
                dtype, ray_dtype=None):
    """pbrt-v3's perspective camera (no lens) through a box filter."""
    u0 = uniform(pid, sidx, 0, seed, dtype)
    u1 = uniform(pid, sidx, 1, seed, dtype)
    r = sc.filter_radius
    fx = px.to(dtype) + 0.5 + (2.0 * u0 - 1.0) * r
    fy = py.to(dtype) + 0.5 + (2.0 * u1 - 1.0) * r
    aspect = width / height
    if aspect > 1.0:
        smin, smax = (-aspect, -1.0), (aspect, 1.0)
    else:
        smin, smax = (-1.0, -1.0 / aspect), (1.0, 1.0 / aspect)
    sx = smin[0] + fx / width * (smax[0] - smin[0])
    sy = -(smin[1] + fy / height * (smax[1] - smin[1]))
    fs = math.tan(math.radians(sc.fov_deg) / 2.0)
    d = torch.stack([sx * fs, sy * fs, torch.ones_like(sx)], dim=-1)
    d = d / d.norm(dim=-1, keepdim=True)
    m = torch.as_tensor(sc.cam_to_world, dtype=dtype, device=d.device)
    d = d @ m[:3, :3].T
    o = m[:3, 3].expand_as(d)
    if ray_dtype is not None:
        o, d = o.to(ray_dtype).to(dtype), d.to(ray_dtype).to(dtype)
    return o, d


def _axes(ax):
    return {2: (0, 1), 0: (1, 2), 1: (2, 0)}[ax]


def closest_hit(sc: PortalScene, o, d):
    """Closest hit over every triangle and the light's plane: (t, index,
    is_plane); index −1 on a miss (t then BIG). Möller–Trumbore with pbrt
    _tpu's acceptance (|det| > 1e-12, barycentrics in [0, 1], t > 1e-4);
    the first of equal triangles, the plane only when strictly nearer."""
    dd, oo = d[:, None, :], o[:, None, :]
    pv = torch.linalg.cross(dd.expand(-1, sc.e2.shape[0], -1),
                            sc.e2[None].expand(d.shape[0], -1, -1))
    det = (sc.e1[None] * pv).sum(-1)
    okd = det.abs() > 1e-12
    inv = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
    rv = oo - sc.v0[None]
    u = (rv * pv).sum(-1) * inv
    q = torch.linalg.cross(rv, sc.e1[None].expand_as(rv))
    v = (dd * q).sum(-1) * inv
    t = (sc.e2[None] * q).sum(-1) * inv
    hit = okd & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN)
    t = torch.where(hit, t, BIG)
    tb, ib = t.min(dim=1)
    ib = torch.where(tb < BIG, ib, -1)
    ax = sc.light_axis
    a0, a1 = _axes(ax)
    dax = d[:, ax]
    okp = dax.abs() > 1e-12
    tp = (sc.light_lo[ax] - o[:, ax]) / torch.where(okp, dax, 1e-12)
    h0 = o[:, a0] + tp * d[:, a0]
    h1 = o[:, a1] + tp * d[:, a1]
    hitp = (okp & (tp > T_MIN) & (tp < tb)
            & (h0 > sc.light_lo[a0]) & (h0 < sc.light_hi[a0])
            & (h1 > sc.light_lo[a1]) & (h1 < sc.light_hi[a1]))
    return torch.where(hitp, tp, tb), torch.where(hitp, -2, ib), hitp


def _concentric(u0, u1):
    x, y = 2.0 * u0 - 1.0, 2.0 * u1 - 1.0
    zero = (x == 0) & (y == 0)
    use_x = x.abs() > y.abs()
    r = torch.where(use_x, x, y)
    theta = torch.where(
        use_x, (math.pi / 4) * (y / torch.where(x == 0, 1.0, x)),
        (math.pi / 2) - (math.pi / 4) * (x / torch.where(y == 0, 1.0, y)))
    r = torch.where(zero, 0.0, r)
    theta = torch.where(zero, 0.0, theta)
    cx, cy = r * torch.cos(theta), r * torch.sin(theta)
    return torch.stack([cx, cy, torch.sqrt(torch.clamp_min(
        1.0 - cx * cx - cy * cy, 0.0))], dim=-1)


def _offset(p, n, w):
    """A new ray's origin: p moved SHADOW_EPS·max(|p|∞, 1) along the
    normal, to the side of ``w``."""
    s = SHADOW_EPS * torch.clamp_min(p.abs().amax(-1), 1.0)
    side = torch.where((n * w).sum(-1) < 0, -1.0, 1.0).to(p.dtype)
    return p + (s * side)[:, None] * n


def _dot(a, b):
    return (a * b).sum(-1)


def trace(sc: PortalScene, kd, emit, o, d, pid, sidx, seed, rr=1.0,
          live=None):
    """Radiance (R, 3) of each lane's path, differentiable with respect to
    ``kd`` (M, 3) and ``emit`` (3,); the geometry carries no gradient.
    ``live``, a list, gets each bounce's count of lanes alive entering it
    (every lane at bounce 0)."""
    R = o.shape[0]
    dt, dev = o.dtype, o.device
    ax = sc.light_axis
    a0, a1 = _axes(ax)
    lo = torch.as_tensor(sc.light_lo, dtype=dt, device=dev)
    hi = torch.as_tensor(sc.light_hi, dtype=dt, device=dev)
    po_lo = torch.as_tensor(sc.portal_lo, dtype=dt, device=dev)
    po_hi = torch.as_tensor(sc.portal_hi, dtype=dt, device=dev)
    axis_n = torch.zeros(3, dtype=dt, device=dev)
    axis_n[ax] = sc.light_sign
    area_l = (sc.light_hi[a0] - sc.light_lo[a0]) * (sc.light_hi[a1]
                                                    - sc.light_lo[a1])
    rows = torch.arange(sc.n_mat, device=dev)
    L = torch.zeros((R, 3), dtype=dt, device=dev)
    beta = torch.ones((R, 3), dtype=dt, device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    spec = torch.ones(R, dtype=torch.bool, device=dev)
    n_b = sc.max_depth + 1

    def u(dim):
        return uniform(pid, sidx, dim, seed, dt)

    for b in range(n_b):
        base = DIM_BASE + b * DIM_STRIDE
        if live is not None:
            live.append(int(R if b == 0 else active.sum()))
        with torch.no_grad():
            t, idx, on_light = closest_hit(sc, o, d)
            hit = idx != -1
            ti = idx.clamp_min(0)
            n = torch.where(on_light[:, None], axis_n, sc.nrm[ti])
            m = torch.where(on_light, sc.light_mat, sc.tri_mat[ti])
            p = o + torch.where(hit, t, 0.0)[:, None] * d
            kemit = active & spec & on_light & (sc.light_sign * -d[:, ax] > 0)
            active = active & hit
        kd_m = (m[:, None] == rows).to(dt) @ kd
        L = L + torch.where(kemit[:, None], beta * emit, 0.0)
        if b == n_b - 1:
            break
        with torch.no_grad():
            woz = -_dot(d, n)
            ul0, ul1 = u(base + 1), u(base + 2)
            # a uniform point on the light's rectangle
            lp = torch.empty_like(p)
            lp[:, ax] = sc.light_lo[ax]
            lp[:, a0] = lo[a0] + (hi[a0] - lo[a0]) * ul0
            lp[:, a1] = lo[a1] + (hi[a1] - lo[a1]) * ul1
            to = lp - p
            d2l = _dot(to, to)
            wl = to * torch.rsqrt(torch.clamp_min(d2l, 1e-30))[:, None]
            pdf_l = d2l / (max(area_l, 1e-20)
                           * torch.clamp_min(wl[:, ax].abs(), 1e-9))
            # projection strategy: the light's corners projected from p
            # through the portal's plane, clipped to the portal
            in_front = (p[:, ax] > po_lo[ax] if sc.portal_facing
                        else p[:, ax] < po_lo[ax])

            def project(corner):
                dv = p - corner
                ok = dv[:, ax].abs() > 1e-12
                tt = (po_lo[ax] - corner[ax]) / torch.where(ok, dv[:, ax],
                                                            1e-12)
                return (corner[a0] + tt * dv[:, a0],
                        corner[a1] + tt * dv[:, a1], ok)

            q0l, q1l, okl = project(lo)
            q0h, q1h, okh = project(hi)
            c0 = torch.maximum(po_lo[a0], torch.minimum(q0l, q0h))
            len0 = torch.clamp_min(
                torch.minimum(po_hi[a0], torch.maximum(q0l, q0h)) - c0, 0.0)
            c1 = torch.maximum(po_lo[a1], torch.minimum(q1l, q1h))
            len1 = torch.clamp_min(
                torch.minimum(po_hi[a1], torch.maximum(q1l, q1h)) - c1, 0.0)
            area_p = len0 * len1
            okp = okl & okh & (area_p > 1e-12)
            sp = torch.empty_like(p)
            sp[:, ax] = po_lo[ax]
            sp[:, a0] = c0 + ul0 * len0
            sp[:, a1] = c1 + ul1 * len1
            tp = sp - p
            d2p = _dot(tp, tp)
            wp = tp * torch.rsqrt(torch.clamp_min(d2p, 1e-30))[:, None]
            pdf_p = torch.where(okp, d2p / torch.clamp_min(
                wp[:, ax].abs() * area_p, 1e-9), 0.0)
            wi = torch.where(in_front[:, None], wp, wl)
            pdf = torch.where(in_front, pdf_p, pdf_l)
            ndw = _dot(n, wi)
            _, _, lit = closest_hit(sc, _offset(p, n, wi), wi)
            lit = lit & (sc.light_sign * -wi[:, ax] > 0)
            ok = active & (pdf > 0) & (woz * ndw > 0) & lit
            knee = torch.where(ok, ndw.abs() / torch.clamp_min(pdf, 1e-20),
                               0.0)
            # continuation: a cosine-weighted direction on wo's side
            c = _concentric(u(base + 7), u(base + 8))
            c = c * torch.sign(woz + 1e-20)[:, None]
            s = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(dt)
            a = -1.0 / (s + n[:, 2])
            bb = n[:, 0] * n[:, 1] * a
            t1 = torch.stack([1.0 + s * n[:, 0] ** 2 * a, s * bb,
                              -s * n[:, 0]], -1)
            t2 = torch.stack([bb, s + n[:, 1] ** 2 * a, -n[:, 1]], -1)
            w = c[:, 0:1] * t1 + c[:, 1:2] * t2 + c[:, 2:3] * n
            pdf_c = c[:, 2].abs() * INV_PI
            kc = torch.where(woz * c[:, 2] > 0, _dot(n, w).abs() * INV_PI
                             / torch.clamp_min(pdf_c, 1e-20), 0.0)
        L = L + beta * kd_m * (knee * INV_PI)[:, None] * emit
        bn = beta * kd_m * kc[:, None]
        with torch.no_grad():
            bmax = bn.detach().amax(-1)
            alive = active & (pdf_c > 0) & (bmax > 0)
        if b > 3:
            q = torch.clamp_min(1.0 - bn.amax(-1), 0.05)
            with torch.no_grad():
                do_rr = bmax < rr
                killed = do_rr & (u(base + 9) < q.detach())
                alive = alive & ~killed
            bn = torch.where((do_rr & ~killed)[:, None],
                             bn / torch.clamp_min(1.0 - q, 1e-6)[:, None],
                             bn)
        beta = torch.where(alive[:, None], bn, beta)
        with torch.no_grad():
            o = torch.where(alive[:, None], _offset(p, n, w), o)
            d = torch.where(alive[:, None], w, d)
            spec = spec & ~alive
            active = alive
    bad = (~torch.isfinite(L)).any(-1) | (L.sum(-1) < -1e-5)
    return torch.where(bad[:, None], 0.0, L)


# ---------------------------------------------------------------------------
# images and training steps
# ---------------------------------------------------------------------------

def render_region(sc: PortalScene, kd, emit, width, height, samples, seed,
                  rows=None, block=1 << 20, dtype=torch.float64,
                  ray_dtype=None, live=None):
    """The sum over ``samples`` (a range of sample indices) of each
    pixel's box-filtered radiance, over the film's ``rows`` (a range; all
    by default): an (len(rows), width, 3) tensor, differentiable with
    respect to kd and emit. ``live`` (a list) gets each block's per-bounce
    live counts, summed."""
    rows = range(height) if rows is None else rows
    dev = kd.device
    n_pix = len(rows) * width
    n = n_pix * len(samples)
    img = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
    for a in range(0, n, block):
        lane = torch.arange(a, min(a + block, n), device=dev)
        lid = lane % n_pix
        sidx = lane // n_pix + samples.start
        px = lid % width
        py = lid // width + rows.start
        pid = py * width + px
        o, d = camera_rays(sc, px, py, pid, sidx, seed, width, height,
                           dtype, ray_dtype)
        counts = [] if live is not None else None
        L = trace(sc, kd, emit, o, d, pid, sidx, seed, live=counts)
        if live is not None:
            if not live:
                live.extend([0] * len(counts))
            for i, c in enumerate(counts):
                live[i] += c
        img = img.index_add(0, lid, L)
    return img.reshape(len(rows), width, 3)


def pass_counts(sc, width, height, samples, seed) -> dict:
    """The work of one pass over ``samples`` (a range of sample indices):
    its lanes, the scene's triangles, and each bounce's count of lanes
    alive entering it."""
    live = []
    render_region(sc, sc.kd, sc.emit, width, height, samples, seed,
                  live=live)
    return {"lanes": width * height * len(samples),
            "n_tri": int(sc.v0.shape[0]), "live": live}


def render(sc, kd, emit, width, height, spp, seed, **kw):
    """The whole image, as pbrt's film gives it: the mean over spp."""
    return render_region(sc, kd, emit, width, height, range(spp), seed,
                         **kw) / spp


def train(sc, kd0, emit0, target, steps, width, height, spp, lr,
          region=None, all_reduce=None, dtype=torch.float64,
          ray_dtype=None):
    """``len(steps)`` SGD steps of the MSE between the render and
    ``target`` (an (H, W, 3) image) with respect to kd and emit, step k
    rendering with sample seed ``steps[k]``. ``region`` = (samples, rows)
    renders only that share of the lanes and ``all_reduce`` (in place, a
    sum over every share) completes images and gradients, so several
    processes can split one step. Returns the losses, the first step's
    gradients and the parameters after the last step."""
    samples, rows = region or (range(spp), range(height))
    kd = kd0.detach().to(dtype).clone()
    emit = emit0.detach().to(dtype).clone()
    target = target.to(dtype)
    losses, first = [], None
    for seed in steps:
        kd.requires_grad_(True)
        emit.requires_grad_(True)
        part = render_region(sc, kd, emit, width, height, samples, seed,
                             rows=rows, dtype=dtype,
                             ray_dtype=ray_dtype) / spp
        full = torch.zeros_like(target)
        full[rows.start:rows.stop] = part.detach()
        if all_reduce is not None:
            all_reduce(full)
        loss = torch.mean((full - target) ** 2)
        g_img = 2.0 * (full - target)[rows.start:rows.stop] / target.numel()
        gk, ge = torch.autograd.grad(part, [kd, emit], g_img)
        if all_reduce is not None:
            all_reduce(gk)
            all_reduce(ge)
        if first is None:
            first = {"kd": gk.clone(), "emit": ge.clone()}
        losses.append(float(loss))
        kd = (kd - lr * gk).detach()
        emit = (emit - lr * ge).detach()
    return losses, first, {"kd": kd, "emit": emit}
