"""Fused path-bounce kernel for small diffuse portal scenes (port of
pbrt_tpu/ops/fused_path.py).

One kernel runs the whole path-tracing bounce loop of each ray: closest
hit over the triangles and the light's aaplane, emission at bounce 0,
next-event estimation (mode 1: portal projection, one shadow sweep;
mode 0: two-sample MIS, two sweeps), cosine continuation and russian
roulette after bounce 3. It writes per bounce three parameter-free
residuals (``code``, ``knee``, ``kc``), and ``replay`` rebuilds
L(kd, emit) from them in plain tensor code, so autograd gives the
gradients with respect to albedo and emission without a backward kernel.

``fused_bounce`` dispatches on the device of its tensors: a CUDA tensor
launches ``csrc/fused_path.cu``; a CPU tensor runs ``_kernel_reference``,
the plain-torch twin that does the same work in the same order. Nothing
falls back from one to the other.

``sweep_counts`` counts, from a launch's residuals, the sweeps of live
paths and the sweeps that warps execute.
"""

from __future__ import annotations

import ctypes
import math

import torch

from pbrt_tpu_torch.core import rng
from pbrt_tpu_torch.core.vecmath import SHADOW_EPS, cross
from pbrt_tpu_torch.ops import fastgather

CLUSTER = 32          # triangles per cull cluster
# Scenes with more than CLUSTER_MIN_TRI triangles get the cluster-AABB
# table; at or below 64 the flat sweep runs. (Kept at pbrt_tpu's gate,
# ``nt > 64``, so n_clu matches the reference table for table.)
CLUSTER_MIN_TRI = 64
MAX_MAT = 8           # the kd select covers at most 8 material rows
# Shared-memory plan of the CUDA kernel: 64 B per triangle row, 32 B per
# cluster box, 64 B of scene scalars, 12 B per material row. At the cap
# (1024 rows, 32 boxes, 8 materials) that is 66,720 B, within the 227 KB
# a Hopper block can use (above the 48 KB default, so the launch raises
# the limit). The cap stays at pbrt_tpu's 1024 so both packages admit the
# same scenes.
MAX_TRI = 1024
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use

BIG = 1e30
INV_PI = 1.0 / math.pi
_DIM_BASE = 6         # integrators/render.py _bounce_dims
_DIM_STRIDE = 10

# residual `code` bit layout (per bounce, per lane)
_MAT_MASK = 7         # bits 0-2: hit material row
_B_ALIVE = 8          # bit 3: lane survives into next bounce
_B_RRDIV = 16         # bit 4: russian-roulette 1/(1-q) compensation applied
_B_EMIT = 32          # bit 5: camera-vertex emission hit (bounce 0)


def eligible(scene, cfg) -> bool:
    """Dispatch gate: the scene has a fused profile and the config asks
    for what the kernel implements. A scene with motion never runs it (its
    rays carry shutter times the kernel does not take), as pbrt_tpu's gate
    refuses a pass with times; nor does a pass that counts live lanes
    (``cfg.collect_stats``: the wavefront loop counts them)."""
    return (getattr(scene, "fused_profile", None) is not None
            and not getattr(scene, "has_motion", False)
            and cfg.sampler == "independent"
            and cfg.light_strategy == "uniform"
            and not cfg.collect_stats)


def _axes_of(ax: int):
    """plane.cpp tangent axes (scene/shapes.py aaplane_axes)."""
    return {2: (0, 1), 0: (1, 2), 1: (2, 0)}[ax]


def smem_bytes(n_rows: int, n_clu: int, n_mat: int) -> int:
    """Dynamic shared memory of one block (csrc/fused_path.cu layout)."""
    return 4 * (16 * n_rows + 8 * n_clu + 16 + 3 * n_mat)


def live_mask(code):
    """(n_b, R) bool: the lanes whose path is alive entering each bounce
    (every lane at bounce 0, then the alive bit of the bounce before)."""
    live = torch.ones_like(code, dtype=torch.bool)
    live[1:] = (code[:-1] & _B_ALIVE) > 0
    return live


def sweep_counts(code, mode: int, paths_per_warp: int):
    """Per bounce, from a launch's residuals code (n_b, R): the sweeps of
    live paths, and the sweeps the kernel's warps execute (a warp of
    ``paths_per_warp`` consecutive lanes runs bounce b for all its paths
    when any of them is alive entering it). A bounce sweeps once for the
    closest hit and, but the emission-only last one, once (mode 1) or
    twice (mode 0) more for next-event estimation. Returns two (n_b,)
    int64 tensors."""
    n_b, R = code.shape
    live = live_mask(code)
    per = torch.full((n_b,), 2 if mode == 1 else 3, dtype=torch.int64)
    per[-1] = 1
    pad = -R % paths_per_warp
    groups = torch.nn.functional.pad(live, (0, pad)).reshape(
        n_b, -1, paths_per_warp)
    executed = groups.any(dim=-1).sum(dim=-1).cpu() * paths_per_warp
    return live.sum(dim=1).cpu() * per, executed * per


# ---------------------------------------------------------------------------
# plain-torch twin of the kernel
# ---------------------------------------------------------------------------

def _kernel_reference(tri_tab, msc, kd, clu, o, d, pid, sidx, *, n_tri, n_b,
                      ax, pl_facing, portal_facing, n_mat, seed,
                      rr_threshold, mode, n_clu):
    """What the kernel computes, vectorized over rays, with Python loops
    over bounces and triangles in the kernel's order. Every lane does all
    the work (dead lanes included), as pbrt_tpu's Pallas kernel does.
    Returns code (n_b,R) int32, knee and kc (n_b,R) float32."""
    ax0, ax1 = _axes_of(ax)
    sgn_pl = 1.0 if pl_facing else -1.0
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    zero = torch.zeros_like(ox)
    pid = pid.to(torch.int64)
    sidx = sidx.to(torch.int64)

    def unif(dim):
        return rng.uniform(pid, sidx, dim, seed)

    rows = [r.unbind(0) for r in tri_tab.unbind(0)]
    boxes = [c.unbind(0) for c in clu.unbind(0)]
    m = msc[0].unbind(0)
    pl_lo, pl_hi, pl_mat = m[0:3], m[3:6], m[6]
    po_lo, po_hi = m[7:10], m[10:13]
    kd_rows = [kd[r].unbind(0) for r in range(n_mat)]

    def sweep(ro, rd, want_attrs):
        """Closest hit over the triangles + the aaplane."""
        rox, roy, roz = ro
        rdx, rdy, rdz = rd
        st = {"t": zero + BIG,
              "p": torch.full_like(ox, -1, dtype=torch.int32)}
        if want_attrs:
            st.update(nx=zero, ny=zero, nz=zero, m=zero)

        def tri(i):
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows[i][:9]
            px = rdy * e2z - rdz * e2y
            py = rdz * e2x - rdx * e2z
            pz = rdx * e2y - rdy * e2x
            det = e1x * px + e1y * py + e1z * pz
            okd = det.abs() > 1e-12
            inv_det = torch.where(okd, 1.0 / det, zero)
            rx = rox - v0x
            ry = roy - v0y
            rz = roz - v0z
            u = (rx * px + ry * py + rz * pz) * inv_det
            qx = ry * e1z - rz * e1y
            qy = rz * e1x - rx * e1z
            qz = rx * e1y - ry * e1x
            v = (rdx * qx + rdy * qy + rdz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            hit = (okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > 1e-4) & (t < st["t"]))
            st["t"] = torch.where(hit, t, st["t"])
            st["p"] = torch.where(hit, i, st["p"])
            if want_attrs:
                for k, col in (("nx", 9), ("ny", 10), ("nz", 11),
                               ("m", 12)):
                    st[k] = torch.where(hit, rows[i][col], st[k])

        if n_clu == 0:
            for i in range(n_tri):
                tri(i)
        else:
            # cluster culling: skip a 32-row leaf when no ray's
            # [0, t_best] segment overlaps its (eps-padded) box. Culling
            # is conservative, so hits equal the flat sweep's.
            def inv(dd):
                return (torch.where(dd >= 0.0, 1.0, -1.0)
                        / torch.clamp_min(dd.abs(), 1e-30))

            iv = [inv(c) for c in rd]
            for ci in range(n_clu):
                tnear = zero - BIG
                tfar = zero + BIG
                for k in range(3):
                    t0 = (boxes[ci][k] - ro[k]) * iv[k]
                    t1 = (boxes[ci][3 + k] - ro[k]) * iv[k]
                    tnear = torch.maximum(tnear, torch.minimum(t0, t1))
                    tfar = torch.minimum(tfar, torch.maximum(t0, t1))
                ov = (tfar >= torch.clamp_min(tnear, 0.0)) \
                    & (tnear <= st["t"])
                if bool(ov.any()):
                    for i in range(ci * CLUSTER, ci * CLUSTER + CLUSTER):
                        tri(i)

        # the single aaplane (plane.cpp:15-55 slab test)
        o_ax, d_ax = ro[ax], rd[ax]
        okd = d_ax.abs() > 1e-12
        t = (pl_lo[ax] - o_ax) / torch.where(okd, d_ax, 1e-12)
        h0 = ro[ax0] + t * rd[ax0]
        h1 = ro[ax1] + t * rd[ax1]
        hitp = (okd & (t > 1e-4) & (t < st["t"])
                & (h0 > pl_lo[ax0]) & (h0 < pl_hi[ax0])
                & (h1 > pl_lo[ax1]) & (h1 < pl_hi[ax1]))
        bt = torch.where(hitp, t, st["t"])
        bp = torch.where(hitp, n_tri, st["p"])
        if not want_attrs:
            return bt, bp
        axis_n = [0.0, 0.0, 0.0]
        axis_n[ax] = sgn_pl
        nrm = [torch.where(hitp, axis_n[k], st[key])
               for k, key in enumerate(("nx", "ny", "nz"))]
        return bt, bp, nrm, torch.where(hitp, pl_mat, st["m"])

    def concentric(u0, u1):
        # sampling.py concentric_sample_disk, per component
        x = 2.0 * u0 - 1.0
        y = 2.0 * u1 - 1.0
        zero_d = (x == 0.0) & (y == 0.0)
        use_x = x.abs() > y.abs()
        r = torch.where(use_x, x, y)
        theta = torch.where(
            use_x, (math.pi / 4) * (y / torch.where(x == 0.0, 1.0, x)),
            (math.pi / 2) - (math.pi / 4) * (x / torch.where(y == 0.0,
                                                             1.0, y)))
        r = torch.where(zero_d, 0.0, r)
        theta = torch.where(zero_d, 0.0, theta)
        cx = r * torch.cos(theta)
        cy = r * torch.sin(theta)
        cz = torch.sqrt(torch.clamp_min(1.0 - cx * cx - cy * cy, 0.0))
        return cx, cy, cz

    def offset(p, n, s, w):
        ndw = n[0] * w[0] + n[1] * w[1] + n[2] * w[2]
        nfs = torch.where(ndw < 0.0, -1.0, 1.0)
        return [p[k] + s * nfs * n[k] for k in range(3)], ndw

    codes, knees, kcs = [], [], []
    beta = [zero + 1.0] * 3
    active = torch.ones_like(ox, dtype=torch.bool)
    spec = torch.ones_like(ox, dtype=torch.bool)
    co = [ox, oy, oz]
    cd = [dx, dy, dz]

    for b in range(n_b):
        base = _DIM_BASE + b * _DIM_STRIDE
        bt, bp, (nx, ny, nz), matf = sweep(co, cd, True)
        n = (nx, ny, nz)
        hitv = bp >= 0
        tv = torch.where(hitv, bt, zero)
        p = [co[k] + tv * cd[k] for k in range(3)]
        # emission at the camera vertex (one-sided light plane)
        kemit = active & spec & (bp == n_tri) & ((sgn_pl * -cd[ax]) > 0.0)
        active = active & hitv
        mi = matf.to(torch.int32)
        if b == n_b - 1:
            # the final iteration collects emission only
            codes.append(mi + kemit.to(torch.int32) * _B_EMIT)
            knees.append(zero)
            kcs.append(zero)
            continue

        # shading frame (Duff; vecmath.coordinate_system)
        s = torch.where(nz >= 0.0, 1.0, -1.0)
        a = -1.0 / (s + nz)
        bb = nx * ny * a
        t1 = (1.0 + s * nx * nx * a, s * bb, -s * nx)
        t2 = (bb, s + ny * ny * a, -ny)
        woz = -(cd[0] * nx + cd[1] * ny + cd[2] * nz)

        # ---- NEE: uniform point on the light rect (sample_aaplane)
        u_l0 = unif(base + 1)
        u_l1 = unif(base + 2)
        lp = [None] * 3
        lp[ax] = pl_lo[ax] + zero
        lp[ax0] = pl_lo[ax0] + (pl_hi[ax0] - pl_lo[ax0]) * u_l0
        lp[ax1] = pl_lo[ax1] + (pl_hi[ax1] - pl_lo[ax1]) * u_l1
        to = [lp[k] - p[k] for k in range(3)]
        d2l = to[0] * to[0] + to[1] * to[1] + to[2] * to[2]
        rl = torch.rsqrt(torch.clamp_min(d2l, 1e-30))
        wl = [to[k] * rl for k in range(3)]
        area_l = (pl_hi[ax0] - pl_lo[ax0]) * (pl_hi[ax1] - pl_lo[ax1])
        cos_l = wl[ax].abs()
        pdf_fb = d2l / (torch.clamp_min(area_l, 1e-20)
                        * torch.clamp_min(cos_l, 1e-9))

        if mode == 1:
            # projection sampling (aaportal.cpp SampleProj): project the
            # light rect's corners through the portal plane, clip, sample
            in_front = (p[ax] > po_lo[ax]) if portal_facing \
                else (p[ax] < po_lo[ax])
            po_c = po_lo[ax]

            def project(lc):
                dv = [p[k] - lc[k] for k in range(3)]
                ok = dv[ax].abs() > 1e-12
                tt = (po_c - lc[ax]) / torch.where(ok, dv[ax], 1e-12)
                return lc[ax0] + tt * dv[ax0], lc[ax1] + tt * dv[ax1], ok

            plo0, plo1, ok_lo = project(pl_lo)
            phi0, phi1, ok_hi = project(pl_hi)
            cmin0 = torch.maximum(po_lo[ax0], torch.minimum(plo0, phi0))
            cmax0 = torch.minimum(po_hi[ax0], torch.maximum(plo0, phi0))
            len0 = torch.clamp_min(cmax0 - cmin0, 0.0)
            cmin1 = torch.maximum(po_lo[ax1], torch.minimum(plo1, phi1))
            cmax1 = torch.minimum(po_hi[ax1], torch.maximum(plo1, phi1))
            len1 = torch.clamp_min(cmax1 - cmin1, 0.0)
            area_p = len0 * len1
            okp = ok_lo & ok_hi & (area_p > 1e-12)
            sp = [None] * 3
            sp[ax] = po_c + zero
            sp[ax0] = cmin0 + u_l0 * len0
            sp[ax1] = cmin1 + u_l1 * len1
            tp = [sp[k] - p[k] for k in range(3)]
            d2p = tp[0] * tp[0] + tp[1] * tp[1] + tp[2] * tp[2]
            rp = torch.rsqrt(torch.clamp_min(d2p, 1e-30))
            wp = [tp[k] * rp for k in range(3)]
            pdf_pj = torch.where(
                okp, d2p / torch.clamp_min(wp[ax].abs() * area_p, 1e-9),
                zero)
            wi = [torch.where(in_front, wp[k], wl[k]) for k in range(3)]
            pdf_nee = torch.where(in_front, pdf_pj, pdf_fb)
        else:
            wi = wl
            pdf_nee = pdf_fb

        # shadow/emission sweep from the offset origin
        scale = SHADOW_EPS * torch.clamp_min(
            torch.maximum(p[0].abs(), torch.maximum(p[1].abs(),
                                                    p[2].abs())), 1.0)
        o2, ndw = offset(p, n, scale, wi)
        _, bp2 = sweep(o2, wi, False)
        le_hit = (bp2 == n_tri) & ((sgn_pl * -wi[ax]) > 0.0)
        refl = (woz * ndw) > 0.0
        ok_nee = active & (pdf_nee > 0.0) & refl & le_hit
        knee = torch.where(ok_nee, ndw.abs() / torch.clamp_min(pdf_nee,
                                                               1e-20), zero)

        if mode == 0:
            # two-sample MIS: light half (power heuristic) + BSDF half
            p_scat = torch.where(refl, ndw.abs() * INV_PI, zero)
            w_l = (pdf_nee * pdf_nee) / torch.clamp_min(
                pdf_nee * pdf_nee + p_scat * p_scat, 1e-20)
            knee = knee * w_l
            bd = concentric(unif(base + 4), unif(base + 5))
            sflip_b = torch.sign(woz + 1e-20)
            wbl = [c * sflip_b for c in bd]
            wb = [wbl[0] * t1[k] + wbl[1] * t2[k] + wbl[2] * n[k]
                  for k in range(3)]
            pdf_b = wbl[2].abs() * INV_PI
            o3, ndw_b = offset(p, n, scale, wb)
            bt3, bp3 = sweep(o3, wb, False)
            hit_l3 = (bp3 == n_tri) & ((sgn_pl * -wb[ax]) > 0.0)
            pdf_li_b = (bt3 * bt3) / torch.clamp_min(wb[ax].abs() * area_l,
                                                     1e-9)
            w_b = (pdf_b * pdf_b) / torch.clamp_min(
                pdf_b * pdf_b + pdf_li_b * pdf_li_b, 1e-20)
            knee_b = torch.where(active & hit_l3 & (pdf_b > 0.0),
                                 ndw_b.abs() * w_b
                                 / torch.clamp_min(pdf_b, 1e-20), zero)
            knee = knee + knee_b

        # ---- continuation (matte cosine lobe)
        dd = concentric(unif(base + 7), unif(base + 8))
        sflip = torch.sign(woz + 1e-20)
        wc = [c * sflip for c in dd]
        ww = [wc[0] * t1[k] + wc[1] * t2[k] + wc[2] * n[k]
              for k in range(3)]
        pdf_c = wc[2].abs() * INV_PI
        cos_c = (nx * ww[0] + ny * ww[1] + nz * ww[2]).abs()
        refl_c = (woz * wc[2]) > 0.0
        kc = torch.where(refl_c, cos_c * INV_PI
                         / torch.clamp_min(pdf_c, 1e-20), zero)

        # beta tracking for RR and survival; kd by per-lane select
        kdv = [zero, zero, zero]
        for mrow in range(n_mat):
            sel = mi == mrow
            kdv = [torch.where(sel, kd_rows[mrow][c], kdv[c])
                   for c in range(3)]
        bn = [beta[c] * kdv[c] * kc for c in range(3)]
        bmax = torch.maximum(bn[0], torch.maximum(bn[1], bn[2]))
        alive = active & (pdf_c > 0.0) & (bmax > 0.0)
        rr_div = torch.zeros_like(alive)
        if b > 3:
            # russian roulette (path.cpp:362-370); eta_scale = 1 (matte)
            do_rr = bmax < rr_threshold
            q = torch.clamp_min(1.0 - bmax, 0.05)
            killed = do_rr & (unif(base + 9) < q)
            rr_div = do_rr & ~killed
            inv = 1.0 / torch.clamp_min(1.0 - q, 1e-6)
            bn = [torch.where(rr_div, v * inv, v) for v in bn]
            alive = alive & ~killed

        codes.append(mi + alive.to(torch.int32) * _B_ALIVE
                     + rr_div.to(torch.int32) * _B_RRDIV
                     + kemit.to(torch.int32) * _B_EMIT)
        knees.append(knee)
        kcs.append(kc)

        # state update (render.py _li_loop tail)
        beta = [torch.where(alive, bn[c], beta[c]) for c in range(3)]
        on, _ = offset(p, n, scale, ww)
        co = [torch.where(alive, on[k], co[k]) for k in range(3)]
        cd = [torch.where(alive, ww[k], cd[k]) for k in range(3)]
        spec = spec & ~alive
        active = alive

    return (torch.stack(codes).to(torch.int32), torch.stack(knees),
            torch.stack(kcs))


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

def _lib():
    from pbrt_tpu_torch.ops import _build

    lib = _build.load("fused_path")
    fn = lib.fused_path_launch
    if fn.argtypes is None:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [i32] * 6 + [ctypes.c_uint32,
                                               ctypes.c_float] \
            + [i32] * 4 + [vp]
        fn.restype = i32
    return fn


def _check(name, x, dtype, shape, device):
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} on {device}, "
                         f"got {x.dtype} on {x.device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")


def fused_bounce(tri_tab, msc, kd, clu, o, d, pid, sidx, *, n_tri, n_b, ax,
                 pl_facing, portal_facing, n_mat, seed, rr_threshold, mode,
                 n_clu):
    """Run the bounce loop for rays o, d (R,3) with sample keys pid, sidx
    (R,) int32. Returns code (n_b,R) int32, knee and kc (n_b,R) float32.

    On the CPU this is the twin; on CUDA it launches the kernel (and adds
    one to ``fused_bounce.launches``). Any other device raises."""
    kw = dict(n_tri=n_tri, n_b=n_b, ax=ax, pl_facing=pl_facing,
              portal_facing=portal_facing, n_mat=n_mat, seed=seed,
              rr_threshold=rr_threshold, mode=mode, n_clu=n_clu)
    if o.device.type == "cpu":
        return _kernel_reference(tri_tab, msc, kd, clu, o, d, pid, sidx,
                                 **kw)
    if o.device.type != "cuda":
        raise NotImplementedError(f"fused_bounce on {o.device}")
    dev = o.device
    R = o.shape[0]
    n_rows = tri_tab.shape[0]
    f32, i32 = torch.float32, torch.int32
    if not (1 <= n_mat <= MAX_MAT and 1 <= n_tri <= n_rows and R > 0):
        raise ValueError(f"bad sizes n_tri={n_tri} rows={n_rows} "
                         f"n_mat={n_mat} R={R}")
    if n_clu and (n_rows != n_clu * CLUSTER or clu.shape[0] != n_clu):
        raise ValueError("clustered tables hold n_clu*32 triangle rows "
                         "and n_clu boxes")
    _check("tri_tab", tri_tab, f32, (n_rows, 16), dev)
    _check("msc", msc, f32, (1, 16), dev)
    _check("kd", kd, f32, (n_mat, 3), dev)
    _check("clu", clu, f32, (clu.shape[0], 8), dev)
    _check("o", o, f32, (R, 3), dev)
    _check("d", d, f32, (R, 3), dev)
    _check("pid", pid, i32, (R,), dev)
    _check("sidx", sidx, i32, (R,), dev)
    if smem_bytes(n_rows, n_clu, n_mat) > SMEM_LIMIT:
        raise ValueError("scene tables exceed the block's shared memory")
    code = torch.empty((n_b, R), dtype=i32, device=dev)
    knee = torch.empty((n_b, R), dtype=f32, device=dev)
    kc = torch.empty((n_b, R), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(tri_tab.data_ptr(), msc.data_ptr(), kd.data_ptr(),
                 clu.data_ptr(), o.data_ptr(), d.data_ptr(), pid.data_ptr(),
                 sidx.data_ptr(), code.data_ptr(), knee.data_ptr(),
                 kc.data_ptr(), R, n_tri, n_rows, n_clu, n_b, n_mat,
                 seed & 0xFFFFFFFF, float(rr_threshold), ax,
                 int(bool(pl_facing)), int(bool(portal_facing)), mode,
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_path kernel launch failed: CUDA error "
                           f"{err}")
    fused_bounce.launches += 1
    return code, knee, kc


fused_bounce.launches = 0


# ---------------------------------------------------------------------------
# tables + replay
# ---------------------------------------------------------------------------

def pack_fused(scene, mode):
    """Pack the scene into the kernel's table layouts.

    tri_tab (rows,16): v0, e1, e2, unit normal, material row, 3 pad.
    Past CLUSTER_MIN_TRI triangles it also builds a (n_clu, 8) table of
    eps-padded cluster AABBs over contiguous CLUSTER-row runs (builder
    order, so hits equal the flat sweep's); the rows are padded to a
    cluster multiple with degenerate copies (e1 = e2 = 0, never hit) of
    the last triangle so the pad cannot grow the last cluster's box.
    msc (1,16): light plane lo, hi, its material, portal lo, hi, 3 pad."""
    g = scene.geom
    nt = scene.n_tri
    dev = g.tri_v0.device
    v0 = g.tri_v0[:nt]
    e1 = g.tri_v1[:nt] - v0
    e2 = g.tri_v2[:nt] - v0
    n = cross(e1, e2)
    n2 = n[:, 0:1] * n[:, 0:1] + n[:, 1:2] * n[:, 1:2] + n[:, 2:3] * n[:, 2:3]
    n = n * torch.rsqrt(torch.clamp_min(n2, 1e-30))
    matf = scene.prim_mat[:nt].to(torch.float32)[:, None]
    z3 = torch.zeros((nt, 3), dtype=torch.float32, device=dev)
    tri_tab = torch.cat([v0, e1, e2, n, matf, z3], dim=-1)
    n_clu = 0
    clu = torch.zeros((1, 8), dtype=torch.float32, device=dev)
    if nt > CLUSTER_MIN_TRI:
        n_clu = -(-nt // CLUSTER)
        pad = n_clu * CLUSTER - nt
        p1 = v0 + e1
        p2 = v0 + e2
        lo = torch.minimum(torch.minimum(v0, p1), p2)
        hi = torch.maximum(torch.maximum(v0, p1), p2)
        if pad:
            prow = tri_tab[-1:].clone()
            prow[:, 3:9] = 0.0
            tri_tab = torch.cat([tri_tab, prow.expand(pad, 16)], dim=0)
            lo = torch.cat([lo, lo[-1:].expand(pad, 3)], dim=0)
            hi = torch.cat([hi, hi[-1:].expand(pad, 3)], dim=0)
        lo = lo.reshape(n_clu, CLUSTER, 3).amin(dim=1)
        hi = hi.reshape(n_clu, CLUSTER, 3).amax(dim=1)
        # conservative float padding: slab-test rounding must not cull a
        # box the exact triangle test would hit
        eps = 1e-5 * torch.maximum(lo.abs(), hi.abs()) + 1e-6
        clu = torch.cat([lo - eps, hi + eps,
                         torch.zeros((n_clu, 2), dtype=torch.float32,
                                     device=dev)], dim=-1)
    if mode == 1:
        po_lo = scene.lights.portal_lo[0, 0]
        po_hi = scene.lights.portal_hi[0, 0]
    else:
        po_lo = po_hi = torch.zeros(3, dtype=torch.float32, device=dev)
    msc = torch.cat([g.pln_lo[0], g.pln_hi[0],
                     scene.prim_mat[nt:nt + 1].to(torch.float32),
                     po_lo, po_hi,
                     torch.zeros(3, dtype=torch.float32, device=dev)])[None]
    return tri_tab.contiguous(), msc, clu.contiguous(), n_clu


def replay(kd, emit, code, knee, kc, rr_threshold=1.0):
    """Differentiable reconstruction of L from the residuals: per bounce,
    emission + NEE with the entering beta, then beta ← beta·kd[m]·kc with
    the RR 1/(1−q) compensation recomputed from beta, so ∂L/∂kd flows
    through it as in the generic path; kd[m] is ``fastgather.gather_rows``,
    whose backward sums the lanes of each material row (no
    ``index_put_``). kd (M,C); emit (C,); code, knee, kc (n_b,R). Returns
    L (R,C)."""
    nb, R = code.shape
    C = kd.shape[-1]
    beta = torch.ones((R, C), dtype=kd.dtype, device=kd.device)
    L = torch.zeros((R, C), dtype=kd.dtype, device=kd.device)
    for b in range(nb):
        cb = code[b]
        m = (cb & _MAT_MASK).long()
        alive = ((cb & _B_ALIVE) > 0)[:, None]
        rr_div = ((cb & _B_RRDIV) > 0)[:, None]
        kem = ((cb & _B_EMIT) > 0)[:, None]
        kd_b = fastgather.gather_rows(kd, m)
        L = L + torch.where(kem, beta * emit[None], 0.0)
        L = L + beta * kd_b * (knee[b] * INV_PI)[:, None] * emit[None]
        bn = beta * kd_b * kc[b][:, None]
        q = torch.clamp_min(1.0 - torch.amax(bn, dim=-1), 0.05)
        bn = torch.where(rr_div, bn / torch.clamp_min(1.0 - q, 1e-6)[:, None],
                         bn)
        beta = torch.where(alive, bn, beta)
    return L


def li_path_fused(scene, o, d, pid, sidx, cfg):
    """Fused-path Li: the bounce kernel (or its twin on the CPU) + replay.
    o, d (R,3); pid, sidx (R,) integer sample keys. Returns (R,C)."""
    ax, pl_facing, portal_facing, n_mat, mode = scene.fused_profile
    tri_tab, msc, clu, n_clu = pack_fused(scene, mode)
    with torch.no_grad():
        code, knee, kc = fused_bounce(
            tri_tab, msc, scene.materials.kd.detach().contiguous(), clu,
            o.detach().contiguous(), d.detach().contiguous(),
            pid.to(torch.int32), sidx.to(torch.int32),
            n_tri=scene.n_tri, n_b=cfg.max_depth + 1, ax=ax,
            pl_facing=pl_facing, portal_facing=portal_facing, n_mat=n_mat,
            seed=cfg.seed, rr_threshold=cfg.rr_threshold, mode=mode,
            n_clu=n_clu)
    return replay(scene.materials.kd, scene.lights.emit[0], code, knee, kc,
                  rr_threshold=cfg.rr_threshold)
