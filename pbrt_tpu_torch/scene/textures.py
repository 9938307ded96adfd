"""Textures (port of pbrt_tpu/scene/textures.py): constant, scale, mix,
checkerboard, uv, dots, bilerp, imagemap and the Perlin-noise textures
fbm, wrinkled, windy and marble.

Counterpart of pbrt's ``src/textures/`` and Texture<T> / MIPMap
(core/texture.{h,cpp}, core/mipmap.h). Textures are rows of a table
evaluated at shading points for every row type at once and selected per
lane. Image maps live in one padded image stack that holds each image's
full mip pyramid (level 0 at the left, levels 1.. in a strip to its
right), built in numpy as pbrt_tpu builds it. An imagemap is read
bilinearly at level 0 without a footprint, trilinearly between two
levels chosen from an isotropic footprint (hit distance × the camera's
pixel spread / |dpdu|), or with the EWA filter over the anisotropic
footprint when the table asks for it (MIPMap doTrilinear=false). Perlin
noise is pbrt's Noise() construction (texture.cpp:316-380) on pbrt_tpu's
pcg-hash lattice, so both packages draw the same gradients.

Indices are clamped into range wherever pbrt_tpu's gathers rely on JAX
clamping an out-of-range index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pbrt_tpu_torch.core import rng as rng_mod
from pbrt_tpu_torch.core import vecmath

CONSTANT = 0
SCALE = 1
MIX = 2
CHECKERBOARD = 3
UV = 4
DOTS = 5
BILERP = 6
IMAGEMAP = 7
FBM = 8
WRINKLED = 9
WINDY = 10
MARBLE = 11


@dataclasses.dataclass
class TextureTable:
    ttype: torch.Tensor     # (T,) int32
    v1: torch.Tensor        # (T,C) tex1 / constant value
    v2: torch.Tensor        # (T,C) tex2
    uv_scale: torch.Tensor  # (T,2)
    uv_delta: torch.Tensor  # (T,2)
    img_id: torch.Tensor    # (T,) int32
    octaves: torch.Tensor   # (T,) fbm octaves
    omega: torch.Tensor     # (T,) fbm roughness; a mix's constant amount
    scale3d: torch.Tensor   # (T,) 3D noise frequency
    variation: torch.Tensor  # (T,) marble FBm variation (marble.h:64)
    # operand texture rows (−1: the constant v1 / v2 / omega slot):
    # scale / mix tex1 → op1, tex2 → op2, a mix's amount → op3
    op1: torch.Tensor       # (T,) int32
    op2: torch.Tensor
    op3: torch.Tensor
    images: torch.Tensor    # (N, Hm, Wm, C) padded mip-atlas stack
    img_wh: torch.Tensor    # (N, 2) level-0 (w, h)
    mip_off: torch.Tensor   # (N, L, 2) per-level atlas (x0, y0)
    mip_wh: torch.Tensor    # (N, L, 2) per-level (w, h)
    n_levels: torch.Tensor  # (N,)
    spread: torch.Tensor    # () camera pixel spread (rad/px); 0: level 0
    ewa: bool = False       # EWA filtering for imagemaps
    max_aniso: float = 8.0
    nest_depth: int = 0     # operand nesting depth (passes to unroll)
    present: tuple = ()     # the row types present (empty: all)


def _downsample2(im: np.ndarray) -> np.ndarray:
    """One 2×2 box-filter mip step, clamping the edge for odd sizes."""
    h, w = im.shape[:2]
    if h > 1 and h % 2:
        im = np.concatenate([im, im[-1:]], axis=0)
    if w > 1 and w % 2:
        im = np.concatenate([im, im[:, -1:]], axis=1)
    if im.shape[0] > 1:
        im = 0.5 * (im[0::2] + im[1::2])
    if im.shape[1] > 1:
        im = 0.5 * (im[:, 0::2] + im[:, 1::2])
    return im


def _mip_pyramid(im: np.ndarray):
    """The full pyramid down to 1×1 as (level image, x0, y0): level 0 at
    (0, 0), levels 1.. stacked top to bottom in a strip at x = W0."""
    levels = [(im, 0, 0)]
    x0 = im.shape[1]
    y0 = 0
    cur = im
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        cur = _downsample2(cur)
        levels.append((cur, x0, y0))
        y0 += cur.shape[0]
    return levels


def make_texture_table(rows, images, n_channels, spread: float = 0.0,
                       filtering: str = "trilinear",
                       device="cpu") -> TextureTable:
    """rows: dicts (type, v1, v2, uscale, vscale, udelta, vdelta, img,
    octaves, omega, scale3d, variation, op1..op3); images: (H,W,C)
    arrays. ``spread`` is the camera's pixel spread (rad/px) that drives
    the mip level, 0 for level-0 bilinear lookups; ``filtering`` is
    "trilinear" or "ewa"."""
    f = lambda k, d: np.asarray([r.get(k, d) for r in rows] or [d],
                                np.float32)
    op_rows = [np.asarray([r.get(k, -1) for r in rows] or [-1], np.int32)
               for k in ("op1", "op2", "op3")]

    def _depth_of(i, seen=()):
        if i in seen:           # a malformed, cyclic operand tree
            return 0
        ops = [rows[i].get(k, -1) for k in ("op1", "op2", "op3")]
        sub = [_depth_of(int(o), seen + (i,)) for o in ops if o >= 0]
        return 1 + max(sub) if sub else 0

    nest_depth = min(max([_depth_of(i) for i in range(len(rows))] or [0]),
                     4)
    fc = lambda k, d: np.asarray(
        [np.broadcast_to(np.asarray(r.get(k, d), np.float32),
                         (n_channels,)) for r in rows]
        or [np.full(n_channels, d, np.float32)], np.float32)
    if images:
        pyramids = [_mip_pyramid(np.asarray(im, np.float32))
                    for im in images]
        lmax = max(len(p) for p in pyramids)
        hm = max(max(im.shape[0], p[-1][2] + 1) for im, p in
                 zip(images, pyramids))
        wm = max(im.shape[1] + (im.shape[1] + 1) // 2 for im in images)
        stack = np.zeros((len(images), hm, wm, n_channels), np.float32)
        wh = np.zeros((len(images), 2), np.int32)
        mip_off = np.zeros((len(images), lmax, 2), np.int32)
        mip_wh = np.ones((len(images), lmax, 2), np.int32)
        n_levels = np.ones(len(images), np.int32)
        for i, (im, pyr) in enumerate(zip(images, pyramids)):
            wh[i] = (im.shape[1], im.shape[0])
            n_levels[i] = len(pyr)
            for lv, (lim, x0, y0) in enumerate(pyr):
                stack[i, y0:y0 + lim.shape[0], x0:x0 + lim.shape[1]] = lim
                mip_off[i, lv] = (x0, y0)
                mip_wh[i, lv] = (lim.shape[1], lim.shape[0])
            # unused level slots repeat the 1×1 tail
            for lv in range(len(pyr), lmax):
                mip_off[i, lv] = mip_off[i, len(pyr) - 1]
                mip_wh[i, lv] = mip_wh[i, len(pyr) - 1]
    else:
        stack = np.zeros((1, 1, 1, n_channels), np.float32)
        wh = np.ones((1, 2), np.int32)
        mip_off = np.zeros((1, 1, 2), np.int32)
        mip_wh = np.ones((1, 1, 2), np.int32)
        n_levels = np.ones(1, np.int32)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return TextureTable(
        ttype=t(np.asarray([r.get("type", CONSTANT) for r in rows] or [0],
                           np.int32)),
        v1=t(fc("v1", 1.0)), v2=t(fc("v2", 0.0)),
        uv_scale=t(np.stack([f("uscale", 1.0), f("vscale", 1.0)], -1)),
        uv_delta=t(np.stack([f("udelta", 0.0), f("vdelta", 0.0)], -1)),
        img_id=t(np.asarray([r.get("img", 0) for r in rows] or [0],
                            np.int32)),
        octaves=t(f("octaves", 6.0)), omega=t(f("omega", 0.5)),
        scale3d=t(f("scale3d", 1.0)), variation=t(f("variation", 0.2)),
        op1=t(op_rows[0]), op2=t(op_rows[1]), op3=t(op_rows[2]),
        images=t(stack), img_wh=t(wh), mip_off=t(mip_off),
        mip_wh=t(mip_wh), n_levels=t(n_levels),
        spread=t(np.float32(spread)), ewa=(filtering == "ewa"),
        nest_depth=nest_depth,
        present=tuple(sorted({int(r.get("type", CONSTANT)) for r in rows}
                             or {CONSTANT})))


# ---------------------------------------------------------------------------
# Perlin-style gradient noise (texture.cpp Noise(), hash-lattice variant)
# ---------------------------------------------------------------------------

def _grad(ix, iy, iz, dx, dy, dz):
    h = rng_mod.pcg4d(ix, iy, iz, 1337)[0] & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    return (torch.where((h & 1) != 0, -u, u)
            + torch.where((h & 2) != 0, -v, v))


def noise3(p: torch.Tensor) -> torch.Tensor:
    """Gradient noise in [-1, 1] over (..., 3)."""
    pi = torch.floor(p)
    pf = p - pi
    ii = pi.to(torch.int32).to(torch.int64)
    ix, iy, iz = ii[..., 0], ii[..., 1], ii[..., 2]
    dx, dy, dz = pf[..., 0], pf[..., 1], pf[..., 2]
    w = pf * pf * pf * (pf * (pf * 6.0 - 15.0) + 10.0)  # smootherstep

    def g(ox, oy, oz):
        return _grad(ix + ox, iy + oy, iz + oz, dx - ox, dy - oy, dz - oz)

    x00 = g(0, 0, 0) * (1 - w[..., 0]) + g(1, 0, 0) * w[..., 0]
    x10 = g(0, 1, 0) * (1 - w[..., 0]) + g(1, 1, 0) * w[..., 0]
    x01 = g(0, 0, 1) * (1 - w[..., 0]) + g(1, 0, 1) * w[..., 0]
    x11 = g(0, 1, 1) * (1 - w[..., 0]) + g(1, 1, 1) * w[..., 0]
    y0 = x00 * (1 - w[..., 1]) + x10 * w[..., 1]
    y1 = x01 * (1 - w[..., 1]) + x11 * w[..., 1]
    return y0 * (1 - w[..., 2]) + y1 * w[..., 2]


def _octaves(p, octaves, omega, fold, max_oct=8):
    out = torch.zeros(p.shape[:-1], device=p.device)
    lam = torch.ones(p.shape[:-1], device=p.device)
    o = torch.ones(p.shape[:-1], device=p.device)
    for i in range(max_oct):
        out = out + torch.where(i < octaves,
                                o * fold(noise3(p * lam[..., None])), 0.0)
        lam = lam * 1.99
        o = o * omega
    return out


def fbm(p, octaves, omega, max_oct: int = 8):
    return _octaves(p, octaves, omega, lambda x: x, max_oct)


def turbulence(p, octaves, omega, max_oct: int = 8):
    return _octaves(p, octaves, omega, torch.abs, max_oct)


# ---------------------------------------------------------------------------
# image lookups
# ---------------------------------------------------------------------------

def _tap(tt: TextureTable, img_id, xi, yi, off, whl):
    """Texel (xi, yi) of one level, clamped into the level and the atlas."""
    wmax = tt.images.shape[2] - 1
    hmax = tt.images.shape[1] - 1
    x = torch.clamp(torch.minimum(torch.clamp_min(xi, 0), whl[..., 0] - 1)
                    + off[..., 0], 0, wmax)
    y = torch.clamp(torch.minimum(torch.clamp_min(yi, 0), whl[..., 1] - 1)
                    + off[..., 1], 0, hmax)
    return tt.images[img_id, y, x]


def _level_rows(tt: TextureTable, img_id, level):
    lv = level.clamp(0, tt.mip_off.shape[1] - 1)
    return (tt.mip_off[img_id, lv].long(), tt.mip_wh[img_id, lv].long())


def _bilinear_image(tt: TextureTable, img_id, uv, level=None):
    """Bilinear tap at one mip level (MIPMap::triangle, core/mipmap.h)."""
    if level is None:
        level = torch.zeros_like(img_id)
    off, whl = _level_rows(tt, img_id, level)
    whf = whl.to(torch.float32)
    x = uv[..., 0] * whf[..., 0] - 0.5
    y = (1.0 - uv[..., 1]) * whf[..., 1] - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = x0f.to(torch.int32).long()
    y0 = y0f.to(torch.int32).long()
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]

    def tap(ox, oy):
        return _tap(tt, img_id, x0 + ox, y0 + oy, off, whl)

    return ((tap(0, 0) * (1 - fx) + tap(1, 0) * fx) * (1 - fy)
            + (tap(0, 1) * (1 - fx) + tap(1, 1) * fx) * fy)


def _lod_levels(tt: TextureTable, img_id, width_texels):
    """(l0, l1, fraction) of the mip levels bracketing a footprint of
    ``width_texels`` level-0 texels."""
    lod = torch.log2(torch.clamp_min(width_texels, 1.0))
    nl = tt.n_levels[img_id].long()
    lod = torch.minimum(torch.clamp_min(lod, 0.0),
                        (nl - 1).to(torch.float32))
    l0f = torch.floor(lod)
    l0 = l0f.to(torch.int32).long()
    l1 = torch.minimum(l0 + 1, nl - 1)
    return l0, l1, (lod - l0f)[..., None]


def _trilinear_image(tt: TextureTable, img_id, uv, width_uv):
    """MIPMap::Lookup (core/mipmap.h:63), isotropic: the level is
    log2(width in texels), lerped between the two adjacent levels."""
    whf = tt.img_wh[img_id].to(torch.float32)
    l0, l1, fl = _lod_levels(
        tt, img_id, width_uv * torch.maximum(whf[..., 0], whf[..., 1]))
    a = _bilinear_image(tt, img_id, uv, l0)
    b = _bilinear_image(tt, img_id, uv, l1)
    return a * (1.0 - fl) + b * fl


_EWA_HALF = 8  # the tap window's half-extent (maxAniso 8, mipmap.h:188-199)


def _ewa_one_level(tt: TextureTable, img_id, uv, duv0, duv1, level):
    """MIPMap::EWA at one level (core/mipmap.h:137-181): the Gaussian-
    weighted average over the texel ellipse of (duv0, duv1), over a fixed
    (2·_EWA_HALF+1)² window in which taps outside the ellipse weigh 0."""
    off, whl = _level_rows(tt, img_id, level)
    whf = whl.to(torch.float32)
    sx = uv[..., 0] * whf[..., 0] - 0.5
    sy = (1.0 - uv[..., 1]) * whf[..., 1] - 0.5
    d0x = duv0[..., 0] * whf[..., 0]
    d0y = -duv0[..., 1] * whf[..., 1]
    d1x = duv1[..., 0] * whf[..., 0]
    d1y = -duv1[..., 1] * whf[..., 1]
    # ellipse A u² + B u v + C v² < 1 (mipmap.h:141-152)
    A = d0y * d0y + d1y * d1y + 1.0
    B = -2.0 * (d0x * d0y + d1x * d1y)
    C = d0x * d0x + d1x * d1x + 1.0
    inv_f = 1.0 / torch.clamp_min(A * C - B * B * 0.25, 1e-12)
    A = A * inv_f
    B = B * inv_f
    C = C * inv_f

    cx = torch.round(sx).to(torch.int32).long()
    cy = torch.round(sy).to(torch.int32).long()
    # the window's rows and columns, hoisted out of the tap loop: each
    # tap's weight takes the operations of pbrt_tpu's per-tap expression
    # in its order, ((A·u)·u + (B·u)·v) + (C·v)·v, and the taps are summed
    # one by one in pbrt_tpu's order (rows outer, columns inner)
    hm, wm = tt.images.shape[1], tt.images.shape[2]
    flat = tt.images.reshape(-1, tt.images.shape[-1])
    base = img_id * (hm * wm)
    offs = range(-_EWA_HALF, _EWA_HALF + 1)
    cols, rows = [], []
    for o_ in offs:
        uu = (cx + o_).to(torch.float32) - sx
        xi = torch.clamp(torch.minimum(torch.clamp_min(cx + o_, 0),
                                       whl[..., 0] - 1) + off[..., 0],
                         0, wm - 1)
        cols.append((A * uu * uu, B * uu, xi))
        vv = (cy + o_).to(torch.float32) - sy
        yi = torch.clamp(torch.minimum(torch.clamp_min(cy + o_, 0),
                                       whl[..., 1] - 1) + off[..., 1],
                         0, hm - 1)
        rows.append((vv, C * vv * vv, base + yi * wm))
    acc = torch.zeros(uv.shape[:-1] + (tt.images.shape[-1],),
                      device=uv.device)
    wsum = torch.zeros(uv.shape[:-1], device=uv.device)
    exp_neg2 = float(np.exp(-2.0))
    for vv, cvv, row in rows:
        for auu, bu, xi in cols:
            e = auu + bu * vv + cvv
            w = torch.where(e < 1.0, torch.exp(-2.0 * e) - exp_neg2, 0.0)
            acc = acc + torch.index_select(flat, 0, row + xi) * w[..., None]
            wsum = wsum + w
    return acc / torch.clamp_min(wsum, 1e-9)[..., None]


def _ewa_image(tt: TextureTable, img_id, uv, duv0, duv1):
    """MIPMap::Lookup's anisotropic path (core/mipmap.h:103-135): the
    level from the minor axis, the eccentricity clamped to max_aniso by
    lengthening the minor axis, EWA lerped between the two levels."""
    len0 = torch.sqrt((duv0 * duv0).sum(-1))
    len1 = torch.sqrt((duv1 * duv1).sum(-1))
    swap = (len1 > len0)[..., None]
    major = torch.where(swap, duv1, duv0)
    minor = torch.where(swap, duv0, duv1)
    maj_l = torch.maximum(len0, len1)
    min_l = torch.minimum(len0, len1)
    scale = torch.where(
        min_l * tt.max_aniso < maj_l,
        maj_l / torch.clamp_min(min_l * tt.max_aniso, 1e-12), 1.0)
    minor = minor * scale[..., None]
    min_l = min_l * scale
    whf = tt.img_wh[img_id].to(torch.float32)
    l0, l1, fl = _lod_levels(
        tt, img_id, min_l * torch.maximum(whf[..., 0], whf[..., 1]))
    a = _ewa_one_level(tt, img_id, uv, major, minor, l0)
    b = _ewa_one_level(tt, img_id, uv, major, minor, l1)
    return a * (1.0 - fl) + b * fl


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

_MARBLE_C = np.asarray(
    [[.58, .58, .6], [.58, .58, .6], [.58, .58, .6],
     [.5, .5, .5], [.6, .59, .58], [.58, .58, .6],
     [.58, .58, .6], [.2, .2, .33], [.58, .58, .6]], np.float32)


def _bump_int(x):
    x2 = x * 0.5
    return torch.floor(x2) + 2.0 * torch.clamp_min(
        x2 - torch.floor(x2) - 0.5, 0.0)


def _checkerboard(st, uvs, v1, v2, width_uv, duv0, duv1):
    """textures/checkerboard.{h,cpp}, 2D: a point sample without a
    footprint, else the closed-form box filter (checkerboard.h:75-100)."""
    check = ((torch.floor(st[..., 0]) + torch.floor(st[..., 1]))
             .to(torch.int32) % 2) == 0
    if width_uv is None and duv0 is None:
        return torch.where(check[..., None], v1, v2)
    if duv0 is not None and duv1 is not None:
        ds = torch.maximum(duv0[..., 0].abs(), duv1[..., 0].abs()) \
            * uvs[..., 0]
        dt_ = torch.maximum(duv0[..., 1].abs(), duv1[..., 1].abs()) \
            * uvs[..., 1]
    else:
        ds = width_uv * uvs[..., 0]
        dt_ = width_uv * uvs[..., 1]
    ds = torch.clamp_min(ds, 1e-8)
    dt_ = torch.clamp_min(dt_, 1e-8)
    s0 = st[..., 0] - ds
    s1 = st[..., 0] + ds
    t0 = st[..., 1] - dt_
    t1 = st[..., 1] + dt_
    sint = (_bump_int(s1) - _bump_int(s0)) / (2.0 * ds)
    tint = (_bump_int(t1) - _bump_int(t0)) / (2.0 * dt_)
    area2 = sint + tint - 2.0 * sint * tint
    area2 = torch.where((ds > 1.0) | (dt_ > 1.0), 0.5, area2)
    inside_one = ((torch.floor(s0) == torch.floor(s1))
                  & (torch.floor(t0) == torch.floor(t1)))
    area2 = torch.where(inside_one, torch.where(check, 0.0, 1.0), area2)
    return (1.0 - area2)[..., None] * v1 + area2[..., None] * v2


def _marble(p3, variation, fbm_p3, C):
    """textures/marble.h:59-89: sin-warped FBm through the 9-colour Bézier
    spline, ×1.5, with pbrt-v3's `min(1, floor(t*NSEG))` segment clamp
    (only the first two segments are reachable there)."""
    mt = 0.5 + 0.5 * torch.sin(p3[..., 1] + variation * fbm_p3)
    mc = torch.as_tensor(_MARBLE_C, device=p3.device)
    if C != 3:
        from pbrt_tpu_torch.core import spectrum as spec_mod
        mc = spec_mod.rgb_to_spectrum(mc)
    nseg = _MARBLE_C.shape[0] - 3
    first = torch.clamp_max(torch.floor(mt * nseg).to(torch.int32), 1)
    mt2 = (mt * nseg - first)[..., None]
    f0 = (first == 0)[..., None]
    c0 = torch.where(f0, mc[0], mc[1])
    c1 = torch.where(f0, mc[1], mc[2])
    c2 = torch.where(f0, mc[2], mc[3])
    c3 = torch.where(f0, mc[3], mc[4])
    b0 = (1 - mt2) * c0 + mt2 * c1
    b1 = (1 - mt2) * c1 + mt2 * c2
    b2 = (1 - mt2) * c2 + mt2 * c3
    b0 = (1 - mt2) * b0 + mt2 * b1
    b1 = (1 - mt2) * b1 + mt2 * b2
    return 1.5 * ((1 - mt2) * b0 + mt2 * b1)


def eval_texture(tt: TextureTable, tex_id, uv, p, width_uv=None, duv0=None,
                 duv1=None, _depth: int | None = None) -> torch.Tensor:
    """Texture rows ``tex_id`` (R,) at uv (R,2) and world p (R,3) →
    (R,C). ``width_uv`` (R,) is an isotropic uv footprint that selects the
    mip level (None: level-0 bilinear); ``duv0`` / ``duv1`` (R,2) are the
    anisotropic footprint's axes (imagemaps use them when ``tt.ewa``).
    Texture operands resolve by unrolling ``tt.nest_depth`` passes. Each
    type present in the table is evaluated on every lane and selected by
    the lane's row type, in pbrt_tpu's order; a type no row has is
    skipped."""
    if _depth is None:
        _depth = tt.nest_depth

    def has(*types):
        return not tt.present or any(x in tt.present for x in types)

    tid = tex_id.long().clamp(0, tt.ttype.shape[0] - 1)
    t = tt.ttype[tid]
    v1 = tt.v1[tid]
    v2 = tt.v2[tid]
    amt = tt.omega[tid][..., None]   # a mix's amount rides in omega
    if _depth > 0:
        def op_resolve(op, fallback):
            sub = eval_texture(tt, torch.clamp_min(op, 0), uv, p, width_uv,
                               duv0, duv1, _depth=_depth - 1)
            return torch.where((op >= 0)[..., None], sub, fallback)
        v1 = op_resolve(tt.op1[tid], v1)
        v2 = op_resolve(tt.op2[tid], v2)
        amt = op_resolve(tt.op3[tid], amt)[..., 0:1]
    uvs = tt.uv_scale[tid]
    st = uv * uvs + tt.uv_delta[tid]
    C = v1.shape[-1]

    def sel(ttype, val, out):
        return torch.where((t == ttype)[..., None], val, out)

    out = v1  # CONSTANT
    if has(CHECKERBOARD):
        out = sel(CHECKERBOARD, _checkerboard(st, uvs, v1, v2, width_uv,
                                              duv0, duv1), out)
    if has(UV):   # the uv debug texture
        uvc = torch.zeros_like(v1)
        uvc[..., 0] = st[..., 0] - torch.floor(st[..., 0])
        if C > 1:
            uvc[..., 1] = st[..., 1] - torch.floor(st[..., 1])
        out = sel(UV, uvc, out)
    if has(DOTS):   # polka dots (textures/dots.cpp)
        cell = torch.floor(st + 0.5)
        key = _f32_to_u32(cell[..., 0]) + _f32_to_u32(cell[..., 1]) * 9973
        rcenter = torch.stack([rng_mod.uniform(key, 0, 21),
                               rng_mod.uniform(key, 0, 22)], -1) * 0.7 \
            - 0.35
        in_dot = ((st - cell - rcenter) ** 2).sum(-1) < 0.0625
        out = sel(DOTS, torch.where(in_dot[..., None], v1, v2), out)
    if has(BILERP):   # textures/bilerp.cpp: corners v00 = v1, v11 = v2
        u_, v_ = st[..., 0:1], st[..., 1:2]
        bl = (1 - u_) * (1 - v_) * v1 + u_ * v_ * v2 \
            + (u_ * (1 - v_) + (1 - u_) * v_) * 0.5 * (v1 + v2)
        out = sel(BILERP, bl, out)
    if has(IMAGEMAP):
        img_id = tt.img_id[tid].long()
        frac = st - torch.floor(st)
        if tt.ewa and duv0 is not None and duv1 is not None:
            img = _ewa_image(tt, img_id, frac, duv0 * uvs, duv1 * uvs)
        elif width_uv is None:
            img = _bilinear_image(tt, img_id, frac)
        else:
            img = _trilinear_image(tt, img_id, frac,
                                   width_uv * uvs.amax(dim=-1))
        out = sel(IMAGEMAP, img * v1, out)
    # the noise textures over world position (textures/{fbm,wrinkled,
    # windy,marble}.cpp)
    if has(FBM, WRINKLED, WINDY, MARBLE):
        p3 = p * tt.scale3d[tid][..., None]
        octv = tt.octaves[tid]
        omg = tt.omega[tid]
        f = fbm(p3, octv, omg) if has(FBM, MARBLE) else None
        if has(FBM):
            out = sel(FBM, v1 * f[..., None], out)
        if has(WRINKLED):
            w = turbulence(p3, octv, omg)
            out = sel(WRINKLED, v1 * w[..., None], out)
        if has(WINDY):
            windy = (fbm(p3 * 0.1, torch.full_like(octv, 3.0), omg).abs()
                     * fbm(p3, torch.full_like(octv, 6.0), omg))
            out = sel(WINDY, v1 * windy[..., None], out)
        if has(MARBLE):
            out = sel(MARBLE, _marble(p3, tt.variation[tid], f, C), out)
    # scale / mix (texture operands resolved above)
    if has(SCALE):
        out = sel(SCALE, v1 * v2, out)
    if has(MIX):
        out = sel(MIX, (1 - amt) * v1 + amt * v2, out)
    return out


def _f32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 → uint32 conversion (saturating: negatives and NaN
    give 0), as an int64 in [0, 2³²)."""
    x = torch.nan_to_num(x, nan=0.0)
    return torch.clamp(x, 0.0, 4294967295.0).to(torch.int64)


def resolve_kd(scene, mp, hit, wo=None) -> torch.Tensor:
    """kd with the texture override: a row with ``kd_tex`` ≥ 0 looks the
    texture up, on those lanes only (gathered, then scattered back). The
    mip footprint is the camera's pixel spread times the hit distance over
    |∂p/∂u| (the reference's ray-differential footprint,
    core/interaction.cpp ComputeDifferentials, collapsed to its isotropic
    width); with ``wo`` (−ray direction) and an EWA table, the screen
    footprint is projected onto the tangent plane and solved against
    (dpdu, dpdv) for the anisotropic uv axes."""
    tt = getattr(scene, "textures", None)
    if tt is None:
        return mp.kd
    idx = torch.nonzero(mp.kd_tex >= 0).squeeze(-1)
    if not idx.numel():
        return mp.kd
    t, uv, p = hit.t[idx], hit.uv[idx], hit.p[idx]
    width_uv = duv0 = duv1 = None
    if hit.dpdu is not None:
        dpdu = hit.dpdu[idx]
        world_w = t * tt.spread
        width_uv = world_w / torch.clamp_min(vecmath.length(dpdu), 1e-8)
        if tt.ewa and wo is not None and hit.dpdv is not None:
            dpdv, ng = hit.dpdv[idx], hit.ng[idx]
            d = -wo[idx]
            e1, e2 = vecmath.coordinate_system(d)
            den = vecmath.dot(d, ng)
            den = torch.where(den.abs() > 1e-4, den,
                              torch.where(den >= 0, 1e-4, -1e-4))
            dpdx = world_w[..., None] * (
                e1 - d * (vecmath.dot(e1, ng) / den)[..., None])
            dpdy = world_w[..., None] * (
                e2 - d * (vecmath.dot(e2, ng) / den)[..., None])
            g11 = vecmath.dot(dpdu, dpdu)
            g12 = vecmath.dot(dpdu, dpdv)
            g22 = vecmath.dot(dpdv, dpdv)
            det = torch.clamp_min(g11 * g22 - g12 * g12, 1e-12)

            def solve(dp):
                b1 = vecmath.dot(dp, dpdu)
                b2 = vecmath.dot(dp, dpdv)
                return torch.stack([(g22 * b1 - g12 * b2) / det,
                                    (g11 * b2 - g12 * b1) / det], dim=-1)

            duv0 = solve(dpdx)
            duv1 = solve(dpdy)
    tex_val = eval_texture(tt, mp.kd_tex[idx], uv, p, width_uv=width_uv,
                           duv0=duv0, duv1=duv1)
    return mp.kd.index_put((idx,), tex_val)
