"""imgtool: assemble / cat / convert / diff / info.

Port of pbrt_tpu/tools/imgtool.py, the counterpart of
``src/tools/imgtool.cpp:32-36`` — `diff` with
--difftol (imgtool.cpp:67-71) is the image-comparison oracle used by
regression tests.

Usage: python -m pbrt_tpu_torch.tools.imgtool <cmd> [args]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from pbrt_tpu_torch.utils import imageio


def cmd_info(args):
    img = imageio.read_image(args.image)
    print(f"{args.image}: {img.shape[1]} x {img.shape[0]}")
    print(f"  min: {img.min(axis=(0, 1))}")
    print(f"  max: {img.max(axis=(0, 1))}")
    print(f"  avg: {img.mean(axis=(0, 1))}")
    ok = np.isfinite(img)
    if not ok.all():
        print(f"  WARNING: {np.size(img) - ok.sum()} non-finite values")
    return 0


def cmd_diff(args):
    a = imageio.read_image(args.image1)
    b = imageio.read_image(args.image2)
    if a.shape != b.shape:
        print(f"images differ in resolution: {a.shape} vs {b.shape}")
        return 1
    d = np.abs(a - b)
    denom = np.abs(a) + np.abs(b)
    rel = 2.0 * d / np.where(denom > 0, denom, 1.0)
    n_diff = (rel > args.difftol).sum()
    mse = float((d * d).mean())
    print(f"images differ: {n_diff} pixels above tol {args.difftol}, "
          f"MSE {mse:.6g}, avg abs diff {float(d.mean()):.6g}")
    if args.outfile:
        imageio.write_image(args.outfile, d)
    return 1 if n_diff > 0 else 0


def _luminance(img):
    return (img[..., 0] * 0.212671 + img[..., 1] * 0.715160
            + img[..., 2] * 0.072169)


def despike(img, limit):
    """Median-patch firefly repair (imgtool.cpp convert --despike): any
    pixel whose luminance exceeds `limit` is replaced by the
    luminance-MEDIAN of its (≤9-pixel) neighborhood — not clamped."""
    h, w, _ = img.shape
    spike = _luminance(img) >= limit
    if not spike.any():
        return img, 0
    out = img.copy()
    ys, xs = np.nonzero(spike)
    for y, x in zip(ys, xs):
        y0, y1 = max(0, y - 1), min(h, y + 2)
        x0, x1 = max(0, x - 1), min(w, x + 2)
        patch = img[y0:y1, x0:x1].reshape(-1, img.shape[-1])
        order = np.argsort(_luminance(patch), kind="stable")
        out[y, x] = patch[order[len(order) // 2]]
    return out, len(ys)


def bloom(img, level, width=15, scale=0.3, iters=5):
    """Bloom overlay (imgtool.cpp:492-585): threshold pixels with any
    channel above `level`, repeatedly blur with a separable
    exp(-2·|r|/radius) kernel, add the scaled sum of the blur passes."""
    thresholded = np.where((img > level).any(-1, keepdims=True), img, 0.0)
    if not (thresholded > 0).any():
        print(f"imgtool: warning: no pixels were above bloom threshold "
              f"{level}", file=sys.stderr)
        return img
    if width % 2 == 0:
        width += 1
        print(f"imgtool: bloom width must be an odd value. Rounding up "
              f"to {width}.", file=sys.stderr)
    radius = width // 2
    sigma = 2.0
    wts = np.exp(-sigma * np.abs(np.arange(width) - radius) / radius)
    wts /= wts.sum()

    def blur_axis(im, axis):
        pad = [(0, 0)] * 3
        pad[axis] = (radius, radius)
        ext = np.pad(im, pad, mode="edge")
        out = np.zeros_like(im)
        for i, wt in enumerate(wts):
            sl = [slice(None)] * 3
            sl[axis] = slice(i, i + im.shape[axis])
            out += wt * ext[tuple(sl)]
        return out

    blurred = thresholded
    total = np.zeros_like(img)
    for _ in range(iters):
        blurred = blur_axis(blur_axis(blurred, 1), 0)
        total += blurred
    return img + (scale / iters) * total


def cmd_convert(args):
    img = imageio.read_image(args.infile)
    img = np.asarray(img, np.float32) * args.scale
    if args.despike < float("inf"):
        img, n = despike(img, args.despike)
        print(f"{args.infile}: despiked {n} pixels", file=sys.stderr)
    if args.bloomlevel < float("inf"):
        img = bloom(img, args.bloomlevel, args.bloomwidth,
                    args.bloomscale, args.bloomiters)
    if args.tonemap:
        img = img / (1.0 + img)
    if args.gamma != 1.0:
        img = np.power(np.clip(img, 0, None), 1.0 / args.gamma)
    imageio.write_image(args.outfile, img)
    return 0


def cmd_cat(args):
    img = imageio.read_image(args.image)
    for y in range(img.shape[0]):
        for x in range(img.shape[1]):
            print(f"({x}, {y}): ({img[y, x, 0]:.6g}, {img[y, x, 1]:.6g}, "
                  f"{img[y, x, 2]:.6g})")
    return 0


def cmd_assemble(args):
    """Merge non-overlapping crops into one image (imgtool assemble)."""
    imgs = [imageio.read_image(p) for p in args.images]
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    out = np.zeros((h, w, 3), np.float32)
    cnt = np.zeros((h, w, 1), np.float32)
    for i in imgs:
        out[:i.shape[0], :i.shape[1]] += i
        cnt[:i.shape[0], :i.shape[1]] += 1
    out = out / np.maximum(cnt, 1)
    imageio.write_image(args.outfile, out)
    return 0


def cmd_makesky(args):
    """Analytic clear-sky environment map — the Hošek–Wilkie spectral
    model (tools/hosek.py), matching the reference's `imgtool makesky`
    (tools/imgtool.cpp:87-186 + ext/ArHosekSkyModel.c) to float
    precision: lat-long dome, 9 wavelengths averaged 3-per-RGB-channel,
    solar disc with limb darkening, below-horizon rows black."""
    from pbrt_tpu_torch.tools.hosek import makesky_image
    rgb = makesky_image(np.radians(args.elevation), args.turbidity,
                        args.albedo, args.resolution)
    imageio.write_image(args.outfile, rgb * args.scale)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="imgtool")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info")
    p.add_argument("image")

    p = sub.add_parser("diff")
    p.add_argument("image1")
    p.add_argument("image2")
    p.add_argument("--difftol", type=float, default=0.0)
    p.add_argument("--outfile", default=None)

    p = sub.add_parser("convert")
    p.add_argument("infile")
    p.add_argument("outfile")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--tonemap", action="store_true")
    p.add_argument("--despike", type=float, default=float("inf"))
    p.add_argument("--bloomlevel", type=float, default=float("inf"))
    p.add_argument("--bloomwidth", type=int, default=15)
    p.add_argument("--bloomscale", type=float, default=0.3)
    p.add_argument("--bloomiters", type=int, default=5)

    p = sub.add_parser("cat")
    p.add_argument("image")

    p = sub.add_parser("assemble")
    p.add_argument("outfile")
    p.add_argument("images", nargs="+")

    p = sub.add_parser("makesky")
    p.add_argument("outfile")
    p.add_argument("--turbidity", type=float, default=3.0)
    p.add_argument("--albedo", type=float, default=0.5)
    p.add_argument("--elevation", type=float, default=30.0,
                   help="sun elevation in degrees")
    p.add_argument("--resolution", type=int, default=256,
                   help="rows; the lat-long map is 2x as wide")
    p.add_argument("--scale", type=float, default=1.0)

    args = ap.parse_args(argv)
    return {"info": cmd_info, "diff": cmd_diff, "convert": cmd_convert,
            "cat": cmd_cat, "assemble": cmd_assemble,
            "makesky": cmd_makesky}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
