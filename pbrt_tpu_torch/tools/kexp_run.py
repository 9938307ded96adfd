"""Run one traversal-kernel experiment on the file that
``pbrt_tpu_torch.tools.kexp_prep`` wrote (port of tools/kexp_run.py).

Usage:
    python -m pbrt_tpu_torch.tools.kexp_run <experiment> [args]
        [--npz PATH] [--smem-nodes N|max] [--device cpu]

Experiments (each prints one JSON line):
  baseline                  the production kernel ops/bvh.py::bvh_traverse
                            (4-wide nodes over the builder's leaves) as the
                            render path launches it
  grid <plain|persistent>   the same with one thread per ray, or with the
                            persistent grid whose warps fetch 32 rays at a time
  l2 <on|off>               the same on a stream of its own with or without
                            an L2 access-policy window over the tree
  binary                    the binary kernel ops/bvh_binary.py, the render
                            path's kernel before the 4-wide one
  smem_probe <KB>           ask one block for that much dynamic shared memory
  variant <v> [block]       variant 1, 2 or 3 of the wide-BVH kernel on the
                            default packing (wide 4, leaves of up to 16)
  count <v>                 steps per ray of variant v (count mode)
  dual [block]              variant 5 on the dual-size leaf layout
  pack <wide> <leaf_max> [block]   variant 2 on another packing

``block`` is the threads per block (64, 128 or 256), ``--smem-nodes`` how
many of the first wide nodes are staged in shared memory (``max``: all that
fit what the probe finds a launch gets). Each ray set of the file is timed
with CUDA events around repeated launches and reported as ``<set>_ms`` per
launch and ``<set>_mrays`` (million rays per second): closest hit on the
primary, random, sorted and bounce rays, any-hit on the shadow rays.
``prim_agreement`` and ``max_abs_dt`` compare the experiment on the file's
mixed rays with the binary twin's hits stored there (the share of rays that
name the same triangle, and the largest difference in ``t``). The default
device is the card, and the run raises without one; with ``--device cpu``
the plain versions run, nothing is timed and the rates are null, as is
``smem_probe``'s ``ok``; ``--smem-nodes max`` raises there.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from pbrt_tpu_torch.ops import bvh as bvh_ops
from pbrt_tpu_torch.ops import bvh_binary
from pbrt_tpu_torch.scene import bvh as bvh_mod
from pbrt_tpu_torch.scene.types import require_device
from pbrt_tpu_torch.tools import kexp_kernels as kk
from pbrt_tpu_torch.tools import kexp_prep

DEFAULT_NPZ = os.path.join(kexp_prep.OUT_DIR, "heightfield.npz")
# name, origins, directions, tmax, any-hit
RAY_SETS = (("primary", "o_p", "d_p", "tmax", False),
            ("random", "o_r", "d_r", "tmax", False),
            ("sorted", "o_rs", "d_rs", "tmax", False),
            ("bounce", "o_b", "d_b", "tmax", False),
            ("shadow", "o_b", "d_sh", "tmax_sh", True))
REPS = 5


def load(path=DEFAULT_NPZ):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def timed_ms(fn, reps=REPS):
    """Mean milliseconds of fn() over ``reps`` launches after one warm-up,
    by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def agreement(t_k, i_k, t_x, i_x, prim_order):
    """Leaf-ordered indices are compared as the triangles they stand for:
    a triangle that spatial splits put into several leaves has several."""
    t_k, i_k = t_k.cpu().numpy(), i_k.cpu().numpy()
    same = (np.where(i_k >= 0, prim_order[np.maximum(i_k, 0)], -1)
            == np.where(i_x >= 0, prim_order[np.maximum(i_x, 0)], -1))
    both = (i_k >= 0) & (i_x >= 0)
    dt = np.abs(np.where(both, t_k - t_x, 0.0))
    return {"prim_agreement": round(float(same.mean()), 6),
            "max_abs_dt": float(dt.max())}


def _dev(z, key, device):
    """Array ``key`` of the file on ``device`` (uploaded once)."""
    cache = z.setdefault("_device", {})
    if (key, str(device)) not in cache:
        cache[key, str(device)] = torch.as_tensor(z[key], device=device)
    return cache[key, str(device)]


def tree_of(z, device):
    """The file's binary tree as a FlatBVH packed for ``device``."""
    cache = z.setdefault("_trees", {})
    if str(device) not in cache:
        cache[str(device)] = bvh_mod._finish_flat(
            z["lo"], z["hi"], z["right"], z["count"], z["axis"],
            z["prim_order"], z["v0"], z["v1"], z["v2"],
            device=device, built_by="kexp")
    return cache[str(device)]


def layout_of(z, device, wide=4, leaf_max=16, dual=False):
    """The file's tree packed wide (``pack_dual_leaf`` when ``dual``) in
    the kernel's layout on ``device``; packed once per shape."""
    cache = z.setdefault("_layouts", {})
    key = (wide, leaf_max, dual, str(device))
    if key not in cache:
        tree = [z[k] for k in kexp_prep.TREE_KEYS[:8]]
        if dual:
            tabs, pp = kk.pack_dual_leaf(*tree, leaf_max=leaf_max), kk.DUAL_PP
        else:
            *tabs, pp = kk.pack_params(*tree, wide=wide, leaf_max=leaf_max)
        cache[key] = kk.make_layout(*tabs, pp, dual=dual, device=device)
    return cache[key]


def _smem_nodes(layout, smem_nodes, device):
    """``max``: all the nodes that fit what the probe finds a launch gets
    (it raises on a device without shared memory to probe)."""
    if smem_nodes != "max":
        return int(smem_nodes)
    return kk.max_smem_nodes(layout, kk.smem_limit_kb(device))


def _check_and_time(z, query, device, out):
    """Fill ``out`` with the agreement of ``query(o, d, tmax, any_hit)`` on
    the file's mixed rays and, on the card, its time on every ray set."""
    n = len(z["t_x"])
    t_k, i_k = query(_dev(z, "o_mix", device), _dev(z, "d_mix", device),
                     _dev(z, "tmax", device)[:n].contiguous(), False)
    out.update(agreement(t_k, i_k, z["t_x"], z["i_x"], z["prim_order"]))
    for name, ok, dk, tk, any_hit in RAY_SETS:
        if dk not in z:
            continue
        if device.type != "cuda":
            out[name + "_ms"] = out[name + "_mrays"] = None
            continue
        o, d, tmax = (_dev(z, k, device) for k in (ok, dk, tk))
        ms = timed_ms(lambda: query(o, d, tmax, any_hit))
        out[name + "_ms"] = round(ms, 4)
        out[name + "_mrays"] = round(o.shape[0] / ms / 1e3, 2)
    return out


def exp_baseline(z, device, persistent=True, l2=None):
    """The production kernel on the render path's persistent grid, or with
    ``persistent=False`` on one thread per ray; with ``l2`` True / False
    inside ``kexp_kernels.l2_window`` with / without the window."""
    tree = tree_of(z, device)
    out = {"nodes": int(tree.lo.shape[0]),
           "wide_nodes": int(tree.nodes.shape[0]),
           "stack_need": tree.stack_need, "persistent": persistent}

    def query(o, d, tmax, any_hit):
        return bvh_ops.bvh_traverse(tree, o, d, tmax, any_hit,
                                    persistent=persistent)

    if l2 is None:
        return _check_and_time(z, query, device, out)
    with kk.l2_window(tree, l2):
        return _check_and_time(z, query, device, dict(out, l2_window=l2))


def exp_binary(z, device):
    tree = tree_of(z, device)
    return _check_and_time(
        z, lambda o, d, tmax, any_hit: bvh_binary.bvh_traverse_binary(
            tree, o, d, tmax, any_hit), device,
        {"nodes": int(tree.lo.shape[0])})


def _choice(args, names):
    if len(args) != 1 or args[0] not in names:
        raise SystemExit(f"want one of {names}, got {args}")
    return args[0] == names[1]


def _exp_wide(z, layout, variant, block, smem_nodes, device, out):
    smem_nodes = _smem_nodes(layout, smem_nodes, device)
    out.update(block=block, smem_nodes=smem_nodes, nw=layout.n_nodes,
               stack_need=layout.stack_need)
    return _check_and_time(
        z, lambda o, d, tmax, any_hit: kk.traverse(
            layout, o, d, tmax, any_hit=any_hit, variant=variant, block=block,
            smem_nodes=smem_nodes), device, out)


def exp_variant(z, variant, block=128, device="cuda", smem_nodes=0):
    if variant not in (1, 2, 3):
        raise SystemExit(f"variant {variant}: 1, 2 or 3 (5 is `dual`)")
    return _exp_wide(z, layout_of(z, device), variant, block, smem_nodes,
                     device, {"variant": variant})


def exp_dual(z, block=128, device="cuda", smem_nodes=0):
    layout = layout_of(z, device, dual=True)
    return _exp_wide(z, layout, 5, block, smem_nodes, device,
                     {"exp_kind": "dual",
                      "tri_rows": int(layout.rows.shape[0])})


def exp_pack(z, wide, leaf_max, block=128, device="cuda", smem_nodes=0):
    layout = layout_of(z, device, wide=wide, leaf_max=leaf_max)
    return _exp_wide(z, layout, 2, block, smem_nodes, device,
                     {"wide": wide, "leaf_max": leaf_max, "n_leaf_blocks":
                      int(layout.rows.shape[0] // layout.block_rows)})


def warp_efficiency(code):
    """From the step codes of a count-mode launch (``steps·65536 + leaf
    steps``, a step being one pop of a ray's stack: wide node or leaf for
    the 4-wide kernels, node for the binary one): the steps of all rays
    over 32 times the sum, over each group of 32 consecutive rays (a warp
    of the one-ray-per-thread grid), of the group's longest walk. 1.0 when
    every ray of a warp takes as many steps as its longest."""
    code = code.long()
    steps = (code >> 16) + (code & 0xFFFF)
    n = steps.numel() // 32 * 32
    longest = steps[:n].reshape(-1, 32).amax(dim=1)
    return float(steps[:n].sum()) / float(32 * longest.sum())


def exp_count(z, variant, device="cuda", wide=4, leaf_max=16):
    """Wide-node and leaf steps per ray (the variant + 10 kernel). A thread
    walks one ray, so a "packet" is a ray here."""
    layout = layout_of(z, device, wide=wide, leaf_max=leaf_max,
                       dual=variant == 5)
    out = {"variant": variant}
    for name, ok, dk, tk, any_hit in RAY_SETS:
        if dk not in z:
            continue
        _, code = kk.traverse(layout, *(_dev(z, k, device)
                                        for k in (ok, dk, tk)),
                              any_hit=any_hit, variant=variant + 10)
        code = code.cpu().numpy()
        n_int, n_leaf = code >> 16, code & 0xFFFF
        out[name] = {"packets": int(len(code)),
                     "int_steps_mean": round(float(n_int.mean()), 1),
                     "leaf_steps_mean": round(float(n_leaf.mean()), 1),
                     "int_steps_max": int(n_int.max()),
                     "leaf_steps_max": int(n_leaf.max())}
    return out


def run(exp, args, z, device, smem_nodes=0):
    """One experiment by name with its positional arguments (strings)."""
    def block(i):
        return int(args[i]) if len(args) > i else 128

    if exp == "baseline":
        return exp_baseline(z, device)
    if exp == "grid":
        return exp_baseline(z, device, persistent=_choice(
            args, ("plain", "persistent")))
    if exp == "l2":
        return exp_baseline(z, device, l2=_choice(args, ("off", "on")))
    if exp == "binary":
        return exp_binary(z, device)
    if exp == "smem_probe":
        return kk.smem_probe(int(args[0]), device)
    if exp == "variant":
        return exp_variant(z, int(args[0]), block(1), device, smem_nodes)
    if exp == "count":
        return exp_count(z, int(args[0]), device)
    if exp == "dual":
        return exp_dual(z, block(0), device, smem_nodes)
    if exp == "pack":
        return exp_pack(z, int(args[0]), int(args[1]), block(2), device,
                        smem_nodes)
    raise SystemExit(f"unknown experiment {exp}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("experiment")
    ap.add_argument("args", nargs="*")
    ap.add_argument("--npz", default=DEFAULT_NPZ)
    ap.add_argument("--smem-nodes", default="0")
    ap.add_argument("--device", default="cuda")
    ns = ap.parse_args(argv)
    device = require_device(ns.device)
    z = {} if ns.experiment == "smem_probe" else load(ns.npz)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = run(ns.experiment, ns.args, z, device, ns.smem_nodes)
    out["exp"] = ns.experiment
    out["device"] = (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu")
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
