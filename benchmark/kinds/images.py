"""Traffic kind ``images``: a closed loop of whole images through the
system's ``render`` at ``width`` × ``height``, ``spp`` samples a pixel in
passes of ``chunk_spp``, each image synchronised when it ends; image k
takes sample seed base + k. Set-up renders one image first.

The record: every window image's time (``item_ms``), the samples of the
passes completed (``samples``) and the window's length; ``checks``, the
worst ``image_rel_l1`` of ``SAMPLE_IMAGES`` window images drawn from the
seed against the reference at the same seeds; with a trace, the
reference's count of the work of the traced block's first
``COUNTED_PASSES`` passes (``pass_counts``, when the reference counts).
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import compare, drive, trace

SAMPLE_IMAGES = 2     # window images compared with the reference
TRACE_ITEMS = 2       # images in the traced block
COUNTED_PASSES = 4    # passes of the traced block the reference counts


def run(cell, seed, seconds, do_trace, system_cls, device, t_process,
        rank, world, port):
    tr, config = cell["traffic"], cell["config"]
    W, H, spp = tr["width"], tr["height"], tr["spp"]
    chunk = tr.get("chunk_spp") or spp
    passes = -(-spp // chunk)
    inp = drive.Inputs(seed)
    system = system_cls(config, device)

    def image(s, prog=None):
        img = system.render(W, H, spp, chunk, s, prog)
        drive.sync(device)
        return img

    image(inp.warm_seed)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec = {"kind": "images"}
    kept = []
    item_ms, samples, k = [], 0, 0
    events, traced, img = None, [], None
    t0 = time.perf_counter()
    rec["setup_s"] = t0 - t_process
    t_end = t0
    while time.perf_counter() - t0 < seconds:
        if do_trace and events is None and t_end - t0 >= seconds / 4:
            wanted = drive.want(cell, TRACE_ITEMS, passes)
            for _ in range(drive.TRIES):
                block = [inp.seed(k + i) for i in range(TRACE_ITEMS)]
                ev = trace.capture(lambda: [image(s) for s in block], device)
                k += TRACE_ITEMS
                if drive.complete(ev, wanted):
                    events, traced = ev, block
                    break
            else:
                events = []
            t_end = time.perf_counter()
            continue
        s = inp.seed(k)
        prog = drive.Progress(W * H)
        ts = time.perf_counter()
        img = image(s, prog)
        t_end = time.perf_counter()
        item_ms.append(1e3 * (t_end - ts))
        samples += prog.samples
        # a reservoir sample of the finished images, drawn from the seed
        n = len(item_ms)
        if len(kept) < SAMPLE_IMAGES:
            kept.append((s, img))
        else:
            j = inp.pick.randrange(n)
            if j < SAMPLE_IMAGES:
                kept[j] = (s, img)
        k += 1
    rec.update(window_s=t_end - t0, items=len(item_ms), item_ms=item_ms,
               samples=samples, attempted=len(item_ms))
    rec["memory_peak_bytes"] = drive.peak_bytes(device)
    rec["failed"] = sum(not bool(torch.isfinite(img).all())
                        for _, img in kept)
    del system, img
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is gone
    t_ref = time.perf_counter()
    ref, sc = drive.reference(cell, device)
    with torch.no_grad():
        gaps = [compare.rel_l1(img, ref.render(sc, sc.kd, sc.emit, W, H,
                                               spp, s))
                for s, img in kept]
        rec["checks"] = compare.checks(
            {"image_rel_l1": max(gaps, default=math.inf)}, config["limits"])
        if events and hasattr(ref, "pass_counts"):
            todo = [(s, range(a, min(a + chunk, spp))) for s in traced
                    for a in range(0, spp, chunk)][:COUNTED_PASSES]
            rec["pass_counts"] = [ref.pass_counts(sc, W, H, smp, s)
                                  for s, smp in todo]
    rec["reference_s"] = time.perf_counter() - t_ref
    drive.trace_fields(rec, events, len(traced))
    return rec
