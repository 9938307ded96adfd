"""fused_roofline_pct: the bounce kernel's (csrc/fused_path.cu) share of
its roofline in the traced block: the least time its first launches
could take (roofline.fused_counts over the reference's count of the
live lanes of the same passes, ``pass_counts``, and the kernel and mode
the configuration's ``roofline`` names) over their device time in the
trace. A pass launches the kernel once, so launch i is pass i. None when
the trace holds fewer launches than passes counted."""

from benchmark import roofline, trace


def read(rec):
    counts, roof = rec.get("pass_counts"), rec["config"].get("roofline")
    if not rec.get("events") or not counts or not roof:
        return None
    launches = sorted((e for e in trace.kernels(rec["events"])
                       if roof["kernel"] in e["name"]),
                      key=lambda e: e["ts"])[:len(counts)]
    if len(launches) < len(counts):
        return None
    bound_ms = sum(roofline.bound_ms(*roofline.fused_counts(
        c["lanes"], c["n_tri"], c["live"], roof["mode"]))[0] for c in counts)
    return 100.0 * bound_ms / (1e-3 * sum(e["dur"] for e in launches))
