"""The device's idle share of the traced block: 100 × (1 − the union of
its kernel, copy and set intervals over the block's span), both from one
torch.profiler trace (rank 0's on several cards)."""

from benchmark import trace


def read(rec):
    if not rec.get("events"):
        return None
    return trace.idle_pct(rec["events"])
