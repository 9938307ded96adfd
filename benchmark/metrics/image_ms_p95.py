"""image_ms_p95: the 95th percentile of every window image's time from
its start to the synchronisation that ends it (host clock)."""

import statistics


def read(rec):
    ms = rec.get("item_ms") or []
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
