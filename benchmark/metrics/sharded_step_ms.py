"""sharded_step_ms: rank 0's window time over the training steps every
rank completed (host clock, several cards)."""


def read(rec):
    if rec["kind"] != "steps" or not rec["items"]:
        return None
    return 1e3 * rec["window_s"] / rec["items"]
