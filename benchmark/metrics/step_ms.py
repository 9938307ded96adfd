"""step_ms: the window's time over the training steps it completed
(host clock, one card)."""


def read(rec):
    if rec["kind"] != "steps" or not rec["items"]:
        return None
    return 1e3 * rec["window_s"] / rec["items"]
