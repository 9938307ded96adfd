"""msamples_per_s: camera samples of the passes the window completed
(counted through render's progress argument) over the window's time, in
millions a second (host clock)."""


def read(rec):
    if rec["kind"] != "images" or not rec["window_s"]:
        return None
    return rec["samples"] / rec["window_s"] / 1e6
