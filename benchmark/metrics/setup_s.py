"""setup_s: seconds from the process's start to the first timed
operation: loading, building or loading the kernels, the scene, the
warm-up (host clock)."""


def read(rec):
    return rec["setup_s"]
