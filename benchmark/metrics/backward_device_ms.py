"""backward_device_ms: device time a training step of the kernels
launched under autograd's backward (host ops named
"autograd::engine::evaluate_function: ..."): replay's VJP and
ops/fastgather.py's reductions. Read from the host capture, whose host
ops it needs; the device times of its kernels are the card's own."""

from benchmark import trace


def read(rec):
    if not rec.get("events_host"):
        return None
    us = trace.device_us_under(rec["events_host"],
                               "autograd::engine::evaluate_function")
    return 1e-3 * us / rec["host_trace_iters"]
