"""collective_ms: device time a training step of the NCCL collectives
(the film merge's all_reduce and all_gather, the parameters'
all_reduce), each counted from the moment its last rank arrives.

A collective's kernel runs on every rank from that rank's arrival to the
end of the exchange, so on any one rank it also holds the wait for the
slowest. The rank that arrives last waits for no one: the least
duration of a launch over the ranks is the collective's own time. The
launches are matched by their order, the same on every rank; None when
the ranks' traces hold different numbers of them."""


def read(rec):
    per_rank = (rec.get("step_kernel_us") or {}).get("nccl")
    if not per_rank or not rec.get("trace_iters"):
        return None
    n = len(per_rank[0])
    if n == 0 or any(len(r) != n for r in per_rank):
        return None
    us = sum(min(r[i] for r in per_rank) for i in range(n))
    return 1e-3 * us / rec["trace_iters"]
