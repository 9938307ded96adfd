"""Traffic kind ``steps``: a closed loop of training steps through the
system's ``train_step`` over a (dp, sp) = ``mesh`` of ``ranks``
processes, one card each, each step feeding the next with sample seed
base + k. The parameters (kd, emit) start at the scene's own values
times factors in 1 ± ``perturb``/2 drawn from the seed; the target is
the image of the scene's own values at another seed. Set-up drives the
first ``COMPARE_STEPS`` steps, which the reference follows, and two more.

The record: the window's steps and length; ``checks``, the gaps of the
compared steps' losses, first gradient and change against the
reference's; with a trace, a device capture of ``TRACE_ITEMS`` steps
(``events``), a host capture of ``HOST_TRACE_ITEMS`` (``events_host``)
and, for each kernel the mix names in ``step_kernels``, every rank's
durations of its launches in the device capture, in order
(``step_kernel_us``).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from benchmark import compare, drive, trace
from benchmark.systems import flat

COMPARE_STEPS = 3      # set-up steps the reference follows
TRACE_ITEMS = 3        # steps in the traced block, device capture
HOST_TRACE_ITEMS = 3   # steps in the traced block, host capture


def _launch_us(events, name):
    """Durations of the kernels whose name holds ``name``, in order."""
    return [e["dur"] for e in sorted(trace.kernels(events),
                                     key=lambda e: e["ts"])
            if name in e["name"]]


def run(cell, seed, seconds, do_trace, system_cls, device, t_process,
        rank, world, port):
    tr, config = cell["traffic"], cell["config"]
    W, H, spp, lr = tr["width"], tr["height"], tr["spp"], tr["lr"]
    inp = drive.Inputs(seed, tr["perturb"])
    system = system_cls(config, device)
    system.init_group(port, world, rank)
    mesh = system.mesh(tr["mesh"])
    own = system.own_params()
    p0 = {"kd": own["kd"] * torch.as_tensor(
              inp.f_kd[:own["kd"].shape[0]], dtype=own["kd"].dtype,
              device=device),
          "emit": own["emit"] * torch.as_tensor(
              inp.f_emit, dtype=own["emit"].dtype, device=device)}
    target = system.render_sharded(mesh, W, H, spp, inp.target_seed)

    def step(k, p):
        return system.train_step(mesh, W, H, spp, inp.seed(k), p, target, lr)

    # the compared steps, then two more timed between synchronisations
    p, losses, states = p0, [], [p0]
    for k in range(COMPARE_STEPS):
        p, loss = step(k, p)
        losses.append(float(loss))
        states.append(p)
    times = []
    for k in range(COMPARE_STEPS, COMPARE_STEPS + 2):
        ts = time.perf_counter()
        p, _ = step(k, p)
        drive.sync(device)
        times.append(time.perf_counter() - ts)
    k = COMPARE_STEPS + 2
    n_steps = None
    if world > 1:
        # every rank takes the same number of steps: rank 0's estimate
        box = [max(1, round(seconds / (sum(times) / len(times))))]
        dist.broadcast_object_list(box, src=0)
        n_steps = box[0]
        dist.barrier()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    rec = {"kind": "steps"}
    win_losses, events, n_traced, done = [], None, 0, 0
    t0 = time.perf_counter()
    rec["setup_s"] = t0 - t_process

    def window_over():
        if n_steps is not None:
            return done >= n_steps
        return time.perf_counter() - t0 >= seconds

    while not window_over():
        due = (n_steps is not None and done >= n_steps // 4) or (
            n_steps is None and time.perf_counter() - t0 >= seconds / 4)
        if do_trace and events is None and due:
            # a device capture, then a host capture for the readers that
            # attribute kernels to host ops; each again while incomplete
            got = []
            for host_ops, n_it in ((False, TRACE_ITEMS),
                                   (True, HOST_TRACE_ITEMS)):
                wanted = drive.want(cell, n_it, 1)
                for _ in range(drive.TRIES):
                    box = {"p": p}

                    def block():
                        q = box["p"]
                        for i in range(n_it):
                            q, loss_i = step(k + i, q)
                            win_losses.append(loss_i)
                        box["p"] = q

                    ev = trace.capture(block, device, host_ops)
                    p, k, done = box["p"], k + n_it, done + n_it
                    ok = torch.tensor([float(drive.complete(ev, wanted))],
                                      device=device)
                    if world > 1:
                        dist.all_reduce(ok, op=dist.ReduceOp.MIN)
                    if bool(ok.item()):
                        got.append(ev)
                        break
                else:
                    got.append([])
            events, rec["events_host"] = got
            rec["host_trace_iters"] = HOST_TRACE_ITEMS
            n_traced = TRACE_ITEMS
            continue
        p, loss = step(k, p)
        win_losses.append(loss)
        k += 1
        done += 1
    drive.sync(device)
    t1 = time.perf_counter()
    rec.update(window_s=t1 - t0, items=done, attempted=done)
    rec["failed"] = (int((~torch.isfinite(torch.stack(
        [x.reshape(()) for x in win_losses]))).sum()) if win_losses else 0)
    rec["memory_peak_bytes"] = drive.peak_bytes(device)
    prog = {"losses": losses,
            "grad": {n: (flat(states[0][n]) - flat(states[1][n])) / lr
                     for n in ("kd", "emit")},
            "change": {n: flat(states[-1][n]) - flat(states[0][n])
                       for n in ("kd", "emit")}}
    del system, p, target, states, p0, own, win_losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, each rank its share of the lanes, completed by sums
    t_ref = time.perf_counter()
    ref, sc = drive.reference(cell, device)
    dp, sp = tr["mesh"]
    r_dp, r_sp = rank // sp, rank % sp
    share = (range(r_dp * spp // dp, (r_dp + 1) * spp // dp),
             range(r_sp * H // sp, (r_sp + 1) * H // sp))
    all_reduce = dist.all_reduce if world > 1 else None
    with torch.no_grad():
        tgt = torch.zeros((H, W, 3), dtype=torch.float64, device=device)
        tgt[share[1].start:share[1].stop] = ref.render_region(
            sc, sc.kd, sc.emit, W, H, share[0], inp.target_seed,
            rows=share[1]) / spp
        if all_reduce:
            all_reduce(tgt)
    kd0 = sc.kd * torch.as_tensor(inp.f_kd[:sc.kd.shape[0]],
                                  dtype=sc.kd.dtype, device=device)
    emit0 = sc.emit * torch.as_tensor(inp.f_emit, dtype=sc.emit.dtype,
                                      device=device)
    r_losses, r_grad, r_p = ref.train(
        sc, kd0, emit0, tgt, [inp.seed(i) for i in range(COMPARE_STEPS)],
        W, H, spp, lr, region=share, all_reduce=all_reduce)
    r_change = {"kd": flat(r_p["kd"]) - flat(kd0),
                "emit": flat(r_p["emit"]) - flat(emit0)}
    r_grad = {n: flat(v) for n, v in r_grad.items()}
    keep = compare.kept_leaves(r_grad)
    vals = {"loss_gap": compare.loss_gap(prog["losses"], r_losses),
            "grad_gap": compare.leaf_gap(prog["grad"], r_grad, keep),
            "change_gap": compare.leaf_gap(prog["change"], r_change, keep)}
    rec["reference_s"] = time.perf_counter() - t_ref
    drive.trace_fields(rec, events, n_traced)
    mine = {"vals": vals, "mem": rec["memory_peak_bytes"],
            "busy": rec.get("busy_s"), "win": rec.get("trace_window_s"),
            "step_us": {n: _launch_us(events, n)
                        for n in tr.get("step_kernels", [])}
            if events else {}}
    every = [mine]
    if world > 1:
        every = [None] * world
        dist.all_gather_object(every, mine)
        vals = {n: max(e["vals"][n] for e in every) for n in vals}
        rec["memory_peak_bytes"] = max(e["mem"] for e in every)
        if events:
            rec["busy_s"] = sum(e["busy"] for e in every) / world
            rec["trace_window_s"] = sum(e["win"] for e in every) / world
    if events:
        rec["step_kernel_us"] = {n: [e["step_us"][n] for e in every]
                                 for n in tr.get("step_kernels", [])}
    rec["checks"] = compare.checks(vals, config["limits"])
    dist.barrier()
    dist.destroy_process_group()
    return rec if rank == 0 else None
