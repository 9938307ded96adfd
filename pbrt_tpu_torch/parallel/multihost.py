"""Process-group set-up and the multi-host mesh (port of
pbrt_tpu/parallel/multihost.py).

Every process calls :func:`initialize_multihost` once before it renders,
with the rendezvous address, the number of processes and its own rank
(nothing on the machine tells a program of a cluster: the caller gives
them). Each process drives one device: the card of its rank (modulo the
cards the host has) over NCCL, or the CPU over gloo when the caller asks
for it. Then :func:`make_multihost_mesh` (or ``render.make_mesh``) builds
the (dp, sp) mesh of ranks that ``render_sharded`` and the training step
take.

Why dp spans the processes: the dp (sample-split) axis carries one
collective a pass, the film's sum, so it can cross hosts; the sp
(row-slab) axis all-gathers the slabs, so it stays within a host. With
one device a process, the multi-host mesh is dp = processes, sp = 1.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pbrt_tpu_torch.scene.types import require_device


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device="cuda") -> int:
    """Idempotent ``torch.distributed.init_process_group``: NCCL for a
    CUDA ``device``, gloo for the CPU. ``coordinator_address`` is
    ``host:port`` (or a ``tcp://`` URL) of rank 0's rendezvous, default
    ``localhost:29500``; ``num_processes`` defaults to 1 and
    ``process_id`` to 0. A CUDA process takes the card of its rank modulo
    the host's cards as its current device. Returns the world size; a
    second call returns it without initialising again."""
    if dist.is_initialized():
        return dist.get_world_size()
    device = require_device(device)
    world = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    addr = coordinator_address or "localhost:29500"
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank)
    return dist.get_world_size()


def make_multihost_mesh(axes=("dp", "sp")):
    """The (dp, sp) mesh with dp spanning the processes: one device a
    process, so dp = the world size and sp = 1 (``axes=("dp",)``: dp
    alone)."""
    from pbrt_tpu_torch.parallel.render import make_mesh

    world = dist.get_world_size()
    return make_mesh(world, axes, shape=(world, 1))


def process_local_rows(height: int, sp_index: int, sp_size: int):
    """The row slab [start, stop) a given sp shard owns, for host-local
    film IO when each host writes its own slab."""
    rows = -(-height // sp_size)
    start = sp_index * rows
    return start, min(start + rows, height)
