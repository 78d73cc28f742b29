"""Multi-process set-up: ``torch.distributed`` process groups.

Counterpart of ``mpr_tpu.parallel.distributed``.  Each process drives one
card (or the CPU, with the ``gloo`` backend); :func:`init` wires them into
one process group, and :func:`global_mesh` lays the group out as the
``(dp, sp)`` mesh of ``parallel/sharded.py``.  Nothing tells a program of
its cluster here: pass the group's address (``tcp://localhost:<port>``,
or ``file://<path>`` of a file the processes share, which needs no free
port), its size and this process's rank, and end each process with
:func:`shutdown`.

    from mpr_tpu_torch.parallel import distributed, sharded
    distributed.init("tcp://localhost:29500", world_size=4, rank=r)
    mesh = distributed.global_mesh()
    img = sharded.render2d_sharded(tape, size=4096, mesh=mesh)
    distributed.shutdown()
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .sharded import Mesh, make_mesh


def init(address: Optional[str] = None, world_size: Optional[int] = None,
         rank: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the default process group (idempotent; nothing to do for a
    single process: no address, or a world size of 1).  ``backend``:
    ``nccl`` where a card is present, else ``gloo``."""
    if dist.is_available() and dist.is_initialized():
        return
    if address is None or (world_size or 1) == 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=address,
                            world_size=int(world_size), rank=int(rank or 0))


def global_mesh() -> Mesh:
    """The ``(dp, sp)`` mesh over every process of the default group (a
    one-process mesh before :func:`init`)."""
    return make_mesh()


def shutdown() -> None:
    """Leave the default process group, if this process joined one.  A
    process that exits inside its group leaves the backend's threads
    running, and their teardown at exit can abort it."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
