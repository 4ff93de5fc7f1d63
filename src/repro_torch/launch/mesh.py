"""Production mesh and the rank launcher — the counterpart of
``repro.launch.mesh``.

``make_production_mesh`` builds the reference's (16, 16) ("data",
"model") mesh of 256 ranks, or (2, 16, 16) ("pod", "data", "model") of
512 with ``multi_pod``, over the process group of the world; on a world
of any other size it raises and names the size it needs.  ``data_axes``
and ``axis_size`` are the reference's (``core.sharding``).

``spawn`` starts ``world_size`` ranks as processes
(``torch.multiprocessing``, the ``spawn`` start method), each with a
process group of the ``backend`` it is given (gloo on the CPU; gloo with
CUDA tensors for several ranks on one card, where NCCL refuses two ranks
a device; NCCL with a card a rank), rendezvous through a ``FileStore`` in
a directory of its own, so that concurrent launches never share a port.
A rank that raises fails the launch with its traceback; a launch that
outlives ``timeout`` seconds is killed and raises ``TimeoutError``.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core.sharding import axis_size, data_axes, mesh_device_type

__all__ = ["axis_size", "data_axes", "make_production_mesh", "spawn"]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape} {axes} needs a world "
                         f"of {n} ranks; this one has {world}")
    return DeviceMesh(mesh_device_type(device_type),
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def _rank_main(rank: int, fn, world_size: int, backend: str, d: str,
               timeout_s: float) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{d}/store",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        args = torch.load(os.path.join(d, "args.pt"), weights_only=False)
        result = fn(rank, *args)
        torch.save(result, os.path.join(d, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, backend: str = "gloo",
          timeout: float = 300.0, workdir: str | None = None) -> list:
    """``fn(rank, *args)`` on ranks 0 .. world_size - 1, each a process
    with its process group up -> each rank's return value, by rank.
    ``fn`` must be importable by name (a module-level function); the store
    and the results live in a temporary directory under ``workdir``."""
    with tempfile.TemporaryDirectory(dir=workdir) as d:
        # the arguments go through a file: a large one on the spawn pipe
        # would start the ranks one after another
        torch.save(args, os.path.join(d, "args.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, d, timeout),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__}"
                                       f" still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
