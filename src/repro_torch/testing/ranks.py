"""Run a function on several CPU ranks of a gloo process group: the
multi-device tests' harness.

``run_ranks(fn, world, *args)`` spawns ``world`` processes, each with the
default process group initialised (gloo at ``tcp://localhost`` on a free
port; one torch thread) and torchrun's ``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK`` set, calls ``fn(rank, world, *args)`` there and returns
the ranks' results in rank order. ``fn`` must be importable by name (a
module-level function) and its result picklable by ``torch.save``. A rank
that raises, or a run past ``timeout`` seconds, raises here.
"""
from __future__ import annotations

import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

__all__ = ["run_ranks"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank: int, fn, world: int, port: int, out_dir: str, args) -> None:
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        result = fn(rank, world, *args)
        torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 300.0) -> list:
    """``[fn(r, world, *args) for r in range(world)]``, each on its own rank
    (module docstring)."""
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = tmp.start_processes(_entry, args=(fn, world, _free_port(), out_dir, args),
                                  nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
        return [torch.load(os.path.join(out_dir, f"{r}.pt"), weights_only=False)
                for r in range(world)]
