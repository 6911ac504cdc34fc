"""Ranks on one host, spawned: `run_ranks` starts `world` processes, each
joins one process group (mesh.init_distributed) and calls
fn(rank, world, *args), and returns every rank's return value.

The processes are spawned, not forked: a CUDA context does not survive a
fork. So fn must be a module-level function of a module the child can
import by name (the child imports it afresh: keep it free of work at
import), and args and return values are pickled. Jobs over several hosts
start their ranks with torchrun instead and call init_distributed()
without arguments.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import mesh


def free_port() -> int:
    """A TCP port on localhost that was free when asked (the OS's pick)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, args, init_method, timeout_s, threads, out_dir):
    if threads is not None:
        torch.set_num_threads(threads)
    mesh.init_distributed(init_method, world, rank, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), init_method: str | None = None,
              timeout_s: float = 60.0, deadline_s: float = 600.0, threads: int | None = None):
    """fn(rank, world, *args) in `world` spawned ranks of one process group;
    returns the list of their return values, in rank order. The backend is
    mesh.default_backend's: NCCL where the host has a card for every rank,
    else gloo (ranks that share one card, or no card).

    init_method: the process group's rendezvous; default a file store in a
    temporary directory (no port to collide on). timeout_s: the process
    group's timeout, so a collective that a rank never joins fails instead
    of hanging. deadline_s: the whole run's limit; past it every rank is
    killed and this raises TimeoutError. A rank that raises or dies makes
    this raise (torch.multiprocessing's ProcessRaisedException, with the
    rank's traceback, or ProcessExitedException), and the other ranks are
    killed. threads: torch.set_num_threads in every rank."""
    with tempfile.TemporaryDirectory() as tmp:
        init = init_method or f"file://{os.path.join(tmp, 'store')}"
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, args, init, timeout_s, threads, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__name__} still running "
                                       f"after {deadline_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
