"""Start ranks on one machine without torchrun.

:func:`spawn` starts ``nprocs`` processes (``spawn`` start method), joins
them into one default process group through a rendezvous file in a fresh
temporary directory, runs ``fn(rank, world_size, *args)`` in each, and
leaves the group (with ``backend=None`` ``fn`` joins one itself, e.g.
through ``mesh.initialize_multihost``). It raises when any rank fails, and
kills every rank and raises when they have not finished within
``timeout`` seconds, so a collective that never completes cannot hang the
caller. ``fn`` must be
importable by name (a module-level function).

Several ranks may share one card: with ``backend="gloo"`` their
collectives go through host memory (``comm``); NCCL refuses two ranks on
one GPU.
"""

from __future__ import annotations

import tempfile
import time


def _entry(rank, fn, world, rendezvous, backend, threads, args):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    if backend is not None:
        dist.init_process_group(backend, init_method=f"file://{rendezvous}",
                                rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs, args=(), backend="gloo", timeout=600.0, threads=1):
    """Run ``fn(rank, nprocs, *args)`` on ``nprocs`` ranks of a new
    process group; ``threads`` caps each rank's intra-op threads (None
    keeps PyTorch's default)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _entry, args=(fn, nprocs, f"{tmp}/rendezvous", backend, threads,
                          tuple(args)),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {fn.__name__} "
                                       f"still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
