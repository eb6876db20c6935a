"""Start the ranks of a process group on one host.

``spawn_ranks(fn, world_size, backend, args)`` runs ``fn(rank, world_size,
*args)`` in ``world_size`` processes started by
``torch.multiprocessing.spawn``, after each has joined one
``torch.distributed`` group, and returns what each rank's ``fn``
returned.  The group meets through a ``file://`` rendezvous in a fresh
temporary directory, so concurrent groups (test workers) never race for a
TCP port.  ``fn`` and ``args`` are pickled: ``fn`` must be a module-level
function, and a spawned process imports its module (the port's modules
import no JAX).

Backends: ``"nccl"`` when every rank has its own card (rank r takes
``cuda:r``); ``"gloo"`` for CPU tensors, or for several ranks on one card,
which NCCL refuses.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["spawn_ranks", "rank_device"]


def rank_device(device, backend: str, rank: int) -> torch.device:
    """The device of rank ``rank``: ``cuda:rank`` under NCCL, else
    ``device`` itself (all gloo ranks share it)."""
    device = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", rank)
    return device


def _rank_main(rank, fn, world_size, backend, init_method, outdir, args):
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        out = fn(rank, world_size, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(fn, world_size: int, backend: str = "gloo",
                args: tuple = ()) -> list:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    of one process group; returns the ranks' results in rank order.  A
    rank that raises stops the others, and the error is raised here."""
    if backend == "nccl" and torch.cuda.device_count() < world_size:
        raise ValueError(
            f"nccl needs a card per rank: {world_size} ranks, "
            f"{torch.cuda.device_count()} cards; use gloo")
    with tempfile.TemporaryDirectory(prefix="eqlb-ranks-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(fn, world_size, backend, init_method, tmp, args))
        out = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
