"""Process groups for the mesh layer: join one, or start N ranks that do.

A rank joins through ``process_group``: under ``torchrun`` (``python -m
torch.distributed.run``, which sets RANK and WORLD_SIZE) it takes the
launched world by its ``env://`` rendezvous; otherwise the ranks meet in a
``FileStore`` file, a fresh temporary one for a one-rank world, so no
fixed port is taken.  CUDA tensors use ``nccl`` (one card a rank) and CPU
tensors ``gloo``; nothing switches from one to the other.

``spawn`` starts N ranks on this host with ``torch.multiprocessing``, each
joining through a ``FileStore`` in a temporary directory.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist


def backend(device) -> str:
    """The collective backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@contextlib.contextmanager
def process_group(device, rank: int = 0, world_size: int = 1, store_path: str | None = None):
    """Join a process group for tensors on ``device`` for the block, and
    leave it after.  Yields this rank's device: on CUDA without an index,
    the card of its local rank (one card a rank).

    Under ``torchrun`` the launched world is joined and the other arguments
    are ignored.  Otherwise ``rank`` of ``world_size`` joins through the
    ``FileStore`` at ``store_path``, which may be None only for a one-rank
    world.
    """
    kind = backend(device)
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) if launched else rank)
        torch.cuda.set_device(dev)
    with contextlib.ExitStack() as stack:
        if launched:
            dist.init_process_group(kind, init_method="env://")
        else:
            if store_path is None:
                if world_size != 1:
                    raise ValueError("a world of several ranks needs a store_path")
                store_path = str(Path(stack.enter_context(tempfile.TemporaryDirectory()))
                                 / "store")
            dist.init_process_group(kind, store=dist.FileStore(store_path, world_size),
                                    rank=rank, world_size=world_size)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def spawn(fn, world_size: int, *args, device="cuda") -> None:
    """Run ``fn(rank, world_size, device, *args)`` in ``world_size`` new
    processes on this host, each a rank of one process group for tensors on
    ``device`` (its own card on CUDA) with one CPU thread, so that N ranks
    do not oversubscribe the host.  ``fn`` must be importable by name (a
    module-level function).  Raises if a rank raised."""
    with tempfile.TemporaryDirectory() as td:
        torch.multiprocessing.spawn(
            _rank_main, args=(fn, world_size, str(Path(td) / "store"), device, args),
            nprocs=world_size, join=True)


def _rank_main(rank, fn, world_size, store_path, device, args):
    torch.set_num_threads(1)
    with process_group(device, rank, world_size, store_path) as dev:
        fn(rank, world_size, dev, *args)
