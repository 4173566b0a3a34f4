"""Start S ranks of `torch.distributed` on this host and run one function
on each.

    launch(fn, nprocs, args, backend="gloo", device="cuda")

runs `fn(rank, nprocs, *args)` in `nprocs` processes started with
`torch.multiprocessing` (start method "spawn": CUDA cannot be used in a
forked child), joined by a `file://` store in a new temporary directory
(no TCP port to collide with another run).  `fn` must be a module-level
function, which each child imports by name.  With device "cuda" each rank
takes card `rank % torch.cuda.device_count()`, so several ranks may share
one card (then only gloo can join them: NCCL refuses two ranks of one
communicator on one device), and the parent builds every CUDA kernel
before it starts the ranks, so that they do not all run nvcc at once.

A rank that raises fails the whole launch: the others are ended and
`launch` raises.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, nprocs: int, store: str, backend: str, device: str, args):
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=store, world_size=nprocs, rank=rank)
    try:
        fn(rank, nprocs, *args)
    finally:
        dist.destroy_process_group()


def launch(
    fn: Callable,
    nprocs: int,
    args: Sequence = (),
    backend: str = "gloo",
    device: str = "cuda",
) -> None:
    """Run `fn(rank, nprocs, *args)` on `nprocs` ranks; returns when all
    have finished, raises when one of them raised."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch(device='cuda') needs a CUDA device")
        from ganet_tpu_torch.ops import _build

        _build.build_all()
    tmp = tempfile.mkdtemp(prefix="ganet_launch_")
    try:
        store = "file://" + os.path.join(tmp, "store")
        mp.start_processes(
            _rank_main, args=(fn, nprocs, store, backend, device, tuple(args)),
            nprocs=nprocs, join=True, start_method="spawn",
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
