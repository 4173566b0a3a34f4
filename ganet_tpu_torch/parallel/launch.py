"""Start S ranks of `torch.distributed` on this host and run one function
on each, or join a world that is already running.

    launch(fn, nprocs, args, backend="gloo", device="cuda", caller_rank=False)

runs `fn(rank, nprocs, *args)` in `nprocs` processes started with
`torch.multiprocessing` (start method "spawn": CUDA cannot be used in a
forked child), joined by a `file://` store in a new temporary directory
(no TCP port to collide with another run).  `fn` must be a module-level
function, which each child imports by name.  With `caller_rank` the
calling process is rank 0 itself and `launch` returns what `fn` returned
there (the train CLI hands back rank 0's `Trainer` so); the others are
children.  With device "cuda" each rank takes card
`rank % torch.cuda.device_count()`, so several ranks may share one card
(then only gloo can join them: NCCL refuses two ranks of one communicator
on one device, `default_backend`), and the parent builds every CUDA
kernel before it starts the ranks, so that they do not all run nvcc at
once.  On the CPU the ranks share the caller's intra-op threads.  The
children take the caller's float32 numerics (TF32 in cuDNN and in matrix
products, cuDNN's deterministic algorithms), so that every rank computes
as rank 0 does.

A rank that raises fails the whole launch: the others are ended and
`launch` raises.

    join_world(fn, args, device="cuda")

runs `fn(rank, world, *args)` as one rank of a world set up by the
environment (`env://`: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as
`torchrun` sets them), on card LOCAL_RANK % device count.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def default_backend(device: str, nprocs: int) -> str:
    """NCCL when each of `nprocs` ranks on this host has a card of its own,
    else gloo (ranks on the CPU, or sharing a card)."""
    if device == "cuda" and nprocs <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _run_rank(rank: int, fn: Callable, nprocs: int, init: str, backend: str, device: str, args):
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=nprocs, rank=rank)
    try:
        return fn(rank, nprocs, *args)
    finally:
        dist.destroy_process_group()


def _numerics() -> tuple:
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


def _child(i: int, first: int, threads: int, numerics: tuple, fn: Callable, nprocs: int, init: str,
           backend: str, device: str, args):
    if device == "cpu":
        torch.set_num_threads(threads)
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = numerics
    _run_rank(first + i, fn, nprocs, init, backend, device, args)


def launch(
    fn: Callable,
    nprocs: int,
    args: Sequence = (),
    backend: str = "gloo",
    device: str = "cuda",
    caller_rank: bool = False,
) -> Any:
    """Run `fn(rank, nprocs, *args)` on `nprocs` ranks; returns when all
    have finished (with `caller_rank`, what `fn` returned on rank 0, which
    runs in this process; else None), raises when one of them raised."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch(device='cuda') needs a CUDA device")
        from ganet_tpu_torch.ops import _build

        _build.build_all()
    first = 1 if caller_rank else 0
    threads = max(1, torch.get_num_threads() // nprocs)
    tmp = tempfile.mkdtemp(prefix="ganet_launch_")
    try:
        init = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _child, args=(first, threads, _numerics(), fn, nprocs, init, backend, device, tuple(args)),
            nprocs=nprocs - first, join=False, start_method="spawn",
        )
        result = None
        if caller_rank:
            before = torch.get_num_threads()
            try:
                if device == "cpu":
                    torch.set_num_threads(threads)
                result = _run_rank(0, fn, nprocs, init, backend, device, tuple(args))
            except BaseException as err:
                # This rank's group is gone, so the others fail their next
                # collective with it and exit; a rank that failed first
                # shows its error here too.
                try:
                    if not ctx.join(timeout=60):
                        for p in ctx.processes:
                            p.terminate()
                except Exception as other:
                    raise err from other
                raise
            finally:
                torch.set_num_threads(before)
        while not ctx.join():
            pass
        return result
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def join_world(fn: Callable, args: Sequence = (), device: str = "cuda") -> Any:
    """Run `fn(rank, world, *args)` as one rank of the world that the
    environment describes (`env://`); returns what `fn` returned.  The
    backend is `default_backend` for the ranks on this host (LOCAL_WORLD_SIZE,
    else WORLD_SIZE)."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    env = os.environ
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("join_world(device='cuda') needs a CUDA device")
    local = int(env.get("LOCAL_RANK", env.get("RANK", "0")))
    on_host = int(env.get("LOCAL_WORLD_SIZE", env.get("WORLD_SIZE", "1")))
    backend = default_backend(device, on_host)
    if device == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="env://")
    try:
        return fn(dist.get_rank(), dist.get_world_size(), *args)
    finally:
        dist.destroy_process_group()
