"""Wavefront efficiency of the H-sharded SGA: chunked vertical sweeps
(counterpart of `scripts/bench_wavefront.py`).

    python -m ganet_tpu_torch.bench_wavefront --single_shard --impl pallas
    python -m ganet_tpu_torch.bench_wavefront --space 4 --backend gloo --impl pallas

Prints one JSON line per configuration.  The default shape is GANet_deep's
full-res SGA block at 576x960: x (1, 32, 64, 192, 320), bfloat16 on a card.

  * --single_shard, on one card without torch.distributed: the unsharded
    `sga` (K1), `sharded_sga` at one shard (the same op), and the wavefront
    forced on at one shard for each chunk count above 1: the fixed cost of
    the chunked machinery (seeded launches over column windows, the max
    tree outside the sweeps), which the static model does not count.
  * --space S: S ranks on this host (`parallel/launch.py`), each timing
    `sharded_sga` on its block for each chunk count, with the schedule's
    static utilisation (`pipeline_stats`) beside the time.  Ranks are laid
    on the cards round-robin; when several share a card only gloo joins
    them (NCCL refuses two ranks of one communicator on one device), and
    the time is then not a multi-GPU time: the lines say how many ranks
    shared a card.

`--impl` takes the JAX script's values: "scan" (its default; the port's
impl "torch", the plain versions on any device), "pallas" ("kernel": K1,
K5 on a card) or "auto" (the kernels on a card), as the train CLI maps
them (`train.cli.JAX_IMPLS`).  It routes the unsharded `sga` and every
`sharded_sga` call, so a run that times the kernels passes `--impl pallas`.

Times are host-clock wall times around a call that ends in a synchronize,
the minimum over --reps calls after a warm-up; with S ranks, the slowest
rank's.  The entry point runs on the card; --device cpu rehearses it on
the CPU at a small --height/--width (its times are CPU times).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops.normalize import l1_normalize
from ganet_tpu_torch.parallel import launch as _launch
from ganet_tpu_torch.parallel.sharded_sga import chunk_layout, pipeline_stats, sharded_sga
from ganet_tpu_torch.train.cli import JAX_IMPLS


def _inputs(args, device):
    """The whole volume, the same on every rank: x (B, C, D, H, W) and
    L1-normalised w (B, C, 4, 5, H, W) from --seed."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    B, C, D, H, W = args.batch, args.channels, args.disp, args.height, args.width
    x = torch.randn((B, C, D, H, W), generator=gen, device=device)
    w = l1_normalize(torch.rand((B, C, 4, 5, H, W), generator=gen, device=device), dim=3)
    dtype = getattr(torch, args.dtype)
    return x.to(dtype), w.to(dtype)


def _wall_ms(fn, reps: int, device) -> float:
    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    fn()
    sync()
    best = float("inf")
    for _ in range(reps):
        if dist.is_initialized():
            dist.barrier()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def _device_name(device) -> str:
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def _impl(args) -> str:
    """The port's impl for the JAX script's --impl value."""
    return JAX_IMPLS.get(args.impl, args.impl)


def _single_shard(args, chunk_list, device):
    x, w = _inputs(args, device)
    shape = list(x.shape)
    impl = _impl(args)

    def emit(mode, fn, extra=None):
        with torch.no_grad():
            ms = _wall_ms(fn, args.reps, device)
        print(json.dumps({"mode": mode, "wall_ms": ms, "device": _device_name(device),
                          "dtype": args.dtype, "impl": args.impl, "shape": shape,
                          **(extra or {})}), flush=True)

    emit("plain_sga", lambda: dispatch.sga_ncdhw(x, w, impl))
    emit("sharded_S1", lambda: sharded_sga(x, w, impl=impl))
    for chunks in [c for c in chunk_list if c > 1]:
        _, starts = chunk_layout(args.width, chunks)
        emit(f"pipeline_S1_chunks{len(starts)}",
             lambda c=chunks: sharded_sga(x, w, chunks=c, force_pipeline=True, impl=impl),
             {"chunks": len(starts)})


def _rank(rank: int, nprocs: int, args, chunk_list, device):
    """One rank of the S-rank mode: its H block, timed per chunk count."""
    x, w = _inputs(args, device)
    Hl = args.height // nprocs
    x = x[:, :, :, rank * Hl : (rank + 1) * Hl].contiguous()
    w = w[:, :, :, :, rank * Hl : (rank + 1) * Hl].contiguous()
    cards = torch.cuda.device_count() if device == "cuda" else 1
    for chunks in chunk_list:
        with torch.no_grad():
            ms = _wall_ms(lambda: sharded_sga(x, w, chunks=chunks, impl=_impl(args)), args.reps,
                          device)
        every = [None] * nprocs
        dist.all_gather_object(every, ms)
        if rank == 0:
            _, starts = chunk_layout(args.width, chunks)
            stats = pipeline_stats(nprocs, len(starts))
            print(json.dumps({
                "chunks": len(starts), "wall_ms": max(every), "rank_wall_ms": every,
                "model_utilization": stats["utilization"],
                "critical_chunk_sweeps": stats["critical_chunk_sweeps"],
                "backend": dist.get_backend(), "device": _device_name(device),
                "ranks_per_card": -(-nprocs // cards) if device == "cuda" else None, "dtype": args.dtype,
                "impl": args.impl,
                "shape": [args.batch, args.channels, args.disp, args.height, args.width],
                "shards": nprocs,
            }), flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--space", type=int, default=4)
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--disp", type=int, default=64, help="D of the block (max_disp / 3)")
    p.add_argument("--height", type=int, default=192, help="global H (1/3 res)")
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--chunks", default="1,2,3,4,8")
    p.add_argument("--impl", default="scan", choices=("scan", "pallas", "auto"),
                   help="the JAX script's values: scan = the plain versions, pallas = the kernels")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--single_shard", action="store_true",
                   help="one card, no torch.distributed: plain sga vs sharded_sga at S=1 vs "
                   "the chunked wavefront forced on")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_wavefront: no CUDA device (pass --device cpu to rehearse on the CPU)")
    chunk_list = [int(c) for c in args.chunks.split(",")]
    if args.single_shard:
        _single_shard(args, chunk_list, args.device)
        return
    if args.height % args.space:
        raise SystemExit(f"--height {args.height} does not split over --space {args.space}")
    _launch.launch(_rank, args.space, (args, chunk_list, args.device),
                   backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
