"""Training-step benchmark of the port: ms a step, pairs/s and peak memory
of the whole update, probing batch sizes until the card runs out of
memory (the counterpart of `scripts/bench_train.py`).

    python -m ganet_tpu_torch.bench_train                  # 240x528 D=192 probe
    python -m ganet_tpu_torch.bench_train --batches 8,16 --remat sga
    python -m ganet_tpu_torch.bench_train --json rows.jsonl --device cpu

Each batch size runs GANet-deep (by default) through the trainer's entry
points, `create_train_state` and `make_train_step`: the train-mode
forward with deep supervision, the backward (the SGA and LGA gradients
through the hand-written kernels on a card) and one Adam update.  The
batch is drawn once on the device from a seeded `torch.Generator`: left
and right views normal, disparity uniform in [1, max_disp - 1), every
pixel valid.

Timing.  The first step is timed by the host clock to a synchronise:
that is `compile_s`, the kernels' load and cuDNN's first calls (the port
has no compiler).  `ms_per_step` is the median of `--steps` whole
updates, each between two CUDA events (`utils.profiling.median_ms`; the
host clock on the CPU); the loss is read after them.  The launches of
each kernel in the first step go on a `#` line on stderr, not in the row.

Each batch prints one JSON line with the keys of `scripts/bench_train.py`.
`compiler_memory` is `{}`, since no compiler reports a plan here;
`runtime_memory` maps `torch.cuda.memory_stats` and `mem_get_info` onto
JAX's names: `bytes_in_use`, `peak_bytes_in_use` (reset before each
batch), `bytes_reserved` and `bytes_limit`, the card's memory; `{}` on
the CPU.

Only `torch.cuda.OutOfMemoryError` ends the probe with a failure row (the
keys and reason texts of the JAX script, its estimate extrapolated from
the measured peaks of the batches that ran, against `bytes_limit`); any
other error, such as a kernel that fails to build or launch, propagates
and the run exits non-zero.  `--json` appends the rows to a file.

It runs on the CUDA device unless --device names another; without a card
and without --device cpu it raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from typing import Dict, List, Optional

import torch

from ganet_tpu_torch.config import (
    IMPLS,
    DataConfig,
    MeshConfig,
    OptimConfig,
    TrainConfig,
    model_config,
)
from ganet_tpu_torch.entry import resolve_device
from ganet_tpu_torch.train.cli import JAX_IMPLS
from ganet_tpu_torch.train.trainer import create_train_state, make_train_step
from ganet_tpu_torch.utils.profiling import median_ms, read_launches, synchronize


def random_batch(batch: int, H: int, W: int, D: int, device: torch.device,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """A training batch drawn on `device` from a seeded generator: left and
    right (B, H, W, 3) normal, disparity (B, H, W) uniform in [1, D - 1),
    valid all ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    left = torch.randn((batch, H, W, 3), generator=gen, device=device)
    right = torch.randn((batch, H, W, 3), generator=gen, device=device)
    disp = 1.0 + (D - 2) * torch.rand((batch, H, W), generator=gen, device=device)
    return {"left": left, "right": right, "disparity": disp,
            "valid": torch.ones((batch, H, W), device=device)}


def runtime_memory(device: torch.device) -> Dict[str, int]:
    """The caching allocator's figures under JAX's `memory_stats` names;
    `{}` off a card."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats["allocated_bytes.all.current"]),
        "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
        "bytes_reserved": int(stats["reserved_bytes.all.current"]),
        "bytes_limit": int(torch.cuda.mem_get_info(device)[1]),
    }


def bytes_limit(device: torch.device) -> Optional[int]:
    """The card's memory in bytes; None off a card."""
    return runtime_memory(device).get("bytes_limit")


def bench_one(model, H, W, D, dtype, batch, remat, lr, steps, impl="auto", device=None) -> dict:
    """The row of one batch size (see the module docstring)."""
    dev = resolve_device(device)
    cfg = TrainConfig(
        model=model_config(model, max_disp=D, compute_dtype=dtype, remat=remat,
                           impl=JAX_IMPLS.get(impl, impl)),
        data=DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
        optim=OptimConfig(lr=lr),
        mesh=MeshConfig(),
        batch_size=batch,
    )
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    data = random_batch(batch, H, W, D, dev)

    t0 = time.perf_counter()
    state = create_train_state(cfg, dev)
    synchronize(dev)
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg)

    before = read_launches()
    t0 = time.perf_counter()
    metrics = step_fn(state, data)
    synchronize(dev)
    compile_s = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in read_launches().items()}
    print(f"# batch={batch} remat={remat} launches a step: {launches}", file=sys.stderr, flush=True)

    def step():
        nonlocal metrics
        metrics = step_fn(state, data)

    ms = median_ms(step, max(1, steps), dev)
    loss = float(metrics["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"non-finite loss {loss} at batch {batch}")
    return {
        "model": model,
        "shape": f"{H}x{W}",
        "max_disp": D,
        "dtype": dtype,
        "batch": batch,
        "remat": remat,
        "impl": impl,
        "ms_per_step": round(ms, 1),
        "pairs_per_s": round(batch / (ms / 1e3), 3),
        "loss": round(loss, 4),
        "init_s": round(init_s, 1),
        "compile_s": round(compile_s, 1),
        "compiler_memory": {},
        "runtime_memory": runtime_memory(dev),
    }


def failure_reason(batch: int, ok_mem: List[tuple], limit: Optional[int]) -> tuple:
    """(reason, estimated bytes or None) for a batch that ran out of memory,
    extrapolated from `ok_mem`, the (batch, peak bytes) of the batches that
    ran, as the JAX script extrapolates the compiler's totals."""
    est = None
    # Fit through the two largest batches that ran (sorted: --batches need
    # not be ascending).
    pts = sorted(set(ok_mem))
    if len(pts) >= 2 and pts[-1][0] != pts[-2][0]:
        (b0, m0), (b1, m1) = pts[-2], pts[-1]
        est = m1 + (m1 - m0) * (batch - b1) / (b1 - b0)
    elif pts:
        est = pts[-1][1] * batch / pts[-1][0]
    basis = f"(extrapolated from the measured peaks at batches {[x[0] for x in ok_mem]})"
    if est and limit and est > limit:
        reason = (f"HBM-infeasible: extrapolated peak memory ≈{est / 2**30:.1f} GiB > "
                  f"{limit / 2**30:.0f} GiB device limit {basis}")
    elif est and limit and est > 0.95 * limit:
        reason = (f"HBM-infeasible at the boundary: extrapolated ≈{est / 2**30:.1f} GiB vs the "
                  f"{limit / 2**30:.0f} GiB limit — over it once the allocator's reserves are "
                  f"included {basis}")
    elif est and limit:
        reason = (f"out of memory well below the device limit (extrapolated ≈{est / 2**30:.1f} GiB "
                  f"of {limit / 2**30:.0f} GiB) — fragmentation or another process, not the batch")
    elif est:
        reason = (f"out of memory; extrapolated peak memory ≈{est / 2**30:.1f} GiB, device memory "
                  "limit unknown on this device")
    else:
        reason = "out of memory with no smaller batch's peak to extrapolate from"
    return reason, est


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GANet training-step benchmark (PyTorch port)")
    p.add_argument("--model", default="GANet_deep")
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=528)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--batches", default="1,2,4,8", help="comma list to probe")
    p.add_argument("--remat", default="none", help="none | sga | full")
    p.add_argument("--impl", default="auto", choices=IMPLS + tuple(JAX_IMPLS),
                   help="auto | torch | kernel, or the JAX names scan (torch) | pallas (kernel)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--steps", type=int, default=4, help="timed steps")
    p.add_argument("--json", default="", help="append results to this file")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={dev} ({name}) torch={torch.__version__}", file=sys.stderr)
    limit = bytes_limit(dev)

    results = []
    ok_mem = []  # (batch, peak bytes) of the batches that ran
    for b in [int(x) for x in args.batches.split(",") if x]:
        error = None
        try:
            r = bench_one(args.model, args.height, args.width, args.max_disp, args.dtype, b,
                          args.remat, args.lr, args.steps, impl=args.impl, device=dev)
        except torch.cuda.OutOfMemoryError as e:
            error = f"{type(e).__name__}: {' '.join(str(e).split())[:300]}"
        if error is None:
            peak = r["runtime_memory"].get("peak_bytes_in_use")
            if peak:
                ok_mem.append((b, peak))
        else:
            # The failed batch's state went with the exception's frames.
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            reason, est = failure_reason(b, ok_mem, limit)
            r = {
                "model": args.model,
                "shape": f"{args.height}x{args.width}",
                "batch": b,
                "remat": args.remat,
                "reason": reason,
                "estimated_total_bytes": int(est) if est else None,
                "hbm_limit_bytes": int(limit) if limit else None,
                "error_head": error,
            }
        results.append(r)
        print(json.dumps(r), flush=True)
        if "reason" in r:
            break  # larger batches run out too
    if args.json:
        with open(args.json, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
    return results


if __name__ == "__main__":
    main()
