"""Benchmark of the port: stereo pairs per second on one card, GANet-deep
inference at 576x960 (the counterpart of the repo's `bench.py`).

    python -m ganet_tpu_torch.bench [--batch 4] [--quick] [--device cpu]

Prints one JSON line with `bench.py`'s keys:
  {"metric": "stereo_pairs_per_sec_per_chip_{H}x{W}_{model}", "value": N,
   "unit": "pairs/s/chip", "vs_baseline": N, "probe_ms": N or null}
and, at a batch above 1 without --quick, "batch", "batch1_latency_ms",
"batch1_pairs_per_s" and "batch1_vs_baseline".

The model is built by `entry.build_model` from seeded random weights and
timed through `entry.predict`: a warm-up call, then the median of --iters
calls, each between two CUDA events and ended by a synchronise.  The
baseline is 0.47 pairs/s, the reference GANet-deep's ~1.8 s a pair at
1242x375 on the KITTI leaderboard's GPU scaled to 576x960 (`bench.py`).
`probe_ms` is a pinned bf16 matrix-product chain timed beside the model
(`utils.profiling.probe_ms`), null on the CPU.

It runs on the CUDA device unless --device names another; without a card
and without --device cpu it raises.  --quick is GANet_small at 96x192 with
max_disp 24.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ganet_tpu_torch.config import IMPLS, model_config
from ganet_tpu_torch.entry import build_model, predict, resolve_device
from ganet_tpu_torch.utils.profiling import median_ms, probe_ms

BASELINE_PAIRS_PER_S = 0.47


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GANet pairs/s on one card (PyTorch port)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--model", default="GANet_deep")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--head_dtype", default="",
                   help="full-res disparity-head volume dtype (default: follow --dtype)")
    p.add_argument("--impl", default="auto", choices=IMPLS)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    args = p.parse_args(argv)
    if args.quick:
        args.model, args.height, args.width, args.max_disp = "GANet_small", 96, 192, 24
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config(
        args.model,
        max_disp=args.max_disp,
        compute_dtype=args.dtype,
        head_dtype=args.head_dtype,
        impl=args.impl,
    )
    B, H, W = args.batch, args.height, args.width
    cfg.validate_image_shape(H, W)
    t0 = time.perf_counter()
    model = build_model(cfg, device, seed=0)
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(0)
    left = torch.randn((B, H, W, 3), generator=gen, device=device)
    right = torch.randn((B, H, W, 3), generator=gen, device=device)

    def timed(n):
        l, r = left[:n], right[:n]
        t0 = time.perf_counter()
        predict(model, l, r)  # warm-up: builds the kernels on first use
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        warm_s = time.perf_counter() - t0
        return median_ms(lambda: predict(model, l, r), max(1, args.iters), device), warm_s

    ms, warm_s = timed(B)
    pairs_per_s = B / (ms / 1e3)
    probe = probe_ms(device) if device.type == "cuda" else None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"# model={cfg.name} {H}x{W} D={cfg.max_disp} batch={B} dtype={args.dtype} "
        f"impl={args.impl} device={name} init={init_s:.1f}s warm-up={warm_s:.1f}s "
        f"latency={ms:.1f}ms" + (f" probe={probe:.2f}ms" if probe is not None else ""),
        file=sys.stderr,
    )
    payload = {
        "metric": f"stereo_pairs_per_sec_per_chip_{H}x{W}_{cfg.name}",
        "value": round(pairs_per_s, 4),
        "unit": "pairs/s/chip",
        "vs_baseline": round(pairs_per_s / BASELINE_PAIRS_PER_S, 3),
        "probe_ms": round(probe, 2) if probe is not None else None,
    }
    if B > 1 and not args.quick:
        # The single-pair latency beside the batch-B throughput: the
        # reference's leaderboard runtime is a batch-1 number.
        ms1, _ = timed(1)
        payload["batch"] = B
        payload["batch1_latency_ms"] = round(ms1, 1)
        payload["batch1_pairs_per_s"] = round(1e3 / ms1, 4)
        payload["batch1_vs_baseline"] = round(1e3 / ms1 / BASELINE_PAIRS_PER_S, 3)
        print(f"# batch1 latency={ms1:.1f}ms pairs/s={1e3 / ms1:.3f}", file=sys.stderr)
    print(json.dumps(payload), flush=True)
    return payload


if __name__ == "__main__":
    main()
