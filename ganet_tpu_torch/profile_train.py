"""Training-step split of the port: the forward, backward and optimizer
shares of a step, and the remat policy's recompute tax (the counterpart
of `scripts/profile_train.py`).

    python -m ganet_tpu_torch.profile_train --batch 1 --remat none
    python -m ganet_tpu_torch.profile_train --batch 4 --remat full

Measures, at the reference crop (GANet-deep 240x528, max_disp 192, bf16
by default), from one seeded state and one batch drawn on the device as
`bench_train` draws it:
  fwd_train   the train-mode forward (batch statistics, every head) and
              `deep_supervision_loss`, under `torch.no_grad()`: JAX's
              forward is not differentiated, so it keeps no residuals;
  fwd_bwd     the same under autograd with `loss.backward()`, the
              gradients set to None before each call (no optimizer); under
              remat sga or full, `torch.utils.checkpoint` recomputes here;
  full_step   `make_train_step`: forward, backward, Adam, and the
              running statistics.
Each is the time one more call adds to a chain of calls, after a
warm-up (`utils.profiling.chained_ms`: a chain of 6 calls with a CUDA
event after each, the median of the 5 gaps after the first; the host
clock on the CPU), the counterpart of JAX's `benchmark_fn_chained`.  A
single call's window would start with the card idle while the host
queues its first launches; in a chain the host queues each call while
the card runs the one before, so where the host keeps ahead the figures
are the card's and a policy's extra device work shows in full.  The
differences give
`bwd_attrib_ms` (fwd_bwd - fwd_train) and `optimizer_attrib_ms`
(full_step - fwd_bwd); `bwd_attrib_ms` under sga or full minus under
none, at the same batch, is the policy's recompute tax.

Prints one JSON line with the JAX script's keys, and on stderr a `#` line
with the device and the forward's loss.  A train-mode forward moves
BatchNorm's running statistics, so the state the step is timed on is not
the fresh one.  It runs on the CUDA device unless --device names another;
without a card and without --device cpu it raises.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ganet_tpu_torch.bench_train import random_batch
from ganet_tpu_torch.config import DataConfig, MeshConfig, OptimConfig, TrainConfig, model_config
from ganet_tpu_torch.entry import resolve_device
from ganet_tpu_torch.train.loss import deep_supervision_loss
from ganet_tpu_torch.train.trainer import create_train_state, make_train_step
from ganet_tpu_torch.utils.profiling import chained_ms

# Calls before each timing, and in its chain.
WARMUP, CHAIN = 1, 6


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GANet training-step split (PyTorch port)")
    p.add_argument("--model", default="GANet_deep")
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=528)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--remat", default="full")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    H, W, D, B = args.height, args.width, args.max_disp, args.batch
    cfg = TrainConfig(
        model=model_config(args.model, max_disp=D, compute_dtype=args.dtype, remat=args.remat),
        data=DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
        optim=OptimConfig(),
        mesh=MeshConfig(),
        batch_size=B,
    )
    batch = random_batch(B, H, W, D, dev)
    state = create_train_state(cfg, dev)
    model = state.model.train()

    def loss_fn():
        outputs = model(batch["left"], batch["right"])
        return deep_supervision_loss(outputs, batch["disparity"], batch["valid"], cfg.loss_weights)

    def timed(fn):
        for _ in range(WARMUP):
            fn()
        return chained_ms(fn, dev, CHAIN)

    results = {"batch": B, "remat": args.remat, "shape": f"{H}x{W}", "dtype": args.dtype}
    losses = []

    def fwd():
        with torch.no_grad():
            losses.append(loss_fn())

    results["fwd_train_ms"] = round(timed(fwd), 1)

    def fwd_bwd():
        for p in model.parameters():
            p.grad = None
        loss_fn().backward()

    results["fwd_bwd_ms"] = round(timed(fwd_bwd), 1)
    step_fn = make_train_step(cfg)
    results["full_step_ms"] = round(timed(lambda: step_fn(state, batch)), 1)
    results["bwd_attrib_ms"] = round(results["fwd_bwd_ms"] - results["fwd_train_ms"], 1)
    results["optimizer_attrib_ms"] = round(results["full_step_ms"] - results["fwd_bwd_ms"], 1)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device={dev} ({name}) fwd_train loss={float(losses[0])!r}", file=sys.stderr)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
