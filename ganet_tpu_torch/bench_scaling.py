"""Scaling harness of the port: pairs/s per device of the sharded train
step on each (data, space, disp) mesh, and the efficiency against one
device (the counterpart of `scripts/bench_scaling.py`).

    python -m ganet_tpu_torch.bench_scaling --meshes 1,1,1 2,1,1 4,1,1
    python -m ganet_tpu_torch.bench_scaling --device cpu --meshes 1,1,1 2,2,1

Each mesh of N devices runs as N ranks of `torch.distributed` started on
this host by `parallel/launch.py` (this process is rank 0; NCCL when
every rank has a card of its own, else gloo).  Each rank builds
`create_train_state(cfg, mesh=train_mesh(cfg.mesh))`, takes its `data`
slice of the synthetic set's first global batch (`batch_per_chip` x
data pairs), runs `--warmup` steps and then `--steps` steps between two
synchronises; rank 0's time gives the row.  One device runs in this
process with no process group.

Output: one JSON line per mesh and a summary line, with the JAX script's
keys.  `pairs_per_s`, `pairs_per_s_per_chip` and `efficiency_vs_1chip`
are null, and `plumbing_only` true, on the CPU and wherever N exceeds
the cards on this host: ranks that share one card time-slice it and gloo
stages every exchange through the host, so such a figure is no scaling
result; the row then shows that the mesh runs and gives a finite loss.
A mesh that the port's shape rules refuse (`check_train_shape`: they
raise where JAX leaves a volume unsharded) is printed as
`{"mesh": ..., "skipped": <the rule's message>}` before any rank starts.

`--real` names the card, which is the default here.  JAX's
`--force_cpu_devices` faked XLA host devices; gloo ranks on the CPU need
none, so any value but 0 raises and names `--device cpu`.  It runs on
the CUDA device unless --device names another; without a card and
without --device cpu it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ganet_tpu_torch.config import DataConfig, MeshConfig, TrainConfig, model_config
from ganet_tpu_torch.data import SyntheticStereoDataset, stack
from ganet_tpu_torch.entry import resolve_device
from ganet_tpu_torch.parallel.launch import default_backend, launch
from ganet_tpu_torch.train.trainer import (
    check_train_shape,
    create_train_state,
    make_train_step,
    train_mesh,
)
from ganet_tpu_torch.utils.profiling import synchronize


def parse_mesh(s: str) -> tuple:
    parts = [int(p) for p in s.replace("x", ",").split(",")]
    while len(parts) < 3:
        parts.append(1)
    return tuple(parts[:3])


def _rank(rank: int, world: int, cfg: TrainConfig, device: str, warmup: int,
          steps: int) -> Optional[dict]:
    """One rank's run on its mesh: (seconds of `steps` steps, last loss) on
    rank 0, None elsewhere."""
    mesh = train_mesh(cfg.mesh)
    # On the card: the device that the launcher made current for this rank.
    state = create_train_state(cfg, "cpu" if device == "cpu" else None, mesh=mesh)
    d = cfg.data
    batch = stack(SyntheticStereoDataset(d.crop_height, d.crop_width, cfg.model.max_disp),
                  range(cfg.batch_size))
    data = 1 if mesh is None else mesh.size("data")
    i = 0 if mesh is None else mesh.index["data"]
    per = cfg.batch_size // data
    batch = {k: v[i * per : (i + 1) * per] for k, v in batch.items()}
    step = make_train_step(cfg)

    def sync():
        synchronize(device)
        if dist.is_initialized():
            dist.barrier()

    metrics = None
    for _ in range(warmup):
        metrics = step(state, batch)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step(state, batch)
    sync()
    dt = time.perf_counter() - t0
    return {"seconds": dt, "loss": float(metrics["loss"])} if rank == 0 else None


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GANet scaling sweep over meshes (PyTorch port)")
    p.add_argument(
        "--meshes",
        nargs="+",
        default=["1,1,1", "2,1,1", "4,1,1", "8,1,1", "2,4,1", "2,2,2"],
        help="data,space,disp mesh shapes to sweep",
    )
    p.add_argument("--model", default="GANet_small")
    p.add_argument("--crop_height", type=int, default=48)
    p.add_argument("--crop_width", type=int, default=96)
    p.add_argument("--max_disp", type=int, default=24)
    p.add_argument("--batch_per_chip", type=int, default=1)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--real", action="store_true",
                   help="use the card (the default here; kept for the JAX script's command lines)")
    p.add_argument("--force_cpu_devices", type=int, default=0,
                   help="JAX's faked CPU devices: not needed here, any value but 0 raises "
                   "(use --device cpu)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    if args.force_cpu_devices:
        raise ValueError(
            f"--force_cpu_devices {args.force_cpu_devices}: gloo ranks on the CPU need no faked "
            "devices; run the sweep on the CPU with --device cpu")
    if args.real and args.device not in (None, "cuda"):
        raise ValueError(f"--real names the card, but --device is {args.device!r}")
    kind = resolve_device(args.device).type
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    results = []
    base_per_chip = None

    for mesh_shape in (parse_mesh(m) for m in args.meshes):
        data_ax, space_ax, disp_ax = mesh_shape
        n = data_ax * space_ax * disp_ax
        batch = args.batch_per_chip * data_ax
        cfg = TrainConfig(
            model=model_config(args.model, max_disp=args.max_disp),
            data=DataConfig(crop_height=args.crop_height, crop_width=args.crop_width,
                            kind="synthetic"),
            mesh=MeshConfig(data=data_ax, space=space_ax, disp=disp_ax),
            batch_size=batch,
        )
        try:
            check_train_shape(cfg)
        except ValueError as e:
            print(json.dumps({"mesh": list(mesh_shape), "skipped": str(e)}), flush=True)
            continue
        run = (cfg, kind, args.warmup, args.steps)
        if n == 1:
            res = _rank(0, 1, *run)
        else:
            res = launch(_rank, n, run, backend=default_backend(kind, n), device=kind,
                         caller_rank=True)
        loss = res["loss"]
        if not math.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss} on mesh {mesh_shape}")
        pairs_per_s = batch * args.steps / res["seconds"]
        per_chip = pairs_per_s / n
        timing_valid = n <= cards
        if base_per_chip is None and n == 1 and timing_valid:
            base_per_chip = per_chip
        eff = per_chip / base_per_chip if base_per_chip else None
        rec = {
            "mesh": list(mesh_shape),
            "devices": n,
            "backend": kind,
            "global_batch": batch,
            "pairs_per_s": round(pairs_per_s, 4) if timing_valid else None,
            "pairs_per_s_per_chip": round(per_chip, 4) if timing_valid else None,
            "efficiency_vs_1chip": round(eff, 4) if (eff and timing_valid) else None,
            "plumbing_only": not timing_valid,
            "loss": loss,
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if kind == "cpu":
        note = "CPU ranks validate plumbing only; run on cards for real efficiency numbers"
    elif any(r["plumbing_only"] for r in results):
        note = (f"meshes of more than {cards} ranks share a card over gloo: plumbing only; "
                "the others are real-device timings")
    else:
        note = "real-device timings"
    print(json.dumps({"summary": "scaling_sweep", "backend": kind, "note": note,
                      "meshes_run": [r["mesh"] for r in results]}), flush=True)
    return results


if __name__ == "__main__":
    main()
