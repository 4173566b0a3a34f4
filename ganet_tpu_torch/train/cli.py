"""Training CLI of the port (the counterpart of the repo's `train.py`, with
its flags and defaults), run as `python -m ganet_tpu_torch.train`:

    python -m ganet_tpu_torch.train --crop_height=240 --crop_width=528 \\
        --max_disp=192 --batchSize=2 --nEpochs=10 --data_path=... \\
        --training_list=... --save_path=./checkpoint --model GANet_deep
    python -m ganet_tpu_torch.train --kitti2015=1 --resume ./checkpoint ...
    python -m ganet_tpu_torch.train --model GANet_small --synthetic_data 1 \\
        --crop_height 48 --crop_width 96 --max_disp 24 --device cpu

It trains on the CUDA device unless --device names another; without a card
and without --device cpu it raises.  The default is --remat sga, as in the
reference.  --sga_impl takes the port's `impl` names (auto, torch, kernel)
and the JAX package's (scan runs the plain versions, pallas the kernels).
--log_every is the port's own (the rows of `train.jsonl`).
--compile_cache is accepted for the reference's command lines and does
nothing: it sets XLA's compilation cache, which PyTorch does not have.
Meshes above one device, --distributed 1 and --channel_tp 1 raise
NotImplementedError: they are not ported.
"""

from __future__ import annotations

import argparse

from ganet_tpu_torch.config import (
    IMPLS,
    REMATS,
    DataConfig,
    MeshConfig,
    OptimConfig,
    TrainConfig,
    model_config,
)
from ganet_tpu_torch.train.trainer import Trainer

# The JAX package's --sga_impl values, as the port's `impl`.
JAX_IMPLS = {"scan": "torch", "pallas": "kernel"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GANet training (PyTorch port)")
    p.add_argument("--crop_height", type=int, default=240)
    p.add_argument("--crop_width", type=int, default=528)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--batchSize", type=int, default=2)
    p.add_argument("--nEpochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--kitti", type=int, default=0)
    p.add_argument("--kitti2015", type=int, default=0)
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--training_list", type=str, default="lists/sceneflow_train.list")
    p.add_argument("--val_list", type=str, default="lists/sceneflow_test_select.list")
    p.add_argument("--save_path", type=str, default="./checkpoint/")
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--model", type=str, default="GANet_deep",
                   choices=["GANet_deep", "GANet11", "GANet_small"])
    p.add_argument("--left_right", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--synthetic_data", type=int, default=0,
                   help="train on the procedural dataset (tests/smoke)")
    p.add_argument("--sparse_frac", type=float, default=0.0,
                   help="synthetic data: thin the ground truth to about this valid fraction")
    p.add_argument("--steps", type=int, default=0, help="steps per epoch cap")
    p.add_argument("--mesh_data", type=int, default=1, help="mesh: not ported above 1")
    p.add_argument("--mesh_space", type=int, default=1, help="mesh: not ported above 1")
    p.add_argument("--mesh_disp", type=int, default=1, help="mesh: not ported above 1")
    p.add_argument("--channel_tp", type=int, default=0, help="channel TP: not ported")
    p.add_argument("--eval", type=int, default=0, help="validate after training")
    p.add_argument("--lr_decay_epoch", type=int, default=0)
    p.add_argument("--bf16", type=int, default=0, help="bfloat16 compute")
    p.add_argument("--sga_impl", type=str, default="auto", choices=IMPLS + tuple(JAX_IMPLS))
    p.add_argument("--remat", type=str, default="sga", choices=REMATS,
                   help="rematerialisation: recompute in backward to save activation memory")
    p.add_argument("--distributed", type=int, default=0, help="multi-process: not ported")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches staged by the background input thread; 0 disables it")
    p.add_argument("--compile_cache", type=int, default=1,
                   help="accepted for the reference's command lines; no effect")
    p.add_argument("--log_every", type=int, default=10, help="steps between logged rows")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def check_unported(args: argparse.Namespace) -> None:
    """Raise for the flags whose paths are not ported."""
    if max(args.mesh_data, args.mesh_space, args.mesh_disp) > 1 or args.distributed:
        raise NotImplementedError(
            f"--mesh_data {args.mesh_data} --mesh_space {args.mesh_space} --mesh_disp"
            f" {args.mesh_disp} --distributed {args.distributed}: the port trains on one device;"
            " data-parallel training (ROADMAP queue 1 #6) and spatial sharding of the model"
            " (queue 1 #7) are not ported yet"
        )
    if args.channel_tp:
        raise NotImplementedError(
            "--channel_tp 1: channel tensor parallelism (ROADMAP queue 1 #8) is not ported yet"
        )


def build_config(args: argparse.Namespace) -> TrainConfig:
    check_unported(args)
    kind = (
        "synthetic"
        if args.synthetic_data
        else "kitti2015"
        if args.kitti2015
        else "kitti2012"
        if args.kitti
        else "sceneflow"
    )
    model = model_config(
        args.model,
        max_disp=args.max_disp,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        impl=JAX_IMPLS.get(args.sga_impl, args.sga_impl),
        remat=args.remat,
    )
    return TrainConfig(
        model=model,
        data=DataConfig(
            data_path=args.data_path,
            training_list=args.training_list,
            val_list=args.val_list,
            crop_height=args.crop_height,
            crop_width=args.crop_width,
            kind=kind,
            left_right=bool(args.left_right),
            num_prefetch=args.prefetch,
            sparse_frac=args.sparse_frac,
        ),
        optim=OptimConfig(lr=args.lr, decay_epoch=args.lr_decay_epoch or None),
        mesh=MeshConfig(data=args.mesh_data, space=args.mesh_space, disp=args.mesh_disp),
        batch_size=args.batchSize,
        num_epochs=args.nEpochs,
        steps_per_epoch=args.steps or None,
        save_path=args.save_path,
        resume=args.resume,
        seed=args.seed,
        log_every=args.log_every,
    )


def main(argv=None) -> Trainer:
    """Run the CLI; returns the (closed) trainer."""
    args = parse_args(argv)
    cfg = build_config(args)
    trainer = Trainer(cfg, device=args.device)
    print(
        f"model={cfg.model.name} max_disp={cfg.model.max_disp} "
        f"crop={cfg.data.crop_height}x{cfg.data.crop_width} batch={cfg.batch_size} "
        f"remat={cfg.model.remat} device={trainer.device} start_epoch={trainer.start_epoch}"
    )
    try:
        trainer.fit()
        if args.eval:
            trainer.evaluate()
    finally:
        trainer.close()
    return trainer
