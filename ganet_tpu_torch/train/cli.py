"""Training CLI of the port (the counterpart of the repo's `train.py`, with
its flags and defaults), run as `python -m ganet_tpu_torch.train`:

    python -m ganet_tpu_torch.train --crop_height=240 --crop_width=528 \\
        --max_disp=192 --batchSize=2 --nEpochs=10 --data_path=... \\
        --training_list=... --save_path=./checkpoint --model GANet_deep
    python -m ganet_tpu_torch.train --kitti2015=1 --resume ./checkpoint ...
    python -m ganet_tpu_torch.train --model GANet_small --synthetic_data 1 \\
        --crop_height 48 --crop_width 96 --max_disp 24 --device cpu

    python -m ganet_tpu_torch.train --mesh_data 4 --batchSize 8 ...
    python -m ganet_tpu_torch.train --mesh_space 2 --mesh_data 2 --batchSize 4 ...
    python -m ganet_tpu_torch.train --mesh_disp 2 ...
    python -m ganet_tpu_torch.train --mesh_disp 2 --channel_tp 1 ...
    torchrun --nproc_per_node 4 -m ganet_tpu_torch.train --distributed 1 \
        --mesh_data 4 --batchSize 8 ...

It trains on the CUDA device unless --device names another; without a card
and without --device cpu it raises.  The default is --remat sga, as in the
reference.  --sga_impl takes the port's `impl` names (auto, torch, kernel)
and the JAX package's (scan runs the plain versions, pallas the kernels).
--log_every is the port's own (the rows of `train.jsonl`).
--compile_cache is accepted for the reference's command lines and does
nothing: it sets XLA's compilation cache, which PyTorch does not have.

--mesh_data N --mesh_space S --mesh_disp P trains on N x S x P ranks of
`torch.distributed` laid out as the mesh (N, S, P), the counterpart of one
JAX process that owns N x S x P devices: the batch is split over `data`,
the image height over `space` and the cost volume's disparity bins over
`disp` (`train/trainer.py`).  This process is rank 0 and starts the
others on this host (`parallel/launch.py`), each on card rank % device
count (--device cpu: on the CPU), joined by NCCL when every rank has a
card of its own and by gloo otherwise.  --batchSize is the global batch,
which N must divide; S must share --crop_height by the model's shape rule
(`parallel.spatial.check_spatial_shape`) and P the bins of --max_disp by
its disparity rule (`parallel.disparity.check_disp_shape`); each fault
exits before this host starts a rank.  --channel_tp 1 (channel tensor
parallelism) makes the P ranks of `disp` split the channels of the
aggregation's volumes instead of their bins, as `train.py`'s flag does;
P must then divide every width of those volumes
(`parallel.channels.check_channel_shape`), else the run exits before a
rank starts.  With --distributed 1 this process
is one rank of a world that is already running (`env://`, as `torchrun`
sets it up), whose size must be N x S x P.  Rank 0 alone prints, logs and
writes the checkpoints, which hold no trace of the mesh.
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
from ganet_tpu_torch.parallel.launch import default_backend, join_world, launch
from ganet_tpu_torch.train.trainer import Trainer, check_train_shape

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
    p.add_argument("--mesh_data", type=int, default=1,
                   help="ranks that split the batch (this host starts the mesh's ranks unless"
                   " --distributed 1)")
    p.add_argument("--mesh_space", type=int, default=1,
                   help="ranks that split the image height (the cost volume's rows)")
    p.add_argument("--mesh_disp", type=int, default=1,
                   help="ranks that split the cost volume's disparity bins")
    p.add_argument("--channel_tp", type=int, default=0,
                   help="channel tensor parallelism: --mesh_disp splits the aggregation's channels")
    p.add_argument("--eval", type=int, default=0, help="validate after training")
    p.add_argument("--lr_decay_epoch", type=int, default=0)
    p.add_argument("--bf16", type=int, default=0, help="bfloat16 compute")
    p.add_argument("--sga_impl", type=str, default="auto", choices=IMPLS + tuple(JAX_IMPLS))
    p.add_argument("--remat", type=str, default="sga", choices=REMATS,
                   help="rematerialisation: recompute in backward to save activation memory")
    p.add_argument("--distributed", type=int, default=0,
                   help="join a running world of --mesh_data x --mesh_space x --mesh_disp ranks"
                   " (env://, as torchrun sets it)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches staged by the background input thread; 0 disables it")
    p.add_argument("--compile_cache", type=int, default=1,
                   help="accepted for the reference's command lines; no effect")
    p.add_argument("--log_every", type=int, default=10, help="steps between logged rows")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> TrainConfig:
    """The `TrainConfig` of the flags."""
    mesh = MeshConfig(data=args.mesh_data, space=args.mesh_space, disp=args.mesh_disp)
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
        channel_tp=bool(args.channel_tp),
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
        mesh=mesh,
        batch_size=args.batchSize,
        num_epochs=args.nEpochs,
        steps_per_epoch=args.steps or None,
        save_path=args.save_path,
        resume=args.resume,
        seed=args.seed,
        log_every=args.log_every,
    )


def check_flags(cfg: TrainConfig) -> None:
    """Exit (SystemExit) for flags that no mesh can train: a mesh axis
    below 1, a --batchSize that --mesh_data does not divide, a
    --crop_height that --mesh_space cannot share, a --max_disp whose bins
    --mesh_disp cannot share, or under --channel_tp 1 a model whose
    channels it cannot split."""
    mesh = cfg.mesh
    if min(mesh.data, mesh.space, mesh.disp) < 1:
        raise SystemExit(f"--mesh_data {mesh.data} --mesh_space {mesh.space} --mesh_disp "
                         f"{mesh.disp}: each must be at least 1")
    if cfg.batch_size % mesh.data:
        raise SystemExit(f"--batchSize {cfg.batch_size} must be divisible by --mesh_data {mesh.data}")
    try:
        check_train_shape(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def run(rank: int, world: int, args: argparse.Namespace) -> Trainer:
    """Train (and evaluate) the flags' configuration as rank `rank` of
    `world` (0 of 1 on one device); returns the closed trainer."""
    cfg = build_config(args)
    if world != cfg.mesh.num_devices:
        raise ValueError(f"--mesh_data {cfg.mesh.data} x --mesh_space {cfg.mesh.space} x --mesh_disp"
                         f" {cfg.mesh.disp} needs a world of as many ranks, got {world}")
    # A rank of several takes the card that its launcher set as current.
    trainer = Trainer(cfg, device=args.device if world == 1 or args.device == "cpu" else None)
    if trainer.is_lead:
        print(
            f"model={cfg.model.name} max_disp={cfg.model.max_disp} "
            f"crop={cfg.data.crop_height}x{cfg.data.crop_width} batch={cfg.batch_size} "
            f"remat={cfg.model.remat} mesh_data={cfg.mesh.data} mesh_space={cfg.mesh.space} "
            f"mesh_disp={cfg.mesh.disp} channel_tp={int(cfg.model.channel_tp)} "
            f"device={trainer.device} "
            f"start_epoch={trainer.start_epoch}"
        )
    try:
        trainer.fit()
        if args.eval:
            trainer.evaluate()
    finally:
        trainer.close()
    return trainer


def main(argv=None) -> Trainer:
    """Run the CLI; returns the (closed) trainer, rank 0's with a mesh."""
    args = parse_args(argv)
    cfg = build_config(args)
    device = "cpu" if args.device == "cpu" else "cuda"
    if args.distributed:
        # The world is running: each rank's Trainer raises ValueError for
        # these faults once run() has checked the world's size.
        return join_world(run, (args,), device=device)
    check_flags(cfg)
    n = cfg.mesh.num_devices
    if n > 1:
        backend = default_backend(device, n)
        return launch(run, n, (args,), backend=backend, device=device, caller_rank=True)
    return run(0, 1, args)
