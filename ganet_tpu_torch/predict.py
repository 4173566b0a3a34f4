"""Inference CLI of the port (the counterpart of the repo's `predict.py`,
with its flags).

    python -m ganet_tpu_torch.predict --kitti2015 1 --data_path DIR \\
        --test_list LIST --resume CKPT_DIR [--bf16 1] [--device cpu]

Loads a checkpoint written by `train.checkpoint.save_checkpoint` (a JAX
checkpoint converted as that module says), pads each test image on top and
right up to (crop_height, crop_width), multiples of 48, runs the model,
crops back to the original frame (its bottom-left corner) and writes
KITTI-submission uint16 PNGs (disparity * 256).  Without --resume and
without a checkpoint under ./checkpoint/ it predicts with fresh random
weights and says so loudly on stderr; with a --resume that holds no
checkpoint it raises.  The last batch is padded by repeating its last
sample, so every batch has one shape.

It runs on the CUDA device unless --device names another; without a card
and without --device cpu it raises.

--space S --data N serve on a (data, space) mesh of S * N ranks on this
host (the JAX CLI's `build_mesh`): this process is rank 0 and starts the
others (`parallel/launch.py`; gloo when the ranks share a card or run on
the CPU, else NCCL).  Each `data` line takes --batch / N of each batch,
and the S ranks of a line share its rows from the cost volume on
(`models/ganet.py`); every rank gets the whole disparity and rank 0 writes
the PNGs.  --batch must be divisible by --data, and the crop height must
meet `parallel.spatial.check_spatial_shape`: both are checked before any
rank starts.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np

from ganet_tpu_torch.config import IMPLS, model_config
from ganet_tpu_torch.data.dataset import StereoDataset
from ganet_tpu_torch.data.png import write_disparity_png
from ganet_tpu_torch.data.synthetic import SyntheticStereoDataset
from ganet_tpu_torch.entry import build_model, predict, resolve_device
from ganet_tpu_torch.parallel.launch import default_backend, launch
from ganet_tpu_torch.parallel.mesh import inference_mesh
from ganet_tpu_torch.parallel.spatial import check_spatial_shape
from ganet_tpu_torch.train.checkpoint import fresh_init_state, load_inference_state

DEFAULT_CHECKPOINT = "./checkpoint/"


def output_names(entries):
    """Collision-free output PNG names for a list of dataset entries.

    KITTI lists have unique basenames (the submission layout keeps them);
    SceneFlow-style nested lists repeat basenames across scenes
    (.../left/0006.png), so those flatten the relative path into the name.
    """
    base = [os.path.basename(e) for e in entries]
    names = (
        base
        if len(set(base)) == len(base)
        else [e.strip("/").replace("/", "_") for e in entries]
    )
    return [
        n if n.lower().endswith(".png") else os.path.splitext(n)[0] + ".png"
        for n in names
    ]


def dataset_kind(args) -> str:
    """The dataset kind the --synthetic_data / --kitti2015 / --kitti flags name."""
    if args.synthetic_data:
        return "synthetic"
    if args.kitti2015:
        return "kitti2015"
    if args.kitti:
        return "kitti2012"
    return "sceneflow"


def check_flags(args, cfg, height: int) -> None:
    """Exit (SystemExit) for flags that no mesh of --data x --space ranks
    can serve: a mesh axis below 1, a --batch that --data does not divide
    (as the JAX CLI), a height that --space cannot share."""
    if args.space < 1 or args.data < 1:
        raise SystemExit(f"--space {args.space} --data {args.data}: each must be at least 1")
    if args.data > 1 and getattr(args, "batch", args.data) % args.data:
        raise SystemExit(f"--batch {args.batch} must be divisible by --data {args.data}")
    try:
        check_spatial_shape(cfg, height, args.space)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def serve(run, args):
    """`run(rank, world, args)` on the --data x --space ranks of the mesh,
    this process rank 0 (what it returns there); in this process alone for
    one device."""
    n = args.data * args.space
    if n == 1:
        return run(0, 1, args)
    device = "cpu" if args.device == "cpu" else "cuda"
    return launch(run, n, (args,), backend=default_backend(device, n), device=device,
                  caller_rank=True)


def load_weights(model_cfg, resume: str, what: str, quiet: bool = False):
    """The state_dict of the checkpoint under `resume` (or ./checkpoint/);
    with no --resume and no checkpoint there, a fresh random init, with a
    loud warning on stderr (unless `quiet`: the mesh's other ranks).  A
    --resume without a checkpoint raises."""
    try:
        return load_inference_state(resume or DEFAULT_CHECKPOINT)
    except FileNotFoundError:
        if resume:
            raise FileNotFoundError(
                f"--resume {resume}: no checkpoint found; {what} needs a trained checkpoint"
                " (or drop --resume to use fresh-init weights)"
            ) from None
        if not quiet:
            print(
            f"WARNING: no checkpoint under {DEFAULT_CHECKPOINT} — {what} with FRESH-INIT"
            " (random) weights; the results are meaningless except as a smoke test",
            file=sys.stderr,
        )
        return fresh_init_state(model_cfg)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GANet inference (PyTorch port)")
    p.add_argument("--crop_height", type=int, default=384)
    p.add_argument("--crop_width", type=int, default=1248)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--test_list", type=str, default="lists/kitti2015_test.list")
    p.add_argument("--save_path", type=str, default="./result/")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint directory (save_checkpoint's save_path)")
    p.add_argument("--model", type=str, default="GANet_deep",
                   choices=["GANet_deep", "GANet11", "GANet_small"])
    p.add_argument("--kitti", type=int, default=0)
    p.add_argument("--kitti2015", type=int, default=0)
    p.add_argument("--synthetic_data", type=int, default=0)
    p.add_argument("--sga_impl", type=str, default="auto", choices=IMPLS)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--batch", type=int, default=1, help="inference batch size")
    p.add_argument("--space", type=int, default=1,
                   help="mesh: spatial (image-height) shards, ranks on this host")
    p.add_argument("--data", type=int, default=1,
                   help="mesh: data-parallel (batch) shards, ranks on this host")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def config(args):
    """The `ModelConfig` of the flags."""
    return model_config(
        args.model,
        max_disp=args.max_disp,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        impl=args.sga_impl,
    )


def main(argv=None) -> List[str]:
    """Run the CLI; returns the paths of the PNGs written (rank 0's)."""
    args = parse_args(argv)
    cfg = config(args)
    cfg.validate_image_shape(args.crop_height, args.crop_width)
    check_flags(args, cfg, args.crop_height)
    return serve(run, args)


def run(rank: int, world: int, args) -> List[str]:
    """The CLI on one rank of the mesh (the only one for one device); rank
    0 writes the PNGs and returns their paths, the others return []."""
    device = resolve_device(args.device)
    cfg = config(args)
    mesh = inference_mesh(args.data, args.space)
    state = load_weights(cfg, args.resume, "predicting", quiet=rank > 0)
    model = build_model(cfg, device, state_dict=state, mesh=mesh)
    lead = rank == 0

    kind = dataset_kind(args)
    if lead:
        os.makedirs(args.save_path, exist_ok=True)
    if kind == "synthetic":
        ds = SyntheticStereoDataset(
            crop_height=args.crop_height,
            crop_width=args.crop_width,
            max_disp=args.max_disp,
            length=4,
            training=False,
        )
        names = [f"synthetic_{i:06d}.png" for i in range(len(ds))]
        sizes = [(args.crop_height, args.crop_width)] * len(ds)
    else:
        ds = StereoDataset(
            data_path=args.data_path,
            list_path=args.test_list,
            crop_height=args.crop_height,
            crop_width=args.crop_width,
            kind=kind,
            training=False,
            max_disp=args.max_disp,
        )
        names = output_names(ds.entries)
        sizes = [ds.original_size(i) for i in range(len(ds))]

    B = max(1, args.batch)
    n = len(ds)
    written = []
    for start in range(0, n, B):
        idx = list(range(start, min(start + B, n)))
        samples = [ds[i] for i in idx]
        # Pad the final partial batch by repeating the last sample, so every
        # batch has one shape.
        while len(samples) < B:
            samples.append(samples[-1])
        left = np.stack([s["left"] for s in samples])
        right = np.stack([s["right"] for s in samples])
        disps = predict(model, left, right).float().cpu().numpy()
        if not lead:
            continue
        for j, i in enumerate(idx):
            # Unpad: the test transform pads top/right, so the original
            # frame is the bottom-left corner.
            H, W = sizes[i]
            disp = disps[j][disps[j].shape[0] - H :, :W]
            out = os.path.join(args.save_path, names[i])
            write_disparity_png(out, disp)
            written.append(out)
            print(f"[{i + 1}/{n}] wrote {out}")
    return written


if __name__ == "__main__":
    main()
