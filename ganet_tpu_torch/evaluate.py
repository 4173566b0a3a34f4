"""Evaluation CLI of the port (the counterpart of the repo's
`evaluation.py`, with its flags): end-point error, the >1/2/3-px error
rates and KITTI's D1-all, either

  * offline, from saved disparity PNGs against ground truth:
      python -m ganet_tpu_torch.evaluate --pred_path ./result/ \\
          --gt_path DIR --test_list LIST --kitti2015 1
  * or online, running the model from a checkpoint over a list:
      python -m ganet_tpu_torch.evaluate --resume CKPT_DIR --data_path DIR \\
          --test_list LIST --crop_height 384 --crop_width 1248

--weighting image (default) averages per-image metrics, as KITTI's
protocol does; pixel weights each image by its valid pixels.  The online
path runs on the CUDA device unless --device names another, and warns
loudly when it falls back to fresh random weights (no --resume and no
checkpoint under ./checkpoint/); a --resume without a checkpoint raises.
--bf16 1 and --sga_impl are predict's flags, for the online path, and so
are --space and --data: the online path then runs on a (data, space) mesh
of ranks on this host, this process rank 0 (`predict.serve`), over
batches of max(1, --data) frames (the last padded by repeating its last
frame, whose metrics are not counted), as the JAX CLI does; rank 0 counts
and prints the metrics.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ganet_tpu_torch.config import IMPLS, DataConfig
from ganet_tpu_torch.data.dataset import get_test_set
from ganet_tpu_torch.data.lists import derive_paths, read_list
from ganet_tpu_torch.data.pfm import read_pfm
from ganet_tpu_torch.data.png import read_disparity_png
from ganet_tpu_torch.entry import build_model, predict, resolve_device
from ganet_tpu_torch.parallel.mesh import inference_mesh
from ganet_tpu_torch.predict import (
    check_flags,
    config,
    dataset_kind,
    load_weights,
    output_names,
    serve,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="GANet evaluation (PyTorch port)")
    p.add_argument("--pred_path", type=str, default="",
                   help="directory of predicted disparity PNGs; empty = run model")
    p.add_argument("--gt_path", type=str, default="")
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--test_list", type=str, required=True)
    p.add_argument("--kitti", type=int, default=0)
    p.add_argument("--kitti2015", type=int, default=0)
    p.add_argument("--synthetic_data", type=int, default=0)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--crop_height", type=int, default=384)
    p.add_argument("--crop_width", type=int, default=1248)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--model", type=str, default="GANet_deep")
    p.add_argument("--max_samples", type=int, default=0)
    p.add_argument("--weighting", choices=["image", "pixel"], default="image",
                   help="'image' = mean of per-image metrics (the KITTI protocol); "
                        "'pixel' = valid-pixel-weighted")
    p.add_argument("--space", type=int, default=1,
                   help="mesh: spatial (image-height) shards, ranks on this host")
    p.add_argument("--data", type=int, default=1,
                   help="mesh: data-parallel (batch) shards, ranks on this host")
    p.add_argument("--sga_impl", type=str, default="auto", choices=IMPLS)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def _metrics_np(pred, gt, max_disp):
    valid = (gt > 0) & (gt < max_disp)
    n = max(valid.sum(), 1)
    err = np.abs(pred - gt)
    d1 = (err > 3.0) & (err > 0.05 * np.abs(gt))
    return {
        "epe": float((err * valid).sum() / n),
        "rate_1px": float(((err > 1.0) & valid).sum() / n),
        "rate_2px": float(((err > 2.0) & valid).sum() / n),
        "rate_3px": float(((err > 3.0) & valid).sum() / n),
        "d1_all": float((d1 & valid).sum() / n),
        "valid_px": float(valid.sum()),
    }


def online(rank: int, world: int, args) -> list:
    """The online path on one rank of the mesh (the only one for one
    device): the metrics of each frame of the list, in order."""
    device = resolve_device(args.device)
    cfg = config(args)
    data = DataConfig(
        data_path=args.data_path,
        val_list=args.test_list,
        crop_height=args.crop_height,
        crop_width=args.crop_width,
        kind=dataset_kind(args),
    )
    mesh = inference_mesh(args.data, args.space)
    state = load_weights(cfg, args.resume, "evaluating", quiet=rank > 0)
    model = build_model(cfg, device, state_dict=state, mesh=mesh)
    ds = get_test_set(data, args.max_disp)
    n = len(ds) if not args.max_samples else min(len(ds), args.max_samples)
    B = max(1, args.data)
    metrics = []
    for start in range(0, n, B):
        samples = [ds[i] for i in range(start, min(start + B, n))]
        count = len(samples)
        while len(samples) < B:
            samples.append(samples[-1])
        preds = predict(model, np.stack([s["left"] for s in samples]),
                        np.stack([s["right"] for s in samples])).float().cpu().numpy()
        for j in range(count):
            metrics.append(_metrics_np(preds[j], samples[j]["disparity"], args.max_disp))
    return metrics


def main(argv=None) -> dict:
    """Run the CLI; returns the metrics."""
    args = parse_args(argv)
    kind = dataset_kind(args)

    totals: dict = {}
    count = 0
    weight_sum = 0.0

    def accumulate(m):
        nonlocal count, weight_sum
        w = m.pop("valid_px") if args.weighting == "pixel" else 1.0
        for k, v in m.items():
            if k != "valid_px":
                totals[k] = totals.get(k, 0.0) + v * w
        weight_sum += w
        count += 1

    if args.pred_path:
        # Offline: compare saved PNGs against ground truth.
        entries = read_list(args.test_list)
        if args.max_samples:
            entries = entries[: args.max_samples]
        # The same collision-free names as predict writes.
        for e, name in zip(entries, output_names(entries)):
            paths = derive_paths(args.gt_path or args.data_path, e, kind)
            pred = read_disparity_png(os.path.join(args.pred_path, name))
            if kind == "sceneflow":
                gt = read_pfm(paths.disparity)
                gt = np.abs(gt[..., 0] if gt.ndim == 3 else gt)
            else:
                gt = read_disparity_png(paths.disparity)
            accumulate(_metrics_np(pred, gt, args.max_disp))
    else:
        # Online: run the model over the list.
        cfg = config(args)
        cfg.validate_image_shape(args.crop_height, args.crop_width)
        check_flags(args, cfg, args.crop_height)
        for m in serve(online, args):
            accumulate(m)

    denom = weight_sum if args.weighting == "pixel" else count
    result = {k: v / max(denom, 1) for k, v in totals.items()}
    print(f"samples={count} " + " ".join(f"{k}={v:.4f}" for k, v in sorted(result.items())))
    return result


if __name__ == "__main__":
    main()
