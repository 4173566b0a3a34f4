"""Input-pipeline throughput of the port: disk to `BatchIterator` batches
(the counterpart of `scripts/bench_input.py`).

    python -m ganet_tpu_torch.bench_input [--samples 64] [--batch 4] [--keep DIR]

Writes a SceneFlow-layout tree (540x960 RGB PNGs of uint8 noise and PFM
disparity, the SceneFlow frame size) with the port's writers, its PNG rows
filtered Sub, Up, Average and Paeth in turn, as an encoder mixes them; then
times pairs/s through `StereoDataset` (random crop, normalise) and
`BatchIterator` at the reference training crop: the Python readers with
prefetch 2, and the native decoder (`data/native_io.py`) with prefetch 2
and 0 where its library builds.  Host work only: no device is used.

Prints one JSON line with the keys of `scripts/bench_input.py`:
  {"metric": "input_pipeline_pairs_per_sec", "unit": "pairs/s", "samples",
   "crop", "batch", "native_available", "host_cpus", "python_pairs_per_s",
   "native_pairs_per_s", "native_noprefetch_pairs_per_s", "value"}
less its three feeding margins, which divide by a training step's rate on
another accelerator; compare "value" with the step's pairs/s on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

# The row filters the tree's PNGs cycle through: Sub, Up, Average, Paeth.
ROW_FILTERS = (1, 2, 3, 4)


def generate_dataset(root: str, n: int, H: int = 540, W: int = 960,
                     row_filters=ROW_FILTERS) -> str:
    """SceneFlow-style tree: frames_finalpass/scene/left|right/NNNN.png +
    disparity/scene/left/NNNN.pfm.  Returns the list-file path."""
    from ganet_tpu_torch.data.pfm import write_pfm
    from ganet_tpu_torch.data.png import write_png

    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        scene = f"scene{i // 8:03d}"
        name = f"{i % 8:04d}"
        ldir = os.path.join(root, "frames_finalpass", scene, "left")
        rdir = os.path.join(root, "frames_finalpass", scene, "right")
        ddir = os.path.join(root, "disparity", scene, "left")
        for d in (ldir, rdir, ddir):
            os.makedirs(d, exist_ok=True)
        # Noise, so that decode costs what a textured photograph costs.
        left = rng.integers(0, 255, (H, W, 3), np.uint8)
        right = rng.integers(0, 255, (H, W, 3), np.uint8)
        disp = (rng.random((H, W)) * 190.0).astype(np.float32)
        write_png(os.path.join(ldir, name + ".png"), left, row_filters)
        write_png(os.path.join(rdir, name + ".png"), right, row_filters)
        write_pfm(os.path.join(ddir, name + ".pfm"), disp)
        entries.append(f"frames_finalpass/{scene}/left/{name}.png")
    list_path = os.path.join(root, "train.list")
    with open(list_path, "w") as f:
        f.write("\n".join(entries) + "\n")
    return list_path


def measure(ds, batch: int, prefetch: int, epochs: int = 2) -> float:
    """pairs/s through BatchIterator (steady state: skips the first epoch's
    size-cache misses by timing the later epoch only)."""
    from ganet_tpu_torch.data.pipeline import BatchIterator

    it = BatchIterator(ds, batch, shuffle=True, seed=0, prefetch=prefetch)
    pairs = 0
    t0 = None
    for e in range(epochs):
        if e == epochs - 1:
            t0 = time.perf_counter()
            pairs = 0
        for b in iter(it):
            pairs += b["left"].shape[0]
    dt = time.perf_counter() - t0
    return pairs / dt


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="disk to BatchIterator pairs/s (PyTorch port)")
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--crop_height", type=int, default=240)
    p.add_argument("--crop_width", type=int, default=528)
    p.add_argument("--keep", default="", help="dataset dir to reuse/keep")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from ganet_tpu_torch.data import native_io
    from ganet_tpu_torch.data.dataset import StereoDataset

    root = args.keep or tempfile.mkdtemp(prefix="ganet_input_bench_")
    list_path = os.path.join(root, "train.list")
    if not os.path.exists(list_path):
        print(f"# generating {args.samples} pairs under {root}", file=sys.stderr)
        list_path = generate_dataset(root, args.samples)

    def make_ds(use_native: bool):
        return StereoDataset(
            data_path=root,
            list_path=list_path,
            crop_height=args.crop_height,
            crop_width=args.crop_width,
            kind="sceneflow",
            training=True,
            max_disp=192,
            use_native=use_native,
        )

    results = {
        "metric": "input_pipeline_pairs_per_sec",
        "unit": "pairs/s",
        "samples": args.samples,
        "crop": f"{args.crop_height}x{args.crop_width}",
        "batch": args.batch,
        "native_available": native_io.native_available(),
        "host_cpus": os.cpu_count(),
    }
    results["python_pairs_per_s"] = round(measure(make_ds(False), args.batch, prefetch=2), 2)
    if native_io.native_available():
        results["native_pairs_per_s"] = round(measure(make_ds(True), args.batch, prefetch=2), 2)
        results["native_noprefetch_pairs_per_s"] = round(
            measure(make_ds(True), args.batch, prefetch=0), 2
        )
    else:
        print(f"# native decoder unavailable: {native_io.why_unavailable()}", file=sys.stderr)
    results["value"] = results.get("native_pairs_per_s", results["python_pairs_per_s"])
    print(json.dumps(results))
    if not args.keep:
        shutil.rmtree(root, ignore_errors=True)
    return results


if __name__ == "__main__":
    main()
