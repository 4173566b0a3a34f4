"""Stage-by-stage latency of GANet-deep's eval forward (the counterpart of
`scripts/profile_breakdown.py`):

    python -m ganet_tpu_torch.profile_breakdown
    python -m ganet_tpu_torch.profile_breakdown --only sga_full --trace /tmp/tr

At 576x960, max_disp 192, bfloat16, batch 1 by default, on inputs drawn
from a seeded `torch.Generator` on the device in the port's layouts
(NCDHW volumes, NCHW maps), the JAX script's 10 stages under its names:
  sga_full(x1), sga_half(x1)     one SGA call (4 sweeps) at the full-res
                                 (B, 32, D/3, H/3, W/3) and half-res
                                 (B, 48, D/6, H/6, W/6) volumes, weights
                                 L1-normalised, through `ops.dispatch`
                                 with impl "kernel": K1 on a card;
  lga_full(x1)                   one float32 LGA pass (radius 2, 75
                                 taps) at (B, D, H, W): K2 on a card;
  disp_head(upsample+softmax+reg)  trilinear x3, softmax, expectation;
  conv3d_64to32_fullres_decomposed(x1)  the full-res 64 -> 32 3x3x3
                                 convolution.  JAX times its
                                 `FastConv3d` (a decomposition into 2D
                                 convolutions); the port times the
                                 convolution its model runs,
                                 `layers.conv_same` (cuDNN), under JAX's
                                 name;
  cost_volume                    `build_cost_volume_ncdhw` at D/3 bins;
  feature_net(both views)        `FeatureNet` on both images;
  guidance_net                   `GuidanceNet`: the mean of every output
                                 in float32, stacked, as JAX sums them;
  cost_aggregation(module, eval) `CostAggregation` on a random cost
                                 volume and guidance (its final map);
  dispagg_head(module, eval)     `DispAggHead`.
The modules are GANet-deep's (`model_config("GANet_deep", ...)`, with
`--head_dtype` as `ModelConfig.head_dtype`), seeded as `entry.build_model`
seeds them and in eval mode, so the eval BatchNorm is folded into the 3D
convolutions; SGA and LGA inside them go through `ops.dispatch` with the
config's impl "auto" (the kernels on a card).

Each row is JAX's line, `f"{name:42s} {ms:9.2f} ms"`, timed by
`utils.profiling.run_stages` (one warm-up call, then `chained_ms`: the
median gap in a chain of 6 calls between CUDA events).  `--only` is a
comma-separated list of substrings; `--trace DIR` writes a
`utils.profiling.trace` (a Chrome trace) of each stage's timed chain into
DIR/<name>, the name's "(" as "_", ")" dropped and "," as "_".  JAX
prints a FAILED row for any error; here only `torch.cuda.OutOfMemoryError`
does, and any other error propagates.  It runs on the CUDA device unless
--device names another; without a card and without --device cpu it
raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

import torch
import torch.nn as nn

from ganet_tpu_torch.config import model_config
from ganet_tpu_torch.entry import resolve_device
from ganet_tpu_torch.models.aggregation import CostAggregation, DispAggHead
from ganet_tpu_torch.models.feature import FeatureNet
from ganet_tpu_torch.models.guidance import GuidanceNet
from ganet_tpu_torch.models.layers import conv_same, init_weights, torch_dtype
from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops.cost_volume import build_cost_volume_ncdhw
from ganet_tpu_torch.ops.disparity import disparity_regression, trilinear_upsample
from ganet_tpu_torch.ops.normalize import l1_normalize
from ganet_tpu_torch.utils.profiling import run_stages

WIDTH = 42


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="GANet-deep eval forward by stage (PyTorch port)")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--head_dtype", default="")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--only", default="", help="comma-separated stage filter")
    p.add_argument(
        "--trace",
        default="",
        metavar="DIR",
        help="also write a torch.profiler Chrome trace of each stage's timed "
        "chain into DIR/<stage>",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def seeded(module: nn.Module, dev: torch.device) -> nn.Module:
    """`module` with `entry.build_model`'s seeded init, on `dev`, in eval mode."""
    init_weights(module, torch.Generator().manual_seed(0))
    return module.to(dev).eval()


def guidance_means(out: dict) -> torch.Tensor:
    """The mean of every guidance output in float32, in the order of JAX's
    `tree_leaves` (keys sorted: lg1, lg2, sg_full..., sg_half...)."""
    leaves = [out["lg1"], out["lg2"], *out["sg_full"], *out["sg_half"]]
    return torch.stack([leaf.float().mean() for leaf in leaves])


def build_stages(args: argparse.Namespace, dev: torch.device) -> Dict[str, Callable]:
    """{stage name: call}, in the JAX script's order, on inputs drawn on `dev`."""
    H, W, D = args.height, args.width, args.max_disp
    H3, W3, D3 = H // 3, W // 3, D // 3
    NB = args.batch
    dtype = torch_dtype(args.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(size, dt=dtype):
        return torch.randn(size, generator=gen, device=dev, dtype=dt)

    def weights(size):
        return l1_normalize(torch.rand(size, generator=gen, device=dev), dim=3)

    stages = {}
    # SGA blocks' sweeps (full and half res).
    C_full, C_half = 32, 48
    x_full = normal((NB, C_full, D3, H3, W3))
    w_full = weights((NB, C_full, 4, 5, H3, W3)).to(dtype)
    stages["sga_full(x1)"] = lambda: dispatch.sga_ncdhw(x_full, w_full, "kernel")
    x_half = normal((NB, C_half, D3 // 2, H3 // 2, W3 // 2))
    w_half = weights((NB, C_half, 4, 5, H3 // 2, W3 // 2)).to(dtype)
    stages["sga_half(x1)"] = lambda: dispatch.sga_ncdhw(x_half, w_half, "kernel")

    # LGA at full image resolution.
    x_lga = normal((NB, D, H, W), torch.float32)
    g_lga = l1_normalize(torch.rand((NB, 75, H, W), generator=gen, device=dev), dim=1)
    stages["lga_full(x1)"] = lambda: dispatch.lga_nchw(x_lga, g_lga, 2, 1, "kernel")

    # Trilinear upsample + softmax + regression.
    x_low = normal((NB, D3, H3, W3), torch.float32)

    def head():
        up = trilinear_upsample(x_low, (D, H, W))
        return disparity_regression(torch.softmax(-up, dim=1), D)

    stages["disp_head(upsample+softmax+reg)"] = head

    # A full-res 3D convolution of the hourglass.
    conv = seeded(nn.Conv3d(2 * C_full, C_full, 3, bias=False), dev)
    cv0 = normal((NB, 2 * C_full, D3, H3, W3))
    stages["conv3d_64to32_fullres_decomposed(x1)"] = lambda: conv_same(cv0, conv)

    # Cost volume.
    f_l, f_r = normal((NB, C_full, H3, W3)), normal((NB, C_full, H3, W3))
    stages["cost_volume"] = lambda: build_cost_volume_ncdhw(f_l, f_r, D3)

    # Feature and guidance nets.
    cfg = model_config("GANet_deep", max_disp=D, compute_dtype=args.dtype,
                       **({"head_dtype": args.head_dtype} if args.head_dtype else {}))
    img = normal((2 * NB, 3, H, W), torch.float32)
    fnet = seeded(FeatureNet(cfg), dev)
    stages["feature_net(both views)"] = lambda: fnet(img.to(dtype))
    gnet = seeded(GuidanceNet(cfg), dev)
    img1 = img[:NB]
    feat1 = normal((NB, C_full, H3, W3))
    stages["guidance_net"] = lambda: guidance_means(gnet(img1.to(dtype), feat1))

    # The whole cost aggregation (convolutions, SGA blocks, final head).
    agg = seeded(CostAggregation(cfg), dev)
    cv_in = normal((NB, 2 * C_full, D3, H3, W3))
    guid = {
        "sg_full": [normal((NB, 20 * C_full, H3, W3)) for _ in range(cfg.num_sga_full)],
        "sg_half": [normal((NB, 20 * C_half, H3 // 2, W3 // 2)) for _ in range(cfg.num_sga_half)],
        "lg1": normal((NB, 75, H, W)),
        "lg2": normal((NB, 75, H, W)),
    }
    stages["cost_aggregation(module, eval)"] = lambda: agg(cv_in, guid)

    dah = seeded(DispAggHead(cfg, C_full), dev)
    x_agg = normal((NB, C_full, D3, H3, W3))
    stages["dispagg_head(module, eval)"] = lambda: dah(x_agg, guid["lg1"], guid["lg2"])
    return stages


def main(argv=None) -> Dict[str, float]:
    """Print every stage's row; returns {stage: ms} (NaN for a FAILED row)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    only = [s for s in args.only.split(",") if s]
    return run_stages(build_stages(args, dev), only, dev, WIDTH, trace_dir=args.trace)


if __name__ == "__main__":
    main()
