"""Module-by-module latency of the cost-aggregation hourglass at its
in-model shapes (the counterpart of `scripts/profile_agg.py`):

    python -m ganet_tpu_torch.profile_agg
    python -m ganet_tpu_torch.profile_agg --impl scan --only sga

At 576x960, max_disp 192, bfloat16 by default, batch 1, on volumes drawn
from a seeded `torch.Generator` on the device: full (1, 32, D/3, H/3,
W/3), half (1, 48, D/6, H/6, W/6), quarter (1, 64, D/12, H/12, W/12),
the cost volume (1, 64, D/3, H/3, W/3) and one SGA block's raw guidance
(1, 640, H/3, W/3).  The JAX script's 16 stages under its names: an
`SGABlock` alone and two chained, `conv_start`, the three `Conv2x`
stages and the two stride-2 descents, `DispHead`, the bare 32 -> 1
convolution (no BatchNorm, no ReLU), a slice of the hourglass's trunk
(`Trunk`: conv_start, SGA, two descents, two ascents, SGA), the SGA
guidance's unpacking and L1 normalisation, the SGA op alone on
pre-normalised weights (`ops.dispatch` with impl "kernel" whatever
`--impl` says, as JAX calls it with "pallas"), and the SGA block's tail
after its sweeps (BatchNorm + ReLU; all of it; the refining
convolution).
The modules are GANet-deep's (`model_config("GANet_deep", ...)`),
seeded as `entry.build_model` seeds them and in eval mode, so the eval
BatchNorm is folded into the 3D convolutions.  `--impl` takes JAX's
values, "pallas" (the port's impl "kernel": K1 on a card) or "scan"
("torch": the plain versions), as the train CLI maps them
(`train.cli.JAX_IMPLS`).

Each row is JAX's line, `f"{name:44s} {ms:9.2f} ms"`, timed by
`utils.profiling.run_stages` (one warm-up call, then `chained_ms`: the
median gap in a chain of 6 calls between CUDA events).  `--only` is a
comma-separated list of substrings.  JAX prints a FAILED row for any
error; here only `torch.cuda.OutOfMemoryError` does, and any other error
propagates.  It runs on the CUDA device unless --device names another;
without a card and without --device cpu it raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ganet_tpu_torch.config import ModelConfig, model_config
from ganet_tpu_torch.entry import resolve_device
from ganet_tpu_torch.models.aggregation import DispHead, SGABlock
from ganet_tpu_torch.models.layers import BasicConv, Conv2x, bn_eval, torch_dtype
from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops.normalize import normalize_weights
from ganet_tpu_torch.profile_breakdown import seeded
from ganet_tpu_torch.train.cli import JAX_IMPLS
from ganet_tpu_torch.utils.profiling import run_stages

WIDTH = 44


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="cost-aggregation hourglass by module (PyTorch port)")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--impl", default="pallas", choices=["pallas", "scan"])
    p.add_argument("--only", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


class Trunk(nn.Module):
    """A vertical slice of the hourglass: conv_start (64 -> 32), an SGA
    block, the descents to half and quarter res, the ascents back with
    their skips, and a second SGA block."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.conv_start = BasicConv(64, 32, 3, is_3d=True, relu=False)
        self.sga0 = SGABlock(32, cfg)
        self.down0 = BasicConv(32, 48, 3, stride=2, is_3d=True)
        self.down1 = BasicConv(48, 64, 3, stride=2, is_3d=True)
        self.up1 = Conv2x(64, 48, 48, deconv=True, is_3d=True)
        self.up0 = Conv2x(48, 32, 32, deconv=True, is_3d=True, relu=False)
        self.sga1 = SGABlock(32, cfg)

    def forward(self, cv: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        x = self.sga0(self.conv_start(cv), g)
        rem0 = x
        x = rem1 = self.down0(x)
        x = self.up1(self.down1(x), rem1)
        return self.sga1(self.up0(x, rem0), g)


class TailBNRelu(nn.Module):
    """The SGA block's eval BatchNorm and ReLU after its sweeps."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = nn.BatchNorm3d(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(bn_eval(x, self.bn))


class TailFull(nn.Module):
    """The SGA block's whole tail: BatchNorm, ReLU, the refining
    convolution (with its BatchNorm) and the residual ReLU."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = nn.BatchNorm3d(channels, eps=1e-5, momentum=0.1)
        self.refine = BasicConv(channels, channels, 3, is_3d=True, relu=False)

    def forward(self, x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        y = self.refine(F.relu(bn_eval(x, self.bn)))
        return F.relu(y + rem.to(y.dtype))


def guidance_prep(g: torch.Tensor, channels: int = 32) -> torch.Tensor:
    """An SGA block's raw guidance (B, 20 C, H, W), (direction, weight, C)
    channel order, as the block unpacks it: (B, C, 4, 5, H, W), each set of
    5 weights L1-normalised."""
    B, _, H, W = g.shape
    k = normalize_weights(g.view(B, 4, 5, channels, H, W), "l1", dim=2)
    return k.permute(0, 3, 1, 2, 4, 5).contiguous()


def build_stages(args: argparse.Namespace, dev: torch.device) -> Dict[str, Callable]:
    """{stage name: call}, in the JAX script's order, on inputs drawn on `dev`."""
    H, W, D = args.height, args.width, args.max_disp
    H3, W3, D3 = H // 3, W // 3, D // 3
    dtype = torch_dtype(args.dtype)
    cfg = model_config("GANet_deep", max_disp=D, compute_dtype=args.dtype, impl=JAX_IMPLS[args.impl])
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(size):
        return torch.randn(size, generator=gen, device=dev, dtype=dtype)

    x_full = normal((1, 32, D3, H3, W3))
    x_half = normal((1, 48, D3 // 2, H3 // 2, W3 // 2))
    x_quarter = normal((1, 64, D3 // 4, H3 // 4, W3 // 4))
    cv = normal((1, 64, D3, H3, W3))
    g_full = normal((1, 640, H3, W3))

    sgab = seeded(SGABlock(32, cfg), dev)
    cs = seeded(BasicConv(64, 32, 3, is_3d=True, relu=False), dev)
    up = seeded(Conv2x(48, 32, 32, deconv=True, is_3d=True, relu=False), dev)
    down = seeded(Conv2x(32, 48, 48, is_3d=True), dev)
    up2 = seeded(Conv2x(64, 48, 48, deconv=True, is_3d=True), dev)
    d1 = seeded(BasicConv(48, 64, 3, stride=2, is_3d=True), dev)
    d0 = seeded(BasicConv(32, 48, 3, stride=2, is_3d=True), dev)
    dh = seeded(DispHead(cfg, 32), dev)
    c1 = seeded(BasicConv(32, 1, 3, is_3d=True, use_bn=False, relu=False), dev)
    sgab2 = seeded(SGABlock(32, cfg), dev)
    trunk = seeded(Trunk(cfg), dev)
    k_pre = guidance_prep(g_full)
    tb = seeded(TailBNRelu(32), dev)
    tf = seeded(TailFull(32), dev)
    rc = seeded(BasicConv(32, 32, 3, is_3d=True, relu=False), dev)

    return {
        "sga_block_full(module)": lambda: sgab(x_full, g_full),
        "conv_start(64to32+BN)": lambda: cs(cv),
        "conv2x_up_to_full(module)": lambda: up(x_half, x_full),
        "conv2x_down_from_full(module)": lambda: down(x_full, x_half),
        "conv2x_up_to_half(module)": lambda: up2(x_quarter, x_half),
        "descent_half_to_quarter(s2 48to64)": lambda: d1(x_half),
        "descent_full_to_half(s2 32to48)": lambda: d0(x_full),
        "disp_head(module)": lambda: dh(x_full),
        "conv_32to1_fullres": lambda: c1(x_full),
        "sga_block_x2_chained": lambda: sgab2(sgab(x_full, g_full), g_full),
        "trunk_slice(cs+sga+desc2+asc2+sga)": lambda: trunk(cv, g_full),
        "sga_guidance_prep(reshape+moveaxis+norm)": lambda: guidance_prep(g_full),
        "sga_bare_with_prenormed_k": lambda: dispatch.sga_ncdhw(x_full, k_pre, "kernel"),
        "sga_tail_bn_relu": lambda: tb(x_full),
        "sga_tail_full(bn+relu+conv+bn+res)": lambda: tf(x_full, x_full),
        "sga_refine_conv(32to32+bn)": lambda: rc(x_full),
    }


def main(argv=None) -> Dict[str, float]:
    """Print every stage's row; returns {stage: ms} (NaN for a FAILED row)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    only = [s for s in args.only.split(",") if s]
    return run_stages(build_stages(args, dev), only, dev, WIDTH)


if __name__ == "__main__":
    main()
