"""Sub-stage dissection of the final disparity head (`DispAggHead`), with
dtype variants (the counterpart of `scripts/profile_head.py`):

    python -m ganet_tpu_torch.profile_head
    python -m ganet_tpu_torch.profile_head --only lga,softmax

At 576x960, max_disp 192, batch 1 by default, on volumes drawn from a
seeded `torch.Generator` on the device (NCHW: the cost and probability
volumes (B, D, H, W), the guidance (B, 75, H, W) raw), the JAX script's
16 stages under its names:
  upsample_f32, upsample_bf16    `ops.disparity.trilinear_upsample` x3;
  l1norm_g75_f32                 the guidance's L1 normalisation;
  lga_pass_f32, lga_pass_bf16,   one and two LGA passes through
  lga_x2_f32                     `ops.dispatch` with impl "kernel", which
                                 launch K2 on a card;
  softmax_f32, softmax_bf16io    the softmax over the disparity bins;
  renorm_reg_f32(current),       the renormalisation and expectation:
  renorm_reg_fused,              two passes, fused, and fused from
  renorm_reg_fused_bf16in        bfloat16 probabilities;
  conv32to1_via2d(current),      the head's 32 -> 1 3x3x3 convolution in
  conv32to1_native3d,            bfloat16 as `bench_conv3d.via2d` (taps
  conv32to1_dsplit               summed in bfloat16), cuDNN's 3D
                                 convolution, and `bench_conv3d.dsplit`
                                 (summed in bfloat16);
  head_after_conv_f32(current),  everything after that convolution:
  head_after_conv_bf16           upsample, both guidance normalisations,
                                 LGA x2, softmax, LGA x2, renormalised
                                 expectation, in float32 and with
                                 bfloat16 volumes.
"current" names what the JAX model ran when the script was written; the
port's head (`models/aggregation.py`) runs the fused expectation and its
convolution is cuDNN's.

Each row is JAX's line, `f"{name:36s} {ms:9.2f} ms"`, timed by
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

from ganet_tpu_torch.bench_conv3d import dsplit, via2d
from ganet_tpu_torch.entry import resolve_device
from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops.disparity import disparity_regression, trilinear_upsample
from ganet_tpu_torch.ops.normalize import l1_normalize
from ganet_tpu_torch.parallel.spatial import halo_conv_same
from ganet_tpu_torch.utils.profiling import run_stages

WIDTH = 36


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="DispAgg head sub-stages (PyTorch port)")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--max_disp", type=int, default=192)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--only", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def renorm_reg(p: torch.Tensor, D: int) -> torch.Tensor:
    """Renormalise (B, D, H, W) probabilities to unit L1 mass, then the
    expectation: two passes."""
    p = p / torch.clamp_min(p.abs().sum(dim=1, keepdim=True), 1e-6)
    return disparity_regression(p, D)


def fused_reg(p: torch.Tensor, D: int) -> torch.Tensor:
    """The renormalised expectation as two reductions, in p's dtype."""
    d = torch.arange(D, dtype=p.dtype, device=p.device).view(1, D, 1, 1)
    num = (p * d).sum(dim=1)
    den = torch.clamp_min(p.abs().sum(dim=1), 1e-6)
    return num / den


def head_f32(x: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor, shape, impl: str = "kernel"):
    """The head after its convolution, float32: x (B, D/3, H/3, W/3) up to
    `shape` (D, H, W), LGA x2 with L1-normalised l1, softmax, LGA x2 with
    l2, renormalised expectation.  l1, l2 (B, 75, H, W) raw."""
    D = shape[0]
    x = trilinear_upsample(x, shape)
    l1 = l1_normalize(l1, dim=1)
    l2 = l1_normalize(l2, dim=1)
    x = dispatch.lga_nchw(x, l1, 2, 2, impl)
    p = torch.softmax(-x, dim=1)
    p = dispatch.lga_nchw(p, l2, 2, 2, impl)
    return renorm_reg(p, D)


def head_bf16(x: torch.Tensor, l1: torch.Tensor, l2: torch.Tensor, shape, impl: str = "kernel"):
    """`head_f32` with bfloat16 volumes and guidance, the softmax and the
    expectation in float32."""
    bf16 = torch.bfloat16
    x = trilinear_upsample(x.to(bf16), shape)
    l1 = l1_normalize(l1, dim=1).to(bf16)
    l2 = l1_normalize(l2, dim=1).to(bf16)
    x = dispatch.lga_nchw(x, l1, 2, 2, impl)
    p = torch.softmax(-x.float(), dim=1).to(bf16)
    p = dispatch.lga_nchw(p, l2, 2, 2, impl)
    return fused_reg(p.float(), shape[0])


def build_stages(args: argparse.Namespace, dev: torch.device) -> Dict[str, Callable]:
    """{stage name: call}, in the JAX script's order, on inputs drawn on `dev`."""
    H, W, D = args.height, args.width, args.max_disp
    H3, W3, D3 = H // 3, W // 3, D // 3
    NB = args.batch
    shape = (D, H, W)
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(size, dtype=f32, uniform=False):
        fn = torch.rand if uniform else torch.randn
        return fn(size, generator=gen, device=dev, dtype=dtype)

    x_low = draw((NB, D3, H3, W3))
    x_full_f32 = draw((NB, D, H, W))
    x_full_bf16 = x_full_f32.to(bf16)
    g_raw = draw((NB, 75, H, W), uniform=True)
    g_norm = l1_normalize(g_raw, dim=1)
    g_norm_bf16 = g_norm.to(bf16)
    # A positive, probability-like volume for the renorm/regression stages.
    p_full = torch.softmax(-x_full_f32, dim=1)
    p_full_bf16 = p_full.to(bf16)
    x_agg = draw((NB, 32, D3, H3, W3), bf16)
    k1 = draw((1, 32, 3, 3, 3), bf16)

    return {
        "upsample_f32": lambda: trilinear_upsample(x_low, shape),
        "upsample_bf16": lambda: trilinear_upsample(x_low.to(bf16), shape),
        "l1norm_g75_f32": lambda: l1_normalize(g_raw, dim=1),
        "lga_pass_f32": lambda: dispatch.lga_nchw(x_full_f32, g_norm, 2, 1, "kernel"),
        "lga_pass_bf16": lambda: dispatch.lga_nchw(x_full_bf16, g_norm_bf16, 2, 1, "kernel"),
        "lga_x2_f32": lambda: dispatch.lga_nchw(x_full_f32, g_norm, 2, 2, "kernel"),
        "softmax_f32": lambda: torch.softmax(-x_full_f32, dim=1),
        "softmax_bf16io": lambda: torch.softmax(-x_full_bf16.float(), dim=1).to(bf16),
        "renorm_reg_f32(current)": lambda: renorm_reg(p_full, D),
        "renorm_reg_fused": lambda: fused_reg(p_full, D),
        "renorm_reg_fused_bf16in": lambda: fused_reg(p_full_bf16.float(), D),
        "conv32to1_via2d(current)": lambda: via2d(x_agg, k1, 1, bf16),
        "conv32to1_native3d": lambda: halo_conv_same(x_agg, k1),
        "conv32to1_dsplit": lambda: dsplit(x_agg, k1, bf16),
        "head_after_conv_f32(current)": lambda: head_f32(x_low, g_raw, g_raw, shape),
        "head_after_conv_bf16": lambda: head_bf16(x_low, g_raw, g_raw, shape),
    }


def main(argv=None) -> Dict[str, float]:
    """Print every stage's row; returns {stage: ms} (NaN for a FAILED row)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    only = [s for s in args.only.split(",") if s]
    return run_stages(build_stages(args, dev), only, dev, WIDTH)


if __name__ == "__main__":
    main()
