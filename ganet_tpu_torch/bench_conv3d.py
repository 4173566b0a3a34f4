"""Microbenchmark of 3x3x3 convolution strategies at the aggregation
hourglass's shapes (the counterpart of `scripts/bench_conv3d.py`):

    python -m ganet_tpu_torch.bench_conv3d
    python -m ganet_tpu_torch.bench_conv3d --only fullres_64to32 --dtype float32

Strategies, each the same "SAME" 3D convolution of an NCDHW volume with
an OIDHW kernel:
  native3d      cuDNN's 3D convolution, as the model runs it
                (`parallel.spatial.halo_conv_same`, under
                `layers.conv_same`), its output in the input's dtype;
  via2d         the port's copy of the JAX package's `conv3d_via_2d`: D
                padded as XLA's SAME pads it (the odd pad high), each of
                the kd depth taps a batched 2D convolution with D folded
                into the batch, the taps summed in float32;
  via2d_bf16    the same, the taps summed in bfloat16;
  dconcat       the kd taps concatenated along the channels, one 2D
                convolution with kd x Cin input channels, its output in
                float32 (`_bf16`: in bfloat16);
  dsplit        the port's copy of `conv3d_dsplit` (stride 1 only): one
                2D convolution with kd x Cout output channels, tap-major,
                then out(d) = y0(d-1) + y1(d) + y2(d+1), summed in
                float32 (`_bf16`: in bfloat16).
PyTorch has no `preferred_element_type`: a 2D convolution of bfloat16
inputs returns bfloat16 (cuDNN sums in float32 inside), so the float32
variants round each tap's output to bfloat16 before they sum the taps in
float32, where JAX's taps stay float32 to the sum.  Each strategy returns
a contiguous NCDHW volume, as the model's next layer takes it: folding D
into the batch and back costs copies that JAX's channels-last layout does
not pay.  These copies live here only; the model's convolutions stay
`layers.conv_same` (cuDNN).

Cases, the JAX script's shapes in NCDHW (30 rows at the defaults):
`fullres_64to32`, `fullres_32to32`, `halfres_96to48` (stride 1: all seven
strategies) and `stride2_32to48` (stride 2: the five without dsplit),
each with a `---` header line, its GFLOP (`flops_same`) and its TFLOP/s
lines; after each stride-1 case the dsplit check: float32 (1, 4, 5, 8, 9)
-> 6 channels against `F.conv3d` at rtol = atol = 2e-4, with TF32 off,
which raises on a mismatch and prints its max |diff| on a `#` stderr
line.  Then two deconvolutions, `deconv_48to32_to_fullres` and
`deconv_64to48`:
  convtranspose  the hourglass's stride-2, kernel-4 transposed
                 convolution, as `layers.Conv2x` computes it
                 (`parallel.spatial.halo_conv_transpose`);
  subpixel8      a copy of the JAX script's `subpixel_deconv` arithmetic,
                 eight 2x2x2-tap convolutions interleaved.  It does NOT
                 compute the transposed convolution it stands beside (the
                 JAX script leaves it unchecked, "timing signal only", and
                 on its own inputs it differs from flax's ConvTranspose by
                 more than the output's size): a timing signal, kept as
                 JAX's arithmetic, not repaired.

Each row is JAX's line, `f"{name:36s} {ms:8.2f} ms"`, timed by
`utils.profiling.run_stages` (one warm-up call, then `chained_ms`: the
median gap in a chain of 6 calls between CUDA events).  `--only` keeps
the rows whose name holds that one substring.  JAX prints a FAILED row
for any error; here only `torch.cuda.OutOfMemoryError` does, and any
other error propagates.  Inputs are drawn from a seeded
`torch.Generator` on the device.  It runs on the CUDA device unless
--device names another; without a card and without --device cpu it
raises.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ganet_tpu_torch.entry import resolve_device
from ganet_tpu_torch.models.layers import torch_dtype
from ganet_tpu_torch.parallel.spatial import halo_conv_same, halo_conv_transpose
from ganet_tpu_torch.utils.profiling import run_stages

# (name, input (B, Cin, D, H, W), Cout, stride): the flagship full-res
# layer, the refine conv of the 7 SGA blocks, the half-res fuse, and the
# stride-2 descent from full res.
CASES = (
    ("fullres_64to32", (1, 64, 64, 192, 320), 32, 1),
    ("fullres_32to32", (1, 32, 64, 192, 320), 32, 1),
    ("halfres_96to48", (1, 96, 32, 96, 160), 48, 1),
    ("stride2_32to48", (1, 32, 64, 192, 320), 48, 2),
)
# (name, input (B, Cin, D, H, W), Cout): the hourglass's ascent.
DECONVS = (
    ("deconv_48to32_to_fullres", (1, 48, 32, 96, 160), 32),
    ("deconv_64to48", (1, 64, 16, 48, 80), 48),
)
STRIDE1 = ("dsplit", "dsplit_bf16")
STRATEGIES = ("native3d", "via2d", "via2d_bf16", "dconcat", "dconcat_bf16")
# The dsplit check: input (B, Cin, D, H, W) and Cout.
CHECK_SHAPE, CHECK_COUT = (1, 4, 5, 8, 9), 6
WIDTH, MS_WIDTH = 36, 8


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="3x3x3 conv strategies (PyTorch port)")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--only", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    return p.parse_args(argv)


def flops_same(B, D, H, W, Cin, Cout, k=3, stride=1) -> int:
    return 2 * (B * (D // stride) * (H // stride) * (W // stride)) * (k * k * k * Cin) * Cout


def strategies(stride: int) -> tuple:
    """A case's strategies in the JAX script's row order."""
    return (STRIDE1 if stride == 1 else ()) + STRATEGIES


def _fold(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B D, C, H, W): D folded into the batch."""
    B, C, D, H, W = x.shape
    return x.transpose(1, 2).reshape(B * D, C, H, W)


def _unfold(y: torch.Tensor, B: int) -> torch.Tensor:
    """(B D, C, H, W) -> contiguous (B, C, D, H, W)."""
    BD, C, H, W = y.shape
    return y.view(B, BD // B, C, H, W).transpose(1, 2).contiguous()


def _depth_taps(x: torch.Tensor, kd: int, stride: int) -> list:
    """The kd depth taps of x, each (B, C, Do, H, W), Do = ceil(D / stride):
    D padded as XLA's SAME pads it, the low pad pad_total // 2."""
    D = x.shape[2]
    Do = -(-D // stride)
    pad_total = max((Do - 1) * stride + kd - D, 0)
    lo = pad_total // 2
    xp = F.pad(x, (0, 0, 0, 0, lo, pad_total - lo))
    return [xp[:, :, dz : dz + stride * (Do - 1) + 1 : stride] for dz in range(kd)]


def via2d(x: torch.Tensor, k: torch.Tensor, stride: int = 1,
          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The port's `conv3d_via_2d`: kd batched 2D convolutions, one a depth
    tap, summed in `out_dtype`.  x (B, Cin, D, H, W), k (Cout, Cin, kd, kh,
    kw) -> (B, Cout, Do, Ho, Wo)."""
    out = None
    for dz, xs in enumerate(_depth_taps(x, k.shape[2], stride)):
        o = halo_conv_same(_fold(xs), k[:, :, dz], stride=stride).to(out_dtype)
        out = o if out is None else out + o
    return _unfold(out, x.shape[0])


def dconcat(x: torch.Tensor, k: torch.Tensor, stride: int = 1,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kd depth taps concatenated along the channels (tap-major), one
    2D convolution with kd Cin input channels, cast to `out_dtype`."""
    kd = k.shape[2]
    xc = torch.cat(_depth_taps(x, kd, stride), dim=1)
    kc = torch.cat([k[:, :, dz] for dz in range(kd)], dim=1)
    return _unfold(halo_conv_same(_fold(xc), kc, stride=stride).to(out_dtype), x.shape[0])


def dsplit(x: torch.Tensor, k: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The port's `conv3d_dsplit` (stride 1, kd 3): one 2D convolution with
    the depth taps packed into its output channels (tap-major), then
    out(d) = y0(d-1) + y1(d) + y2(d+1), zero past the ends, summed in
    `out_dtype` in that order."""
    B, _, D, H, W = x.shape
    Cout, _, kd = k.shape[:3]
    if kd != 3:
        raise ValueError(f"dsplit requires kd=3, got {kd}")
    k2 = torch.cat([k[:, :, dz] for dz in range(kd)], dim=0)
    y = halo_conv_same(_fold(x), k2).to(out_dtype).view(B, D, kd, Cout, H, W)
    out = y[:, :, 1].clone()
    out[:, 1:] += y[:, :-1, 0]
    out[:, :-1] += y[:, 1:, 2]
    return out.transpose(1, 2).contiguous()


def subpixel8(x: torch.Tensor, k4: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX script's `subpixel_deconv` (`scripts/bench_conv3d.py`), its
    arithmetic copied: for each of the 8 parities (a, b, c), the 2x2x2
    taps k4[..., a::2, b::2, c::2] applied as two VALID 2D convolutions
    over x padded by one zero in front along D, H and W, summed in
    `out_dtype`; the 8 outputs interleaved, out[2d + a, 2h + b, 2w + c].
    x (B, Cin, D, H, W), k4 (Cout, Cin, 4, 4, 4) -> (B, Cout, 2D, 2H, 2W).
    Not the transposed convolution it is timed beside: a timing signal."""
    B, _, D, H, W = x.shape
    Cout = k4.shape[0]
    xp = F.pad(x, (1, 0, 1, 0, 1, 0))
    outs = []
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                kk = k4[:, :, a::2, b::2, c::2].to(x.dtype)
                o = None
                for dz in range(2):
                    oo = F.conv2d(_fold(xp[:, :, dz : dz + D]), kk[:, :, dz]).to(out_dtype)
                    o = oo if o is None else o + oo
                outs.append(o.view(B, D, Cout, H, W))
    z = torch.stack(outs, dim=2).view(B, D, 2, 2, 2, Cout, H, W)  # (B, D, a, b, c, Cout, H, W)
    z = z.permute(0, 5, 1, 2, 6, 3, 7, 4)  # (B, Cout, D, a, H, b, W, c)
    return z.reshape(B, Cout, 2 * D, 2 * H, 2 * W)


def case_stages(cname: str, x: torch.Tensor, k: torch.Tensor, stride: int) -> Dict[str, Callable]:
    """{row name: call} of one case, in the JAX script's row order."""
    bf16 = torch.bfloat16
    calls = {
        "dsplit": lambda: dsplit(x, k),
        "dsplit_bf16": lambda: dsplit(x, k, bf16),
        "native3d": lambda: halo_conv_same(x, k, stride=stride),
        "via2d": lambda: via2d(x, k, stride),
        "via2d_bf16": lambda: via2d(x, k, stride, bf16),
        "dconcat": lambda: dconcat(x, k, stride),
        "dconcat_bf16": lambda: dconcat(x, k, stride, bf16),
    }
    return {f"{cname}/{n}": calls[n] for n in strategies(stride)}


def dsplit_check(device: torch.device) -> float:
    """The JAX script's dsplit check: float32 `CHECK_SHAPE` -> `CHECK_COUT`
    channels against `F.conv3d`, rtol = atol = 2e-4, with TF32 off (a check
    of the arithmetic, not of TF32's rounding).  Raises on a mismatch;
    returns the max |diff|."""
    gen = torch.Generator(device=device).manual_seed(0)
    xs = torch.randn(CHECK_SHAPE, generator=gen, device=device)
    ks = torch.randn((CHECK_COUT, CHECK_SHAPE[1], 3, 3, 3), generator=gen, device=device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, ref = dsplit(xs, ks), F.conv3d(xs, ks, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    return (got - ref).abs().max().item()


def main(argv=None) -> Dict[str, float]:
    """Print every row; returns {row name: ms} (NaN for a FAILED row)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    dtype = torch_dtype(args.dtype)
    only = [args.only] if args.only else []
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    results: Dict[str, float] = {}
    for cname, shape, cout, stride in CASES:
        B, Cin, D, H, W = shape
        x, k = normal(shape), normal((cout, Cin, 3, 3, 3))
        gf = flops_same(B, D, H, W, Cin, cout, stride=stride) / 1e9
        print(f"--- {cname}  {shape} -> C{cout} s{stride}  ({gf:.1f} GFLOP)", flush=True)
        rows = run_stages(case_stages(cname, x, k, stride), only, dev, WIDTH, ms_width=MS_WIDTH)
        results.update(rows)
        if stride == 1:
            err = dsplit_check(dev)
            print(f"# {cname}: dsplit check max |diff| {err:.3e} (rtol = atol = 2e-4) ok",
                  file=sys.stderr, flush=True)
        for n in STRATEGIES + STRIDE1:
            ms = rows.get(f"{cname}/{n}", math.nan)
            if math.isfinite(ms):
                print(f"    {n:20s} {gf / ms:6.1f} TFLOP/s", flush=True)
        del x, k

    for dname, shape, cout in DECONVS:
        xd = normal(shape)
        wt = normal((shape[1], cout, 4, 4, 4))  # ConvTranspose3d's (Cin, Cout, kd, kh, kw)
        k4 = normal((cout, shape[1], 4, 4, 4))
        results.update(run_stages({
            f"{dname}/convtranspose": lambda: halo_conv_transpose(xd, wt),
            f"{dname}/subpixel8": lambda: subpixel8(xd, k4),
        }, only, dev, WIDTH, ms_width=MS_WIDTH))
        del xd, wt, k4
    return results


if __name__ == "__main__":
    main()
