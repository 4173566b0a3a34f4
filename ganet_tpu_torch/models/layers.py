"""Shared conv building blocks (counterpart of `ganet_tpu/models/layers.py`).

Convolutions follow XLA's "SAME" padding, which puts the odd pad on the
high side: a stride-2 3x3 conv pads (0, 1), not (1, 1).  The transposed
convs (kernel 4, stride 2) equal PyTorch's ConvTranspose with padding 1
once the weight bridge has flipped the kernel (see `convert.py`).

Parameters stay float32; every layer casts its weights to the input's
dtype, so a bfloat16 input runs the conv in bfloat16 and rounds its output
to bfloat16, as the JAX package's `compute_dtype` does.  BatchNorm with its
running statistics (the eval forward) is the per-channel affine x * s + t
with s = scale / sqrt(var + eps) and t = bias - mean * s, rounded where
the JAX package rounds it: after a 3D conv it is folded into the conv (the
weights times s in float32, then + t in the input's dtype, as its
`FoldableBN`), elsewhere taken in float32 and rounded once, as flax's
`BatchNorm`.

With a `space` group (`shard_space`, the sharded model of inference), a
BasicConv takes this rank's block of rows and exchanges the rows its
padding needs with its neighbours (`parallel/spatial.py`).

Submodules are named `conv` and `bn`; containers keep the JAX package's
child names (`BasicConv_0`, `Conv2x_1`, ...) so that the weight bridge maps
parameter paths one to one.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from ganet_tpu_torch.ops.normalize import at_least_f32
from ganet_tpu_torch.parallel.comm import all_reduce_sum
from ganet_tpu_torch.parallel.spatial import halo_conv_same, halo_conv_transpose


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype name ("float32" or "bfloat16";
    "float64" measures the float32 noise of the others)."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}[name]


def bn_affine(bn: nn.modules.batchnorm._BatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    """(s, t), float32, such that eval-mode BatchNorm is x * s + t:
    s = scale / sqrt(var + eps), t = bias - mean * s."""
    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    return s, bn.bias - bn.running_mean * s


def bn_eval(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Eval-mode BatchNorm over dim 1 rounded where flax's `BatchNorm`
    rounds: x * s + t taken in float32 (float64 for a float64 input) and
    rounded to the input's dtype once."""
    s, t = bn_affine(bn)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    dt = at_least_f32(x).dtype
    s, t = s.to(dt).view(shape), t.to(dt).view(shape)
    return torch.addcmul(t, x, s).to(x.dtype)


# Set, in the thread that runs it, while `torch.utils.checkpoint` recomputes
# a forward in backward.
_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """The recompute context of `remat`'s checkpoints: `bn_train` inside it
    does not update the running statistics a second time."""
    before = getattr(_recompute, "active", False)
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = before


def sync_batch_norm(module: nn.Module, group) -> None:
    """Train-mode BatchNorm in `module` takes its batch moments over the
    ranks of `group` (the mesh's `data` axis), as flax's BatchNorm under
    GSPMD takes them over the global batch; None: over this rank's batch.
    The group is kept on each BatchNorm module, so that `remat`'s
    recompute, which runs in the autograd engine's thread, reaches it
    too."""
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.data_group = group


def bn_train(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """Train-mode BatchNorm over dim 1: batch moments in float32 (float64
    for a float64 input) as E[x^2] - E[x]^2, the biased variance, clipped at
    0 as flax does; normalised in that precision and cast to the input's
    dtype.  The running statistics take the same biased variance with
    momentum 0.1 (flax's 0.9): `F.batch_norm` would update them with the
    unbiased one (and so would `nn.SyncBatchNorm`).  A forward that `remat`
    runs again in backward (inside `recomputing()`) leaves them alone: they
    move once a step.

    With a `data_group` (`sync_batch_norm`) the moments are global: the
    sums of x and x^2 and the element count are summed over the group's
    ranks in one all-reduce, whose backward sums their cotangents, and a
    recompute issues it again as the forward did."""
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = at_least_f32(x)
    group = getattr(bn, "data_group", None)
    if group is None:
        m = xf.mean(dim=dims)
        ex2 = (xf * xf).mean(dim=dims)
    else:
        C = x.shape[1]
        local = torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                           xf.new_full((1,), x.numel() // C)])
        sums = all_reduce_sum(local, group)
        m, ex2 = sums[:C] / sums[2 * C], sums[C : 2 * C] / sums[2 * C]
    v = torch.clamp_min(ex2 - m * m, 0.0)
    if not getattr(_recompute, "active", False):
        with torch.no_grad():
            bn.running_mean.lerp_(m.to(bn.running_mean.dtype), bn.momentum)
            bn.running_var.lerp_(v.to(bn.running_var.dtype), bn.momentum)
            bn.num_batches_tracked += 1
    s = bn.weight / torch.sqrt(v + bn.eps)
    return ((xf - m.view(shape)) * s.view(shape) + bn.bias.view(shape)).to(x.dtype)


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """`bn_train` when `bn` is in train mode, else `bn_eval`."""
    return bn_train(x, bn) if bn.training else bn_eval(x, bn)


def conv_same(
    x: torch.Tensor, conv: nn.Module, stride: int = 1, scale: torch.Tensor | None = None,
    group=None,
) -> torch.Tensor:
    """`conv`'s weights applied with "SAME" padding in the input's dtype;
    with `scale`, each output channel's weights times it first, in float32.
    With a `space` group, x is this rank's block of rows and the H padding
    comes from its neighbours (`parallel.spatial.halo_conv_same`)."""
    return halo_conv_same(x, conv.weight, conv.bias, stride, scale, group)


def shard_space(module: nn.Module, group) -> None:
    """Every layer in `module` that takes a `space` group (BasicConv and
    the aggregation's SGA blocks and heads) runs on this rank's block of
    rows of the volumes, exchanging halo rows over `group` (the mesh's
    `space` axis); None: on the whole volume.  Like `sync_batch_norm`, the
    group is kept on each module: the state_dict does not change."""
    for m in module.modules():
        if hasattr(m, "space_group"):
            m.space_group = group


class BasicConv(nn.Module):
    """Conv or stride-2 deconv (2D or 3D) + optional BatchNorm + optional
    ReLU; on this rank's block of rows when it has a `space_group`
    (`shard_space`)."""

    space_group = None

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int = 3,
        stride: int = 1,
        is_3d: bool = False,
        deconv: bool = False,
        use_bn: bool = True,
        relu: bool = True,
    ):
        super().__init__()
        self.stride = stride
        self.deconv = deconv
        self.relu = relu
        if deconv:
            if stride != 2:
                raise ValueError("deconv is the stride-2, kernel-4 upsampling conv")
            cls = nn.ConvTranspose3d if is_3d else nn.ConvTranspose2d
            self.conv = cls(in_channels, features, 4, stride=2, padding=1, bias=not use_bn)
        else:
            cls = nn.Conv3d if is_3d else nn.Conv2d
            self.conv = cls(in_channels, features, kernel_size, stride=stride, bias=not use_bn)
        bn_cls = nn.BatchNorm3d if is_3d else nn.BatchNorm2d
        self.bn = bn_cls(features, eps=1e-5, momentum=0.1) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = self.space_group
        if self.deconv:
            x = halo_conv_transpose(x, self.conv.weight, self.conv.bias, group)
        elif x.dim() == 5 and self.bn is not None and not self.bn.training:
            # An eval BatchNorm after a 3D conv is folded into the conv, as
            # the JAX package's FoldableBN does: weights times s in float32,
            # then + t in the input's dtype.
            s, t = bn_affine(self.bn)
            x = conv_same(x, self.conv, self.stride, scale=s, group=group)
            x = x + t.to(x.dtype).view(1, -1, 1, 1, 1)
            return F.relu(x) if self.relu else x
        else:
            x = conv_same(x, self.conv, self.stride, group=group)
        if self.bn is not None:
            x = batch_norm(x, self.bn)
        if self.relu:
            x = F.relu(x)
        return x


class Conv2x(nn.Module):
    """Down- or up-sampling conv, concat with the skip tensor, fusing conv."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        rem_channels: int,
        deconv: bool = False,
        is_3d: bool = False,
        relu: bool = True,
    ):
        super().__init__()
        self.BasicConv_0 = BasicConv(
            in_channels, features, 3, stride=2, is_3d=is_3d, deconv=deconv
        )
        self.BasicConv_1 = BasicConv(
            features + rem_channels, features, 3, is_3d=is_3d, relu=relu
        )

    def forward(self, x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        x = self.BasicConv_0(x)
        if x.shape[2:] != rem.shape[2:]:
            raise ValueError(f"Conv2x skip mismatch: {tuple(x.shape)} vs rem {tuple(rem.shape)}")
        return self.BasicConv_1(torch.cat([x, rem.to(x.dtype)], dim=1))


def channel_schedule(base: int, levels: int) -> list[int]:
    """Hourglass channel widths per level (base 32, 4 levels ->
    [32, 48, 64, 96, 128])."""
    mults = [1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0]
    if levels + 1 > len(mults):
        raise ValueError(f"too many levels: {levels}")
    return [max(1, int(base * m)) for m in mults[: levels + 1]]


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init matching the JAX package's: conv kernels from a
    truncated normal with the He fan-in scale (flax `he_normal`),
    BatchNorm scale 1, bias 0, running mean 0, running var 1."""
    convs = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)
    with torch.no_grad():
        for _, m in sorted(module.named_modules(), key=lambda kv: kv[0]):
            if isinstance(m, convs):
                w = m.weight
                in_ch = w.shape[0] if isinstance(m, nn.modules.conv._ConvTransposeNd) else w.shape[1]
                fan_in = in_ch * math.prod(w.shape[2:])
                # 0.8796... is the std of a unit normal truncated at +-2.
                std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
