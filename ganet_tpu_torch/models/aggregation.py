"""Cost aggregation and disparity heads (counterpart of
`ganet_tpu/models/aggregation.py`).

Volumes are (B, C, D, H, W).  The 3D-conv hourglass is interleaved with
SGA blocks at 1/3 resolution (C channels) and 1/6 resolution (1.5C); the
final head refines with LGA.  SGA and LGA go through `ops.dispatch`, so
with `impl="auto"` a CUDA volume runs the hand-written kernels, and their
gradients the hand-written backward kernels.

In train mode the intermediate heads `disp0`.. run too, and
`CostAggregation` returns every head's map for deep supervision; in eval
mode only the final map.

Rematerialisation (`cfg.remat`, the JAX package's `nn.remat` policy) runs
in train mode with gradients enabled: under "sga" each SGA block, each
intermediate head and the final head is a `torch.utils.checkpoint`
(non-reentrant) whose activations are recomputed in backward, which on a
CUDA device launches the SGA and LGA forward kernels a second time; under
"full" so is each 3D-conv stage of the hourglass.  Parameter names do not
change, so checkpoints of every policy are interchangeable.  The recompute
runs inside `layers.recomputing()`, so train-mode BatchNorm updates its
running statistics once a step.

Spatial sharding (eval only): after `layers.shard_space(module, group)`
every 3D conv, SGA block and head runs on this rank's block of H rows of
the volumes, its blocks in rank order along the mesh's `space` group:
halo convolutions and upsample (`parallel/spatial.py`), the SGA wavefront
and the halo LGA (`ops.dispatch`); the final map is the rank's block of
rows.  Softmax, the expectation and the eval BatchNorm are local.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ganet_tpu_torch.config import ModelConfig
from ganet_tpu_torch.models.layers import (
    BasicConv,
    Conv2x,
    batch_norm,
    channel_schedule,
    recomputing,
    torch_dtype,
)
from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops.disparity import disparity_regression
from ganet_tpu_torch.ops.normalize import at_least_f32, l1_normalize, normalize_weights
from ganet_tpu_torch.parallel.spatial import halo_conv_same, halo_trilinear_upsample


class SGABlock(nn.Module):
    """SGA + BatchNorm + ReLU + refining conv + residual ReLU."""

    space_group = None

    def __init__(self, channels: int, cfg: ModelConfig):
        super().__init__()
        self.channels = channels
        self.cfg = cfg
        self.bn = nn.BatchNorm3d(channels, eps=1e-5, momentum=0.1)
        self.BasicConv_0 = BasicConv(channels, channels, 3, is_3d=True, relu=False)

    def forward(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """x (B, C, D, H, W); g (B, 20C, H, W) raw guidance in (dir, weight, C)
        channel order."""
        C = self.channels
        if x.shape[1] != C or g.shape[1] != 20 * C:
            raise ValueError(
                f"SGABlock({C}) got x {tuple(x.shape)} and guidance {tuple(g.shape)}"
            )
        B, _, H, W = g.shape
        k = normalize_weights(g.view(B, 4, 5, C, H, W), self.cfg.sga_norm, dim=2)
        k = k.permute(0, 3, 1, 2, 4, 5).contiguous()  # (B, C, 4, 5, H, W)
        rem = x
        x = dispatch.sga_ncdhw(x.contiguous(), k.to(x.dtype), self.cfg.impl, self.space_group)
        x = F.relu(batch_norm(x, self.bn))
        x = self.BasicConv_0(x)
        return F.relu(x + rem.to(x.dtype))


class DispHead(nn.Module):
    """Intermediate head of the train mode (`disp0`, `disp1`): C -> 1 conv,
    trilinear x3 upsample in the head dtype, softmax over the negated cost
    in float32, expectation."""

    space_group = None

    def __init__(self, cfg: ModelConfig, channels: int):
        super().__init__()
        self.cfg = cfg
        self.conv = nn.Conv3d(channels, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, D/3, H/3, W/3) -> (B, H, W)."""
        cfg = self.cfg
        x = halo_conv_same(x, self.conv.weight, group=self.space_group)[:, 0]
        D = cfg.max_disp
        H, W = x.shape[2] * 3, x.shape[3] * 3
        x = halo_trilinear_upsample(
            x.to(torch_dtype(cfg.resolved_head_dtype)), (D, H, W), self.space_group
        )
        return disparity_regression(torch.softmax(-at_least_f32(x), dim=1), D)


class DispAggHead(nn.Module):
    """Final head: LGA before the softmax and after it, then the
    renormalised expectation."""

    space_group = None

    def __init__(self, cfg: ModelConfig, channels: int):
        super().__init__()
        self.cfg = cfg
        self.conv = nn.Conv3d(channels, 1, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor, lg1: torch.Tensor, lg2: torch.Tensor) -> torch.Tensor:
        """x (B, C, D/3, H/3, W/3); lg1, lg2 (B, 75, H, W) raw -> (B, H, W)."""
        cfg = self.cfg
        r = cfg.lga_radius
        hd = torch_dtype(cfg.resolved_head_dtype)
        # C -> 1 conv, then the trilinear x3 upsample in the head dtype.
        group = self.space_group
        x = halo_conv_same(x, self.conv.weight, group=group)[:, 0]
        D = cfg.max_disp
        H, W = x.shape[2] * 3, x.shape[3] * 3
        x = halo_trilinear_upsample(x.to(hd), (D, H, W), group).contiguous()
        # Guidance is normalised in float32, then stored in the head dtype.
        lg1 = l1_normalize(at_least_f32(lg1), dim=1).to(hd).contiguous()
        lg2 = l1_normalize(at_least_f32(lg2), dim=1).to(hd).contiguous()
        x = dispatch.lga_nchw(x, lg1, r, cfg.lga_repeats, cfg.impl, group)
        # Softmax in float32; the probabilities are stored in the head dtype.
        p = torch.softmax(-at_least_f32(x), dim=1).to(hd).contiguous()
        p = dispatch.lga_nchw(p, lg2, r, cfg.lga_repeats, cfg.impl, group)
        # Renormalisation fused with the expectation, in float32.
        pf = at_least_f32(p)
        d = torch.arange(cfg.max_disp, dtype=pf.dtype, device=pf.device)
        num = (pf * d.view(1, -1, 1, 1)).sum(dim=1)
        den = torch.clamp_min(pf.abs().sum(dim=1), 1e-6)
        return num / den


class CostAggregation(nn.Module):
    """3D hourglass with SGA blocks.  Returns the final map in eval mode and
    the list [disp0, disp1, ..., final] in train mode.

    The layer order is fixed in `__init__` as a plan of steps, which
    `forward` runs: ("conv", name), ("c2", name, skip index),
    ("sga", name, guidance key, index), ("save", skip index) and
    ("head", name), the last run in train mode only.  Modules
    are created in the JAX package's order, so that their names match its
    parameter paths.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.agg_channels
        levels, cycles = cfg.agg_levels, cfg.agg_cycles
        chans = channel_schedule(C, levels)
        plan = []
        counts = {"bc": 0, "c2": 0, "sg_full": 0, "sg_half": 0}
        num = {"sg_full": cfg.num_sga_full, "sg_half": cfg.num_sga_half}

        def conv(cin, cout, stride=1, relu=True):
            name = f"BasicConv_{counts['bc']}"
            counts["bc"] += 1
            self.add_module(name, BasicConv(cin, cout, 3, stride=stride, is_3d=True, relu=relu))
            plan.append(("conv", name))

        def c2(cin, cout, skip, deconv, relu=True):
            name = f"Conv2x_{counts['c2']}"
            counts["c2"] += 1
            self.add_module(
                name, Conv2x(cin, cout, chans[skip], deconv=deconv, is_3d=True, relu=relu)
            )
            plan.append(("c2", name, skip))

        def sga(key):
            j = counts[key]
            if j < num[key]:
                counts[key] += 1
                name = f"sga_{key[3:]}{j}"
                self.add_module(name, SGABlock(chans[0 if key == "sg_full" else 1], cfg))
                plan.append(("sga", name, key, j))

        def head(name):
            self.add_module(name, DispHead(cfg, chans[0]))
            plan.append(("head", name))

        conv(2 * cfg.feature_channels, C, relu=False)
        sga("sg_full")
        head("disp0")
        plan.append(("save", 0))
        for i in range(levels):
            conv(chans[i], chans[i + 1], stride=2)
            if i == 0:
                sga("sg_half")
            plan.append(("save", i + 1))
        for cycle in range(cycles):
            for i in range(levels, 0, -1):
                c2(chans[i], chans[i - 1], i - 1, deconv=True, relu=i - 1 != 0)
                if i - 1 == 1:
                    sga("sg_half")
                plan.append(("save", i - 1))
            sga("sg_full")
            plan.append(("save", 0))
            if cycle != cycles - 1:
                head(f"disp{cycle + 1}")
                for i in range(levels):
                    c2(chans[i], chans[i + 1], i + 1, deconv=False)
                    if i == 0:
                        sga("sg_half")
                    plan.append(("save", i + 1))
        self.disp_final = DispAggHead(cfg, chans[0])
        self.plan = plan
        self.levels = levels

    def forward(self, cv: torch.Tensor, guidance: dict):
        remat = self.cfg.remat if self.training and torch.is_grad_enabled() else "none"
        blocks, convs = remat in ("sga", "full"), remat == "full"
        rem = [None] * (self.levels + 1)
        outputs = []
        x = cv
        for step in self.plan:
            kind = step[0]
            if kind == "conv":
                x = _run(convs, getattr(self, step[1]), x)
            elif kind == "c2":
                x = _run(convs, getattr(self, step[1]), x, rem[step[2]])
            elif kind == "sga":
                x = _run(blocks, getattr(self, step[1]), x, guidance[step[2]][step[3]])
            elif kind == "save":
                rem[step[1]] = x
            elif kind == "head" and self.training:
                outputs.append(_run(blocks, getattr(self, step[1]), x))
        final = _run(blocks, self.disp_final, x, guidance["lg1"], guidance["lg2"])
        return outputs + [final] if self.training else final


def _run(remat: bool, module: nn.Module, *args: torch.Tensor) -> torch.Tensor:
    """`module(*args)`, as a checkpoint recomputed in backward when `remat`."""
    if not remat:
        return module(*args)
    return torch.utils.checkpoint.checkpoint(
        module, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recomputing()),
    )
