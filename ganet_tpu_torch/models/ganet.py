"""Top-level GANet (counterpart of `ganet_tpu/models/ganet.py`).

    feature(left), feature(right)        one batched call, 1/3 resolution
    conv_x / conv_y                      per-view projection
    guidance(left image, left features)  SGA / LGA weights
    cost volume                          (B, 2C, D/3, H/3, W/3)
    cost aggregation                     3D hourglass + SGA, LGA head

Takes (B, H, W, 3) images, as the JAX package does, and returns the
(B, H, W) disparity map in eval mode, or in train mode (`model.train()`)
the list of every head's map for deep supervision, the final map last.
BatchNorm follows the mode: batch statistics and running-statistic updates
in train mode, running statistics in eval mode.

With a mesh (`parallel.mesh.Mesh`) whose `space` axis has more than one
rank, the model is one rank of the counterpart of the JAX package's
`GANet(cfg, mesh)`, in either mode: it runs the 2D part (features,
`conv_x`/`conv_y`, guidance) on the whole image, as the JAX package does
with its inputs replicated, then takes this rank's block of rows of the
features (the cost volume shifts along W only, so each rank builds its
block of it), of the SGA guidance at H/3 and H/6 and of the LGA guidance
at H, and runs the aggregation on the blocks over the mesh's `space`
group (`layers.shard_space`).  It returns this rank's block of rows of
the disparity, in train mode of every head's; `entry.predict` joins the
blocks, and the train step holds them against the targets' rows
(`train/trainer.py`).  The image height must meet
`parallel.spatial.check_spatial_shape`, checked on every call.

With a `disp` axis of more than one rank the model is one rank of the JAX
package's `GANet(cfg, mesh)` with its conv phase sharded over disparity
(`volume_sharding`): every rank of a `disp` line runs the same 2D part,
builds its block of the cost volume's bins from the whole features
(which pass through `comm.copy_in`, so that their gradient sums the
blocks'), and runs the aggregation on its block over the `disp` group
(`layers.shard_disp`): D-halo 3D convolutions, the bins gathered around
the SGA sweeps and the heads (`models/aggregation.py`).  Every rank of a
`disp` line returns the same maps.  max_disp must meet
`parallel.disparity.check_disp_shape`, checked on every call before any
collective.  The batch is the caller's: the `data` axis splits it in
`entry.predict` and in the trainer's batch iterator.

With `cfg.channel_tp` the `disp` axis splits channels instead (the JAX
package's `GANet(cfg, mesh)` with `volume_sharding(mesh, channel_tp=True)`):
every rank of a `disp` line builds its block of the cost volume's 2C
channels from the whole features (through `comm.copy_in`, as for bins)
and runs the aggregation on its block of every volume's channels over the
`disp` group (`layers.shard_channels`, `parallel/channels.py`); every
rank of the line returns the same maps.  Every width of the volumes must
meet `parallel.channels.check_channel_shape`, checked on every call.
Without a mesh, or with `disp` 1, `channel_tp` changes nothing.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ganet_tpu_torch.config import ModelConfig
from ganet_tpu_torch.models.aggregation import CostAggregation
from ganet_tpu_torch.models.feature import FeatureNet
from ganet_tpu_torch.models.guidance import GuidanceNet
from ganet_tpu_torch.models.layers import (
    BasicConv,
    shard_channels,
    shard_disp,
    shard_space,
    torch_dtype,
)
from ganet_tpu_torch.ops.cost_volume import build_cost_volume_ncdhw
from ganet_tpu_torch.parallel.channels import channel_block, check_channel_shape
from ganet_tpu_torch.parallel.comm import copy_in
from ganet_tpu_torch.parallel.disparity import check_disp_shape, disp_block
from ganet_tpu_torch.parallel.spatial import check_spatial_shape, row_block, space_size


class GANet(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        Cf = cfg.feature_channels
        self.feature = FeatureNet(cfg)
        self.conv_x = BasicConv(Cf, Cf, 3)
        self.conv_y = BasicConv(Cf, Cf, 3)
        self.guidance = GuidanceNet(cfg)
        self.cost_agg = CostAggregation(cfg)
        shard_space(self.cost_agg, None if mesh is None else mesh.space_group)
        if cfg.channel_tp:
            tp = mesh is not None and mesh.size("disp") > 1
            shard_channels(self.cost_agg, mesh.disp_group if tp else None)
        else:
            shard_disp(self.cost_agg, None if mesh is None else mesh.disp_group)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        cfg = self.cfg
        if left.dim() != 4 or left.shape != right.shape or left.shape[-1] != 3:
            raise ValueError(
                f"expected matching (B,H,W,3) pairs, got {tuple(left.shape)} vs"
                f" {tuple(right.shape)}"
            )
        B, H, W, _ = left.shape
        cfg.validate_image_shape(H, W)
        group = None if self.mesh is None else self.mesh.space_group
        line = None if self.mesh is None else self.mesh.disp_group
        space, disp = space_size(group), space_size(line)
        # The `disp` line splits either the channels or the bins.
        chans = line if cfg.channel_tp and disp > 1 else None
        bins = None if cfg.channel_tp else line
        if space > 1:
            check_spatial_shape(cfg, H, space)
        if chans is not None:
            check_channel_shape(cfg, disp)
        elif disp > 1:
            check_disp_shape(cfg, disp)
        dtype = torch_dtype(cfg.compute_dtype)
        left = left.permute(0, 3, 1, 2).to(dtype)
        right = right.permute(0, 3, 1, 2).to(dtype)

        feats = self.feature(torch.cat([left, right], dim=0))
        f_left = self.conv_x(feats[:B])
        f_right = self.conv_y(feats[B:])
        guidance = self.guidance(left, f_left)
        if space > 1:
            a, b = row_block(f_left.shape[2], group)
            f_left, f_right = f_left[:, :, a:b], f_right[:, :, a:b]
            guidance = {
                "sg_full": [g[:, :, a:b].contiguous() for g in guidance["sg_full"]],
                "sg_half": [g[:, :, a // 2 : b // 2].contiguous() for g in guidance["sg_half"]],
                "lg1": guidance["lg1"][:, :, 3 * a : 3 * b].contiguous(),
                "lg2": guidance["lg2"][:, :, 3 * a : 3 * b].contiguous(),
            }
        if disp > 1:
            # One copy_in for both views, so that its backward runs on
            # every rank: a block of channels may use one view only.
            C = f_left.shape[1]
            f = copy_in(torch.cat([f_left, f_right], dim=1), line)
            f_left, f_right = f[:, :C], f[:, C:]
        cv = build_cost_volume_ncdhw(f_left, f_right, cfg.disp_channels,
                                     *disp_block(cfg.disp_channels, bins),
                                     channels=channel_block(2 * f_left.shape[1], chans))
        return self.cost_agg(cv, guidance)
