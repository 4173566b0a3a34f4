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
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ganet_tpu_torch.config import ModelConfig
from ganet_tpu_torch.models.aggregation import CostAggregation
from ganet_tpu_torch.models.feature import FeatureNet
from ganet_tpu_torch.models.guidance import GuidanceNet
from ganet_tpu_torch.models.layers import BasicConv, torch_dtype
from ganet_tpu_torch.ops.cost_volume import build_cost_volume_ncdhw


class GANet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        Cf = cfg.feature_channels
        self.feature = FeatureNet(cfg)
        self.conv_x = BasicConv(Cf, Cf, 3)
        self.conv_y = BasicConv(Cf, Cf, 3)
        self.guidance = GuidanceNet(cfg)
        self.cost_agg = CostAggregation(cfg)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        cfg = self.cfg
        if left.dim() != 4 or left.shape != right.shape or left.shape[-1] != 3:
            raise ValueError(
                f"expected matching (B,H,W,3) pairs, got {tuple(left.shape)} vs"
                f" {tuple(right.shape)}"
            )
        B, H, W, _ = left.shape
        cfg.validate_image_shape(H, W)
        dtype = torch_dtype(cfg.compute_dtype)
        left = left.permute(0, 3, 1, 2).to(dtype)
        right = right.permute(0, 3, 1, 2).to(dtype)

        feats = self.feature(torch.cat([left, right], dim=0))
        f_left = self.conv_x(feats[:B])
        f_right = self.conv_y(feats[B:])
        guidance = self.guidance(left, f_left)
        cv = build_cost_volume_ncdhw(f_left, f_right, cfg.disp_channels)
        return self.cost_agg(cv, guidance)
