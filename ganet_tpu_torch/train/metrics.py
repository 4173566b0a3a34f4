"""Evaluation metrics (counterpart of `ganet_tpu/train/metrics.py`): EPE,
>1/2/3 px error rates and KITTI D1-all (error > 3 px and > 5 % of the
ground truth), as masked means over the valid pixels."""

from __future__ import annotations

from typing import Dict

import torch


def disparity_metrics(
    pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """pred, target, valid (B, H, W) -> scalar tensors."""
    err = (pred - target).abs()
    n = torch.clamp_min(valid.sum(), 1.0)

    def masked_rate(cond: torch.Tensor) -> torch.Tensor:
        return (cond.to(valid.dtype) * valid).sum() / n

    d1 = (err > 3.0) & (err > 0.05 * target.abs())
    return {
        "epe": (err * valid).sum() / n,
        "rate_1px": masked_rate(err > 1.0),
        "rate_2px": masked_rate(err > 2.0),
        "rate_3px": masked_rate(err > 3.0),
        "d1_all": masked_rate(d1),
        "valid_frac": valid.mean(),
        # Valid-pixel count, for pixel-weighted means across batches.
        "valid_px": valid.sum(),
    }
