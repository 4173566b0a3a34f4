"""Training loss (counterpart of `ganet_tpu/train/loss.py`): masked
smooth-L1 per head, weighted over the deep-supervision heads."""

from __future__ import annotations

from typing import Sequence

import torch


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean smooth-L1 (Huber, delta 1) over valid pixels; pred, target and
    valid are (B, H, W).  A scalar; 0 when no pixel is valid."""
    diff = (pred - target).abs()
    per_pixel = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    return (per_pixel * valid).sum() / torch.clamp_min(valid.sum(), 1.0)


def deep_supervision_loss(
    outputs: Sequence[torch.Tensor],
    target: torch.Tensor,
    valid: torch.Tensor,
    weights: Sequence[float],
) -> torch.Tensor:
    """Weighted sum of the heads' smooth-L1 losses.  With fewer heads than
    weights (lighter presets) the last len(outputs) weights apply, so the
    final head keeps the weight 1.0."""
    weights = tuple(weights)[-len(outputs) :]
    total = 0.0
    for w, out in zip(weights, outputs):
        total = total + w * smooth_l1_loss(out, target, valid)
    return total
