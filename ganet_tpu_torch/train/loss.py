"""Training loss (counterpart of `ganet_tpu/train/loss.py`): masked
smooth-L1 per head, weighted over the deep-supervision heads.

In a step on a mesh each rank holds its slice of the batch and, with a
`space` axis, its block of rows of the maps and targets; it divides its
sum by the valid pixels of the global batch (`valid_count` over the
mesh's `data` x `space` plane), so each rank's loss is its share of the
global batch's loss and the ranks' gradients sum to its gradient.  A mean of the ranks' own means would
weigh their pixels unequally whenever their valid counts differ (sparse
ground truth, the zero-valid padded tail)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ganet_tpu_torch.parallel.comm import all_reduce_


def valid_count(valid: torch.Tensor, group=None) -> torch.Tensor:
    """The valid pixels of the batch, `valid.sum()`, summed over the ranks of
    `group` when one is given; no gradient."""
    n = valid.sum()
    return n if group is None else all_reduce_(n.detach().clone(), group)


def smooth_l1_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    valid: torch.Tensor,
    count: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean smooth-L1 (Huber, delta 1) over valid pixels; pred, target and
    valid are (B, H, W).  The sum is divided by `count` (default
    `valid.sum()`).  A scalar; 0 when no pixel is valid."""
    diff = (pred - target).abs()
    per_pixel = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    n = valid.sum() if count is None else count
    return (per_pixel * valid).sum() / torch.clamp_min(n, 1.0)


def deep_supervision_loss(
    outputs: Sequence[torch.Tensor],
    target: torch.Tensor,
    valid: torch.Tensor,
    weights: Sequence[float],
    group=None,
) -> torch.Tensor:
    """Weighted sum of the heads' smooth-L1 losses.  With fewer heads than
    weights (lighter presets) the last len(outputs) weights apply, so the
    final head keeps the weight 1.0.  With `group`, this rank's share of
    the loss over the ranks' global batch."""
    weights = tuple(weights)[-len(outputs) :]
    count = valid_count(valid, group)
    total = 0.0
    for w, out in zip(weights, outputs):
        total = total + w * smooth_l1_loss(out, target, valid, count)
    return total
