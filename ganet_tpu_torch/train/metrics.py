"""Evaluation metrics (counterpart of `ganet_tpu/train/metrics.py`): EPE,
>1/2/3 px error rates and KITTI D1-all (error > 3 px and > 5 % of the
ground truth), as masked means over the valid pixels.  With a process
group, over the ranks' global batch (their slices of it, or their blocks
of rows on a `space` axis): each numerator and the counts are summed over
the group in one all-reduce, so that every rank returns what JAX's
replicated outputs hold."""

from __future__ import annotations

from typing import Dict

import torch

from ganet_tpu_torch.parallel.comm import all_reduce_


def disparity_metrics(
    pred: torch.Tensor, target: torch.Tensor, valid: torch.Tensor, group=None
) -> Dict[str, torch.Tensor]:
    """pred, target, valid (B, H, W) -> scalar tensors."""
    err = (pred - target).abs()
    d1 = (err > 3.0) & (err > 0.05 * target.abs())
    masked = lambda cond: (cond.to(valid.dtype) * valid).sum()  # noqa: E731
    sums = torch.stack([
        (err * valid).sum(), masked(err > 1.0), masked(err > 2.0), masked(err > 3.0), masked(d1),
        valid.sum(), valid.new_tensor(float(valid.numel())),
    ])
    if group is not None:
        all_reduce_(sums, group)
    epe, r1, r2, r3, d1_all, valid_px, numel = sums.unbind()
    n = torch.clamp_min(valid_px, 1.0)
    return {
        "epe": epe / n,
        "rate_1px": r1 / n,
        "rate_2px": r2 / n,
        "rate_3px": r3 / n,
        "d1_all": d1_all / n,
        "valid_frac": valid_px / numel,
        # Valid-pixel count, for pixel-weighted means across batches.
        "valid_px": valid_px,
    }
