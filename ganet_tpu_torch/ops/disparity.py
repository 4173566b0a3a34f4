"""Disparity regression and volume upsampling (counterpart of
`ganet_tpu/ops/disparity.py`)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def trilinear_upsample(x: torch.Tensor, target_shape: Sequence[int]) -> torch.Tensor:
    """Trilinear resize of a (B, D, H, W) volume to (B, D', H', W') with
    half-pixel centres (align_corners=False), as `jax.image.resize` does
    when it enlarges."""
    return F.interpolate(
        x[:, None], size=tuple(target_shape), mode="trilinear", align_corners=False
    )[:, 0]


def soft_argmin(cost: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Softmax over the negated cost (the soft-argmin probabilities)."""
    return torch.softmax(-cost, dim=dim)


def disparity_regression(prob: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Expectation over the disparity bins of a (B, D, H, W) volume."""
    if prob.shape[1] != max_disp:
        raise ValueError(
            f"prob has {prob.shape[1]} disparity bins, expected {max_disp}"
        )
    d = torch.arange(max_disp, dtype=prob.dtype, device=prob.device)
    return (prob * d.view(1, max_disp, 1, 1)).sum(dim=1)
