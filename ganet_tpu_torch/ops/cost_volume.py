"""Concatenation cost volume (counterpart of `ganet_tpu/ops/cost_volume.py`).

For each disparity d at 1/3 resolution, the left features are concatenated
with the right features shifted right by d, zero-filled where the shift
falls outside the image:

    cv[b, d, h, w] = concat(left[b, h, w], right[b, h, w - d])
"""

from __future__ import annotations

import torch


def build_cost_volume_ncdhw(
    left: torch.Tensor, right: torch.Tensor, num_disp: int, start: int = 0,
    stop: int | None = None,
) -> torch.Tensor:
    """left, right (B, C, H, W) -> (B, 2C, D, H, W), the model's layout;
    with `start`/`stop`, only the bins [start, stop) of the whole volume's
    D = num_disp (a rank's block over the mesh's `disp` axis), which equal
    that slice of the whole volume."""
    if left.ndim != 4 or left.shape != right.shape:
        raise ValueError(f"expected matching (B,C,H,W) features, got {left.shape}")
    stop = num_disp if stop is None else stop
    if not 0 <= start < stop <= num_disp:
        raise ValueError(f"bins [{start}, {stop}) are not a block of {num_disp}")
    B, C, H, W = left.shape
    cv = left.new_zeros((B, 2 * C, stop - start, H, W))
    cv[:, :C] = left[:, :, None]
    for d in range(start, stop):
        if d == 0:
            cv[:, C:, 0] = right
        elif d < W:
            cv[:, C:, d - start, :, d:] = right[:, :, :, : W - d]
    return cv


def build_cost_volume(
    left: torch.Tensor, right: torch.Tensor, num_disp: int
) -> torch.Tensor:
    """left, right (B, H, W, C) -> (B, D, H, W, 2C), the JAX package's layout."""
    if left.ndim != 4:
        raise ValueError(f"expected (B,H,W,C) features, got {left.shape}")
    cv = build_cost_volume_ncdhw(
        left.permute(0, 3, 1, 2), right.permute(0, 3, 1, 2), num_disp
    )
    return cv.permute(0, 2, 3, 4, 1)
